"""Run-health heartbeats: the process-global seam only (port of
``obs/heartbeat.py:337-413``).

The run log's emit path and the phase timer each make one call into
this module; with no heartbeat installed every call is one module-global
read.  At the default config no heartbeat is installed:
``resolve_dir('auto', checkpoint_dir=None)`` is None, because 'auto'
places ``health/`` inside the durable checkpoint directory and the port
has none yet.  The writer (``RunHeartbeat``/``HeartbeatFile``) and the
read side come with the item that makes 'auto' live (ROADMAP A8, with
``checkpoint_dir``); until then an installed heartbeat is any object
with ``note_chunk(**kw)``, ``note_phase(name, seconds)`` and
``observe_event(event, payload)``.
"""

from __future__ import annotations

import pathlib
from typing import Optional

_ACTIVE = None


def install(hb) -> None:
    """Make ``hb`` the process heartbeat (newest wins, like the metrics
    registry)."""
    global _ACTIVE
    _ACTIVE = hb


def uninstall(hb) -> None:
    """Remove ``hb`` if it is still the installed heartbeat."""
    global _ACTIVE
    if _ACTIVE is hb:
        _ACTIVE = None


def current():
    return _ACTIVE


def note_chunk(**kw) -> None:
    hb = _ACTIVE
    if hb is not None:
        hb.note_chunk(**kw)


def note_phase(name, seconds) -> None:
    hb = _ACTIVE
    if hb is not None:
        hb.note_phase(name, seconds)


def observe_event(event: str, payload: dict) -> None:
    hb = _ACTIVE
    if hb is not None:
        hb.observe_event(event, payload)


def attach_phase_sink(timer) -> None:
    """Chain a heartbeat phase note onto the PhaseTimer ``on_add``
    chain.  The sink resolves the installed heartbeat at call time, so
    one attachment serves whichever is installed when a phase closes;
    re-attaching is a no-op (stacking would double-pump every phase)."""
    if getattr(timer, "_pert_heartbeat_sink", False):
        return
    prev = getattr(timer, "on_add", None)

    def _sink(name, seconds):
        if prev is not None:
            prev(name, seconds)
        hb = _ACTIVE
        if hb is not None:
            hb.note_phase(name, seconds)

    timer._pert_heartbeat_sink = True
    timer.on_add = _sink


def resolve_dir(setting, checkpoint_dir=None) -> Optional[str]:
    """Config-level resolution of ``heartbeat_dir``: 'auto' places
    ``health/`` inside the checkpoint directory when one is configured
    and disables otherwise; None/'none'/'off'/'' disables; any other
    value is the directory itself."""
    if setting is None or str(setting).lower() in ("none", "off", ""):
        return None
    if str(setting) == "auto":
        if not checkpoint_dir:
            return None
        return str(pathlib.Path(checkpoint_dir) / "health")
    return str(setting)
