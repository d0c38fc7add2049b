"""Run-health heartbeats: the writer and the process-global seam (port
of ``obs/heartbeat.py:1-413``).

* :class:`HeartbeatFile` is the low-level writer: one JSON document per
  path, committed with ``utils.fileio.atomic_write_bytes`` (a reader
  never sees a torn file), stamped with a **monotonic sequence number**
  (``seq``) and a wall-clock ``written_unix``.  ``seq`` resumes from any
  prior document at the path, so a restarted process never appears to
  move backwards;
* :class:`RunHeartbeat` is the per-process fit writer: it publishes
  ``health/host_<rank>.json`` with step/chunk/iteration progress, a
  ms/iter EWMA and the ETA it implies, the controller verdict-trail
  tail, and device memory and fault-ladder counters sampled from the
  installed metrics registry.  Writes are throttled to the configured
  interval; fault-ladder events force an immediate write;
* a process-global :func:`install`/:func:`current` seam plus module-level
  no-op helpers (:func:`note_chunk`, :func:`note_phase`,
  :func:`observe_event`), so the chunk loop and the run log's emit seam
  need one call each and heartbeat-off runs cost one global read.

``resolve_dir('auto', checkpoint_dir)`` places ``health/`` inside the
checkpoint directory, so a run with ``checkpoint_dir`` writes a live
heartbeat at the default config.  The documents are the JAX package's,
field for field (``last_span`` stays None until span tracing is ported),
so its read side (``read_heartbeat``, ``freshness``, ``scan_health``,
``aggregate_health``) and ``tools/pert_watch.py`` read them; the read
side's port comes with ROADMAP A11b.

Lifecycle contract: :meth:`RunHeartbeat.close` is called on normal
completion (``state="done"``) and on ``Exception`` (``state="error"``)
— but deliberately NOT on ``BaseException``.  A simulated preemption or
a real SIGKILL leaves the last heartbeat in place, exactly like a lost
host, so the watcher's staleness ladder is the detection mechanism in
both cases.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import pathlib
import time
from typing import Dict, Optional

from scdna_replication_tools_tpu_torch.obs import metrics as metrics_mod
from scdna_replication_tools_tpu_torch.utils.fileio import atomic_write_bytes

logger = logging.getLogger("scdna_replication_tools_tpu_torch")

HEARTBEAT_KIND = "pert_heartbeat"
HEARTBEAT_VERSION = 1

#: metrics sampled out of the installed registry into each heartbeat —
#: the HBM gauges plus the fault-ladder counters (base names; labelled
#: series keep their full ``name{label="v"}`` key in the document)
SAMPLED_METRICS = (
    "pert_device_hbm_bytes_in_use",
    "pert_device_hbm_peak_bytes",
    "pert_retries_total",
    "pert_degrades_total",
    "pert_mesh_shrinks_total",
    "pert_nan_aborts_total",
    "pert_faults_injected_total",
)

#: RunLog event kinds that mutate fault-ladder state — each one forces
#: an immediate heartbeat write (rare, high-signal)
_FAULT_EVENTS = frozenset({"retry", "degrade", "fault_injected",
                           "resume", "mesh_shrink"})

_EWMA_ALPHA = 0.3
_TRAIL_LEN = 8


def host_path(health_dir, process_index: int) -> pathlib.Path:
    """The per-rank heartbeat path inside ``health_dir``."""
    return pathlib.Path(health_dir) / f"host_{int(process_index)}.json"


class HeartbeatFile:
    """Sequence-stamped atomic JSON document at a fixed path.

    The write never raises (a full disk must not take down the run it
    observes) and never leaves a torn file (``atomic_write_bytes``).
    ``seq`` is monotonic per writer and resumes from any prior document
    at the path, so freshness-by-sequence survives process restarts.
    """

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self.seq = self._prior_seq()

    def _prior_seq(self) -> int:
        try:
            doc = json.loads(self.path.read_text())
            return int(doc.get("seq", 0))
        except (OSError, ValueError, TypeError):
            return 0

    def write(self, doc: dict) -> Optional[int]:
        """Commit ``doc`` (plus ``seq``/``written_unix``) atomically.

        Returns the sequence number written, or None on failure.
        """
        self.seq += 1
        body = dict(doc)
        body["seq"] = self.seq
        body["written_unix"] = time.time()
        try:
            atomic_write_bytes(
                self.path,
                (json.dumps(body, indent=1, sort_keys=True,
                            default=str) + "\n").encode())
            return self.seq
        except (OSError, ValueError) as exc:
            logger.debug("heartbeat: cannot write %s (%s)",
                         self.path, exc)
            return None


class RunHeartbeat:
    """Per-process fit heartbeat: ``<health_dir>/host_<rank>.json``.

    All mutators are best-effort and never raise — the heartbeat rides
    inside the chunk loop and must cost nothing when the disk is sick.
    """

    def __init__(self, health_dir, interval_seconds: float = 15.0,
                 process_index: int = 0, process_count: int = 1,
                 run_name: str = "pert",
                 config_digest: Optional[str] = None):
        self.health_dir = pathlib.Path(health_dir)
        self.interval_seconds = max(float(interval_seconds), 0.05)
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.run_name = str(run_name)
        self.config_digest = config_digest
        self._file = HeartbeatFile(host_path(health_dir, process_index))
        self._fields: Dict[str, object] = {
            "state": "running", "phase": None, "step": None,
            "chunk": None, "iteration": None, "budget": None,
            "ms_per_iter_ewma": None, "eta_seconds": None,
            # the cost meter's live efficiency fields, None until the
            # meter is ported (ROADMAP A11b)
            "goodput": None, "waste_frac": None,
            "error": None,
        }
        self._trail: collections.deque = collections.deque(
            maxlen=_TRAIL_LEN)
        self._faults: Dict[str, int] = {}
        self._last_iteration: Optional[int] = None
        self._last_write = 0.0
        self.pump(force=True)   # announce the process immediately

    # -- write side ------------------------------------------------------

    def _doc(self) -> dict:
        doc = {
            "kind": HEARTBEAT_KIND,
            "version": HEARTBEAT_VERSION,
            "pid": os.getpid(),
            "process_index": self.process_index,
            "process_count": self.process_count,
            "run_name": self.run_name,
            "config_digest": self.config_digest,
            "interval_seconds": self.interval_seconds,
            "trail": list(self._trail),
            "faults": dict(sorted(self._faults.items())),
            # the last closed span rides here once span tracing is
            # ported (ROADMAP A11b)
            "last_span": None,
            "metrics": self._sample_metrics(),
        }
        doc.update(self._fields)
        return doc

    def _sample_metrics(self) -> dict:
        """HBM + fault-ladder series out of the installed registry."""
        try:
            snap = metrics_mod.current().snapshot(stable_only=False)
        except Exception as exc:  # noqa: BLE001 — sampling is
            # best-effort; the heartbeat still carries progress
            logger.debug("heartbeat: metrics sample failed: %s", exc)
            return {}
        out = {}
        for key, payload in snap.items():
            if metrics_mod.metric_base_name(key) in SAMPLED_METRICS \
                    and payload.get("type") != "histogram":
                out[key] = payload.get("value")
        return out

    def pump(self, force: bool = False) -> None:
        """Write the heartbeat if ``interval_seconds`` has elapsed (or
        unconditionally with ``force``).  Never raises."""
        now = time.monotonic()
        if not force and now - self._last_write < self.interval_seconds:
            return
        self._last_write = now
        try:
            eta = self._fields.get("eta_seconds")
            if eta is not None:
                metrics_mod.current().gauge(
                    "pert_run_eta_seconds").set(float(eta))
            self._file.write(self._doc())
        except Exception as exc:  # noqa: BLE001 — a sick disk or a
            # half-torn registry must not take down the fit it observes
            logger.debug("heartbeat: pump failed: %s", exc)

    def note(self, **fields) -> None:
        """Update document fields (no write — the next pump carries
        them).  Unknown fields are stored verbatim."""
        self._fields.update(fields)

    def note_phase(self, name, seconds) -> None:
        """PhaseTimer ``on_add`` sink target: record the phase that just
        closed and give the throttle a chance to write."""
        try:
            self._fields["phase"] = str(name)
            self.pump()
        except Exception as exc:  # noqa: BLE001 — sink rides on every
            # phase exit; must cost nothing on failure
            logger.debug("heartbeat: phase note failed: %s", exc)

    def note_chunk(self, step=None, chunk=None, iteration=None,
                   budget=None, wall_seconds=None, iters=None,
                   action=None, verdict=None) -> None:
        """One dispatched fit chunk: update progress, the ms/iter EWMA,
        the ETA projection and the verdict trail, then pump (throttled).
        """
        try:
            f = self._fields
            if step is not None:
                f["step"] = str(step)
            if chunk is not None:
                f["chunk"] = int(chunk)
            if iteration is not None:
                f["iteration"] = int(iteration)
            if budget is not None:
                f["budget"] = int(budget)
            if wall_seconds is not None and iters:
                ms = 1000.0 * float(wall_seconds) / max(int(iters), 1)
                prev = f.get("ms_per_iter_ewma")
                f["ms_per_iter_ewma"] = ms if prev is None else (
                    _EWMA_ALPHA * ms + (1.0 - _EWMA_ALPHA) * prev)
            if f.get("budget") and f.get("iteration") is not None \
                    and f.get("ms_per_iter_ewma"):
                remaining = max(int(f["budget"]) - int(f["iteration"]), 0)
                f["eta_seconds"] = round(
                    remaining * float(f["ms_per_iter_ewma"]) / 1000.0, 3)
            if action is not None or verdict is not None:
                self._trail.append(
                    f"it{f.get('iteration')}:"
                    f"{action or '?'}/{verdict or '?'}")
            self._last_iteration = f.get("iteration")
            self.pump()
        except Exception as exc:  # noqa: BLE001 — rides inside the
            # chunk loop; progress accounting must never cost the fit
            logger.debug("heartbeat: chunk note failed: %s", exc)

    def observe_event(self, event: str, payload: dict) -> None:
        """RunLog emit hook (pre-gating, so it fires on every rank):
        fault-ladder events update state and force an immediate write —
        a retry or mesh shrink is exactly what a watcher wants NOW."""
        if event not in _FAULT_EVENTS:
            return
        try:
            self._faults[event] = self._faults.get(event, 0) + 1
            self.pump(force=True)
        except Exception as exc:  # noqa: BLE001 — rides the emit seam
            logger.debug("heartbeat: event note failed: %s", exc)

    def close(self, state: str = "done", error=None) -> None:
        """Terminal write.  Call on normal completion or on Exception —
        NOT on BaseException (preemption must leave a stale heartbeat
        for the watcher's ladder to flag; see module docstring)."""
        self._fields["state"] = str(state)
        if error is not None:
            self._fields["error"] = str(error)[:500]
        self.pump(force=True)


# ---------------------------------------------------------------------------
# process-global seam (install/current + no-op module helpers)
# ---------------------------------------------------------------------------

_ACTIVE: Optional[RunHeartbeat] = None


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
