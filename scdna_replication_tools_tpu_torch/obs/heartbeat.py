"""Run-health heartbeats: the writer, the process-global seam and the
read side (port of ``obs/heartbeat.py``).

* :class:`HeartbeatFile` is the low-level writer: one JSON document per
  path, committed with ``utils.fileio.atomic_write_bytes`` (a reader
  never sees a torn file), stamped with a **monotonic sequence number**
  (``seq``) and a wall-clock ``written_unix``.  ``seq`` resumes from any
  prior document at the path, so a restarted process never appears to
  move backwards;
* :class:`RunHeartbeat` is the per-process fit writer: it publishes
  ``health/host_<rank>.json`` with step/chunk/iteration progress, a
  ms/iter EWMA and the ETA it implies, the controller verdict-trail
  tail, device memory and fault-ladder counters sampled from the
  installed metrics registry, the cost meter's live ``goodput`` and
  ``waste_frac`` (``obs/meter.py`` notes them on every cost record) and
  the last closed span (``spans.last_closed_span()``, the mid-fit
  progress needle).  Writes are throttled to the configured interval;
  fault-ladder events force an immediate write;
* a process-global :func:`install`/:func:`current` seam plus module-level
  no-op helpers (:func:`note_chunk`, :func:`note_phase`,
  :func:`observe_event`), so the chunk loop and the run log's emit seam
  need one call each and heartbeat-off runs cost one global read;
* the read side -- :func:`read_heartbeat`, :func:`scan_health`,
  :func:`freshness`, :func:`aggregate_health` -- turns a ``health/``
  directory into one summary: per-host freshness ladder (fresh ->
  lagging -> stale -> presumed_lost, thresholds from each writer's own
  declared interval), straggler spread within the modal step, desync,
  missing ranks and the worst-case ETA; ``obs/alerts.py`` evaluates its
  rules over that summary.

``resolve_dir('auto', checkpoint_dir)`` places ``health/`` inside the
checkpoint directory, so a run with ``checkpoint_dir`` writes a live
heartbeat at the default config.  The documents are the JAX package's,
field for field, so either package's read side reads either package's
files.

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
import re
import time
from typing import Dict, List, Optional

from scdna_replication_tools_tpu_torch.obs import metrics as metrics_mod
from scdna_replication_tools_tpu_torch.obs import spans as spans_mod
from scdna_replication_tools_tpu_torch.utils.fileio import atomic_write_bytes

logger = logging.getLogger("scdna_replication_tools_tpu_torch")

HEARTBEAT_KIND = "pert_heartbeat"
HEARTBEAT_VERSION = 1

#: terminal states -- a document in one of these is "final", exempt from
#: the staleness ladder (a finished run's heartbeat never goes stale).
#: "stopped" is the serve worker's terminal state (same primitive).
TERMINAL_STATES = frozenset({"done", "error", "stopped"})

#: freshness ladder thresholds, in multiples of the writer's own
#: declared ``interval_seconds`` (each writer stamps its cadence into
#: the document, so the reader derives thresholds with no config)
FRESHNESS_LADDER = (("fresh", 3.0), ("lagging", 10.0), ("stale", 30.0))
FRESHNESS_ORDER = ("final", "fresh", "lagging", "stale", "presumed_lost")

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

#: heartbeat document fields the alert grammar may reference (kept in
#: one place so ``obs/alerts.py`` can validate rules at load time)
HEARTBEAT_FIELDS = frozenset({
    "seq", "written_unix", "pid", "process_index", "process_count",
    "run_name", "config_digest", "interval_seconds", "state", "phase",
    "step", "chunk", "iteration", "budget", "ms_per_iter_ewma",
    "eta_seconds", "trail", "last_span", "metrics", "faults", "error",
    "goodput", "waste_frac",
})

#: aggregate fields (``aggregate_health`` output) the alert grammar may
#: reference
AGGREGATE_FIELDS = frozenset({
    "hosts_seen", "process_count", "missing_ranks", "max_lag_seconds",
    "worst_freshness", "desync", "straggler_spread_chunks",
    "straggler_spread_iters", "eta_seconds", "states",
})

_HOST_FILE_RE = re.compile(r"^host_(\d+)\.json$")
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
            # live efficiency (obs/meter.py books them on every cost
            # record): effective cell-iters per billed device-second
            # and the billed fraction lost to named waste
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
            "last_span": spans_mod.last_closed_span(),
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


# ---------------------------------------------------------------------------
# read side: freshness ladder + multi-host aggregation
# ---------------------------------------------------------------------------

def read_heartbeat(path) -> Optional[dict]:
    """One heartbeat document, or None when absent, torn or not a JSON
    object (the atomic write makes torn reads impossible from the shared
    writer, but the reader stays defensive against foreign files)."""
    try:
        doc = json.loads(pathlib.Path(path).read_text())
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict):
        return None
    return doc


def freshness(doc: dict, now: Optional[float] = None) -> str:
    """Freshness class of one heartbeat document.

    Terminal states are "final" (a finished run never goes stale).
    Otherwise the age of ``written_unix`` is laddered against the
    writer's own declared cadence: fresh <= 3x interval, lagging <= 10x,
    stale <= 30x, beyond that **presumed_lost** -- the pre-deadlock
    hostloss flag.
    """
    if doc.get("state") in TERMINAL_STATES:
        return "final"
    now = time.time() if now is None else now
    interval = max(float(doc.get("interval_seconds") or 15.0), 0.05)
    age = max(now - float(doc.get("written_unix") or 0.0), 0.0)
    for level, mult in FRESHNESS_LADDER:
        if age <= mult * interval:
            return level
    return "presumed_lost"


def scan_health(health_dir) -> List[dict]:
    """All ``host_<rank>.json`` docs under ``health_dir``, as
    ``{"rank", "path", "doc"}`` rows sorted by rank.  Unreadable files
    are skipped (a torn foreign file must not break the reader)."""
    root = pathlib.Path(health_dir)
    rows = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return rows
    for name in names:
        m = _HOST_FILE_RE.match(name)
        if not m:
            continue
        doc = read_heartbeat(root / name)
        if doc is None:
            continue
        rows.append({"rank": int(m.group(1)), "path": str(root / name),
                     "doc": doc})
    rows.sort(key=lambda r: r["rank"])
    return rows


def _spread(values: List[int]) -> Optional[int]:
    vals = [int(v) for v in values if v is not None]
    return (max(vals) - min(vals)) if len(vals) >= 2 else (
        0 if vals else None)


def aggregate_health(health_dir, now: Optional[float] = None) -> dict:
    """One mission-control summary of a ``health/`` directory.

    Returns hosts (each with ``age_seconds``/``freshness`` annotated),
    missing ranks against the declared ``process_count``, the straggler
    spread in chunks and iterations (among RUNNING hosts in the modal
    step -- chunk counters do not compare across steps), desync (running
    hosts reporting different steps), the worst freshness level, the
    max heartbeat lag and the worst-case ETA.
    """
    now = time.time() if now is None else now
    rows = scan_health(health_dir)
    hosts = []
    for r in rows:
        doc = r["doc"]
        level = freshness(doc, now)
        hosts.append({
            "rank": r["rank"], "path": r["path"], "doc": doc,
            "seq": doc.get("seq"),
            "age_seconds": round(
                max(now - float(doc.get("written_unix") or 0.0), 0.0), 3),
            "freshness": level,
        })
    declared = max(
        [int(h["doc"].get("process_count") or 1) for h in hosts],
        default=0)
    seen = {h["rank"] for h in hosts}
    missing = sorted(set(range(declared)) - seen)
    running = [h for h in hosts
               if h["doc"].get("state") not in TERMINAL_STATES]
    steps = sorted({str(h["doc"].get("step"))
                    for h in running if h["doc"].get("step") is not None})
    desync = len(steps) > 1
    by_step: Dict[str, List[dict]] = {}
    for h in running:
        if h["doc"].get("step") is not None:
            by_step.setdefault(str(h["doc"]["step"]), []).append(h)
    modal = max(by_step.values(), key=len) if by_step else []
    spread_chunks = _spread([h["doc"].get("chunk") for h in modal])
    spread_iters = _spread([h["doc"].get("iteration") for h in modal])
    etas = [float(h["doc"]["eta_seconds"]) for h in running
            if h["doc"].get("eta_seconds") is not None]
    non_final = [h for h in hosts if h["freshness"] != "final"]
    worst = max((h["freshness"] for h in hosts),
                key=FRESHNESS_ORDER.index, default=None)
    return {
        "hosts": hosts,
        "hosts_seen": len(hosts),
        "process_count": declared,
        "missing_ranks": missing,
        "max_lag_seconds": round(
            max((h["age_seconds"] for h in non_final), default=0.0), 3),
        "worst_freshness": worst,
        "desync": desync,
        "steps": steps,
        "straggler_spread_chunks": spread_chunks,
        "straggler_spread_iters": spread_iters,
        "eta_seconds": max(etas, default=None),
        "states": dict(sorted(collections.Counter(
            str(h["doc"].get("state")) for h in hosts).items())),
    }
