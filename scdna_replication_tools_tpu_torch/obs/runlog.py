"""JSONL run log: one structured event stream per pipeline run (port of
``obs/runlog.py``, schema version 9).

* one run = one JSONL file; every line is one event dict carrying
  ``event`` (type), ``seq`` (the line index) and ``t`` (seconds since
  ``run_start``), flushed as written so a killed run leaves a readable
  prefix;
* the event vocabulary and per-event required fields are pinned by the
  port's copy of ``runlog_schema.json`` (see :mod:`obs.schema`), so
  ``tools/pert_report.py`` renders a port log as it renders a JAX one;
* ``run_end`` is GUARANTEED by :meth:`RunLog.session`: on an exception
  it records ``status='error'`` with the exception's type and message
  before re-raising;
* emission never raises into the pipeline: a failing write disables the
  log with one warning, and the fit goes on;
* :func:`current` exposes the innermost open log to layers that are not
  plumbed explicitly (the runner and the kernel loader's ``compile``
  events reach it that way).

A sharded run's log is written by rank 0 alone (JAX's process-0 gate:
:meth:`RunLog.create` gives the other ranks a disabled log), and
``run_start`` takes its topology from ``torch.cuda`` and the process
group.  A span tracer riding the log (``obs/spans.
attach_tracer``) adds the run's root span, ``trace_id`` on ``run_start``
and the ``span`` envelope on every other event; a cost ledger riding it
(``meter_ledger``) adds ``run_end``'s ``meter`` section; ``add_context``
folds run metadata (a serving request's ``request_id`` and
``slab_width``) into ``run_start``.  The :func:`current` stack is
thread-local (the serving worker runs one request per thread); the
cross-thread handoff (:func:`stack_snapshot`/:func:`install_stack`)
serves the watchdog's worker thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import itertools
import json
import os
import pathlib
import threading
import time
from typing import Optional

from scdna_replication_tools_tpu_torch.obs import heartbeat as _heartbeat
from scdna_replication_tools_tpu_torch.obs import metrics as _metrics
from scdna_replication_tools_tpu_torch.utils import profiling
from scdna_replication_tools_tpu_torch.utils.profiling import logger

SCHEMA_VERSION = 9


def _json_safe(value):
    """Best-effort coercion of numpy scalars/arrays and torch tensors
    for json (``tolist`` copies a CUDA tensor to the host, so no event
    is emitted inside a fit chunk)."""
    if hasattr(value, "tolist"):          # np.ndarray / np scalar / tensor
        return value.tolist()
    if hasattr(value, "item"):
        return value.item()
    return str(value)


def telemetry_disabled(value) -> bool:
    """True when a ``telemetry_path``-style value spells 'no telemetry'."""
    return value in (None, "", "none", "off")


# an 'auto' directory would accumulate one file per run forever; keep the
# newest N (explicit paths and directories are never pruned)
AUTO_RETAIN_RUNS = 50

# where 'auto' run logs land: the repository's .pert_runs/
AUTO_ROOT = pathlib.Path(__file__).resolve().parents[2] / ".pert_runs"


def _prune_auto_dir(root: pathlib.Path) -> None:
    """Best-effort retention cap for the 'auto' run-log directory."""
    try:
        logs = sorted(root.glob("*.jsonl"), key=lambda p: p.stat().st_mtime)
        for stale in logs[:max(0, len(logs) - (AUTO_RETAIN_RUNS - 1))]:
            stale.unlink()
    except OSError:  # concurrent runs may race the stat/unlink
        pass


def resolve_telemetry_path(value, run_name: str = "pert") -> Optional[str]:
    """Resolve ``PertConfig.telemetry_path`` to a JSONL file path or None.

    ``'auto'`` (the default) creates a timestamped file under the
    repository's ``.pert_runs/`` (:data:`AUTO_ROOT`; a per-user tmp
    directory when that is unwritable), pruned to the newest
    :data:`AUTO_RETAIN_RUNS`.  An explicit DIRECTORY gets a generated
    filename inside it; an explicit file path is used verbatim.
    ``None``/``''``/``'none'``/``'off'`` disables telemetry.  Never
    raises: an unusable location resolves to None with one warning.
    """
    if telemetry_disabled(value):
        return None
    stamp = time.strftime("%Y%m%d_%H%M%S")
    # pid and a per-process counter keep two runs of one second apart
    fname = (f"{run_name}_{stamp}_{os.getpid()}"
             f"_{next(_RUN_COUNTER)}.jsonl")
    if value == "auto":
        root = AUTO_ROOT
        if not profiling.probe_writable_dir(root):
            import tempfile

            root = pathlib.Path(tempfile.gettempdir()) \
                / f"scdna_rt_torch_runs_{profiling.stable_user()}"
            if not profiling.probe_writable_dir(root):
                logger.warning("telemetry disabled: no writable run-log "
                               "directory (%s)", root)
                return None
        _prune_auto_dir(root)
        return str(root / fname)
    path = pathlib.Path(value)
    if path.is_dir() or str(value).endswith(os.sep):
        if not profiling.probe_writable_dir(path):
            logger.warning("telemetry disabled: run-log directory %s is "
                           "not writable", path)
            return None
        return str(path / fname)
    return str(path)


_RUN_COUNTER = itertools.count()


def _config_digest(config) -> Optional[str]:
    """Short content hash of the config for run comparison, without
    ``config.NON_HASH_FIELDS`` (where the log, the textfile and the
    heartbeats land).  A port ``PertConfig`` hashes the JAX package's
    field set: its own fields plus ``config.UNPORTED_FIELDS`` at their
    JAX defaults, so one setting gives one hash in both packages."""
    from scdna_replication_tools_tpu_torch.config import (
        NON_HASH_FIELDS,
        UNPORTED_FIELDS,
    )

    try:
        if dataclasses.is_dataclass(config):
            config = {**{k: v for k, (v, _) in UNPORTED_FIELDS.items()},
                      **dataclasses.asdict(config)}
        if isinstance(config, dict):
            config = {k: v for k, v in config.items()
                      if k not in NON_HASH_FIELDS}
        blob = json.dumps(config, sort_keys=True, default=_json_safe)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]
    except (TypeError, ValueError):
        return None


def _device_topology(device=None) -> dict:
    """Device topology for ``run_start``: the run's CUDA device (the
    card when ``device`` is None and one is present) or the CPU, with
    the rank and the number of ranks (0 of 1 without a process group;
    ``num_devices`` counts every rank's)."""
    try:
        import torch

        dev = torch.device(device) if device is not None else (
            torch.device("cuda") if torch.cuda.is_available()
            else torch.device("cpu"))
        if dev.type == "cuda":
            topo = {"platform": "gpu",
                    "device_kind": torch.cuda.get_device_name(dev),
                    "num_devices": torch.cuda.device_count()}
        else:
            topo = {"platform": "cpu", "device_kind": "cpu",
                    "num_devices": 1}
        from scdna_replication_tools_tpu_torch.parallel.distributed import (
            process_rank_and_count,
        )

        rank, world = process_rank_and_count()
        topo.update(local_devices=topo["num_devices"], process_index=rank,
                    process_count=world,
                    num_devices=topo["num_devices"] * world)
        return topo
    except Exception as exc:  # noqa: BLE001 — run_start then lacks the
        # topology fields; the log itself must not fail over a probe
        logger.debug("run log: device topology unavailable (%s)", exc)
        return {}


class RunLog:
    """Append-only JSONL event log for one run (see module docstring).

    A disabled instance (``path=None``) accepts every call as a no-op,
    so instrumented code never checks for enablement.
    """

    def __init__(self, path: Optional[str]):
        self.path = str(path) if path else None
        self.enabled = path is not None
        self._fh = None
        self._seq = 0
        self._t0: Optional[float] = None
        self._open = False
        # the metrics registry that owns this log's final snapshot (set by
        # the facade that created both): close_run emits the guaranteed
        # run_end metrics_snapshot from it, and every emit feeds it
        self.metrics_registry = None
        # metadata folded into run_start (add_context before the open)
        self._pending_context: dict = {}
        # the cost ledger riding this log (obs/meter.CostLedger, set by
        # the runner or worker that owns the run): booking sites resolve
        # it through meter.ledger_of(runlog.current()), and close_run
        # lands its summary as run_end's `meter` section; None = unmetered
        self.meter_ledger = None
        # the span tracer riding this log (obs/spans.attach_tracer); None
        # keeps the stream free of span material (no envelope, no
        # span_end, no trace_id)
        self.tracer = None
        # the root 'run' span the session opens when a tracer rides the
        # log, closed just before run_end
        self._root_span = None
        # serialises the seq counter and the file write
        self._emit_lock = threading.Lock()

    @classmethod
    def create(cls, telemetry_path, run_name: str = "pert") -> "RunLog":
        """RunLog from a ``PertConfig.telemetry_path``-style value.
        Never raises: a resolution failure degrades to a disabled log
        with a warning."""
        try:
            path = resolve_telemetry_path(telemetry_path, run_name=run_name)
        except Exception as exc:  # noqa: BLE001 — observability must not
            # abort the run it observes
            logger.warning("telemetry disabled: %s", exc)
            path = None
        from scdna_replication_tools_tpu_torch.parallel.distributed import (
            process_rank_and_count,
        )

        if process_rank_and_count()[0] != 0:
            # a sharded run's log is rank 0's, as JAX's is process 0's
            return cls(None)
        return cls(path)

    # -- lifecycle --------------------------------------------------------

    def add_context(self, **fields) -> None:
        """Attach run metadata: folded into ``run_start`` when the run is
        not yet open, emitted as a ``note`` event afterwards."""
        if not self.enabled:
            return
        if self._open:
            self.emit("note", **fields)
        else:
            self._pending_context.update(fields)

    def open_run(self, config=None, run_name: str = "pert",
                 device=None) -> None:
        if not self.enabled or self._open:
            return
        self._t0 = time.perf_counter()
        self._open = True
        # a second run on the same instance replaces the file ("w" open
        # below), so seq restarts with it
        self._seq = 0
        payload = {
            "schema_version": SCHEMA_VERSION,
            "run_name": run_name,
            "pid": os.getpid(),
            "started_unix": round(time.time(), 3),
            **_device_topology(device),
            **self._pending_context,
        }
        import numpy

        payload["numpy_version"] = numpy.__version__
        if config is not None:
            digest = _config_digest(config)
            if digest:
                payload["config_hash"] = digest
            if dataclasses.is_dataclass(config):
                payload["config"] = dataclasses.asdict(config)
            elif isinstance(config, dict):
                payload["config"] = config
        if self.tracer is not None:
            # the key that stitches the logs of one trace (a serving
            # request's worker and request logs)
            payload.setdefault("trace_id", self.tracer.trace_id)
        self._pending_context = {}
        self.emit("run_start", **payload)
        if self.tracer is not None:
            # the run's root span: every phase and chunk span parents
            # under it (or under the trace_parent the tracer carries)
            self._root_span = self.tracer.begin("run", run_name=run_name)

    def close_run(self, status: str = "ok", error=None,
                  phases: Optional[dict] = None) -> None:
        # gate on _open alone: a log disabled MID-run (write failure)
        # still needs its session state reset and its handle closed
        if not self._open:
            return
        if self.tracer is not None and self._root_span is not None:
            # the run span (and any still open under it) closes first:
            # its span_end lands inside the stream, before run_end
            self.tracer.end(self._root_span, status=status)
            self._root_span = None
        # the guaranteed final metrics snapshot, inside events_emitted
        if self.metrics_registry is not None:
            self.metrics_registry.emit_snapshot(self, "run_end")
        payload: dict = {"status": status,
                         "wall_seconds": round(self._elapsed(), 4),
                         "events_emitted": self._seq}
        if error is not None:
            payload["error"] = {"type": type(error).__name__,
                                "message": str(error)[:2000]}
        if phases:
            payload["phases"] = dict(phases)
        if self.meter_ledger is not None:
            try:
                payload["meter"] = self.meter_ledger.summary()
            except Exception:  # noqa: BLE001 — a torn ledger must not
                # cost the run_end record; the missing section shows it
                pass
        self.emit("run_end", **payload)
        self._open = False
        if self._fh is not None:
            try:
                self._fh.close()
            except OSError:
                pass
            self._fh = None

    @contextlib.contextmanager
    def session(self, config=None, timer=None, run_name: str = "pert",
                device=None):
        """Open the run, register as :func:`current`, stream ``timer``'s
        phases, and guarantee ``run_end``, even on exception.

        Re-entrant: an already-open log yields without a second
        ``run_start``/``run_end`` pair (the outermost owner closes)."""
        if not self.enabled or self._open:
            yield self
            return
        t0 = time.perf_counter()
        self.open_run(config=config, run_name=run_name, device=device)
        _stack().append(self)
        prev_sink = None
        if timer is not None:
            prev_sink = getattr(timer, "on_add", None)

            # CHAIN, don't replace: the metrics registry's sink stays
            # attached for the run's duration
            def _chained_sink(name, seconds, _prev=prev_sink):
                self._phase_sink(name, seconds)
                if _prev is not None:
                    _prev(name, seconds)

            timer.on_add = _chained_sink
            # opening the run (config digest, device query, the
            # run_start write) is accounted wall
            timer.add("telemetry/open", time.perf_counter() - t0)
        try:
            yield self
        except BaseException as exc:
            self.close_run(status="error", error=exc,
                           phases=timer.report() if timer is not None
                           else None)
            raise
        else:
            self.close_run(status="ok",
                           phases=timer.report() if timer is not None
                           else None)
        finally:
            if timer is not None:
                timer.on_add = prev_sink
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()

    # -- emission ---------------------------------------------------------

    def _elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.perf_counter() - self._t0

    def _phase_sink(self, name: str, seconds: float) -> None:
        self.emit("phase", name=name, seconds=round(float(seconds), 6))

    def emit(self, event: str, **payload) -> None:
        """Append one event line; never raises (disables on I/O error).

        Events outside an open run are DROPPED (no run_start-less orphan
        file, and no emit after ``close_run`` reopens the finished
        file).  The metrics and heartbeat seams see every emit BEFORE
        that gating, so counters accumulate with the JSONL off."""
        registry = self.metrics_registry if self.metrics_registry \
            is not None else _metrics.current()
        registry.record_event(event, payload)
        _heartbeat.observe_event(event, payload)
        with self._emit_lock:
            if not self.enabled or not self._open:
                return
            record = {"event": event, "seq": self._seq,
                      "t": round(self._elapsed(), 4), **payload}
            # the span envelope: every event emitted while a span is open
            # carries the causal context it happened under (only with a
            # tracer attached, and not on span_end, which carries its own)
            if self.tracer is not None and event != "span_end" \
                    and "span" not in record:
                cur = self.tracer.current()
                if cur is not None:
                    record["span"] = {"trace_id": cur.trace_id,
                                      "span_id": cur.span_id,
                                      "parent_id": cur.parent_id}
            self._seq += 1
            try:
                if self._fh is None:
                    os.makedirs(
                        os.path.dirname(os.path.abspath(self.path)),
                        exist_ok=True)
                    # "w", not "a": one run = one file (seq is the line
                    # index)
                    self._fh = open(self.path, "w")
                self._fh.write(json.dumps(record, default=_json_safe)
                               + "\n")
                self._fh.flush()
            except (OSError, TypeError, ValueError) as exc:
                self.enabled = False
                logger.warning("run log disabled: cannot write %s (%s)",
                               self.path, exc)
                if self._fh is not None:
                    try:
                        self._fh.close()
                    except OSError:
                        pass
                    self._fh = None


_NULL = RunLog(None)

# the current() seam is thread-local: a fresh thread starts with an
# empty stack
_TLS = threading.local()


def _stack() -> list:
    stack = getattr(_TLS, "stack", None)
    if stack is None:
        stack = _TLS.stack = []
    return stack


def stack_snapshot() -> tuple:
    """The calling thread's RunLog stack, for a handoff to a worker
    thread (``utils.faults.run_with_deadline``)."""
    return tuple(_stack())


def install_stack(snapshot) -> None:
    """Adopt another thread's stack (see :func:`stack_snapshot`)."""
    _TLS.stack = list(snapshot)


def active() -> Optional[RunLog]:
    """The innermost RunLog whose session is open on this thread (also
    when a failed write has since disabled it), or None."""
    stack = _stack()
    return stack[-1] if stack else None


def current() -> RunLog:
    """The innermost RunLog open on this thread, or a disabled no-op
    instance."""
    return active() or _NULL
