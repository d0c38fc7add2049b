"""Causal span tracing: request/fit timelines over the RunLog stream.

Port of ``obs/spans.py``, copied whole but for :func:`_live_process_index`,
which reads ``torch.distributed`` where the JAX module reads
``jax.process_index()``.  The chunked fit loop named below is the port's
``infer/svi._fit_map_controlled``.

The observability stack measures *quantities* (RunLog events, the typed
metrics registry, the fleet index) but not *causality*: a pertserve
request's p99 cannot be decomposed into queue-wait vs admission vs
compile vs fit-chunks vs stream-back, and a multi-host fit has no way
to stitch per-process timelines into one picture.  This module is the
missing seam — a deterministic, stdlib-only span tracer wired through
the EXISTING instrumentation seams rather than sprinkled:

* a span is (``trace_id``, ``span_id``, ``parent_id``, monotonic
  start/end, typed attributes, ``process_index``).  Span ids are a
  per-tracer counter namespaced by the tracer's place in the trace
  (handoff tracers prefix their parent span id, non-zero processes
  their rank — several tracers legitimately share one trace id across
  stitched logs, and bare counters would collide), and the trace id is
  derived from stable identity (request id, or run name + config
  digest), so the span TREE — names, ids, parentage, attributes — is
  byte-identical across same-seed reruns; only the wall-clock fields
  (``start_unix``, ``duration_seconds``) are unstable.  That keeps the byte-stability
  contracts of the metrics snapshots intact;
* spans ride the RunLog (schema v8): every closed span lands as one
  ``span_end`` event, and every OTHER event emitted while a span is
  open carries a ``span`` envelope (``trace_id``/``span_id``/
  ``parent_id``) — but ONLY when a tracer is attached, so tracing-off
  runs emit logs indistinguishable from pre-v8 ones;
* ``attach_phase_sink`` turns every :class:`utils.profiling.PhaseTimer`
  accumulation into a completed span through the existing ``on_add``
  chain (the same pattern as the metrics sink) — no per-phase
  instrumentation anywhere;
* the chunked fit loop (``infer/svi.py::_chunk_loop``) records one
  ``fit/chunk`` span per dispatched chunk, carrying the controller's
  verdict for the pass;
* cross-process: every span stamps ``process_index``, and tickets
  carry the trace id across the serve spool, so ``tools/pert_trace``
  can merge per-process RunLogs into one Perfetto timeline.

Literal span names are pinned by the checked-in
``obs/span_registry.json`` (pertlint PL014 cross-checks call sites);
phase-derived spans use the phase name itself with ``kind='phase'``
and are exempt (the phase vocabulary is owned by the phase ledger).

API shape: ``tracer.span(name)`` is a context manager and MUST be used
as one (PL014's unclosed-span check enforces it); code that needs
manual lifetime management (the worker's per-request root span, the
session's run span) uses the explicit ``begin()``/``end()`` pair.
``record_span`` records an already-completed interval from external
timestamps — the queue-wait span is measured from the ticket's
pending-file mtime to the claim, an interval no context manager could
have wrapped.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import json
import pathlib
import time
from typing import Callable, List, Optional

_REGISTRY_PATH = pathlib.Path(__file__).parent / "span_registry.json"


@functools.lru_cache(maxsize=1)
def load_registry() -> dict:
    """The checked-in span-name catalogue; {} when unreadable (the
    tracer then records every name unchecked — lint is the gate, a
    missing registry must never crash a run)."""
    try:
        return json.loads(_REGISTRY_PATH.read_text())
    except (OSError, ValueError):
        return {}


def registry_span_names() -> frozenset:
    """Registered literal span names (see ``span_registry.json``)."""
    return frozenset(load_registry().get("spans", {}))


def derive_trace_id(seed_text: str) -> str:
    """Deterministic 16-hex trace id from stable identity text.

    Same-seed reruns of the same workload derive the SAME trace id —
    part of the span-tree determinism contract (the unstable fields are
    only the wall-clock ones)."""
    return hashlib.sha256(str(seed_text).encode()).hexdigest()[:16]


def parse_trace_parent(value) -> tuple:
    """``'<trace_id>:<span_id>'`` -> (trace_id, parent_span_id).

    The cross-process handoff format (``PertConfig.trace_parent``): the
    serving worker stamps its request span here so the per-request
    scRT run's whole span tree stitches under it.  Malformed values
    degrade to (None, None) — tracing must never abort the run it
    observes."""
    if not value or not isinstance(value, str) or ":" not in value:
        return None, None
    trace_id, _, parent_id = value.partition(":")
    return (trace_id or None), (parent_id or None)


@dataclasses.dataclass
class Span:
    """One open (or completed) span.  ``attrs`` may be extended while
    the span is open; everything except the two wall-clock fields is
    deterministic content."""

    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str]
    start_unix: float
    start_perf: float
    attrs: dict = dataclasses.field(default_factory=dict)
    process_index: int = 0


class SpanTracer:
    """Deterministic span tracer for one trace (see module docstring).

    ``sink`` (callable of one payload dict) observes every span CLOSE —
    :func:`attach_tracer` points it at a RunLog so each completed span
    lands as a ``span_end`` event.  The open-span stack is readable at
    any time (:meth:`stack`) — the serving worker's ``status.json``
    heartbeat surfaces it as "what is the worker doing right now".
    """

    def __init__(self, trace_id: Optional[str] = None,
                 process_index: Optional[int] = None,
                 sink: Optional[Callable] = None):
        self.trace_id = trace_id or derive_trace_id("pert")
        self.sink = sink
        self._stack: List[Span] = []
        self._next_id = 0
        if process_index is None:
            process_index = _live_process_index()
        self.process_index = int(process_index)
        # the parent a ROOT span attaches under: set from a
        # cross-process trace_parent handoff so a request's run-level
        # tree stitches under the worker's request span
        self.root_parent_id: Optional[str] = None

    @classmethod
    def from_trace_parent(cls, trace_parent: str,
                          fallback_seed: str = "pert") -> "SpanTracer":
        """Tracer continuing a cross-process trace (or a fresh one
        derived from ``fallback_seed`` when the handoff is absent)."""
        trace_id, parent_id = parse_trace_parent(trace_parent)
        tracer = cls(trace_id=trace_id or derive_trace_id(fallback_seed))
        tracer.root_parent_id = parent_id
        return tracer

    # -- identity ---------------------------------------------------------

    def _new_span_id(self) -> str:
        # a per-tracer counter, not randomness/time: two same-seed runs
        # must produce identical span ids (the determinism contract).
        # The counter is NAMESPACED by the tracer's place in the trace:
        # a handoff tracer (trace_parent) prefixes its parent span id
        # and a non-zero process prefixes its rank — several tracers
        # share one trace id across the stitched logs (the worker's
        # request tracer + the request run's own; every host of a
        # multi-process run), and bare counters restarting at 1 in
        # each would collide, making parent_id→span_id joins cyclic
        # (a 'run' span that is its own parent).  Both namespace
        # inputs are themselves deterministic.
        self._next_id += 1
        prefix = ""
        if self.root_parent_id:
            prefix = f"{self.root_parent_id}."
        if self.process_index:
            prefix += f"p{self.process_index}."
        return f"{prefix}{self._next_id:08x}"

    def trace_parent(self, span: Optional[Span] = None) -> Optional[str]:
        """The ``'<trace_id>:<span_id>'`` handoff token of ``span`` (or
        the innermost open span); None when nothing is open."""
        span = span if span is not None else self.current()
        if span is None:
            return None
        return f"{self.trace_id}:{span.span_id}"

    # -- lifecycle --------------------------------------------------------

    def current(self) -> Optional[Span]:
        return self._stack[-1] if self._stack else None

    def stack(self) -> List[dict]:
        """The open-span stack, outermost first, as JSON-ready dicts —
        the worker status surface's "what is in flight" payload.
        Snapshot-copied first: the status heartbeat thread reads this
        while the worker thread opens/closes spans."""
        now = time.time()
        return [{
            "name": s.name,
            "span_id": s.span_id,
            "started_unix": round(s.start_unix, 3),
            "age_seconds": round(max(now - s.start_unix, 0.0), 3),
        } for s in tuple(self._stack)]

    def begin(self, name: str, **attrs) -> Span:
        """Open a span manually (caller MUST :meth:`end` it).  Prefer
        the :meth:`span` context manager wherever lexical scoping fits —
        PL014's unclosed-span check only trusts ``with``."""
        parent = self.current()
        span = Span(
            name=str(name), trace_id=self.trace_id,
            span_id=self._new_span_id(),
            parent_id=parent.span_id if parent is not None
            else self.root_parent_id,
            start_unix=time.time(), start_perf=time.perf_counter(),
            attrs=dict(attrs), process_index=self.process_index)
        self._stack.append(span)
        return span

    def end(self, span: Span, **attrs) -> None:
        """Close a :meth:`begin`-opened span (idempotence: closing a
        span not on the stack is a no-op — a failed request path may
        race its own cleanup).  Inner spans left open are closed with
        it, innermost first, so the stream can never interleave
        mis-nested span_end events."""
        if span not in self._stack:
            return
        while self._stack:
            top = self._stack.pop()
            if top is span:
                top.attrs.update(attrs)
            self._finish(top, time.time(),
                         time.perf_counter() - top.start_perf)
            if top is span:
                return

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """Context-managed span — the normal call shape (PL014 checks
        both the literal name and the ``with`` usage)."""
        opened = self.begin(name, **attrs)
        try:
            yield opened
        finally:
            self.end(opened)

    def record_span(self, name: str, start_unix: float, end_unix: float,
                    **attrs) -> None:
        """Record an already-completed interval from external
        timestamps (parented under the innermost open span).  The
        queue-wait span is the canonical case: its start is the
        ticket's pending-file mtime — a moment this process never
        executed through."""
        parent = self.current()
        span = Span(
            name=str(name), trace_id=self.trace_id,
            span_id=self._new_span_id(),
            parent_id=parent.span_id if parent is not None
            else self.root_parent_id,
            start_unix=float(start_unix), start_perf=0.0,
            attrs=dict(attrs), process_index=self.process_index)
        self._finish(span, float(end_unix),
                     max(float(end_unix) - float(start_unix), 0.0))

    # -- emission ---------------------------------------------------------

    def _finish(self, span: Span, end_unix: float,
                duration: float) -> None:
        # the process-wide progress note (see :func:`last_closed_span`):
        # plain reference assignment, so a reader thread (the serve
        # worker's status heartbeat) always sees a complete dict
        global _LAST_CLOSED
        _LAST_CLOSED = {"name": span.name, "trace_id": span.trace_id,
                        "end_unix": round(end_unix, 3)}
        if self.sink is None:
            return
        payload = {
            "name": span.name,
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            # the two UNSTABLE fields: everything else in this payload
            # is byte-identical across same-seed reruns
            "start_unix": round(span.start_unix, 6),
            "duration_seconds": round(max(duration, 0.0), 6),
            "process_index": span.process_index,
        }
        if span.attrs:
            payload["attrs"] = dict(span.attrs)
        try:
            self.sink(payload)
        except Exception:  # pertlint: disable=PL011 — the sink is the
            # RunLog emit path, which already never raises; any other
            # sink failing must not take down the traced code either
            # (the span is simply lost, like a dropped log line)
            pass


_LAST_CLOSED: Optional[dict] = None


def last_closed_span() -> Optional[dict]:
    """The most recently CLOSED span in this process — ``{"name",
    "trace_id", "end_unix"}`` — across every live tracer.

    This is the mid-fit progress signal the serve worker's status
    heartbeat surfaces: the worker-log tracer's OPEN stack reads just
    ``["request"]`` for the whole pipeline (the request run's phase and
    chunk spans live on the request log's own tracer, and spans are
    recorded at close), but fit chunks close every ``diag_every``
    iterations — so "last closed span + its age" answers "what is it
    doing right now, and how long since anything finished" even while
    the worker thread is deep inside a fit.  Deliberately
    process-global (like :func:`obs.runlog.current`): the status
    reader has no handle to the request run's tracer."""
    note = _LAST_CLOSED
    return dict(note) if note else None


def _live_process_index() -> int:
    """This process's rank when ``torch.distributed`` is initialised,
    else 0: the tracer must not set up a process group as a side
    effect, so only one that is already up is consulted."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
        return 0
    except Exception:  # noqa: BLE001 — no process group means
        # single-process: 0 IS the answer
        return 0


def attach_tracer(run_log, tracer: Optional[SpanTracer]) -> None:
    """Wire a tracer onto a RunLog (or detach, with None): closed spans
    emit as ``span_end`` events on THAT log, and every other event the
    log emits while a span is open carries the ``span`` envelope (see
    ``obs/runlog.py``).  The log also learns the trace id so its
    ``run_start`` can carry it for cross-log stitching."""
    if tracer is None:
        run_log.tracer = None
        return
    tracer.sink = functools.partial(_emit_span_end, run_log)
    run_log.tracer = tracer


def attach_sink(run_log, tracer: SpanTracer) -> None:
    """Wire ONLY the tracer's span_end sink onto a RunLog, without
    occupying the log's single ``tracer`` slot: the batched serving
    worker runs K concurrent request tracers against its one worker
    log — their closed spans all land there as ``span_end`` events,
    but no one tracer may own the log-level span envelope (so worker
    events in batched mode carry no ``span`` envelope; documented in
    OBSERVABILITY.md "Serving")."""
    tracer.sink = functools.partial(_emit_span_end, run_log)


def _emit_span_end(run_log, payload: dict) -> None:
    run_log.emit("span_end", **payload)


def tracer_for_run(config, run_name: str = "pert") -> SpanTracer:
    """The runner/facade tracer factory: continue ``trace_parent``
    when the config carries one (a serve request stitching under the
    worker's request span), else derive a deterministic trace id from
    the run's stable identity (request id, or run name + config
    digest)."""
    from scdna_replication_tools_tpu_torch.obs import runlog as _runlog

    seed = getattr(config, "request_id", None)
    if not seed:
        seed = f"{run_name}:{_runlog._config_digest(config) or 'none'}"
    trace_parent = getattr(config, "trace_parent", None)
    if trace_parent:
        return SpanTracer.from_trace_parent(trace_parent,
                                            fallback_seed=seed)
    return SpanTracer(trace_id=derive_trace_id(seed))


def attach_phase_sink(timer, tracer: Optional[SpanTracer]) -> None:
    """Turn every PhaseTimer accumulation into a completed span through
    the existing ``on_add`` chain — the same chaining/rescoping
    discipline as ``obs.metrics.attach_phase_sink``: ONE span sink per
    timer, re-attaching re-scopes the tracer cell in place (stacking
    would double-emit every phase), and the sink forwards to whatever
    ``on_add`` was already installed.  Pass ``tracer=None`` to mute the
    sink without unchaining it.

    The span covers ``[now - seconds, now]`` with ``kind='phase'`` —
    ``on_add`` fires at phase exit, so the interval is exact for
    context-managed phases and a faithful as-if placement for direct
    ``add()`` accumulations (fit/trace/compile timings added at fit
    return)."""
    existing = getattr(timer, "_pert_span_sink_fn", None)
    if existing is not None:
        existing._pert_tracer_cell[0] = tracer
        return
    prev = getattr(timer, "on_add", None)
    cell = [tracer]

    def _sink(name, seconds):
        tr = cell[0]
        if tr is not None:
            now = time.time()
            tr.record_span(name, now - float(seconds), now, kind="phase")
        if prev is not None:
            prev(name, seconds)

    _sink._pert_span_sink = True
    _sink._pert_tracer_cell = cell
    timer._pert_span_sink_fn = _sink
    timer.on_add = _sink
