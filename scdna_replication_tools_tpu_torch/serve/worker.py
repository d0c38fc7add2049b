"""The pertserve worker daemon: a long-lived inference loop over a
file-queue spool.

Port of ``serve/worker.py`` with JAX's keywords and defaults, plus
``device`` (None = the GPU, raising when there is none; ``'cpu'`` for
tests), which every request's ``scRT`` receives.  The compiled-program
store (``infer/aotcache.py``) follows JAX's rule: ``'auto'`` is
``<spool>/exec_cache``, a path pins it, None/'none' runs without one.
The worker activates the store for its life, so every request's run
shares it: a request's solo fit chunks, the slab's packed chunks and
the request's decode and PPC slab passes replay CUDA graphs captured
once per program (a later same-shaped request with the same behavioural
config replays the earlier one's).
The kernel libraries and a record of each program persist in the
directory for the next worker, whose warm-up thread ranks them by this
worker's ``buckets_served`` ledger, reads the libraries and captures the
programs again ahead of traffic (``status.json``'s ``executable_cache``
block).  With ``max_batch`` K > 1 each request thread hands its fit
chunks to the slab coordinator, which advances concurrent same-shape
chunks in one launch per iteration through the block-axis kernels
(``infer/svi.dispatch_chunk_slab``), replaying the rung's ``slab{W}``
program.

The JAX module's description follows; where it speaks of programs and
compiles, the port's counterparts are its kernel libraries (built once,
cached under ``_build/``) and the per-thread dispatch of PyTorch ops.

One worker process holds everything a cold CLI run pays for on every
invocation — the Python/jax import, the in-process AOT program cache
(``infer/svi.py``) and the warm XLA compile cache — RESIDENT, and
drains queued requests through it.  Each request:

1. is **admitted**: input shapes are probed and the request is padded
   into the nearest shape bucket (``serve/buckets.py``); oversized
   requests are refused, not compiled ad hoc;
2. runs as one ordinary :class:`api.scRT` pipeline with per-request
   everything — RunLog (``results/<id>/run.jsonl``, stamped with the
   request id), metrics registry (the log-scoped seam keeps it from
   cross-feeding the worker's own registry), and durable-run
   checkpoint dir (``results/<id>/ckpt``) — so the whole
   fault-tolerance ladder (transient retry, OOM degrade, watchdog,
   NaN escalation) applies per request;
3. is **isolated**: an exception escaping one request fails THAT
   request's ticket/manifest and the worker moves on — the injected
   ``oom@step2/fit#1`` chaos case in tests/test_serve.py pins that a
   faulted request leaves a concurrently queued one bit-identical to
   its golden run;
4. streams results back: ``output.tsv``/``supp.tsv`` (+ the G1 pair
   when step 3 runs), ``cell_qc.tsv``, the request RunLog, and a
   terminal ticket.

The worker emits ``request_start``/``request_end`` events on its own
RunLog and feeds the worker gauges (``pert_serve_queue_depth``,
``pert_serve_requests_total``, ``pert_serve_bucket_pad_frac``,
``pert_serve_queue_wait_seconds``) through the same emit seam; its
Prometheus textfile (``--metrics-textfile``) is the scrape surface
for exactly this resident process.  SIGTERM/SIGINT request
a graceful drain: the in-flight request completes, pending tickets
stay queued for the next worker, and the worker log closes cleanly.

Two live surfaces ride on top (schema v8, OBSERVABILITY.md
"Tracing"):

* **causal spans** (default ON): each request is one trace — the
  ``request`` root span, the ``queue_wait`` spool crossing (ticket
  commit → claim), ``admission``, ``stream_back``, and, via the
  ``trace_parent`` handoff, the per-request run's entire span tree —
  exportable as one stitched Perfetto timeline with
  ``tools/pert_trace.py``;
* **status.json** in the spool root: an atomically heartbeat-written
  snapshot of the in-flight request + its open span stack, queue
  depth, the bucket-residency ledger and recent outcomes — what
  ``pert-serve status <spool>`` renders, the first way to ask a
  running worker "what are you doing right now and how long has it
  been stuck there".

**Continuous batching** (``max_batch`` K > 1): the worker runs up to K
requests as concurrent BLOCKS of one slab (serve/slab.py).  The claim
predicate steers same-bucket-rung tickets in (their shape hints map to
the rung the first live block pinned), so every block runs the SAME
compiled programs — one resident program set serves the whole slab,
and block dispatches interleave on the device.  A block that finishes
retires from the slab immediately (its decode/stream-back ran while
the others kept fitting) and its slot is refilled from the spool on
the next claim — continuous batching, not gang scheduling.  Each block
keeps per-request EVERYTHING via the thread-local observability seams
(RunLog stack, metrics registry, fault plan), so per-request fault
isolation is per-block isolation: an injected ``oom`` in one block
fails that ticket only.  Priority/SLO admission is ticket-borne
(``priority`` class + ``deadline_unix``, serve/queue.py).  Several
workers may share one spool — the rename-claim protocol already
arbitrates them — for multi-worker scale-out.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import itertools
import json
import os
import re
import signal
import threading
import time
from typing import Optional

import pandas as pd
import torch

from scdna_replication_tools_tpu_torch.device import resolve_device
from scdna_replication_tools_tpu_torch.infer import aotcache
from scdna_replication_tools_tpu_torch.obs import heartbeat as heartbeat_mod
from scdna_replication_tools_tpu_torch.obs import meter as meter_mod
from scdna_replication_tools_tpu_torch.obs import metrics as metrics_mod
from scdna_replication_tools_tpu_torch.obs import spans as spans_mod
from scdna_replication_tools_tpu_torch.obs.runlog import RunLog
from scdna_replication_tools_tpu_torch.obs.summary import summarize_run
from scdna_replication_tools_tpu_torch.serve.buckets import (
    BucketRefusal,
    BucketSet,
)
from scdna_replication_tools_tpu_torch.serve.queue import (
    RequestTicket,
    SpoolQueue,
)
from scdna_replication_tools_tpu_torch.infer import svi as svi_mod
from scdna_replication_tools_tpu_torch.serve.slab import (
    SlabFitCoordinator,
    SlabState,
)
from scdna_replication_tools_tpu_torch.serve.tsv import TsvWriter
from scdna_replication_tools_tpu_torch.utils import faults as faults_mod
from scdna_replication_tools_tpu_torch.utils.profiling import logger

# The subset of scRT keyword arguments a request ticket may override.
# A whitelist, not passthrough: a ticket is external input, and an
# arbitrary kwarg would let one tenant reconfigure the worker's
# execution substrate (telemetry/checkpoint paths, sharding) out from
# under every other request.  Shape-affecting knobs stay out too —
# bucket padding owns the shapes.
REQUEST_OPTION_KEYS = frozenset({
    "input_col", "assign_col", "clone_col", "cn_prior_method",
    "cn_prior_weight", "rt_prior_col", "max_iter", "min_iter",
    "rel_tol", "learning_rate", "seed", "run_step3", "mirror_rescue",
    "qc", "qc_entropy_thresh", "qc_ppc_z", "controller",
    "controller_max_extra_iters", "faults", "resume",
    "clustering_method", "cn_hmm_self_prob",
})


_WORKER_LOG_COUNTER = itertools.count()

# recent-outcome window kept in memory (`ServeWorker.outcomes`): big
# enough for every bench/smoke/test harness (they bound the loop with
# max_requests anyway), bounded so the production daemon's RSS is flat
RECENT_OUTCOMES = 256


# records the warm-up thread reads (a kernel library's) or captures (a
# program's) ahead of traffic (JAX's cap)
WARMUP_PRELOAD_MAX = 16
# the share of the card's memory the worker's captured programs may hold
# together (their buffers, and each graph pool once) before the least
# recently used idle ones are released: on an 80 GB card, 25.5 GB, which
# holds one flagship request's programs (the fits', its decode's and its
# PPC's) and leaves the rest to four requests' own state, a capture's
# warm-up and the other processes on the card (chip_smoke.py's serving
# phase prints the least memory free on the card during its drain)
PROGRAM_MEMORY_SHARE = 0.3


def rank_warmup_entries(entries: list, ledger: dict) -> list:
    """The store's records in the warm-up's order (JAX
    ``_warmup_executables``'s ``_traffic`` rank): a record belongs to
    bucket ``c<cells>xl<loci>`` when the last two dims of one of its
    recorded shapes (``meta['shapes']``) are that bucket's padding, and
    its traffic is the sum of ``ledger[bucket]`` (the previous worker's
    ``buckets_served``) over its buckets; sorted by (traffic, mtime),
    descending, and with a ledger only the records whose traffic is
    above 0 (a record without shapes, a kernel library's, has none)."""
    def _traffic(entry) -> int:
        shapes = entry["meta"].get("shapes") or []
        tails = {tuple(s[-2:]) for s in shapes if len(s) >= 2}
        count = 0
        for name, served in ledger.items():
            m = re.match(r"c(\d+)xl(\d+)$", name)
            if m and (int(m.group(1)), int(m.group(2))) in tails:
                count += int(served)
        return count

    ranked = sorted(entries, key=lambda e: (_traffic(e), e["mtime"]),
                    reverse=True)
    if ledger:
        ranked = [e for e in ranked if _traffic(e) > 0]
    return ranked


def _resolve_executable_cache(queue, value) -> Optional[str]:
    """JAX's rule (``serve/worker.py``): 'auto' is ``<spool>/exec_cache``,
    None/'none' no store, any other value that path."""
    if value == "auto":
        return str(queue.root / "exec_cache")
    if value is None or str(value).lower() == "none":
        return None
    return str(value)


@dataclasses.dataclass
class RequestOutcome:
    request_id: str
    status: str                 # ok / failed / refused
    wall_seconds: float
    bucket: Optional[dict] = None
    error: Optional[str] = None
    run_log: Optional[str] = None
    compile_cache: Optional[dict] = None
    # batched mode: the request completed while >= 1 slab peer kept
    # fitting (its decode/stream-back overlapped their fit time)
    retired_early: bool = False
    # sanitized tenant label (cost attribution rollup); never the raw
    # ticket string — see ServeWorker._sanitize_tenant
    tenant: Optional[str] = None


class ServeWorker:
    """See module docstring.  ``max_requests``/``exit_when_idle`` bound
    the loop for CI/bench harnesses; a production worker runs with
    neither and drains on signal."""

    def __init__(self, queue: SpoolQueue,
                 buckets: Optional[BucketSet] = None,
                 telemetry_path: Optional[str] = None,
                 metrics_textfile: Optional[str] = None,
                 poll_interval: float = 0.5,
                 max_requests: Optional[int] = None,
                 exit_when_idle: bool = False,
                 default_options: Optional[dict] = None,
                 trace_spans: bool = True,
                 max_batch: int = 1,
                 executable_cache_dir: Optional[str] = "auto",
                 device=None):
        self.executable_cache_dir = _resolve_executable_cache(
            queue, executable_cache_dir)
        # where every request's fit runs (device.resolve_device: the
        # GPU unless 'cpu' is passed), resolved once so a worker without
        # a GPU fails at construction, not per request
        self.device = resolve_device(device)
        self.queue = queue
        self.buckets = buckets or BucketSet()
        self.poll_interval = float(poll_interval)
        self.max_requests = max_requests
        self.exit_when_idle = bool(exit_when_idle)
        self.default_options = dict(default_options or {})
        # continuous batching width: K > 1 runs up to K same-rung
        # requests as concurrent slab blocks (see module docstring);
        # 1 keeps the strictly serial loop byte-identical to before
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.slab = SlabState(self.max_batch)
        # the slab FIT ENGINE: block threads hand their fit chunks to
        # this coordinator (via svi.set_chunk_dispatcher), which packs
        # concurrent same-signature chunks into one vectorized
        # dispatch at a power-of-two width rung — see
        # serve/slab.SlabFitCoordinator
        self.slab_coordinator = (SlabFitCoordinator(self.max_batch)
                                 if self.max_batch > 1 else None)
        # causal span tracing (obs/spans.py) — default ON for the
        # worker: serving is exactly where "where did the p99 go" needs
        # queue-wait/admission/fit/stream-back decomposed, and each
        # request's trace id rides its ticket so pert_trace stitches
        # the worker log + the per-request run log into one timeline
        self.trace_spans = bool(trace_spans)
        # fail FAST on bad worker defaults: they apply to every
        # request, and a reserved key (telemetry_path, checkpoint_dir,
        # pad_*, request_id — the per-request kwargs the worker itself
        # owns) would otherwise TypeError inside scRT on each request
        # instead of at startup; ticket options are merely warned-and-
        # filtered (external input), but the operator's own flags
        # deserve a loud refusal
        bad = sorted(set(self.default_options) - REQUEST_OPTION_KEYS)
        if bad:
            raise ValueError(
                f"worker default option(s) {bad} are not requestable "
                f"scRT knobs (whitelist: serve/worker.py "
                f"REQUEST_OPTION_KEYS; telemetry/checkpoint/padding/"
                f"request-identity paths are owned by the worker)")
        self._draining = False
        # bounded: a production daemon processes requests forever, and
        # an unbounded outcome list would be a slow memory leak; the
        # full per-request record lives in the worker log + tickets,
        # this keeps only the recent window (+ running counters)
        self.outcomes: collections.deque = collections.deque(
            maxlen=RECENT_OUTCOMES)
        self._status_counts: dict = {}
        # the live status surface (status.json in the spool root): the
        # in-flight request + its open span stack, queue depth, the
        # bucket-residency ledger, and the recent-outcome window —
        # rewritten atomically at every state change plus a periodic
        # heartbeat, so `pert-serve status <spool>` can ask a running
        # worker "what are you doing right now and for how long"
        self._started_unix = round(time.time(), 3)
        self._processed = 0
        self._state = "starting"
        # rid -> {"request_id", "started_unix"}: one entry in serial
        # mode, up to max_batch in batched mode.  _state_lock guards
        # it plus the tracer map, ledger and counters — block threads
        # mutate all of them concurrently
        self._inflight: dict = {}
        self._request_tracers: dict = {}
        # rid -> slab residency facts, snapshotted by the FIRST
        # _slab_exit call (the request_end emit in batched mode) so
        # the request-span close in process_request's finally reports
        # the same numbers
        self._slab_facts: dict = {}
        self._state_lock = threading.RLock()
        self._bucket_ledger: dict = {}
        self._heartbeat_stop = threading.Event()
        queue.ensure_dirs()
        # status.json rides the shared heartbeat primitive
        # (obs/heartbeat.py): atomic commits with the monotonic 'seq'
        # stamp, so pert_watch's sequence-based freshness contract
        # covers the serve surface too
        self._status_file = heartbeat_mod.HeartbeatFile(
            queue.status_path)
        # the stream back's result files, formatted by a pool of
        # processes that run() stops (serve/tsv.py: pandas' bytes)
        self._tsv = TsvWriter()
        # the compiled-program store's surface: its directory, the
        # library records the warm-up read, and (in the status document)
        # the programs it holds
        self._warmup_info: dict = {
            "dir": self.executable_cache_dir, "preloaded": 0,
            "entries": 0, "done": self.executable_cache_dir is None}
        self._store = None
        # the previous worker's buckets_served, read before this worker's
        # heartbeat rewrites status.json: the warm-up's ranking
        self._prior_buckets = self._read_prior_bucket_ledger()
        if telemetry_path is None:
            # pid + counter in the default name: multiple workers may
            # share one spool (the queue's rename-based claiming
            # exists for that), and RunLog opens its file with "w" —
            # a same-second collision would clobber a sibling's
            # request audit trail
            telemetry_path = str(
                queue.root / f"worker_{time.strftime('%Y%m%d_%H%M%S')}"
                             f"_{os.getpid()}"
                             f"_{next(_WORKER_LOG_COUNTER)}.jsonl")
        self.telemetry_path = telemetry_path
        self.registry = metrics_mod.MetricsRegistry.create(
            textfile_path=metrics_textfile)
        self.worker_log = RunLog.create(telemetry_path,
                                        run_name="pert_serve")
        # log-scoped registry routing: the worker log's events (incl.
        # request_start/request_end) feed THIS registry, while each
        # request's own log feeds its own — no cross-feeding even
        # though both are live in one process
        self.worker_log.metrics_registry = self.registry
        # the WORKER-SESSION cost ledger (obs/meter.py): books the
        # device time no single request owns — claim-gap idle
        # (queue_idle) and parked slab lanes (retired_lane via the
        # coordinator) — and lands its summary in run()'s stats +
        # status.json + the worker log's run_end.  Each request's own
        # billed/waste lives in ITS run's ledger (the runner attaches
        # one per request pipeline)
        self.meter = meter_mod.CostLedger(
            scope={"worker": "pert_serve", "spool": str(queue.root)})
        self.meter.metrics_registry = self.registry
        self.worker_log.meter_ledger = self.meter
        if self.slab_coordinator is not None:
            self.slab_coordinator.meter_ledger = self.meter
        # per-tenant processed rollup (status.json processed.by_tenant)
        self._by_tenant: dict = {}
        # claim-gap bookkeeping: perf stamp of the last request
        # retirement (or worker start) -> next claim books queue_idle
        self._idle_since = time.perf_counter()
        # the slab gauges (manifest-pinned): configured width is
        # static; occupancy moves on every admit/retire
        self.registry.gauge("pert_serve_batch_width").set(self.max_batch)
        self.registry.gauge("pert_serve_slab_occupancy").set(0)

    # -- lifecycle --------------------------------------------------------

    def install_signal_handlers(self) -> None:
        """SIGTERM/SIGINT -> graceful drain.  Main thread only (signal
        module restriction); harnesses running the worker in a thread
        install these themselves and call :meth:`request_drain`."""
        signal.signal(signal.SIGTERM, self.request_drain)
        signal.signal(signal.SIGINT, self.request_drain)

    def request_drain(self, signum=None, frame=None) -> None:
        """Finish the in-flight request, leave the queue intact, exit
        the loop.  Idempotent; safe from signal handlers and threads."""
        if not self._draining:
            logger.warning(
                "pert-serve: drain requested (%s) — finishing the "
                "in-flight request, leaving pending tickets queued",
                f"signal {signum}" if signum is not None else "api")
        self._draining = True

    def _sleep_poll(self) -> None:
        """Sleep one poll interval in small increments so a drain
        request during an idle wait is honoured promptly."""
        deadline = time.monotonic() + self.poll_interval
        while not self._draining and time.monotonic() < deadline:
            time.sleep(min(0.05, self.poll_interval))

    def run(self) -> dict:
        """Drain the spool until stopped; returns the session stats."""
        if threading.current_thread() is threading.main_thread():
            self.install_signal_handlers()
        config = {
            "spool": str(self.queue.root),
            "buckets": self.buckets.describe(),
            "poll_interval": self.poll_interval,
            "max_requests": self.max_requests,
            "exit_when_idle": self.exit_when_idle,
            "default_options": self.default_options,
            "trace_spans": self.trace_spans,
            "max_batch": self.max_batch,
            "executable_cache": self.executable_cache_dir,
        }
        heartbeat = threading.Thread(target=self._heartbeat_loop,
                                     name="pert-serve-status",
                                     daemon=True)
        self._heartbeat_stop.clear()
        heartbeat.start()
        warmup = None
        if self.executable_cache_dir is not None:
            # the worker's store, shared by every request's run for the
            # worker's life; its graphs are released when run() returns
            budget = None
            if self.device.type == "cuda":
                budget = int(PROGRAM_MEMORY_SHARE * torch.cuda.
                             get_device_properties(self.device).total_memory)
            self._store = aotcache.activate(self.executable_cache_dir,
                                            max_program_bytes=budget)
            warmup = threading.Thread(target=self._warmup_executables,
                                      name="pert-serve-warmup", daemon=True)
            warmup.start()
        try:
            with self.worker_log.session(config=config,
                                         run_name="pert_serve"):
                if self.max_batch > 1:
                    self._drain_batched()
                else:
                    self._drain_serial()
        finally:
            # join the heartbeat BEFORE writing the terminal state: a
            # heartbeat mid-write when the stop flag lands would
            # otherwise commit its stale 'idle'/'processing' doc AFTER
            # the 'stopped' one, leaving a live-looking status.json
            # for a worker that has exited
            self._heartbeat_stop.set()
            heartbeat.join(timeout=5)
            if warmup is not None:
                warmup.join(timeout=30)
            if self._store is not None:
                if aotcache.active_store() is self._store:
                    aotcache.deactivate()
                else:
                    self._store.close()
            self._tsv.close()
            self._set_state("stopped")
        self.registry.write_textfile()
        return {
            "processed": self._processed,
            "by_tenant": dict(self._by_tenant),
            "by_status": dict(self._status_counts),
            "drained": self._draining,
            "pending_left": self.queue.depth(),
            "worker_log": self.worker_log.path,
            "status_path": str(self.queue.status_path),
            "outcomes": [dataclasses.asdict(o) for o in self.outcomes],
            # session cost plane: billed/effective/waste decomposition
            # for everything this worker dispatched (worker-scope only;
            # per-request fit costs live in each request's run.jsonl)
            "meter": self.meter.summary(),
        }

    def _finish_outcome(self, outcome: RequestOutcome) -> None:
        with self._state_lock:
            self.outcomes.append(outcome)
            self._status_counts[outcome.status] = \
                self._status_counts.get(outcome.status, 0) + 1
            self._processed += 1
            if outcome.tenant:
                self._by_tenant[outcome.tenant] = \
                    self._by_tenant.get(outcome.tenant, 0) + 1
        self.registry.write_textfile()
        self._write_status()

    def _drain_serial(self) -> None:
        """The strictly serial loop (``max_batch == 1``): claim, run,
        repeat — one request in flight, ever."""
        while not self._draining:
            if self.max_requests is not None \
                    and self._processed >= self.max_requests:
                break
            self._set_state("idle")
            ticket = self.queue.claim()
            if ticket is None:
                if self.exit_when_idle:
                    break
                self._sleep_poll()
                continue
            self._finish_outcome(self.process_request(ticket))

    # -- continuous batching ----------------------------------------------

    def _slab_predicate(self):
        """Claim filter while the slab has live blocks: admit tickets
        whose shape hint lands in the slab's pinned bucket rung (one
        compiled program set serves every block), plus hint-less
        tickets (real admission decides — a mismatch merely makes a
        second program family resident, it is never wrong).  With an
        empty slab (rung None) there is nothing to match: claim the
        best-priority ticket outright."""
        rung = self.slab.rung
        if rung is None:
            return None

        def _same_rung(ticket: RequestTicket) -> bool:
            bucket = self.buckets.select_hint(ticket.shape)
            return bucket is None or bucket.name == rung

        return _same_rung

    def _block_main(self, ticket: RequestTicket, box: dict) -> None:
        """One slab block = one full request pipeline on its own
        thread.  The thread-local seams (RunLog stack, metrics
        registry, fault plan) scope every per-request install to this
        block; the chunk dispatcher install routes this block's fit
        chunks through the shared slab coordinator."""
        try:
            svi_mod.set_chunk_dispatcher(self.slab_coordinator)
            try:
                box["outcome"] = self.process_request(ticket)
            finally:
                svi_mod.set_chunk_dispatcher(None)
        except BaseException as exc:  # noqa: BLE001 — thread
            # boundary, not a swallow: process_request only lets
            # process-fatal BaseExceptions escape (it already called
            # request_drain); the reaper re-raises ``box['error']`` on
            # the worker thread, which owns reporting
            box["error"] = exc

    def _drain_batched(self) -> None:
        """Continuous batching (``max_batch`` K > 1): keep up to K
        block threads in flight, reap finished blocks as they retire,
        refill vacated blocks from the spool — admission never waits
        for the slab to drain (that would be gang scheduling)."""
        active: dict = {}
        claimed = 0

        def _reap() -> None:
            for rid in [r for r, blk in active.items()
                        if not blk["thread"].is_alive()]:
                block = active.pop(rid)
                block["thread"].join()
                error = block["box"].get("error")
                if error is not None:
                    # process-fatal escape (preemption/KeyboardInterrupt
                    # in a block): drain — the loop exits once every
                    # live block has been reaped
                    logger.warning(
                        "pert-serve: block %s died process-fatally "
                        "(%s) — draining", rid, error)
                    self.request_drain()
                    continue
                outcome = block["box"].get("outcome")
                if outcome is not None:
                    self._finish_outcome(outcome)

        while True:
            _reap()
            budget_left = (self.max_requests is None
                           or claimed < self.max_requests)
            if self._draining or not budget_left:
                if not active:
                    break
                time.sleep(0.05)
                continue
            if len(active) >= self.max_batch:
                time.sleep(0.05)
                continue
            ticket = self.queue.claim(predicate=self._slab_predicate())
            if ticket is None:
                if not active:
                    self._set_state("idle")
                    if self.exit_when_idle:
                        break
                    self._sleep_poll()
                else:
                    # slab partially full, nothing claimable (empty
                    # queue or all candidates off-rung): keep serving
                    time.sleep(0.05)
                continue
            claimed += 1
            box: dict = {}
            thread = threading.Thread(
                target=self._block_main, args=(ticket, box),
                name=f"pert-serve-block-{ticket.request_id}",
                daemon=True)
            active[ticket.request_id] = {"thread": thread, "box": box}
            thread.start()

    # -- the live status surface ------------------------------------------

    def _set_state(self, state: str) -> None:
        if state != self._state:
            self._state = state
            self._write_status()

    def _heartbeat_loop(self) -> None:
        """Periodic status.json refresh from a daemon thread: the
        worker thread is busy inside a fit for most of a request's
        life, and "how long has it been stuck there" needs a fresh
        ``updated_unix`` (and span-stack ages) regardless."""
        interval = min(max(self.poll_interval, 0.2), 2.0)
        while not self._heartbeat_stop.wait(interval):
            self._write_status()

    def _read_prior_bucket_ledger(self) -> dict:
        """The previous worker's ``buckets_served`` ledger out of
        status.json (JAX ``_read_prior_bucket_ledger``): the residency
        signal that ranks the warm-up's records.  Read at construction,
        before this worker's own heartbeat rewrites the file."""
        try:
            with open(self.queue.status_path, encoding="utf-8") as fh:
                doc = json.load(fh)
            if doc.get("kind") == "pert_serve_status":
                return dict(doc.get("buckets_served") or {})
        except (OSError, ValueError):
            pass
        return {}

    def _warmup_executables(self) -> None:
        """One-shot background warm-up (JAX ``_warmup_executables``): rank
        the store's records by the previous worker's per-bucket traffic
        (:func:`rank_warmup_entries`) and take the first
        ``WARMUP_PRELOAD_MAX``: a kernel library's record is read into
        RAM, so the first request loads the library without touching the
        disk; a program's record (a fit chunk's, a slab's, a decode or
        PPC slab pass's) is captured again (``svi.precapture``: its
        libraries loaded, its graphs captured on placeholder buffers, the
        program put into the store under the digest a request of its rung
        computes), so the first request of a warmed rung replays its
        fits, its packaging decode and its QC without capturing.  The programs are
        captured in reverse rank, so that the store's caps release the
        lowest-ranked first; a slab wider than this worker packs is left
        out.
        A failure is logged and recorded (``error``): the request then
        captures on first use.  ``preloaded`` counts the programs ready
        in RAM and the library records read."""
        t0 = time.perf_counter()
        store = self._store
        info = {"preloaded": 0, "precaptured": 0,
                "precaptured_key_hashes": []}
        try:
            entries = store.entries()
            ranked = rank_warmup_entries(entries, self._prior_buckets)
            info["entries"] = len(entries)
            chosen = ranked[:WARMUP_PRELOAD_MAX]
            programs = [e for e in chosen
                        if e["meta"].get("kind") == "program"]
            # the programs in reverse rank: past the store's caps its LRU
            # release then takes the lowest-ranked ones first
            for entry in [e for e in chosen if e not in programs] \
                    + programs[::-1]:
                if self._heartbeat_stop.is_set() or self._draining:
                    break
                meta = entry["meta"]
                if meta.get("kind") != "program":
                    if store.preload(entry["digest"]):
                        info["preloaded"] += 1
                    continue
                # a slab wider than this worker's widest rung (the power
                # of two at or above max_batch; a serial worker packs
                # nothing) is never dispatched here
                width = re.match(r"slab(\d+)$", str(meta.get("tag", "")))
                if width and (self.max_batch < 2 or int(width.group(1))
                              >= 2 * self.max_batch):
                    continue
                try:
                    got = svi_mod.precapture(store, entry["digest"],
                                             self.device)
                except Exception as exc:  # noqa: BLE001 — recorded:
                    # the program's first request captures it instead
                    logger.warning("pert-serve: pre-capture of %s "
                                   "failed: %s", entry["digest"], exc)
                    info.setdefault("error", f"{type(exc).__name__}: "
                                    f"{str(exc)[:200]}")
                    continue
                info["preloaded"] += 1
                info["precaptured"] += 1
                info["precaptured_key_hashes"] += got["key_hashes"]
            if info["preloaded"]:
                logger.info(
                    "pert-serve: executable warm-up: %d programs "
                    "captured, %d records read ahead of %d in %s",
                    info["precaptured"],
                    info["preloaded"] - info["precaptured"],
                    len(entries), self.executable_cache_dir)
        except Exception as exc:  # noqa: BLE001 — warm-up is an
            # optimisation; a failure must not take down the worker
            logger.warning("pert-serve: executable warm-up failed: %s",
                           exc)
            info["error"] = str(exc)[:200]
        info["precapture_seconds"] = round(time.perf_counter() - t0, 4)
        with self._state_lock:
            self._warmup_info.update(info, done=True)

    def _inflight_doc(self, info: dict) -> dict:
        doc = dict(info)
        doc["age_seconds"] = round(
            max(time.time() - doc.get("started_unix", 0.0), 0.0), 3)
        tracer = self._request_tracers.get(doc.get("request_id"))
        if tracer is not None:
            # the WORKER-side open spans (request, and admission/
            # stream_back while they run) with per-span ages.  The
            # pipeline's own phase/chunk spans live on the request
            # run's tracer and close as they complete — the last_span
            # note below is what moves during the fit
            doc["span_stack"] = tracer.stack()
            doc["trace_id"] = tracer.trace_id
        return doc

    def _status_doc(self) -> dict:
        with self._state_lock:
            inflight_infos = [self._inflight_doc(info)
                              for info in self._inflight.values()]
        inflight = inflight_infos[0] if inflight_infos else None
        if inflight is not None:
            last = spans_mod.last_closed_span()
            if last is not None:
                # mid-fit progress: fit/chunk spans close every chunk,
                # so "last completed span + age" answers "how long has
                # it been stuck" even while the worker thread is deep
                # inside scrt.infer()
                last["age_seconds"] = round(
                    max(time.time() - last.get("end_unix", 0.0), 0.0),
                    3)
                inflight["last_span"] = last
        # slab membership: configured width, live occupancy, pinned
        # rung, and every in-flight block (span stacks included) — in
        # serial mode a one-block (or empty) slab, for a uniform
        # surface
        slab = self.slab.describe()
        slab["blocks"] = inflight_infos
        if self.slab_coordinator is not None:
            # fit-engine counters: how much of the fitting actually ran
            # packed (vs solo fallbacks at occupancy 1)
            slab["fit_dispatches"] = self.slab_coordinator.dispatches
            slab["packed_dispatches"] = \
                self.slab_coordinator.packed_dispatches
            slab["packed_lanes"] = self.slab_coordinator.packed_lanes
            slab["packed_graphed"] = self.slab_coordinator.packed_graphed
            slab["degraded_dispatches"] = self.slab_coordinator.degraded
        return {
            "kind": "pert_serve_status",
            "pid": os.getpid(),
            "started_unix": self._started_unix,
            "updated_unix": round(time.time(), 3),
            "state": "draining" if self._draining
            and self._state not in ("stopped",) else self._state,
            "queue_depth": self.queue.depth(),
            "in_flight": inflight,
            "slab": slab,
            # processed rollup: total plus the per-tenant attribution
            # (sanitized labels only — see _sanitize_tenant)
            "processed": {"total": self._processed,
                          "by_tenant": dict(self._by_tenant)},
            "by_status": dict(self._status_counts),
            # cost digest: the worker-session meter's headline numbers
            # (full decomposition in the run() stats / worker log)
            "meter": self.meter.brief(),
            # bucket-residency ledger: which compiled shape families
            # this worker is keeping warm, and how much traffic each
            # has served — the eviction/right-sizing signal
            "buckets_served": dict(self._bucket_ledger),
            # the compiled-program store: its library records on disk,
            # how many the warm-up read ahead, and the captured programs
            # it holds in RAM with their device bytes
            "executable_cache": dict(
                self._warmup_info,
                programs=self._store.program_count()
                if self._store is not None else 0,
                program_bytes=self._store.program_bytes()
                if self._store is not None else 0,
                programs_released=self._store.released
                if self._store is not None else 0,
                peak_program_bytes=self._store.peak_program_bytes
                if self._store is not None else 0),
            "recent": [dataclasses.asdict(o)
                       for o in list(self.outcomes)[-10:]],
            "worker_log": self.worker_log.path,
        }

    def _write_status(self) -> None:
        """Atomic heartbeat write through the shared primitive
        (``obs.heartbeat.HeartbeatFile``: mkstemp + fsync + os.replace,
        plus the monotonic ``seq`` stamp): a concurrent ``pert-serve
        status`` reader can never observe a torn document, and a
        watcher can detect a stalled worker by sequence alone.  Never
        raises — the status surface must not take down the worker."""
        try:
            self._status_file.write(self._status_doc())
        except Exception as exc:  # noqa: BLE001 — best-effort surface;
            # the worker log remains the durable record
            logger.debug("pert-serve: status.json write failed: %s", exc)

    # -- one request ------------------------------------------------------

    def _probe_shape(self, df_s: pd.DataFrame, df_g1: pd.DataFrame,
                     options: dict) -> dict:
        cell_col = options.get("cell_col", "cell_id")
        chr_col = options.get("chr_col", "chr")
        start_col = options.get("start_col", "start")
        return {
            "num_cells_s": int(df_s[cell_col].nunique()),
            "num_cells_g1": int(df_g1[cell_col].nunique()),
            "num_loci": int(df_s[[chr_col, start_col]]
                            .drop_duplicates().shape[0]),
        }

    def _merged_options(self, ticket: RequestTicket) -> dict:
        options = dict(self.default_options)
        unknown = sorted(set(ticket.options) - REQUEST_OPTION_KEYS)
        if unknown:
            logger.warning(
                "pert-serve: request %s carries non-whitelisted "
                "option(s) %s — ignored (see serve/worker.py "
                "REQUEST_OPTION_KEYS)", ticket.request_id, unknown)
        options.update({k: v for k, v in ticket.options.items()
                        if k in REQUEST_OPTION_KEYS})
        return options

    _TENANT_BAD = re.compile(r"[^A-Za-z0-9._-]")

    @staticmethod
    def _sanitize_tenant(value) -> Optional[str]:
        """Sanitize the ticket's advisory tenant label before it is
        trusted anywhere (worker log events, ``status.json`` rollups,
        meter attribution).  The spool is a filesystem drop-box: any
        process that can write a ticket controls this string, so the
        worker never echoes it raw — characters outside
        ``[A-Za-z0-9._-]`` are squashed to ``_`` and the result is
        truncated to 64 chars.  Empty/None (or a value that sanitizes
        to nothing) attributes to no tenant at all."""
        if value is None:
            return None
        cleaned = ServeWorker._TENANT_BAD.sub("_", str(value))[:64]
        return cleaned or None

    def process_request(self, ticket: RequestTicket) -> RequestOutcome:
        rid = ticket.request_id
        results_dir = self.queue.results_dir(rid)
        results_dir.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        depth = self.queue.depth()
        options = self._merged_options(ticket)
        bucket = None
        # --- causal tracing: one trace per request, id from the ticket.
        # The request span is the root the queue-wait/admission/
        # stream-back spans (worker log) AND the per-request run's own
        # span tree (request log, via trace_parent) stitch under.
        tracer = req_span = None
        if self.trace_spans:
            tracer = spans_mod.SpanTracer(
                trace_id=ticket.trace_id
                or spans_mod.derive_trace_id(rid))
            if self.max_batch > 1:
                # K concurrent request tracers cannot share the worker
                # log's single tracer slot — wire each one's span sink
                # straight to the log instead (span_end events still
                # land there; the log-level span envelope is absent in
                # batched mode)
                spans_mod.attach_sink(self.worker_log, tracer)
            else:
                spans_mod.attach_tracer(self.worker_log, tracer)
            req_span = tracer.begin("request", request_id=rid)
            with self._state_lock:
                self._request_tracers[rid] = tracer
        # queue-wait: ticket commit (pending/ mtime) -> claim.  A real
        # span over an interval the worker never executed through —
        # the spool crossing — recorded retroactively from the claim
        # timestamps and surfaced on request_start so the
        # pert_serve_queue_wait_seconds histogram fills from the emit
        # seam.
        queue_wait = None
        q_start = ticket.pending_mtime or ticket.submitted_unix or None
        if ticket.claimed_unix and q_start:
            queue_wait = max(float(ticket.claimed_unix)
                             - float(q_start), 0.0)
            if tracer is not None:
                tracer.record_span("queue_wait", float(q_start),
                                   float(ticket.claimed_unix),
                                   request_id=rid)
        with self._state_lock:
            if not self._inflight:
                # claim-gap accounting: the device sat idle from the
                # last retirement (or worker start) until this claim —
                # billed to the worker session as queue_idle waste
                idle = time.perf_counter() - self._idle_since
                if idle > 0:
                    self.meter.book_queue_idle(seconds=idle)
            self._inflight[rid] = {"request_id": rid,
                                   "started_unix": round(time.time(), 3)}
        self.slab.admit(rid)
        self.registry.gauge("pert_serve_slab_occupancy").set(
            self.slab.occupancy())
        self._set_state("processing")
        try:
            return self._process_claimed(
                ticket, rid, results_dir, t0, depth, options, bucket,
                tracer, req_span, queue_wait)
        finally:
            # idempotent: in batched mode the request_end emit already
            # retired the block and cached the facts
            facts = self._slab_exit(rid)
            if tracer is not None:
                if req_span is not None:
                    if self.max_batch > 1:
                        # the waterfall's attribution inputs ride the
                        # request span (tools/pert_trace.py divides the
                        # shared fit seconds by this occupancy)
                        tracer.end(
                            req_span,
                            slab_avg_occupancy=facts["avg_occupancy"],
                            retired_early=facts["retired_early"])
                    else:
                        tracer.end(req_span)
                if self.max_batch <= 1:
                    spans_mod.attach_tracer(self.worker_log, None)
            with self._state_lock:
                self._inflight.pop(rid, None)
                self._request_tracers.pop(rid, None)
                self._slab_facts.pop(rid, None)
                if not self._inflight:
                    # last in-flight request retired: the claim gap
                    # (queue_idle) starts now
                    self._idle_since = time.perf_counter()
            # the request's pipeline is garbage now, but its objects
            # form reference cycles (the phase timer's sink chain, an
            # exception's traceback through the frames that held its
            # tensors), which hold its device memory until a collection
            # runs; with few Python objects allocated that can take many
            # requests, and the card runs out under the next ones
            gc.collect()

    def _slab_exit(self, rid: str) -> dict:
        """Retire the block from the slab ledger — idempotent: the
        first call snapshots the residency facts (avg_occupancy,
        retired_early) and refreshes the occupancy gauge; later calls
        in the same request return the snapshot."""
        with self._state_lock:
            facts = self._slab_facts.get(rid)
            if facts is None:
                facts = self.slab.retire(rid)
                self._slab_facts[rid] = facts
                self.registry.gauge("pert_serve_slab_occupancy").set(
                    self.slab.occupancy())
            return facts

    def _slab_end_attrs(self, rid: str) -> dict:
        """Extra ``request_end`` fields in batched mode: did the block
        retire while >= 1 peer kept fitting, and its time-weighted
        average slab occupancy (the waterfall's shared-fit-time
        divisor).  Empty in serial mode so those worker logs stay
        byte-identical to pre-batching ones."""
        if self.max_batch <= 1:
            return {}
        facts = self._slab_exit(rid)
        return {"retired_early": facts["retired_early"],
                "slab_avg_occupancy": facts["avg_occupancy"]}

    def _process_claimed(self, ticket, rid, results_dir, t0, depth,
                         options, bucket, tracer, req_span,
                         queue_wait) -> RequestOutcome:
        tenant = self._sanitize_tenant(getattr(ticket, "tenant", None))
        admission_cm = tracer.span("admission", request_id=rid) \
            if tracer is not None else contextlib.nullcontext()
        try:
            with admission_cm:
                df_s = pd.read_csv(ticket.s_path, sep="\t",
                                   dtype={"chr": str})
                df_g1 = pd.read_csv(ticket.g1_path, sep="\t",
                                    dtype={"chr": str})
                shape = self._probe_shape(df_s, df_g1, options)
                bucket = self.buckets.select(
                    max(shape["num_cells_s"], shape["num_cells_g1"]),
                    shape["num_loci"])
                pad_frac = bucket.pad_frac(
                    max(shape["num_cells_s"], shape["num_cells_g1"]),
                    shape["num_loci"])
            self.worker_log.emit(
                "request_start", request_id=rid,
                bucket={"name": bucket.name, "cells": bucket.cells,
                        "loci": bucket.loci},
                pad_frac=round(pad_frac, 6), queue_depth=depth,
                queue_wait_seconds=(round(queue_wait, 6)
                                    if queue_wait is not None else None),
                tenant=tenant, shape=shape)
            # bucket-residency ledger (status.json): admitted traffic
            # per compiled shape family this worker keeps warm
            with self._state_lock:
                self._bucket_ledger[bucket.name] = \
                    self._bucket_ledger.get(bucket.name, 0) + 1
            # the first admitted block's bucket pins the slab rung —
            # the claim predicate steers same-rung tickets in after it
            self.slab.set_bucket(rid, bucket.name)
        except BucketRefusal as exc:
            wall = time.perf_counter() - t0
            self.worker_log.emit(
                "request_start", request_id=rid, bucket=None,
                pad_frac=None, queue_depth=depth,
                queue_wait_seconds=(round(queue_wait, 6)
                                    if queue_wait is not None else None),
                tenant=tenant, detail="refused at admission")
            slab_attrs = self._slab_end_attrs(rid)
            self.worker_log.emit(
                "request_end", request_id=rid, status="refused",
                wall_seconds=round(wall, 4), error=str(exc)[:500],
                tenant=tenant, **slab_attrs)
            self.queue.finish(ticket, "refused", error=str(exc),
                              results_dir=results_dir)
            logger.warning("pert-serve: request %s refused: %s", rid,
                           exc)
            return self._record(rid, "refused", wall, error=str(exc),
                                tenant=tenant,
                                retired_early=bool(
                                    slab_attrs.get("retired_early",
                                                   False)))
        except Exception as exc:
            # unreadable/malformed input: fail the request at
            # admission.  Still open the lifecycle pair — the worker
            # log's contract is one request_start per request_end, and
            # a consumer joining starts to ends must not see orphans
            wall = time.perf_counter() - t0
            self.worker_log.emit(
                "request_start", request_id=rid, bucket=None,
                pad_frac=None, queue_depth=depth,
                queue_wait_seconds=(round(queue_wait, 6)
                                    if queue_wait is not None else None),
                tenant=tenant, detail="failed at admission")
            slab_attrs = self._slab_end_attrs(rid)
            self.worker_log.emit(
                "request_end", request_id=rid, status="failed",
                wall_seconds=round(wall, 4),
                error=f"{type(exc).__name__}: {str(exc)[:400]}",
                error_class="admission",
                tenant=tenant, **slab_attrs)
            self.queue.finish(ticket, "failed", error=str(exc),
                              results_dir=results_dir)
            logger.warning("pert-serve: request %s failed at admission "
                           "(%s)", rid, exc)
            return self._record(rid, "failed", wall, error=str(exc),
                                tenant=tenant,
                                retired_early=bool(
                                    slab_attrs.get("retired_early",
                                                   False)))

        bucket_info = {"name": bucket.name, "cells": bucket.cells,
                       "loci": bucket.loci}
        run_log_path = str(results_dir / "run.jsonl")
        try:
            self._run_pipeline(rid, df_s, df_g1, options, bucket,
                               results_dir, run_log_path,
                               tracer=tracer, req_span=req_span)
        except Exception as exc:
            # PER-REQUEST FAULT ISOLATION: whatever escaped the
            # pipeline — an OOM past the degradation ladder, a NaN
            # escalation abort, a deterministic bug in one tenant's
            # data — fails THIS request's ticket and manifest; the
            # worker, its program cache and the rest of the queue
            # carry on.  The scRT instance lives inside _run_pipeline,
            # whose own handler already retired its registry
            # (_cleanup_failed_request); here only the process-global
            # fault plan is left to clear.
            faults_mod.install(None)
            wall = time.perf_counter() - t0
            kind = faults_mod.classify_exception(exc)
            slab_attrs = self._slab_end_attrs(rid)
            self.worker_log.emit(
                "request_end", request_id=rid, status="failed",
                wall_seconds=round(wall, 4), bucket=bucket_info,
                error=f"{type(exc).__name__}: {str(exc)[:400]}",
                error_class=kind, run_log=run_log_path,
                results_dir=str(results_dir),
                tenant=tenant,
                detail=("request isolated: the per-request durable-run "
                        "artifacts (checkpoints, RunLog, manifest) "
                        "carry the post-mortem; the worker and queue "
                        "continue"),
                **slab_attrs)
            self.queue.finish(ticket, "failed",
                              error=f"{type(exc).__name__}: "
                                    f"{str(exc)[:400]}",
                              results_dir=results_dir)
            logger.warning(
                "pert-serve: request %s failed (%s: %s) — worker "
                "continues", rid, kind, str(exc)[:200])
            return self._record(rid, "failed", wall,
                                bucket=bucket_info,
                                error=f"{type(exc).__name__}: "
                                      f"{str(exc)[:400]}",
                                run_log=run_log_path,
                                tenant=tenant,
                                retired_early=bool(
                                    slab_attrs.get("retired_early",
                                                   False)))
        except BaseException:
            # a real preemption/KeyboardInterrupt: the PROCESS is going
            # away — record what we can and propagate (the ticket stays
            # in active/, visibly orphaned, for the operator)
            self.request_drain()
            raise

        wall = time.perf_counter() - t0
        summary = summarize_run(run_log_path) or {}
        compile_cache = {
            k: (summary.get("compile") or {}).get(k)
            for k in ("programs", "cache_hits", "cache_misses",
                      "disk_hits", "hit_rate")
        }
        slab_attrs = self._slab_end_attrs(rid)
        self.worker_log.emit(
            "request_end", request_id=rid, status="ok",
            wall_seconds=round(wall, 4), bucket=bucket_info,
            run_log=run_log_path, results_dir=str(results_dir),
            compile_cache=compile_cache, tenant=tenant, **slab_attrs)
        self.queue.finish(ticket, "ok", results_dir=results_dir)
        logger.info(
            "pert-serve: request %s ok in %.1fs (bucket %s, compile "
            "%s hit / %s disk / %s miss)", rid, wall, bucket.name,
            compile_cache.get("cache_hits"),
            compile_cache.get("disk_hits"),
            compile_cache.get("cache_misses"))
        return self._record(rid, "ok", wall, bucket=bucket_info,
                            run_log=run_log_path,
                            compile_cache=compile_cache,
                            tenant=tenant,
                            retired_early=bool(
                                slab_attrs.get("retired_early", False)))

    def _run_pipeline(self, rid: str, df_s, df_g1, options: dict,
                      bucket, results_dir, run_log_path: str,
                      tracer=None, req_span=None) -> None:
        from scdna_replication_tools_tpu_torch.api import scRT

        trace_kwargs = {}
        if tracer is not None and req_span is not None:
            # the cross-process handoff: the request run's own span
            # tree (its 'run' root, every phase and fit chunk) carries
            # the ticket's trace id and parents under the worker's
            # request span — pert_trace stitches the two logs on it
            trace_kwargs = dict(
                trace_spans=True,
                trace_parent=tracer.trace_parent(req_span))
        scrt = scRT(
            df_s, df_g1,
            telemetry_path=run_log_path,
            checkpoint_dir=str(results_dir / "ckpt"),
            pad_cells_to=bucket.cells,
            pad_loci_to=bucket.loci,
            request_id=rid,
            slab_width=(self.max_batch if self.max_batch > 1 else None),
            executable_cache_dir=self.executable_cache_dir,
            device=self.device,
            **trace_kwargs,
            **options,
        )
        try:
            cn_s_out, supp_s, cn_g1_out, supp_g1 = scrt.infer(
                level="pert")
        except BaseException:
            self._cleanup_failed_request(scrt)
            raise
        stream_cm = tracer.span("stream_back", request_id=rid) \
            if tracer is not None else contextlib.nullcontext()
        with stream_cm:
            write = self._tsv.write
            write(cn_s_out, results_dir / "output.tsv")
            write(supp_s, results_dir / "supp.tsv")
            if cn_g1_out is not None and len(cn_g1_out):
                write(cn_g1_out, results_dir / "g1_output.tsv")
                write(supp_g1, results_dir / "g1_supp.tsv")
            if scrt._cell_qc_df is not None:
                write(scrt.cell_qc(), results_dir / "cell_qc.tsv")

    def _cleanup_failed_request(self, scrt) -> None:
        """A failed request must not leak process-global state into its
        successors: retire its registry from the install seam (on the
        success path the facade does this itself) and clear any fault
        plan its config installed — the next request's runner installs
        its own, but worker-level code between requests must not trip
        a dead tenant's chaos spec."""
        try:
            registry = getattr(scrt, "metrics_registry", None)
            if registry is not None:
                metrics_mod.uninstall(registry)
        except Exception:  # noqa: BLE001 — cleanup of a
            # failed request is best-effort by definition; the failure
            # itself is already being reported by the caller
            pass
        faults_mod.install(None)

    def _record(self, rid: str, status: str, wall: float,
                bucket=None, error=None, run_log=None,
                compile_cache=None,
                retired_early: bool = False,
                tenant: Optional[str] = None) -> RequestOutcome:
        return RequestOutcome(
            request_id=rid, status=status,
            wall_seconds=round(wall, 4), bucket=bucket, error=error,
            run_log=run_log, compile_cache=compile_cache,
            retired_early=retired_early, tenant=tenant)
