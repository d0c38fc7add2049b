"""Slab scheduling state for the batched serving worker.

Port of ``serve/slab.py``: the membership and occupancy ledger and the
coordinator as in JAX.  A packed group goes through the port's
``infer/svi.dispatch_chunk_slab`` (one launch per iteration for the
group, one host read), a singleton through its own solo chunk; the
port's chunks return after their host read, so a dispatch's wall is
complete when it returns, and the booking thunks only book.

Continuous batching (serve/worker.py ``max_batch > 1``) runs up to K
same-bucket-rung requests as concurrent BLOCKS of one slab: each block
is a full per-request pipeline (own RunLog, metrics registry, fault
plan — all thread-local seams), all blocks share the worker's one
compiled program set because the bucket ladder pads them to identical
shapes.  A block that converges retires at its next chunk boundary and
streams back while the remainder keeps fitting; a vacated block is
refilled from the spool at the next claim — the way vectorized-MCMC
ensembles retire converged chains without stalling the rest
(arXiv:2503.17405).

This module owns the bookkeeping the worker and the observability
surfaces need about that slab:

* **membership** — which requests occupy blocks right now
  (status.json's ``slab.blocks``), and the slab's bucket RUNG (the
  first admitted block's bucket pins it; claims prefer hint-matching
  tickets while any block is live);
* **occupancy accounting** — a time-weighted occupancy integral per
  block.  ``avg_occupancy`` over a request's residency is what lets
  the ``pert_trace`` waterfall attribute SHARED fit wall-time
  per-request (``fit / avg_occupancy``) instead of double-counting K
  concurrent blocks' overlapping seconds;
* **retirement facts** — ``retired_early`` (the block finished while
  ≥1 peer kept fitting) for the ``request_end`` event and the
  request outcome.

Thread-safe: block threads admit/retire concurrently; the status
heartbeat reads while they do.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from scdna_replication_tools_tpu_torch.infer import svi as _svi

class _Block:
    __slots__ = ("request_id", "started_unix", "started_perf",
                 "occ_integral", "last_perf", "bucket")

    def __init__(self, request_id: str):
        self.request_id = request_id
        self.started_unix = round(time.time(), 3)
        self.started_perf = time.perf_counter()
        self.occ_integral = 0.0
        self.last_perf = self.started_perf
        self.bucket: Optional[str] = None


class SlabState:
    """Membership + occupancy ledger of one worker's slab."""

    def __init__(self, max_batch: int = 1):
        self.max_batch = int(max_batch)
        self._lock = threading.Lock()
        self._blocks: Dict[str, _Block] = {}
        # the slab's bucket rung: pinned by the first block whose
        # admission resolves a bucket, cleared when the slab empties —
        # the claim predicate steers same-rung tickets in while set
        self.rung: Optional[str] = None

    # -- occupancy integral ----------------------------------------------

    def _advance(self, now_perf: float) -> None:
        occ = len(self._blocks)
        for block in self._blocks.values():
            block.occ_integral += occ * (now_perf - block.last_perf)
            block.last_perf = now_perf

    # -- membership -------------------------------------------------------

    def admit(self, request_id: str) -> None:
        with self._lock:
            self._advance(time.perf_counter())
            self._blocks[request_id] = _Block(request_id)

    def set_bucket(self, request_id: str, bucket_name: str) -> None:
        """Record the admitted block's bucket; the first one pins the
        slab rung."""
        with self._lock:
            block = self._blocks.get(request_id)
            if block is not None:
                block.bucket = bucket_name
            if self.rung is None:
                self.rung = bucket_name

    def retire(self, request_id: str) -> dict:
        """Remove the block and return its residency facts:
        ``avg_occupancy`` (time-weighted blocks co-resident over this
        request's life, >= 1), ``peers_at_exit`` and
        ``retired_early``."""
        with self._lock:
            now = time.perf_counter()
            self._advance(now)
            block = self._blocks.pop(request_id, None)
            peers = len(self._blocks)
            if not self._blocks:
                self.rung = None
            if block is None:
                return {"avg_occupancy": 1.0, "peers_at_exit": peers,
                        "retired_early": False}
            wall = max(now - block.started_perf, 1e-9)
            return {
                "avg_occupancy": round(max(block.occ_integral / wall,
                                           1.0), 4),
                "peers_at_exit": peers,
                "retired_early": peers > 0,
            }

    # -- read surfaces ----------------------------------------------------

    def occupancy(self) -> int:
        with self._lock:
            return len(self._blocks)

    def describe(self) -> dict:
        """status.json's ``slab`` payload: configured width, live
        occupancy, the pinned rung and per-block membership."""
        with self._lock:
            now = time.time()
            return {
                "max_batch": self.max_batch,
                "occupancy": len(self._blocks),
                "rung": self.rung,
                "blocks": [{
                    "request_id": b.request_id,
                    "bucket": b.bucket,
                    "started_unix": b.started_unix,
                    "age_seconds": round(
                        max(now - b.started_unix, 0.0), 3),
                } for b in self._blocks.values()],
            }


_UNSET = object()


class _PendingChunk:
    __slots__ = ("call", "result", "error", "done", "book")

    def __init__(self, call):
        self.call = call
        self.result = _UNSET
        self.error: Optional[BaseException] = None
        self.done = False
        # cost-attribution thunk stamped by the leader, run by the
        # OWNING lane thread after ``done``, so peers arriving meanwhile
        # find the rendezvous open; it holds host values only (a thunk
        # holding the entry would make a cycle that pins the chunk's
        # entry state on the card until a full garbage collection)
        self.book = None


class SlabFitCoordinator:
    """Cross-thread rendezvous that packs concurrent chunk dispatches
    into one device slab — the fit engine of continuous batching.

    Installed per block thread via ``svi.set_chunk_dispatcher``; the
    chunked fit driver then hands every chunk over as a ``ChunkCall``.
    The barrier: a dispatching thread waits until every thread currently
    inside a fit (``fit_begin``/``fit_end`` bracket) has a chunk pending
    — or its rendezvous window, which restarts while any peer's chunk
    is executing, expires — then elects itself leader, takes the pending
    set, groups it by ``ChunkCall.signature()`` and advances each
    group:

    * groups of >= 2 go through ``svi.dispatch_chunk_slab`` — ONE
      vectorized dispatch at the power-of-two width rung covering the
      group (vacancies within a rung padded as parked lanes), so the
      whole slab advances on one bounded ladder of compiled programs;
    * singletons use the call's own ``solo`` program — bit-identical
      with serial mode (the documented occupancy-1 guarantee);
    * a slab dispatch that fails as a unit is retried lane-by-lane solo,
      so one lane's poison (or an unpackable signature slipping through)
      degrades THAT lane only — per-request fault isolation holds.

    Retirement and refill fall out of the bracket: a converged request's
    driver exits the fit (``fit_end`` drops it from the barrier count)
    and decodes while the remainder keeps dispatching; a freshly claimed
    request's first ``fit_begin`` joins it to the next rendezvous.
    """

    def __init__(self, width: int, window_seconds: float = 0.1):
        self.width = max(int(width), 1)
        self.window_seconds = float(window_seconds)
        self._cv = threading.Condition(threading.Lock())
        self._fitting = 0    # threads inside a chunked fit
        self._executing = 0  # pending entries taken by a live leader
        self._pending: List[_PendingChunk] = []
        # counters for the status surface / tests
        self.dispatches = 0        # leader executions
        self.packed_dispatches = 0  # slab-program dispatches (>= 2 lanes)
        self.packed_lanes = 0      # lanes advanced by slab dispatches
        # the WORKER-session cost ledger (obs/meter.py), attached by the
        # serve worker: parked-lane device time — a rung dispatched
        # wider than its live lane count — is the slab's own waste, not
        # any request's, so it books here as ``retired_lane``
        self.meter_ledger = None

    # -- driver bracket ---------------------------------------------------

    def fit_begin(self) -> None:
        with self._cv:
            self._fitting += 1
            self._cv.notify_all()

    def fit_end(self) -> None:
        with self._cv:
            self._fitting -= 1
            self._cv.notify_all()

    # -- dispatch ---------------------------------------------------------

    def _barrier_met_locked(self) -> bool:
        # every thread inside a fit counts, those whose chunk a leader is
        # executing too: a port dispatch holds its thread for the whole
        # chunk (launches paced by the host, then the read), so a lane
        # that went solo beside an executing peer would stay out of step
        # with it for the rest of the fit and never pack (JAX's
        # dispatches return at once, so JAX discounts executing lanes)
        waiting = max(self._fitting, 1)
        return len(self._pending) >= min(waiting, self.width)

    def dispatch(self, call):
        entry = _PendingChunk(call)
        deadline = time.monotonic() + self.window_seconds
        with self._cv:
            self._pending.append(entry)
            self._cv.notify_all()
        while not entry.done:
            batch: Optional[List[_PendingChunk]] = None
            with self._cv:
                while not entry.done:
                    if self._pending and (self._barrier_met_locked()
                                          or time.monotonic() >= deadline):
                        # take at most width entries — the configured
                        # slab cap bounds the dispatch rung ladder
                        # (oldest first, so the taker's own entry is
                        # included unless > width peers preceded it)
                        batch = self._pending[:self.width]
                        self._pending = self._pending[self.width:]
                        self._executing += len(batch)
                        break
                    if self._executing:
                        # the window runs from the last peer's return:
                        # a peer still executing re-arrives within it
                        deadline = time.monotonic() + self.window_seconds
                    self._cv.wait(min(
                        max(deadline - time.monotonic(), 0.001), 0.02))
            if batch is None:
                break
            try:
                self._execute(batch)
            finally:
                with self._cv:
                    self._executing -= len(batch)
                    for e in batch:
                        e.done = True
                    self._cv.notify_all()
        if entry.error is not None:
            raise entry.error
        if entry.result is _UNSET:
            raise RuntimeError("slab coordinator dropped a chunk dispatch")
        book, entry.book = entry.book, None
        if book is not None:
            try:  # lane-side cost booking
                book()
            except Exception:  # noqa: BLE001 — metering
                # must never fail a dispatch whose result is committed
                pass
        return entry.result

    # -- leader path (no coordinator lock held) ---------------------------

    def _execute(self, batch: List[_PendingChunk]) -> None:
        self.dispatches += 1
        groups: Dict[object, List[_PendingChunk]] = {}
        order: List[object] = []
        for e in batch:
            try:
                key = e.call.signature()
            except Exception:  # noqa: BLE001 — an
                # unpackable signature is a supported shape, not a
                # fault: the unique key routes the call to its own
                # solo dispatch below, where any real error surfaces
                key = ("unpackable", id(e))
            if key not in groups:
                groups[key] = []
                order.append(key)
            groups[key].append(e)
        for key in order:
            group = groups[key]
            if len(group) >= 2:
                try:
                    slab_timings: dict = {}
                    t0 = time.perf_counter()
                    outs = _svi.dispatch_chunk_slab(
                        [e.call for e in group], self.width,
                        timings=slab_timings)
                    for e, out in zip(group, outs):
                        e.result = out
                    self.packed_dispatches += 1
                    self.packed_lanes += len(group)
                    # metering runs on the LEAD lane's thread, off the
                    # leader's path: peers arriving meanwhile must find
                    # the rendezvous open, not a leader still booking
                    group[0].book = self._slab_book_thunk(
                        group, outs, t0, slab_timings)
                    continue
                except BaseException:  # noqa: BLE001 — not
                    # a swallow: the slab failed as a UNIT (a refused
                    # operand, a pack mismatch), so every
                    # lane retries solo below and a real per-lane
                    # error surfaces there, attributed to its own
                    # request instead of the whole slab
                    pass
            for e in group:
                try:
                    t0 = time.perf_counter()
                    e.result = e.call.solo(e.call.args)
                    if e.call.meter is not None:
                        e.book = self._solo_book_thunk(e, t0)
                except BaseException as exc:  # noqa: BLE001
                    # — not a swallow: ``dispatch`` re-raises
                    # ``entry.error`` on the owning block thread, whose
                    # request pipeline reports it (fault isolation)
                    e.error = exc

    def _slab_book_thunk(self, group, outs, t0: float,
                         slab_timings: dict):
        # the slab's host read has waited for the card: the wall is
        # complete at dispatch return
        wall = time.perf_counter() - t0
        lanes = [(e.call.meter, int(e.call.args[4]), int(out[2].i))
                 for e, out in zip(group, outs)]
        flops = float(slab_timings.get("flops") or 0.0)

        def _book():
            self._book_slab(lanes, wall, flops)
        return _book

    def _solo_book_thunk(self, e, t0: float):
        wall = time.perf_counter() - t0
        (ledger, ctx), entry_it = e.call.meter, int(e.call.args[4])
        end_it = int(e.result[2].i)

        def _book():
            ledger.book_chunk(entry_it=entry_it, end_it=end_it,
                              wall_seconds=wall, ctx=ctx, kind="chunk")
        return _book

    def _book_slab(self, lanes, wall: float, flops: float) -> None:
        """Attribute one packed dispatch's device time: the W-wide rung
        bills wall x devices split W ways — each live lane (``lanes``:
        its meter, entry and end iterations) books its 1/W share
        (padding + retry_refit decomposed by ITS ledger with ITS booking
        context), the (W - n) parked vacancies book as ``retired_lane``
        waste on the worker-session ledger.  Best-effort by contract:
        metering must never fail a dispatch whose results are already
        committed."""
        try:
            W = 2
            while W < len(lanes):
                W *= 2
            for meter, entry_it, end_it in lanes:
                if meter is None:
                    continue
                ledger, ctx = meter
                ledger.book_chunk(
                    entry_it=entry_it, end_it=end_it, wall_seconds=wall,
                    device_share=1.0 / W, flops=flops / W, ctx=ctx,
                    kind="slab_lane")
            parked = W - len(lanes)
            if parked > 0 and self.meter_ledger is not None:
                # attribute the vacancy to the slab's rung so the
                # by_bucket rollup shows WHERE refill lagged
                lead_ctx = (lanes[0][0] or (None, {}))[1]
                self.meter_ledger.book_retired(
                    seconds=wall, device_share=parked / W,
                    ctx={"bucket": lead_ctx.get("bucket")})
        except Exception:  # noqa: BLE001 — a torn ledger
            # (request retired mid-book) costs the record, not the fit
            return
