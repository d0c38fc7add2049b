"""Device-cost attribution ledger: the goodput/cost plane.

Port of ``obs/meter.py``, copied whole but for :func:`device_count`,
which counts CUDA devices.  The port books chunk walls measured on the
host at chunk boundaries, as the JAX package does, and no FLOPs (it has
no compiled-program cost analysis).

The observability stack measures *time* in several disconnected
currencies — spans (wall), ``cost_analysis`` stamps (FLOPs per
compiled program), slab occupancy, bucket ``pad_frac`` — but nothing
fuses them into the quantity the roadmap's autopilot is scored in:
**attributed device-seconds and goodput**.  This module is that fusion.

Model
-----
Every dispatched program execution (fit chunk, slab rung, decode/PPC
slab, compile) books one **cost record** into a :class:`CostLedger`:

* ``billed`` device-seconds: measured wall x device count x the lane's
  share of the dispatch (a W-wide slab bills each live lane 1/W);
* named **waste** categories decomposing the billed-minus-useful gap:

  - ``padding``       — ``pad_frac`` x billed (the bucket contract:
    padded cells/loci burn device time producing discarded planes);
  - ``retired_lane``  — parked slab lanes (a W-rung dispatch carrying
    n < W live lanes wastes (W-n)/W of its device time until refill);
  - ``compile``       — trace+compile wall (a whole-device stall);
  - ``compile_deserialize`` — the AOT store's disk-hit deserialize
    (restart cost, separated from true XLA compiles);
  - ``retry_refit``   — iterations re-fitted after a fault-ladder
    re-entry (NaN rewind, transient retry, resume overlap), detected
    by a per-step iteration high-water mark;
  - ``queue_idle``    — a serve worker's claim gaps (device paid for,
    nothing dispatched);

* ``effective`` device-seconds := billed - sum(waste) **by
  construction**, so the conservation invariant
  ``billed == effective + sum(waste)`` holds exactly per record, per
  scope and in every rollup — the contract ``tests/test_meter.py``
  pins and the CI meter smoke asserts over a real spool;
* effective work units: ``cell_iters`` = unpadded cells x iterations
  actually advanced (net of refits).  ``goodput`` =
  cell_iters / billed device-seconds — the cross-run objective
  function (`Efficiently Vectorized MCMC`, arXiv:2503.17405: once
  lanes retire early, wall time stops measuring useful work).

Wiring
------
The ledger rides the :mod:`obs.runlog` seam rather than a new install
stack: the owner (runner / serve worker) sets
``run_log.meter_ledger``, and the instrumentation sites resolve
``ledger_of(_runlog.current())`` — thread-local scoping (one request
pipeline per slab block thread) comes for free, and tracing-off runs
still meter.  ``book()`` is lock-protected because a slab *leader*
thread books lane records into its peers' ledgers.

Surfaces: the ``meter`` section of ``run_end`` (schema v9), the
manifest gauges ``pert_device_seconds_total`` /
``pert_waste_seconds_total{category}`` /
``pert_goodput_cell_iters_per_device_second``, the heartbeat's live
``goodput``/``waste_frac`` fields, and ``tools/pert_meter``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional

METER_VERSION = 1

#: the closed waste taxonomy (OBSERVABILITY.md "Cost & goodput").
#: ``compile_deserialize`` is the disk-hit arm of ``compile`` — kept a
#: separate category so restart cost never masquerades as XLA cost.
WASTE_CATEGORIES = ("padding", "retired_lane", "compile",
                    "compile_deserialize", "retry_refit", "queue_idle")


def device_count() -> int:
    """Local CUDA device count, 1 without a GPU (a run on the CPU, or a
    tool reading logs, books one device)."""
    try:
        import torch

        return max(int(torch.cuda.device_count()), 1)
    except Exception:  # noqa: BLE001 — no CUDA runtime means a
        # one-device cost model; the absent topology is the record
        return 1


class _Slot:
    """One aggregation cell: billed/effective seconds, waste decomposed
    by category, effective cell-iterations, program FLOPs."""

    __slots__ = ("billed", "effective", "waste", "cell_iters", "flops",
                 "records")

    def __init__(self):
        self.billed = 0.0
        self.effective = 0.0
        self.waste: Dict[str, float] = {}
        self.cell_iters = 0.0
        self.flops = 0.0
        self.records = 0

    def add(self, billed: float, waste: Dict[str, float],
            cell_iters: float, flops: float) -> None:
        self.billed += billed
        self.effective += billed - sum(waste.values())
        for cat, sec in waste.items():
            if sec > 0.0:
                self.waste[cat] = self.waste.get(cat, 0.0) + sec
        self.cell_iters += cell_iters
        self.flops += flops
        self.records += 1

    def to_dict(self) -> dict:
        total_waste = sum(self.waste.values())
        out = {
            "billed_device_seconds": round(self.billed, 6),
            "effective_device_seconds": round(self.effective, 6),
            "waste_seconds": {k: round(v, 6)
                              for k, v in sorted(self.waste.items())},
            "waste_frac": round(total_waste / self.billed, 6)
            if self.billed > 0 else 0.0,
            "cell_iters": round(self.cell_iters, 2),
            "records": self.records,
        }
        if self.flops:
            out["flops"] = self.flops
        if self.billed > 0:
            out["goodput_cell_iters_per_device_second"] = round(
                self.cell_iters / self.billed, 3)
        return out


class CostLedger:
    """Attributed device-cost accumulator for one scope (a run, a serve
    request, or a worker session).

    ``scope`` identifies the owner in summaries (e.g. ``{"run": name}``
    or ``{"request": rid, "tenant": t}``); ``devices`` overrides the
    probed device count (tests, offline replay).  Thread-safe: slab
    leaders book into peers' ledgers.
    """

    def __init__(self, scope: Optional[dict] = None,
                 devices: Optional[int] = None):
        self.scope = dict(scope or {})
        self.devices = int(devices) if devices else device_count()
        # the metrics registry this ledger feeds (set by the owner,
        # exactly like RunLog.metrics_registry); None = process-global
        # seam fallback at book time
        self.metrics_registry = None
        self._lock = threading.Lock()
        self._total = _Slot()
        self._by_step: Dict[str, _Slot] = {}
        self._by_bucket: Dict[str, _Slot] = {}
        # per-step fitted-iteration high-water: iterations at or below
        # it have been fitted before — re-running them (NaN rewind,
        # fault-ladder re-entry) is retry_refit waste, not fresh work
        self._iter_high: Dict[str, int] = {}
        # booking context (step/bucket/cells/pad_frac/phase): plain
        # per-ledger fields — the owning pipeline runs its fits
        # sequentially, and cross-thread bookings (slab leader) carry
        # an explicit snapshot on the ChunkCall instead
        self._ctx: dict = {}

    # -- booking context --------------------------------------------------

    @contextlib.contextmanager
    def context(self, **fields):
        """Scope booking attribution: ``step``, ``bucket``, ``cells``
        (real, unpadded), ``pad_frac``, ``phase``.  Nested contexts
        overlay; booking sites read the innermost values."""
        prev = dict(self._ctx)
        self._ctx.update({k: v for k, v in fields.items()
                          if v is not None})
        try:
            yield self
        finally:
            self._ctx = prev

    def ctx_snapshot(self) -> dict:
        """The current booking context, for cross-thread handoff (the
        slab leader books with the lane's snapshot, not its own)."""
        return dict(self._ctx)

    # -- core booking -----------------------------------------------------

    def book(self, *, kind: str, wall_seconds: float,
             device_share: float = 1.0,
             waste: Optional[Dict[str, float]] = None,
             cell_iters: float = 0.0, flops: float = 0.0,
             ctx: Optional[dict] = None) -> dict:
        """Book one cost record.  ``billed`` = wall x devices x share;
        ``waste`` maps :data:`WASTE_CATEGORIES` names to device-second
        amounts (clamped so they never exceed billed — conservation is
        by construction); the remainder is effective.  Returns the
        normalized record (tests consume it)."""
        ctx = self._ctx if ctx is None else ctx
        billed = max(float(wall_seconds), 0.0) * self.devices \
            * max(float(device_share), 0.0)
        waste = {k: max(float(v), 0.0) for k, v in (waste or {}).items()
                 if v and float(v) > 0.0}
        total_waste = sum(waste.values())
        if total_waste > billed > 0.0:
            scale = billed / total_waste
            waste = {k: v * scale for k, v in waste.items()}
        elif total_waste > 0.0 and billed <= 0.0:
            waste = {}
        record = {
            "kind": str(kind),
            "step": ctx.get("step"),
            "bucket": ctx.get("bucket"),
            "billed_device_seconds": billed,
            "effective_device_seconds": billed - sum(waste.values()),
            "waste": waste,
            "cell_iters": max(float(cell_iters), 0.0),
            "flops": max(float(flops), 0.0),
        }
        with self._lock:
            self._total.add(billed, waste, record["cell_iters"],
                            record["flops"])
            if record["step"]:
                self._by_step.setdefault(
                    str(record["step"]), _Slot()).add(
                        billed, waste, record["cell_iters"],
                        record["flops"])
            if record["bucket"]:
                self._by_bucket.setdefault(
                    str(record["bucket"]), _Slot()).add(
                        billed, waste, record["cell_iters"],
                        record["flops"])
        self._export(billed, waste)
        return record

    # -- typed booking entry points ---------------------------------------

    def book_chunk(self, *, entry_it: int, end_it: int,
                   wall_seconds: float, device_share: float = 1.0,
                   flops: float = 0.0, ctx: Optional[dict] = None,
                   kind: str = "chunk") -> dict:
        """One fit dispatch (solo chunk, slab lane, or a whole-budget
        fit): decomposes billed time into padding waste (the bucket
        contract's ``pad_frac``), retry_refit waste (iterations at or
        below the step's high-water — they were fitted before) and
        effective work, and credits ``cells x fresh_iters`` work units.
        """
        ctx = self._ctx if ctx is None else ctx
        entry_it = max(int(entry_it), 0)
        end_it = max(int(end_it), entry_it)
        iters = end_it - entry_it
        step = str(ctx.get("step") or "fit")
        with self._lock:
            high = self._iter_high.get(step, 0)
            fresh = max(end_it - max(entry_it, high), 0)
            if end_it > high:
                self._iter_high[step] = end_it
        refit = iters - fresh
        pad_frac = min(max(float(ctx.get("pad_frac") or 0.0), 0.0), 1.0)
        billed = max(float(wall_seconds), 0.0) * self.devices \
            * max(float(device_share), 0.0)
        waste: Dict[str, float] = {}
        if pad_frac > 0.0:
            waste["padding"] = pad_frac * billed
        if refit > 0 and iters > 0:
            # the refitted share of the non-padding time: those
            # iterations produced values the trajectory already had
            waste["retry_refit"] = (1.0 - pad_frac) * billed \
                * (refit / iters)
        cells = float(ctx.get("cells") or 0.0)
        return self.book(kind=kind, wall_seconds=wall_seconds,
                         device_share=device_share, waste=waste,
                         cell_iters=cells * fresh, flops=flops, ctx=ctx)

    def book_compile(self, *, seconds: float, deserialize: bool = False,
                     flops: float = 0.0,
                     ctx: Optional[dict] = None) -> dict:
        """Trace+compile wall (or, with ``deserialize=True``, the AOT
        store's disk-hit deserialize) — billed whole-device, all waste:
        no model work advances while XLA (or the deserializer) runs."""
        cat = "compile_deserialize" if deserialize else "compile"
        billed = max(float(seconds), 0.0) * self.devices
        return self.book(kind=cat, wall_seconds=seconds,
                         waste={cat: billed}, flops=flops, ctx=ctx)

    def book_exec(self, *, kind: str, seconds: float,
                  flops: float = 0.0,
                  ctx: Optional[dict] = None) -> dict:
        """A non-fit program execution (decode/PPC slab, QC pass):
        padding waste per the bucket contract, the rest effective
        (no iteration work units — goodput counts fit progress)."""
        ctx = self._ctx if ctx is None else ctx
        pad_frac = min(max(float(ctx.get("pad_frac") or 0.0), 0.0), 1.0)
        billed = max(float(seconds), 0.0) * self.devices
        waste = {"padding": pad_frac * billed} if pad_frac > 0.0 else {}
        return self.book(kind=kind, wall_seconds=seconds, waste=waste,
                         flops=flops, ctx=ctx)

    def book_retired(self, *, seconds: float, device_share: float,
                     ctx: Optional[dict] = None) -> dict:
        """Parked slab lanes: a W-rung dispatch with n live lanes burns
        (W-n)/W of its device time on vacated blocks until refill."""
        billed = max(float(seconds), 0.0) * self.devices \
            * max(float(device_share), 0.0)
        return self.book(kind="retired_lane", wall_seconds=seconds,
                         device_share=device_share,
                         waste={"retired_lane": billed}, ctx=ctx)

    def book_queue_idle(self, *, seconds: float) -> dict:
        """A serve worker's claim gap: the device sat idle between the
        previous request's retirement and the next claim."""
        billed = max(float(seconds), 0.0) * self.devices
        return self.book(kind="queue_idle", wall_seconds=seconds,
                         waste={"queue_idle": billed}, ctx={})

    # -- export seams ------------------------------------------------------

    def _export(self, billed: float, waste: Dict[str, float]) -> None:
        """Feed the manifest gauges + the live heartbeat, best-effort —
        cost accounting must never cost the run it accounts."""
        try:
            from scdna_replication_tools_tpu_torch.obs import (
                metrics as _metrics,
            )

            registry = self.metrics_registry \
                if self.metrics_registry is not None \
                else _metrics.current()
            if billed > 0:
                registry.counter("pert_device_seconds_total").inc(billed)
            for cat, sec in waste.items():
                registry.counter("pert_waste_seconds_total",
                                 labels={"category": cat}).inc(sec)
            with self._lock:
                total_billed = self._total.billed
                cell_iters = self._total.cell_iters
                waste_total = sum(self._total.waste.values())
            if total_billed > 0:
                registry.gauge(
                    "pert_goodput_cell_iters_per_device_second").set(
                        round(cell_iters / total_billed, 3))
        except Exception:  # pertlint: disable=PL011 — a half-torn
            # registry must not take down the dispatch being metered;
            # the ledger totals above are already committed
            return
        try:
            from scdna_replication_tools_tpu_torch.obs import (
                heartbeat as _heartbeat,
            )

            hb = _heartbeat.current()
            if hb is not None and total_billed > 0:
                hb.note(goodput=round(cell_iters / total_billed, 3),
                        waste_frac=round(waste_total / total_billed, 4))
        except Exception:  # pertlint: disable=PL011 — the heartbeat is
            # a best-effort live surface; the durable summary stands
            pass

    # -- read side --------------------------------------------------------

    def totals(self) -> dict:
        """The global rollup slot as a dict (conservation holds:
        billed == effective + sum(waste_seconds))."""
        with self._lock:
            return self._total.to_dict()

    def brief(self) -> dict:
        """The live-surface digest (worker status.json, heartbeats)."""
        t = self.totals()
        return {
            "billed_device_seconds": t["billed_device_seconds"],
            "effective_device_seconds": t["effective_device_seconds"],
            "goodput_cell_iters_per_device_second":
                t.get("goodput_cell_iters_per_device_second"),
            "waste_frac": t["waste_frac"],
        }

    def summary(self) -> dict:
        """The durable ``meter`` section (run_end / manifest / tools)."""
        with self._lock:
            by_step = {k: s.to_dict()
                       for k, s in sorted(self._by_step.items())}
            by_bucket = {k: s.to_dict()
                         for k, s in sorted(self._by_bucket.items())}
            total = self._total.to_dict()
        return {
            "version": METER_VERSION,
            "scope": dict(self.scope),
            "devices": self.devices,
            **total,
            "by_step": by_step,
            "by_bucket": by_bucket,
        }


def ledger_of(run_log) -> Optional[CostLedger]:
    """The ledger riding a RunLog (``run_log.meter_ledger``), or None.

    The instrumentation seam: booking sites resolve
    ``ledger_of(_runlog.current())`` so thread-local request scoping
    (one RunLog session per slab block thread) carries over verbatim.
    """
    return getattr(run_log, "meter_ledger", None)


def conservation_gap(meter: dict) -> float:
    """Relative conservation error of one meter summary/rollup dict:
    ``|billed - effective - sum(waste)| / max(billed, eps)``.  The CLI
    and the CI smoke assert this stays under 1%."""
    billed = float(meter.get("billed_device_seconds") or 0.0)
    effective = float(meter.get("effective_device_seconds") or 0.0)
    waste = sum(float(v) for v in
                (meter.get("waste_seconds") or {}).values())
    return abs(billed - effective - waste) / max(billed, 1e-9)
