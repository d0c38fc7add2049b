"""The port's cost ledger (``obs/meter.py``) against the JAX package's.

The same booking sequences into both ledgers (one device each) give the
same summaries, exactly: the port's module is a copy, and these pins
keep it one.  The invariant both hold, ``billed == effective +
sum(waste)``, is checked on every rollup, in a port run's ``run_end``
``meter`` section and in the serving slab's lane bookings (each live
lane books its 1/W share into its own ledger, the parked vacancies book
``retired_lane`` into the worker's).
"""

import json

import pytest
import torch

from scdna_replication_tools_tpu.obs import meter as jmeter
from scdna_replication_tools_tpu_torch.infer import svi as tsvi
from scdna_replication_tools_tpu_torch.obs import meter as tmeter
from scdna_replication_tools_tpu_torch.serve.slab import SlabFitCoordinator

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_slab import _call, _rendezvous


def _book_all(mod, case):
    led = mod.CostLedger(scope={"run": "t", "request": "r1"}, devices=1)
    if case == "all_kinds":
        with led.context(step="step2", bucket="c32xl64", cells=24,
                         pad_frac=0.25):
            led.book_chunk(entry_it=0, end_it=100, wall_seconds=2.0)
            led.book_chunk(entry_it=50, end_it=100, wall_seconds=0.5)
            led.book_compile(seconds=1.5)
            led.book_compile(seconds=0.3, deserialize=True)
            led.book_exec(kind="decode", seconds=0.8)
        with led.context(step="step3", bucket="c64xl64", cells=48):
            led.book_chunk(entry_it=0, end_it=50, wall_seconds=1.0)
        led.book_retired(seconds=2.0, device_share=0.25)
        led.book_queue_idle(seconds=0.7)
    elif case == "slab_lanes":
        ctx = {"step": "step2", "bucket": "c1024xl8192", "cells": 1000,
               "pad_frac": 0.3498}
        for entry, end in ((0, 25), (25, 50), (50, 62)):
            led.book_chunk(entry_it=entry, end_it=end, wall_seconds=0.41,
                           device_share=0.25, ctx=ctx, kind="slab_lane")
    else:  # overbooked waste is clamped to billed
        led.book(kind="x", wall_seconds=1.0,
                 waste={"padding": 3.0, "compile": 1.0})
    return led


@pytest.mark.parametrize("case", ["all_kinds", "slab_lanes", "overbooked"])
def test_ledger_summaries_equal_jax(case):
    t, j = _book_all(tmeter, case), _book_all(jmeter, case)
    assert t.summary() == j.summary()
    assert t.brief() == j.brief()
    # the summaries round seconds to 1e-6: conservation holds to that
    summary = t.summary()
    assert tmeter.conservation_gap(summary) < 1e-4
    for slot in list(summary["by_step"].values()) \
            + list(summary["by_bucket"].values()):
        assert tmeter.conservation_gap(slot) < 1e-4
    assert set(summary["waste_seconds"]) <= set(tmeter.WASTE_CATEGORIES)


def test_device_count_reads_cuda():
    assert tmeter.device_count() == max(torch.cuda.device_count(), 1)


def test_slab_books_each_lane_its_share_and_the_vacancy_as_waste():
    """Three live lanes in a rung of four: each lane's ledger books one
    slab_lane record at a quarter of the dispatch's device time with its
    own step context, and the worker ledger books the parked quarter as
    retired_lane."""
    coord = SlabFitCoordinator(4, window_seconds=2.0)
    worker = tmeter.CostLedger(scope={"worker": "t"}, devices=1)
    coord.meter_ledger = worker
    calls, ledgers = {}, {}
    for seed in (3, 11, 29):
        ledgers[seed] = tmeter.CostLedger(scope={"request": str(seed)},
                                          devices=1)
        call = _call(seed)
        call.meter = (ledgers[seed], {"step": "step2", "cells": 10,
                                      "bucket": "c8xl64"})
        calls[seed] = call
    box = _rendezvous(coord, calls)
    assert coord.packed_dispatches == 1 and coord.packed_lanes == 3
    assert all(not isinstance(v, BaseException) for v in box.values())
    billed = [ledgers[s].summary()["billed_device_seconds"]
              for s in (3, 11, 29)]
    assert len(set(billed)) == 1 and billed[0] > 0
    wsum = worker.summary()
    assert set(wsum["waste_seconds"]) == {"retired_lane"}
    assert wsum["waste_seconds"]["retired_lane"] == pytest.approx(
        billed[0], rel=1e-3, abs=1e-6)
    for s in (3, 11, 29):
        summary = ledgers[s].summary()
        assert summary["by_step"]["step2"]["cell_iters"] == 160
        assert tmeter.conservation_gap(summary) < 1e-4


def test_chunk_loop_books_solo_chunks_into_the_run_ledger(tmp_path):
    """A controlled fit on a thread whose run log carries a ledger books
    each chunk it runs alone (no dispatcher) with the ledger's context:
    the booked iterations are the fit's."""
    from scdna_replication_tools_tpu_torch.obs.runlog import RunLog
    from scdna_replication_tools_tpu_torch.obs.controller import (
        ControllerPolicy,
    )
    log = RunLog.create(str(tmp_path / "run.jsonl"))
    led = tmeter.CostLedger(scope={"run": "t"}, devices=1)
    log.meter_ledger = led
    params = {"x": torch.tensor([1.0, -2.0, 0.5, 3.0], dtype=torch.float32)}
    with log.session(), led.context(step="step1", cells=4):
        fit = tsvi.fit_map(lambda p, t: torch.sum((p["x"] - t) ** 2),
                           params, (torch.zeros(4, dtype=torch.float32),),
                           max_iter=60, min_iter=60, device="cpu",
                           diag_every=20,
                           controller=ControllerPolicy())
    summary = led.summary()
    assert summary["records"] == 3
    assert summary["cell_iters"] == 4 * fit.num_iters == 240
    end = json.loads(open(tmp_path / "run.jsonl").read().splitlines()[-1])
    assert end["event"] == "run_end" and end["meter"]["cell_iters"] == 240
