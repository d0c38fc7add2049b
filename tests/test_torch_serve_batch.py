"""The port's continuous batching (``ServeWorker(max_batch=2)``) against
its serial worker on the same burst, on the CPU.

The requests of the JAX ``tests/test_serve_batch.py`` burst at half the
request budgets, in another order: A (clean), B (clean, another cohort)
and C (``oom@step2/fit#1`` injected).  With two lanes, A and B share the
slab from the start (the port packs the enumerated steps 2 and 3 only,
so two lanes must reach them together), the first to finish retires
while its peer is still in flight, and C refills the vacancy and fails
alone.  Held: the fault fails C alone in both modes; A's and B's decoded
CN and replication states agree with the serial run's on at least 99 %
of bins, and their tau within 0.05 (packed lanes may part from a solo
fit by float32 rounding, which the controller's decisions can amplify;
ROADMAP C); the
``request_end`` events carry the slab facts (``retired_early``,
``slab_avg_occupancy`` >= 1) in batched mode only; the request logs
record ``slab_width``; the terminal ``status.json`` shows an empty slab
of width 2 whose fits were packed at least once, each packed dispatch
with two lanes; and the slab's occupancy gauge is back to 0.
"""

import json
import pathlib
import sys

import numpy as np
import pandas as pd
import pytest

from scdna_replication_tools_tpu_torch.obs.schema import validate_run
from scdna_replication_tools_tpu_torch.serve import (
    BucketSet,
    ServeWorker,
    SpoolQueue,
)
from scdna_replication_tools_tpu_torch.utils import faults

from test_torch_model import one_torch_thread  # noqa: F401

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                       / "tools"))
from test_serve import REQUEST_OPTIONS, _frames  # noqa: E402

AGREE = 0.99


@pytest.fixture(scope="module")
def burst(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve_batch")
    options = {**REQUEST_OPTIONS, "max_iter": 60, "min_iter": 20}
    sim_a, sim_b = _frames(seed=3), _frames(seed=11)
    submits = [("ba_clean", sim_a, {}),
               ("bb_clean", sim_b, {}),
               ("bc_oom", sim_a, {"faults": "oom@step2/fit#1"})]

    def arm(tag, max_batch):
        q = SpoolQueue(root / tag)
        for rid, sim, extra in submits:
            q.submit_frames(*sim, options={**options, **extra},
                            request_id=rid)
        w = ServeWorker(q, buckets=BucketSet(cells=(8, 16), loci=(64, 128)),
                        max_requests=len(submits), exit_when_idle=True,
                        max_batch=max_batch, device="cpu")
        stats = w.run()
        faults.install(None)
        return {"queue": q, "worker": w, "stats": stats,
                "by_id": {o.request_id: o for o in w.outcomes}}
    return {"serial": arm("serial", 1), "batched": arm("batched", 2)}


def _ends(arm):
    return {e["request_id"]: e for e in
            (json.loads(line) for line in
             open(arm["stats"]["worker_log"]).read().splitlines())
            if e["event"] == "request_end"}


def test_batched_isolates_the_fault_like_serial(burst):
    for tag in ("serial", "batched"):
        by_id = burst[tag]["by_id"]
        assert burst[tag]["stats"]["by_status"] == {"ok": 2, "failed": 1}
        assert by_id["ba_clean"].status == by_id["bb_clean"].status == "ok"
        assert by_id["bc_oom"].status == "failed"
        assert "RESOURCE_EXHAUSTED" in by_id["bc_oom"].error


@pytest.mark.parametrize("rid", ["ba_clean", "bb_clean"])
def test_batched_outputs_match_serial(burst, rid):
    s, b = (pd.read_csv(burst[k]["queue"].results_dir(rid) / "output.tsv",
                        sep="\t", dtype={"chr": str})
            for k in ("serial", "batched"))
    assert list(s.columns) == list(b.columns) and len(s) == len(b) > 0
    for col in ("model_cn_state", "model_rep_state"):
        agree = float((s[col] == b[col]).mean())
        assert agree >= AGREE, (col, agree)
    assert np.abs(s["model_tau"] - b["model_tau"]).max() < 0.05


def test_retirement_refill_and_occupancy(burst):
    ends = _ends(burst["batched"])
    assert set(ends) == {"ba_clean", "bb_clean", "bc_oom"}
    for e in ends.values():
        assert "retired_early" in e
        assert float(e["slab_avg_occupancy"]) >= 1.0
    # the first clean request to finish retires while its peer is in
    # flight, and C, claimed into its lane, overlaps the other
    assert any(o.retired_early for o in burst["batched"]["by_id"].values())
    assert max(float(e["slab_avg_occupancy"]) for e in ends.values()) > 1.0
    for e in _ends(burst["serial"]).values():
        assert "retired_early" not in e and "slab_avg_occupancy" not in e
    reg = burst["batched"]["worker"].registry
    assert reg.gauge("pert_serve_slab_occupancy").value == 0
    assert reg.gauge("pert_serve_batch_width").value == 2


def test_logs_schema_valid_and_record_the_slab_width(burst):
    for tag, width in (("serial", None), ("batched", 2)):
        arm = burst[tag]
        assert validate_run(arm["stats"]["worker_log"]) == []
        for rid in ("ba_clean", "bb_clean"):
            path = arm["queue"].results_dir(rid) / "run.jsonl"
            assert validate_run(path) == []
            start = json.loads(open(path).readline())
            assert start.get("slab_width") == width
            assert start["request_id"] == rid


def test_terminal_status_doc_shows_packed_fits(burst):
    doc = json.loads((burst["batched"]["queue"].root
                      / "status.json").read_text())
    slab = doc["slab"]
    assert slab["max_batch"] == 2
    assert slab["occupancy"] == 0 and slab["blocks"] == []
    assert slab["packed_dispatches"] >= 1
    assert slab["packed_lanes"] == 2 * slab["packed_dispatches"]
    assert slab["fit_dispatches"] >= slab["packed_dispatches"]
