"""The port's serving worker (``serve/worker.py``, serial) against the JAX
package's, on the same tiny spool.

Both workers drain the same three requests (clean, ``oom@step2/fit#1``
injected, clean on another cohort) plus one above the largest bucket,
the JAX one with ``executable_cache_dir=None`` (its default 'auto'
switches the compiled-program store on for the whole process), the
port's on the CPU.  Held equal: every ticket's terminal state, status
and the faulted request's error class, the bucket chosen and its
``pad_frac``, the result files each request streamed back, the
``request_start``/``request_end`` fields that do not depend on time,
and the keys of ``status.json``; the clean requests' decoded CN and
replication states agree on at least 99 % of bins (the packages'
float32 trajectories differ in rounding; ROADMAP C).  Then the port
alone: the request logs schema-valid with their ``request_id``, the
worker log's lifecycle pairs, drain on a shutdown signal, the
compiled-program store's rule and the GPU default.
"""

import json
import pathlib
import signal
import sys
import threading
import time

import numpy as np
import pandas as pd
import pytest
import torch

from scdna_replication_tools_tpu.serve import BucketSet as JBucketSet
from scdna_replication_tools_tpu.serve import ServeWorker as JServeWorker
from scdna_replication_tools_tpu.serve import SpoolQueue as JSpoolQueue
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

CELLS, LOCI = (8, 16), (64, 128)
AGREE = 0.99
# request_start / request_end fields that depend on time or on paths
TIMED = {"seq", "t", "wall_seconds", "queue_wait_seconds", "queue_depth",
         "run_log", "results_dir", "compile_cache", "span", "error"}


def _submit(q, sim_a, sim_b, big):
    q.submit_frames(*sim_a, options=REQUEST_OPTIONS, request_id="r1")
    q.submit_frames(*sim_a, options={**REQUEST_OPTIONS,
                                     "faults": "oom@step2/fit#1"},
                    request_id="r2")
    q.submit_frames(*sim_b, options=REQUEST_OPTIONS, request_id="r3")
    q.submit_frames(*big, options=REQUEST_OPTIONS, request_id="r4")


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_serve")
    sim_a, sim_b = _frames(seed=3), _frames(seed=11)
    big = _frames(num_loci=256, cells_per_clone=3, seed=5)
    arms = {}
    for tag, Q, W, B, kw in (
            ("jax", JSpoolQueue, JServeWorker, JBucketSet,
             dict(executable_cache_dir=None)),
            ("torch", SpoolQueue, ServeWorker, BucketSet,
             dict(device="cpu"))):
        q = Q(root / tag)
        _submit(q, sim_a, sim_b, big)
        w = W(q, buckets=B(cells=CELLS, loci=LOCI), max_requests=4,
              exit_when_idle=True, **kw)
        stats = w.run()
        faults.install(None)
        events = [json.loads(line) for line in
                  open(stats["worker_log"]).read().splitlines()]
        arms[tag] = {"queue": q, "worker": w, "stats": stats,
                     "events": events}
    return arms


def test_ticket_outcomes_equal_jax(served):
    for arm in served.values():
        assert arm["stats"]["by_status"] == {"ok": 2, "failed": 1,
                                             "refused": 1}
    for rid in ("r1", "r2", "r3", "r4"):
        t, j = (served[k]["queue"].status(rid) for k in ("torch", "jax"))
        assert (t["state"], t["status"]) == (j["state"], j["status"]), rid
    err = served["torch"]["queue"].status("r2")["error"]
    assert "RESOURCE_EXHAUSTED" in err
    assert "exceeds the largest bucket" in \
        served["torch"]["queue"].status("r4")["error"]


def _lifecycle(events):
    out = {}
    for e in events:
        if e["event"] in ("request_start", "request_end"):
            out[(e["request_id"], e["event"])] = {
                k: v for k, v in e.items() if k not in TIMED}
    return out


def test_request_lifecycle_events_equal_jax(served):
    t = _lifecycle(served["torch"]["events"])
    j = _lifecycle(served["jax"]["events"])
    assert t == j
    starts = {k[0]: v for k, v in t.items() if k[1] == "request_start"}
    assert starts["r1"]["bucket"] == {"name": "c8xl64", "cells": 8,
                                      "loci": 64}
    assert starts["r1"]["pad_frac"] > 0


def test_results_streamed_back_equal_jax(served):
    for rid in ("r1", "r2", "r3"):
        files = [sorted(p.name for p in served[k]["queue"].results_dir(rid)
                        .glob("*") if p.is_file())
                 for k in ("torch", "jax")]
        assert files[0] == files[1], rid
    assert {"output.tsv", "supp.tsv", "cell_qc.tsv", "run.jsonl"} <= set(
        p.name for p in served["torch"]["queue"].results_dir("r1").glob("*"))


@pytest.mark.parametrize("rid", ["r1", "r3"])
def test_served_outputs_decode_as_jax(served, rid):
    t, j = (pd.read_csv(served[k]["queue"].results_dir(rid) / "output.tsv",
                        sep="\t", dtype={"chr": str})
            for k in ("torch", "jax"))
    keys = ["cell_id", "chr", "start"]
    m = pd.merge(t, j, on=keys, suffixes=("_t", "_j"))
    assert len(m) == len(t) == len(j) > 0
    for col in ("model_cn_state", "model_rep_state"):
        agree = float((m[f"{col}_t"] == m[f"{col}_j"]).mean())
        assert agree >= AGREE, (col, agree)
    tau = m.groupby("cell_id")[["model_tau_t", "model_tau_j"]].first()
    assert np.corrcoef(tau["model_tau_t"], tau["model_tau_j"])[0, 1] > 0.95


def test_status_document_keys_equal_jax(served):
    docs = [json.loads(served[k]["queue"].status_path.read_text())
            for k in ("torch", "jax")]
    assert set(docs[0]) == set(docs[1])
    assert set(docs[0]["slab"]) == set(docs[1]["slab"])
    assert docs[0]["state"] == docs[1]["state"] == "stopped"
    # the store under the spool (JAX's 'auto'); fits on the CPU capture
    # no program and build no kernel library, so the warm-up captured
    # nothing again (its seconds aside)
    block = dict(docs[0]["executable_cache"])
    assert block.pop("precapture_seconds") >= 0
    assert block == {
        "dir": str(served["torch"]["queue"].root / "exec_cache"),
        "preloaded": 0, "entries": 0, "done": True, "programs": 0,
        "program_bytes": 0, "precaptured": 0,
        "precaptured_key_hashes": [], "programs_released": 0,
        "peak_program_bytes": 0}
    assert docs[0]["buckets_served"] == docs[1]["buckets_served"]


def test_request_and_worker_logs(served):
    arm = served["torch"]
    assert validate_run(arm["stats"]["worker_log"]) == []
    for rid in ("r1", "r2", "r3"):
        path = arm["queue"].results_dir(rid) / "run.jsonl"
        assert validate_run(path) == [], rid
        start = json.loads(open(path).readline())
        assert start["request_id"] == rid and "slab_width" not in start
        end = json.loads(open(path).read().splitlines()[-1])
        assert end["event"] == "run_end"
        assert end["status"] == ("error" if rid == "r2" else "ok")
        if rid != "r2":
            # the request's own cost ledger, scoped to it
            assert end["meter"]["scope"] == {"run": "pert", "request": rid}
            assert end["meter"]["cell_iters"] > 0
    starts = [e["request_id"] for e in arm["events"]
              if e["event"] == "request_start"]
    ends = [e["request_id"] for e in arm["events"]
            if e["event"] == "request_end"]
    assert sorted(starts) == sorted(ends) == ["r1", "r2", "r3", "r4"]


def test_drain_on_shutdown_signal(served, tmp_path):
    """A shutdown signal mid-session: the in-flight request finishes, a
    request submitted after it stays queued, the worker log closes."""
    queue = SpoolQueue(tmp_path / "spool")
    sim = _frames(seed=11)
    rid1 = queue.submit_frames(*sim, options=REQUEST_OPTIONS)
    worker = ServeWorker(queue, buckets=BucketSet(cells=CELLS, loci=LOCI),
                         poll_interval=0.1, device="cpu")
    prev = signal.getsignal(signal.SIGTERM), signal.getsignal(signal.SIGINT)
    worker.install_signal_handlers()
    result = {}
    thread = threading.Thread(target=lambda: result.update(
        stats=worker.run()), daemon=True)
    try:
        thread.start()
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            doc = queue.status(rid1)
            if doc and doc["state"] == "done":
                break
            time.sleep(0.05)
        else:
            pytest.fail("the first request never finished")
        signal.raise_signal(signal.SIGTERM)
        rid2 = queue.submit_frames(*sim, options=REQUEST_OPTIONS)
        thread.join(timeout=60)
        assert not thread.is_alive(), "the worker did not drain"
    finally:
        signal.signal(signal.SIGTERM, prev[0])
        signal.signal(signal.SIGINT, prev[1])
    stats = result["stats"]
    assert stats["drained"] is True and stats["processed"] == 1
    assert queue.status(rid2)["state"] == "pending"
    assert validate_run(stats["worker_log"]) == []


def test_compiled_program_store_rule_and_gpu_default(tmp_path):
    q = SpoolQueue(tmp_path / "spool")
    # JAX's rule: 'auto' is the spool's exec_cache, None/'none' no store,
    # a path that path
    assert ServeWorker(q, device="cpu").executable_cache_dir == \
        str(q.root / "exec_cache")
    for value in (None, "none"):
        w = ServeWorker(q, executable_cache_dir=value, device="cpu")
        assert w.executable_cache_dir is None
    assert ServeWorker(q, executable_cache_dir=str(tmp_path / "store"),
                       device="cpu").executable_cache_dir == \
        str(tmp_path / "store")
    with pytest.raises(ValueError, match="telemetry_path"):
        ServeWorker(q, default_options={"telemetry_path": "x"},
                    device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ServeWorker(q)


def test_tsv_writer_writes_pandas_bytes(tmp_path, monkeypatch):
    """The stream back's pooled writer: a frame longer than a block is
    formatted by processes, block by block, into the bytes of pandas'
    ``to_csv(sep='\\t', index=False)`` (floats, NaN, ints, strings,
    None, booleans); a short one is pandas' own write."""
    from scdna_replication_tools_tpu_torch.serve import tsv
    monkeypatch.setattr(tsv, "CHUNK_ROWS", 128)
    monkeypatch.setattr(tsv, "PROCESSES", 2)
    rng = np.random.default_rng(0)
    n = 1000
    frame = pd.DataFrame({
        "cell_id": [f"s_{i // 7}" for i in range(n)],
        "chr": ["1", "X"] * (n // 2),
        "start": np.arange(n) * 500_000,
        "reads": rng.poisson(30, n).astype(float),
        "model_tau": rng.random(n).astype(np.float32).astype(float),
        "tiny": rng.random(n) * 1e-7,
        "flag": rng.random(n) < 0.5,
    })
    frame.loc[3, "model_tau"] = np.nan
    frame.loc[9, "cell_id"] = None
    writer = tsv.TsvWriter()
    try:
        writer.write(frame, tmp_path / "pooled.tsv")
        writer.write(frame.iloc[:100], tmp_path / "short.tsv")
    finally:
        writer.close()
    frame.to_csv(tmp_path / "pandas.tsv", sep="\t", index=False)
    frame.iloc[:100].to_csv(tmp_path / "pandas_short.tsv", sep="\t",
                            index=False)
    assert (tmp_path / "pooled.tsv").read_bytes() \
        == (tmp_path / "pandas.tsv").read_bytes()
    assert (tmp_path / "short.tsv").read_bytes() \
        == (tmp_path / "pandas_short.tsv").read_bytes()


def test_unlabelled_request_with_viterbi_runs(tmp_path):
    """A ticket with ``clone_col: null``, ``clustering_method`` and
    ``cn_hmm_self_prob`` (requestable options of the JAX worker) runs in
    the port: its clones come from k-means, its CN from the Viterbi
    decode, and its output carries the discovered ``cluster_id``."""
    q = SpoolQueue(tmp_path / "spool")
    cn_s, cn_g1 = _frames(seed=3)
    options = {**REQUEST_OPTIONS, "clone_col": None,
               "clustering_method": "kmeans", "cn_hmm_self_prob": 0.99}
    rid = q.submit_frames(cn_s.drop(columns=["clone_id"]),
                          cn_g1.drop(columns=["clone_id"]),
                          options=options, request_id="u1")
    w = ServeWorker(q, buckets=BucketSet(cells=CELLS, loci=LOCI),
                    max_requests=1, exit_when_idle=True, device="cpu")
    stats = w.run()
    faults.install(None)
    assert stats["by_status"] == {"ok": 1}, q.status(rid)
    out = pd.read_csv(q.results_dir(rid) / "output.tsv", sep="\t",
                      dtype={"chr": str})
    assert "cluster_id" in out.columns
    assert (out["model_rep_state"] == out["true_rep"]).mean() > 0.8
