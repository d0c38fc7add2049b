"""chip_smoke.py's [analysis] phase on the CPU, at a small size: the
phase-calling, cell-cycle-feature and pivot checks of ``analysis`` pass
on an output that carries the simulated states and fail on a broken
one, and ``run_health`` passes on a finished traced run's health
directory and fails on a stale one.  (On the card the same functions run
at 1000 S + 250 G1 cells x 5451 loci, the features' 2-GMM on the card.)
"""

import importlib.util
import json
import time
from pathlib import Path

import pytest
import torch

from scdna_replication_tools_tpu_torch.obs import heartbeat as hb
from scdna_replication_tools_tpu_torch.obs import spans

from test_torch_model import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py as a module, cut to 60 S + 20 G1 cells x 1200 loci."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_analysis",
        Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.CELLS, mod.G1_CELLS, mod.LOCI = 60, 20, 1200
    return mod


@pytest.fixture(scope="module")
def frames(cs):
    s, g = cs.simulate_frames()
    for df in (s, g):
        df["model_rep_state"] = df["true_rep"]
        df["model_cn_state"] = df["state"]
    return s, g


def _run(cs, frames, cn, monkeypatch):
    monkeypatch.setattr(cs, "FAILURES", [])
    rec = cs.analysis(torch.device("cpu"), frames, cn, 1.0, "CPU")
    return rec, list(cs.FAILURES)


def test_analysis_checks_pass_on_the_simulated_states(cs, frames,
                                                      monkeypatch, capsys):
    cn = cs.analysis_input(*frames)
    rec, failures = _run(cs, frames, cn, monkeypatch)
    assert failures == []
    assert rec["s_share"] == rec["s_share_simulated"]
    assert rec["label_agreement"] == 1.0 and rec["g1_share"] == 1.0
    assert rec["lrs_err"] == 0.0
    assert sum(rec["phase_counts"].values()) == 80
    out = capsys.readouterr().out
    assert "[analysis] matplotlib: " in out
    assert "pivot_matrix, the loader's 4 pivots" in out


def test_analysis_checks_fail_on_a_broken_output(cs, frames, monkeypatch):
    """Replication states lost (all 0): the S cells are called G1/2, and
    the phase checks fail."""
    cn = cs.analysis_input(*frames)
    cn["model_rep_state"] = 0.0
    _, failures = _run(cs, frames, cn, monkeypatch)
    assert any("called S" in f for f in failures)
    assert any("label is the one" in f for f in failures)


def _health(tmp_path, state="done", age=0.0, with_span=True,
            monkeypatch=None):
    monkeypatch.setattr(spans, "_LAST_CLOSED", None)
    start = time.time()
    if with_span:
        tracer = spans.SpanTracer(trace_id=spans.derive_trace_id("x"))
        with tracer.span("step3"):
            pass
    rh = hb.RunHeartbeat(tmp_path, interval_seconds=0.5)
    if state != "running":
        rh.close(state)
    doc = hb.read_heartbeat(hb.host_path(tmp_path, 0))
    return doc, start, time.time() + age


def test_run_health_passes_on_a_finished_traced_run(cs, tmp_path,
                                                    monkeypatch):
    doc, start, _ = _health(tmp_path, monkeypatch=monkeypatch)
    monkeypatch.setattr(cs, "FAILURES", [])
    rec = cs.run_health(tmp_path, doc, start)
    assert cs.FAILURES == []
    assert rec["states"] == {"done": 1} and rec["failing"] == []
    assert rec["last_span"]["name"] == "step3"


@pytest.mark.parametrize("case", ["running_stale", "no_span",
                                  "old_span", "missing_rank"])
def test_run_health_fails(cs, tmp_path, monkeypatch, case):
    doc, start, _ = _health(tmp_path, state="running" if case ==
                            "running_stale" else "done",
                            with_span=case != "no_span",
                            monkeypatch=monkeypatch)
    if case == "running_stale":
        path = hb.host_path(tmp_path, 0)
        doc = dict(doc, written_unix=doc["written_unix"] - 3600)
        path.write_text(json.dumps(doc))
    if case == "old_span":
        start += 60.0
    if case == "missing_rank":
        path = hb.host_path(tmp_path, 0)
        path.write_text(json.dumps(dict(doc,
                                                      process_count=2)))
    monkeypatch.setattr(cs, "FAILURES", [])
    cs.run_health(tmp_path, doc, start)
    assert cs.FAILURES, case
