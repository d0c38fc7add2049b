"""The port's profiled run (``profile_dir``): ``utils/profiling.trace``
and ``scope``, ``utils/trace_summary`` (``scope_totals``, ``summarise``)
and the ``pert_xla_scope_seconds`` gauges that ``scRT`` feeds into
run_end's metrics snapshot.

On the CPU a trace has no device activity, so a range's time is its own
host wall less the ranges nested in it; a trace from the card counts the
kernels each range launched (synthetic traces here hold both rules,
graph replays included).  JAX's run on the same frames writes traces
whose CPU events carry no scope metadata, so it sets no gauge there:
the port's gauges are a superset of JAX's names under the same metric.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os

import pytest
import torch

from scdna_replication_tools_tpu_torch.utils import profiling
from scdna_replication_tools_tpu_torch.utils import trace_summary

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_pipeline import sim_data  # noqa: F401

SCOPES = ("pert/fit_step", "pert/decode", "pert/qc_entropy", "pert/ppc")


def test_trace_none_does_nothing(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the profiler started")
    monkeypatch.setattr(torch.profiler, "profile", refuse)
    with profiling.trace(None):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path), label="unit"):
        with profiling.scope("pert/decode"):
            y = x @ x
            with profiling.scope("pert/qc_entropy"):
                y = torch.log_softmax(y, dim=0)
        with profiling.scope("pert/ppc"):
            y.sum()
    (path,) = glob.glob(str(tmp_path / "unit.*.trace.json.gz"))
    with gzip.open(path) as fh:
        data = json.load(fh)
    names = {e.get("name") for e in data["traceEvents"]}
    assert {"pert/decode", "pert/qc_entropy", "pert/ppc"} <= names
    totals = trace_summary.scope_totals(str(tmp_path))
    assert set(totals) == {"pert/decode", "pert/decode/pert/qc_entropy",
                           "pert/ppc"}
    assert all(v > 0 for v in totals.values())
    text = trace_summary.summarise(str(tmp_path), top=5)
    assert "named ranges" in text and "pert/decode/pert/qc_entropy" in text


def _x(name, ts, dur, cat, pid=1, tid=1, **args):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
            "pid": pid, "tid": tid, "args": args}


def _write(tmp_path, events, name="step2.1.0.trace.json.gz"):
    with gzip.open(tmp_path / name, "wt") as fh:
        json.dump({"traceEvents": events}, fh)


def test_scope_totals_count_each_ranges_device_work(tmp_path):
    """A kernel counts for the ranges open when its launch ran, on any
    thread of the process (the autograd thread's backward launches); a
    graph replay's kernels share the replay's correlation id; work
    launched outside every range counts for none."""
    events = [
        _x("pert/fit_step", 0, 100, "user_annotation"),
        _x("cudaLaunchKernel", 10, 2, "cuda_runtime", correlation=1),
        _x("cudaLaunchKernel", 20, 2, "cuda_runtime", tid=2, correlation=2),
        _x("fwd", 50, 30, "kernel", pid=0, tid=7, correlation=1),
        _x("bwd", 80, 40, "kernel", pid=0, tid=7, correlation=2),
        _x("pert/fit_step", 200, 50, "user_annotation"),
        _x("cudaGraphLaunch", 210, 3, "cuda_runtime", correlation=3),
        _x("g1", 220, 5, "kernel", pid=0, tid=7, correlation=3),
        _x("g2", 226, 6, "kernel", pid=0, tid=7, correlation=3),
        _x("pert/decode", 400, 100, "user_annotation"),
        _x("pert/qc_entropy", 450, 40, "user_annotation"),
        _x("cudaLaunchKernel", 410, 1, "cuda_runtime", correlation=4),
        _x("cudaLaunchKernel", 460, 1, "cuda_runtime", correlation=5),
        _x("argmax", 500, 9, "kernel", pid=0, tid=7, correlation=4),
        _x("lse", 510, 11, "kernel", pid=0, tid=7, correlation=5),
        _x("cudaMemcpyAsync", 600, 1, "cuda_runtime", correlation=6),
        _x("Memcpy DtoH", 610, 4, "gpu_memcpy", pid=0, tid=7,
           correlation=6),
    ]
    _write(tmp_path, events)
    totals = trace_summary.scope_totals(str(tmp_path))
    assert totals == pytest.approx({
        "pert/fit_step": (30 + 40 + 5 + 6) / 1e6,
        "pert/decode": 9 / 1e6,
        "pert/decode/pert/qc_entropy": 11 / 1e6})
    device = trace_summary.device_seconds(
        str(tmp_path / "step2.1.0.trace.json.gz"))
    assert totals["pert/fit_step"] <= device


def test_scope_totals_host_rule_and_degradation(tmp_path):
    events = [_x("pert/decode", 0, 100, "user_annotation"),
              _x("pert/qc_entropy", 20, 30, "user_annotation"),
              _x("pert/ppc", 200, 10, "user_annotation", tid=3),
              _x("aten::add", 30, 5, "cpu_op")]
    _write(tmp_path, events, "package.1.0.trace.json.gz")
    assert trace_summary.scope_totals(str(tmp_path)) == pytest.approx({
        "pert/decode": 70 / 1e6, "pert/decode/pert/qc_entropy": 30 / 1e6,
        "pert/ppc": 10 / 1e6})
    # an unreadable trace and an empty directory: no totals, no error
    (tmp_path / "bad.1.0.trace.json.gz").write_bytes(b"not gzip")
    assert set(trace_summary.scope_totals(str(tmp_path))) == \
        {"pert/decode", "pert/decode/pert/qc_entropy", "pert/ppc"}
    assert trace_summary.scope_totals(str(tmp_path / "none")) == {}


def test_trace_summary_cli_json(tmp_path, capsys):
    _write(tmp_path, [_x("pert/ppc", 0, 10, "user_annotation")])
    trace_summary.main([str(tmp_path), "--json"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["scope_seconds"] == {"pert/ppc": 1e-05}
    with pytest.raises(SystemExit):
        trace_summary.main([str(tmp_path / "empty"), "--json"])


def _gauges(snapshot: dict) -> dict:
    out = {}
    for key, val in snapshot.items():
        if key.startswith("pert_xla_scope_seconds{"):
            out[key.split('scope="', 1)[1].rstrip('"}')] = val["value"]
    return out


def test_profiled_scrt_feeds_the_scope_gauges(sim_data,  # noqa: F811
                                              tmp_path):
    """scRT(profile_dir=T) on the CPU: one trace per step fit and one of
    the packaging in T, and run_end's metrics snapshot holds a positive
    pert_xla_scope_seconds gauge for each of the four ranges (the
    entropy one nested in the decode, as the JAX scopes nest); JAX's run
    on the same frames sets the same metric under a subset of those
    names (none on the CPU, whose XLA trace events carry no scope)."""
    from scdna_replication_tools_tpu.api import scRT as JaxScRT
    from scdna_replication_tools_tpu_torch import scRT

    sim_s, sim_g = sim_data
    opts = dict(input_col="reads", clone_col="clone_id", assign_col="copy",
                rt_prior_col=None, max_iter=20, min_iter=10)
    port = scRT(sim_s.copy(), sim_g.copy(), device="cpu",
                profile_dir=str(tmp_path / "T"),
                telemetry_path=str(tmp_path / "port.jsonl"), **opts)
    port.infer("pert")
    traces = sorted(os.path.basename(p).split(".")[0] for p in
                    glob.glob(str(tmp_path / "T" / "*.trace.json.gz")))
    assert traces == ["package", "step1", "step2", "step3"]
    events = [json.loads(line) for line in
              (tmp_path / "port.jsonl").read_text().splitlines()]
    snap = [e for e in events if e["event"] == "metrics_snapshot"][-1]
    assert snap["phase"] == "run_end"
    got = _gauges(snap["metrics"])
    for scope in SCOPES:
        keys = [k for k in got if k.endswith(scope)]
        assert keys and all(got[k] > 0 for k in keys), (scope, got)
    # the JAX facade takes profile_dir through its config only
    jscrt = JaxScRT(sim_s.copy(), sim_g.copy(), compile_cache_dir=None,
                    telemetry_path=None, **opts)
    jscrt.config = dataclasses.replace(jscrt.config,
                                       profile_dir=str(tmp_path / "J"))
    jscrt.infer("pert")
    assert glob.glob(str(tmp_path / "J" / "**" / "*.xplane.pb"),
                     recursive=True)
    jax_names = set(_gauges(jscrt.metrics_registry.snapshot(
        stable_only=False)))
    assert jax_names <= set(got)
