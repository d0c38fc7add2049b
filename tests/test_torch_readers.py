"""The port's run-log readers (``tools/{pert_report,pert_fleet,pert_meter,
pert_trace}``) against the repo's JAX tools, byte for byte.

Inputs: the default run logs of both packages (the fixture of
tests/test_torch_runlog.py), the traced and untraced logs of
tests/test_torch_spans.py, a spool the port's worker drained on the CPU
(two requests packed into one slab under two tenants, one refused), and
a heartbeat tree of two hosts.  On each, every subcommand of each port
tool prints the same standard output and error, exits with the same
code and writes the same files as the JAX tool, with the clock frozen
for both (the index's and the baseline's time stamps, the heartbeats'
ages).  Then ``regress_verdict`` against JAX's on the cases of JAX's
tests, ``pert_trace --profile-dir`` on the port's ``torch.profiler``
traces, each tool run as ``python -m`` with JAX blocked from import,
and the console scripts.
"""

import importlib
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from scdna_replication_tools_tpu.obs import metrics as jax_metrics
from scdna_replication_tools_tpu_torch.obs import metrics as port_metrics
from scdna_replication_tools_tpu_torch.serve import (
    BucketSet,
    ServeWorker,
    SpoolQueue,
)
from scdna_replication_tools_tpu_torch.tools import pert_fleet
from scdna_replication_tools_tpu_torch.tools import pert_meter
from scdna_replication_tools_tpu_torch.tools import pert_report
from scdna_replication_tools_tpu_torch.tools import pert_trace
from scdna_replication_tools_tpu_torch.utils import faults
from scdna_replication_tools_tpu_torch.utils import trace_summary
from tools import pert_fleet as jax_fleet
from tools import pert_meter as jax_meter
from tools import pert_report as jax_report
from tools import pert_trace as jax_trace

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_pert_watch import _doc, _tree
from test_torch_pipeline import sim_data  # noqa: F401
from test_torch_runlog import runs  # noqa: F401
from test_torch_spans import logs  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
from test_serve import REQUEST_OPTIONS, _frames  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PORT = {"report": pert_report, "fleet": pert_fleet, "meter": pert_meter,
        "trace": pert_trace}
JAX = {"report": jax_report, "fleet": jax_fleet, "meter": jax_meter,
       "trace": jax_trace}
# the instant both tools read from the clock
FROZEN = 1_760_000_000.0
BASELINES = ("artifacts/FLEET_BASELINE_cpu.json",
             "artifacts/FLEET_BASELINE_serve_cpu.json")


@pytest.fixture(scope="module")
def spool(tmp_path_factory):
    """A spool the port's worker drained at max_batch=2 on the CPU: r1
    and r2 (tenants lab-a and lab-b) packed into one slab, r3 refused
    above the largest bucket."""
    root = tmp_path_factory.mktemp("readers_spool")
    q = SpoolQueue(root / "spool")
    options = {**REQUEST_OPTIONS, "max_iter": 60, "min_iter": 20}
    q.submit_frames(*_frames(seed=3), options=options, request_id="r1",
                    tenant="lab-a")
    q.submit_frames(*_frames(seed=11), options=options, request_id="r2",
                    tenant="lab-b")
    q.submit_frames(*_frames(num_loci=256, cells_per_clone=3, seed=5),
                    options=options, request_id="r3", tenant="lab-a")
    w = ServeWorker(q, buckets=BucketSet(cells=(8, 16), loci=(64, 128)),
                    max_requests=3, exit_when_idle=True, max_batch=2,
                    device="cpu")
    stats = w.run()
    faults.install(None)
    assert stats["by_status"] == {"ok": 2, "refused": 1}
    return root / "spool"


@pytest.fixture(scope="module")
def paths(runs, logs, spool, tmp_path_factory):  # noqa: F811
    """The operands of the parity cases, by placeholder name."""
    root = tmp_path_factory.mktemp("readers")
    health = _tree(root / "run", [
        _doc(0, now=FROZEN, state="done", chunk=5, iteration=90),
        _doc(1, now=FROZEN, interval=0.5, age=300.0)])
    bad = root / "bad_trace.json"
    bad.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "name": "a", "ts": 0, "dur": -1, "pid": 0, "tid": 1},
        {"name": "no ph"}, 3]}))
    (worker_log,) = sorted(spool.glob("worker_*.jsonl"))
    return {"port": str(runs["root"] / "port.jsonl"),
            "jax": str(runs["root"] / "jax.jsonl"),
            "port_traced": logs["torch"][1], "jax_traced": logs["jax"][1],
            "port_off": logs["off"][1], "spool": str(spool),
            "worker": str(worker_log), "result": str(spool / "results"
                                                     / "r1"),
            "health": str(health), "bad": str(bad), "repo": str(REPO)}


def _freeze(monkeypatch):
    real_gmtime = time.gmtime
    monkeypatch.setattr(time, "time", lambda: FROZEN)
    monkeypatch.setattr(time, "gmtime", lambda secs=None: real_gmtime(
        FROZEN if secs is None else secs))


def _call(tool, argv, capsys):
    try:
        rc = tool.main(argv)
    except SystemExit as exc:
        rc = exc.code
    got = capsys.readouterr()
    return rc, got.out, got.err


def _drive(tools, name, commands, paths, out, capsys):  # noqa: F811
    """Each command through one package's tool; the results and every
    file left in ``out``, which starts empty."""
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir()
    fill = dict(paths, out=str(out))
    results = [_call(tools[name], [a.format(**fill) for a in argv], capsys)
               for argv in commands]
    files = {p.name: p.read_bytes() for p in sorted(out.iterdir())}
    return results, files


def _same(name, commands, paths, tmp_path, capsys,
          monkeypatch):  # noqa: F811
    _freeze(monkeypatch)
    out = tmp_path / "out"
    jax = _drive(JAX, name, commands, paths, out, capsys)
    port = _drive(PORT, name, commands, paths, out, capsys)
    for (j, p, argv) in zip(jax[0], port[0], commands):
        assert p == j, argv
    assert port[1] == jax[1]
    return port


REPORT = {
    "port": [["{port}"]],
    "jax": [["{jax}"]],
    "port_traced": [["{port_traced}"]],
    "jax_traced": [["{jax_traced}"]],
    "worker_log": [["{worker}"]],
    "health_dir": [["{port}", "--health-dir", "{health}"],
                   ["{jax}", "--health-dir", "{health}"]],
    "out_file": [["{port_off}", "--out", "{out}/report.md"]],
    "compare_port_jax": [["--compare", "{port}", "{jax}"]],
    "compare_traced": [["--compare", "{port_traced}", "{port_off}"],
                       ["--compare", "{jax_traced}", "{port_traced}"]],
    "usage": [[]],
}


@pytest.mark.parametrize("case", sorted(REPORT))
def test_pert_report_output_equals_jax(case, paths, tmp_path, capsys,
                                       monkeypatch):
    (results, _) = _same("report", REPORT[case], paths, tmp_path, capsys,
                         monkeypatch)
    if case in ("port", "jax"):
        text = results[0][1]
        for placeholder in ("_no phase events_", "_no fit_end events_",
                            "_no model-health events",
                            "_no control_decision", "_no rescue events",
                            "_no metrics_snapshot"):
            assert placeholder not in text, placeholder
    if case == "compare_port_jax":
        assert "## Metrics (B - A)" in results[0][1]


ROOTS = ["--roots", "{port}", "{jax}", "{port_traced}", "{jax_traced}",
         "{spool}", "--index", "{out}/absent.json"]
FLEET = {
    "index": [["index", "--roots", "{port}", "{jax}", "{spool}", "--out",
               "{out}/index.json"]],
    "query": [["query"] + ROOTS,
              ["query"] + ROOTS + ["--format", "json"],
              ["query"] + ROOTS + ["--request", "*"],
              ["query"] + ROOTS + ["--status", "ok", "--json"]],
    "trend": [["trend"] + ROOTS,
              ["trend"] + ROOTS + ["--format", "json"],
              ["trend"] + ROOTS + ["--request", "r1", "--metric",
                                   "pert_fit_wall_seconds",
                                   "--out", "{out}/trend.md"]],
    "write_baseline": [["regress", "--run", "{port}", "--write-baseline",
                        "{out}/port_base.json"],
                       ["regress", "--run", "{jax}", "--write-baseline",
                        "{out}/jax_base.json"]],
    "baseline_written": [["regress", "--run", "{port}", "--write-baseline",
                          "{out}/base.json"],
                         ["regress", "--run", "{jax}", "--baseline",
                          "{out}/base.json", "--out", "{out}/v.md"],
                         ["regress", "--run", "{port_traced}",
                          "--baseline", "{out}/base.json",
                          "--tolerance-scale", "3"]],
    "newest_run": [["regress"] + ROOTS + ["--baseline",
                                          "{repo}/" + BASELINES[1]]],
    "no_baseline": [["regress", "--run", "{port}"]],
}
for _log in ("port", "jax"):
    for _i, _base in enumerate(BASELINES):
        FLEET[f"committed_{_i}_{_log}"] = [
            ["regress", "--run", "{" + _log + "}", "--baseline",
             "{repo}/" + _base],
            ["regress", "--run", "{" + _log + "}", "--baseline",
             "{repo}/" + _base, "--tolerance-scale", "2.5"]]


@pytest.mark.parametrize("case", sorted(FLEET))
def test_pert_fleet_output_equals_jax(case, paths, tmp_path, capsys,
                                      monkeypatch):
    _same("fleet", FLEET[case], paths, tmp_path, capsys, monkeypatch)


METER = {
    "report_logs": [["report", "{port}"], ["report", "{jax}"],
                    ["report", "{port}", "--json"]],
    "report_spool": [["report", "{spool}"], ["report", "{spool}", "--json"],
                     ["report", "{result}", "--check"],
                     ["report", "{worker}"]],
    "attribution": [["attribution", "{spool}", "--check"],
                    ["attribution", "{spool}", "--json", "--check"]],
    "ab": [["ab", "{port}", "{jax}"], ["ab", "{spool}", "{port}", "--json"],
           ["ab", "{jax_traced}", "{spool}"]],
}


@pytest.mark.parametrize("case", sorted(METER))
def test_pert_meter_output_equals_jax(case, paths, tmp_path, capsys,
                                      monkeypatch):
    (results, _) = _same("meter", METER[case], paths, tmp_path, capsys,
                         monkeypatch)
    if case == "attribution":
        doc = json.loads(results[1][1])
        assert results[1][0] == 0 and doc["conservation_ok"]
        assert set(doc["by_tenant"]) == {"lab-a", "lab-b"}


TRACE = {
    "export_logs": [["export", "--perfetto", "--out", "{out}/t.json",
                     "{port_traced}", "{jax_traced}", "{port_off}"],
                    ["validate", "{out}/t.json"]],
    "export_default": [["export", "--perfetto", "--out", "{out}/t.json",
                        "{port}"], ["validate", "{out}/t.json"]],
    "export_spool": [["export", "--perfetto", "--out", "{out}/t.json",
                      "--spool", "{spool}"], ["validate", "{out}/t.json"]],
    "export_missing": [["export", "--perfetto", "--out", "{out}/t.json",
                        "{out}/absent.jsonl"]],
    "validate_bad": [["validate", "{bad}"]],
    "waterfall": [["waterfall", "--spool", "{spool}"],
                  ["waterfall", "--spool", "{spool}", "--request", "r2"]],
}


@pytest.mark.parametrize("case", sorted(TRACE))
def test_pert_trace_output_equals_jax(case, paths, tmp_path, capsys,
                                      monkeypatch):
    (results, _) = _same("trace", TRACE[case], paths, tmp_path, capsys,
                         monkeypatch)
    if case == "waterfall":
        rows = json.loads(results[0][1])["requests"]
        assert set(rows) == {"r1", "r2"}
        for row in rows.values():
            assert set(pert_trace.WATERFALL_COMPONENTS) <= set(row)


HIGHER = {"regress": {"threshold": 0.3, "direction": "higher"}}
LOWER = {"regress": {"threshold": 0.25, "direction": "lower"}}
HITS = port_metrics.manifest_metrics()["pert_compile_cache_hits_total"]
VERDICT_CASES = {
    "higher_collapse_scaled": (HIGHER, 100.0, 1.0, 4.0),
    "hits_all_lost": (HITS, 8, 0, 1.0),
    "hits_within": (HITS, 8, 6, 1.0),
    "higher_zero_base_improved": (HITS, 0, 4, 1.0),
    "lower_zero_base_incomparable": (LOWER, 0, 3, 1.0),
    "lower_zero_base_flat": (LOWER, 0, 0, 1.0),
    "lower_regressed": (LOWER, 10.0, 13.0, 1.0),
    "lower_scaled_ok": (LOWER, 10.0, 13.0, 2.0),
    "lower_improved": (LOWER, 10.0, 5.0, 1.0),
    "negative_base": (LOWER, -4.0, -2.0, 1.0),
    "untracked": ({"type": "gauge"}, 3.0, 9.0, 1.0),
    "no_spec": (None, 0.0, -1.0, 1.0),
}


@pytest.mark.parametrize("case", sorted(VERDICT_CASES))
def test_regress_verdict_equals_jax(case):
    spec, base, run, scale = VERDICT_CASES[case]
    got = port_metrics.regress_verdict(spec, base, run,
                                       tolerance_scale=scale)
    assert got == jax_metrics.regress_verdict(spec, base, run,
                                              tolerance_scale=scale)
    assert port_metrics._HIGHER_THRESHOLD_CAP \
        == jax_metrics._HIGHER_THRESHOLD_CAP


@pytest.fixture(scope="module")
def profiled(sim_data, tmp_path_factory):  # noqa: F811
    """scRT(profile_dir=T) on the CPU: its log and T."""
    from scdna_replication_tools_tpu_torch import scRT

    root = tmp_path_factory.mktemp("readers_profiled")
    sim_s, sim_g = sim_data
    scRT(sim_s.copy(), sim_g.copy(), device="cpu",
         profile_dir=str(root / "T"),
         telemetry_path=str(root / "profiled.jsonl"), input_col="reads",
         clone_col="clone_id", assign_col="copy", rt_prior_col=None,
         max_iter=20, min_iter=10).infer("pert")
    return root / "profiled.jsonl", root / "T"


def test_profile_dir_counter_track_is_the_ports_scope_totals(
        profiled, tmp_path, capsys):
    """export --profile-dir on the traces that scRT(profile_dir=T) wrote
    on the CPU: the pert_xla_scope_seconds track holds the port's
    scope_totals of T, the four named ranges among them; without a
    readable trace the export has no counter track."""
    log, traces = profiled
    out = tmp_path / "t.json"
    rc, _, _ = _call(pert_trace, ["export", "--perfetto", "--out", str(out),
                                  "--profile-dir", str(traces), str(log)],
                     capsys)
    doc = json.loads(out.read_text())
    (track,) = [e for e in doc["traceEvents"] if e["ph"] == "C"]
    totals = trace_summary.scope_totals(str(traces))
    assert rc == 0 and pert_trace.validate_trace(doc) == []
    assert track["name"] == "pert_xla_scope_seconds"
    assert track["args"] == {k: round(v, 6) for k, v in sorted(
        totals.items())}
    for scope in ("pert/fit_step", "pert/decode", "pert/qc_entropy",
                  "pert/ppc"):
        keys = [k for k in track["args"] if k.endswith(scope)]
        assert keys and all(track["args"][k] > 0 for k in keys), scope
    (tmp_path / "empty").mkdir()
    _call(pert_trace, ["export", "--perfetto", "--out", str(out),
                       "--profile-dir", str(tmp_path / "empty"), str(log)],
          capsys)
    assert not [e for e in json.loads(out.read_text())["traceEvents"]
                if e["ph"] == "C"]


@pytest.fixture(scope="module")
def cs():
    """chip_smoke.py as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_chip_smoke_readers_phase_on_cpu_logs(cs, runs, logs, spool,
                                              profiled, tmp_path,
                                              monkeypatch):  # noqa: F811
    """chip_smoke.py's [readers] phase on logs of CPU runs: every tool a
    ``python -m`` subprocess with JAX blocked, every check passes (the
    default run's report, the compare, the profiled trace's counter
    track against its run_end gauges, the waterfall and the meter of the
    spool, the fleet index, baseline and regress), and the files land in
    its output directory.  The default run's log is JAX's: a port run on
    the CPU builds no kernel library, so its log has no compile event
    for the report's Compiled programs section, which the phase
    requires of the card's run."""
    log, traces = profiled
    out = tmp_path / "chiprun_out"
    out.mkdir()
    shutil.copy(runs["root"] / "jax.jsonl", out / "default_run.jsonl")
    shutil.copy(logs["torch"][1], out / "graphs_run.jsonl")
    shutil.copy(log, out / "graphs_profiled.jsonl")
    snap = [json.loads(line) for line in log.read_text().splitlines()
            if '"metrics_snapshot"' in line][-1]
    gauges = {k.split('scope="', 1)[1].rstrip('"}'): v["value"]
              for k, v in snap["metrics"].items()
              if k.startswith("pert_xla_scope_seconds{")}
    record = {"graphs": {"profiled": {"gauges": gauges}}}
    monkeypatch.setattr(cs, "FAILURES", [])
    phase = cs.ReadersPhase(out / "default_run.jsonl",
                            out / "graphs_run.jsonl",
                            out / "graphs_profiled.jsonl", traces, spool,
                            out=out)
    phase.finish(record, ["r1", "r2"])
    assert cs.FAILURES == []
    rec = record["readers"]
    assert len(rec["commands"]) == 15 and rec["gap"] <= 0.01
    assert set(rec["waterfall"]) == {"r1", "r2"}
    assert {"default_run.jsonl", "graphs_run.jsonl"} <= set(
        rec["fleet_files"])
    for name in ("default_run_report.md", "default_vs_graphs.md",
                 "graphs_profiled_trace.json", "fleet_index.json",
                 "fleet_baseline_default.json"):
        assert (out / name).stat().st_size > 0, name


@pytest.mark.parametrize("tool", ["pert_watch", "chaos_smoke"])
def test_tool_runs_with_jax_blocked(cs, tool):
    """``python -m`` of the tools the [readers] phase does not run, behind
    the import hook that refuses JAX: --help exits 0."""
    run = subprocess.run(
        [sys.executable, "-c", cs.BLOCK_JAX, f"{cs.PKG}.tools.{tool}",
         "--help"], capture_output=True, text=True, cwd=str(REPO),
        timeout=300)
    assert run.returncode == 0 and "usage" in run.stdout, run.stderr


@pytest.mark.parametrize("name,refused", [
    ("scdna_replication_tools_tpu", True),
    ("scdna_replication_tools_tpu.obs.summary", True),
    ("jax", True), ("scdna_replication_tools_tpu_torch.obs.summary", False)])
def test_blocking_hook_refuses_the_jax_package(cs, name, refused):
    """The hook itself: the JAX package and jax fail to import under it,
    the port's modules import."""
    run = subprocess.run([sys.executable, "-c",
                          cs.JAX_HOOK + f"\nimport {name}\n"],
                         capture_output=True, text=True, cwd=str(REPO),
                         timeout=300)
    assert (run.returncode != 0) == refused, run.stderr
    if refused:
        assert "blocked, the port imports no JAX" in run.stderr


def test_console_scripts_name_port_callables():
    """pyproject.toml's [project.scripts]: the JAX package's four lines
    as they were, and four lines naming callables of the port."""
    import tomllib

    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert {k: v for k, v in scripts.items() if not k.endswith(
        "torch")} == {
        "infer_scRT": "scdna_replication_tools_tpu.cli:infer_scrt_main",
        "infer_SPF": "scdna_replication_tools_tpu.cli:infer_spf_main",
        "pert_simulator": "scdna_replication_tools_tpu.cli:simulator_main",
        "pert-serve": "scdna_replication_tools_tpu.serve.cli:console_main"}
    port = {k: v for k, v in scripts.items() if k.endswith("torch")}
    assert sorted(port) == ["infer_SPF_torch", "infer_scRT_torch",
                            "pert-serve-torch", "pert_simulator_torch"]
    for name, target in port.items():
        module, attr = target.split(":")
        assert module.startswith("scdna_replication_tools_tpu_torch.")
        assert callable(getattr(importlib.import_module(module), attr))
        jax_target = scripts[name[:-len("_torch")]
                             if name.endswith("_torch")
                             else name[:-len("-torch")]]
        assert attr == jax_target.split(":")[1]

