"""The port's run log against the JAX package's: ``scRT(cn_s, cn_g1)``
with every option at its default (the run log on) in both packages, on
the simulator frames of tests/test_torch_pipeline.py, each writing its
log to a file under the test's temporary directory.  The port runs on
the CPU through the plain versions of its kernels, with JAX's
posterior-predictive replicate draws (the ``replicates=`` seam), so the
QC flags can be held equal.

Left out of the comparisons: ``compile`` events (JAX's CPU run compiles
XLA programs; the port's CPU run builds no kernel library) and the
series the metrics registry derives from them, ``phase`` events (each
package names its own stages: the port has no trace or h2d stage and
packages in one), and the values of ``metrics_snapshot``.
"""

import json
import logging
import os
import sys
from pathlib import Path

import numpy as np
import pytest

from scdna_replication_tools_tpu.api import scRT as JaxScRT
from scdna_replication_tools_tpu.infer import runner as jax_runner
from scdna_replication_tools_tpu.obs import metrics as jax_metrics
from scdna_replication_tools_tpu.obs import schema as jax_schema
from scdna_replication_tools_tpu_torch import scRT as TorchScRT
from scdna_replication_tools_tpu_torch.infer import runner as port_runner
from scdna_replication_tools_tpu_torch.obs import metrics as port_metrics
from scdna_replication_tools_tpu_torch.obs import runlog as port_runlog
from scdna_replication_tools_tpu_torch.obs import schema as port_schema
from scdna_replication_tools_tpu_torch.ops import _cuda

from test_metrics import _SAMPLE_RE
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_pipeline import sim_data  # noqa: F401
from test_torch_qc import _jax_replicates

REPO = Path(__file__).resolve().parents[1]
COLUMNS = dict(input_col="reads", clone_col="clone_id", assign_col="copy",
               rt_prior_col=None)
# the frames' columns, the pipeline tests' budgets; nothing else is set
DEFAULTS = dict(COLUMNS, max_iter=300, min_iter=100)
# compile-derived series (JAX compiles XLA programs on the CPU, the port
# builds no library there) and the device-memory pair (no CUDA device)
NOT_COMPARED = ("pert_compile_", "pert_program_peak_bytes", "pert_aot_",
                "pert_device_hbm_")


def _events(path):
    return [json.loads(line) for line in Path(path).read_text().splitlines()]


def _of(events, kind):
    return [e for e in events if e["event"] == kind]


@pytest.fixture(scope="module")
def runs(sim_data, tmp_path_factory):  # noqa: F811
    """Both packages' default scRT with the log written to a file; the
    port with JAX's PPC replicate draws and a metrics textfile."""
    sim_s, sim_g = sim_data
    root = tmp_path_factory.mktemp("runlog")
    seen = {}
    mp = pytest.MonkeyPatch()

    def jax_ppc(spec, params, fixed, batch, key, num_replicates, maps,
                _orig=jax_runner.ppc_discrepancy):
        seen["reps"] = _jax_replicates(spec, params, fixed, batch, *maps,
                                       0, num_replicates)
        return _orig(spec, params, fixed, batch, key,
                     num_replicates=num_replicates, maps=maps)

    def port_ppc(*a, _orig=port_runner.ppc_discrepancy, **k):
        return _orig(*a, replicates=seen["reps"], **k)
    mp.setattr(jax_runner, "ppc_discrepancy", jax_ppc)
    mp.setattr(port_runner, "ppc_discrepancy", port_ppc)
    try:
        jscrt = JaxScRT(sim_s.copy(), sim_g.copy(), compile_cache_dir=None,
                        telemetry_path=str(root / "jax.jsonl"), **DEFAULTS)
        jscrt.infer(level="pert")
        tscrt = TorchScRT(sim_s.copy(), sim_g.copy(), device="cpu",
                          telemetry_path=str(root / "port.jsonl"),
                          metrics_textfile=str(root / "port.prom"),
                          **DEFAULTS)
        tscrt.infer(level="pert")
    finally:
        mp.undo()
    return dict(jax=_events(jscrt.run_log_path),
                port=_events(tscrt.run_log_path), jscrt=jscrt,
                tscrt=tscrt, root=root)


def test_event_sequence_matches_jax(runs):
    """The same event types in the same order, apart from compile and
    phase events; the log lands where scRT.run_log_path says."""
    def kinds(events):
        return [e["event"] for e in events
                if e["event"] not in ("compile", "phase")]
    assert runs["tscrt"].run_log_path == str(runs["root"] / "port.jsonl")
    assert kinds(runs["port"]) == kinds(runs["jax"])
    assert _of(runs["port"], "phase"), "no phase events"


def test_fit_events_match_jax(runs):
    """fit_end's step, iters, converged, nan_abort and num_cells, and
    fit_health's verdict, per step."""
    keys = ("step", "iters", "converged", "nan_abort", "num_cells")

    def fits(events):
        return [{k: e[k] for k in keys} for e in _of(events, "fit_end")]
    assert fits(runs["port"]) == fits(runs["jax"])
    assert len(fits(runs["port"])) == 3
    verdicts = [[(e["step"], e["verdict"]) for e in _of(ev, "fit_health")]
                for ev in (runs["port"], runs["jax"])]
    assert verdicts[0] == verdicts[1]


def test_control_decisions_match_jax(runs):
    """The control_decision list: step, action, iteration, budget,
    grant and outcome, in order (the rescue gate's among them)."""
    keys = ("step", "action", "iter", "budget", "iters_granted", "outcome")

    def decisions(events):
        return [tuple(e.get(k) for k in keys)
                for e in _of(events, "control_decision")]
    assert decisions(runs["port"]) == decisions(runs["jax"])
    assert any(d[1] in ("rescue", "rescue_skip")
               for d in decisions(runs["port"]))


def test_rescue_and_cell_qc_summary_match_jax(runs):
    """rescue's candidates, accepted and capped_to; cell_qc_summary's
    num_cells, thresholds and (on JAX's replicate draws) flag counts."""
    (jr,), (tr,) = _of(runs["jax"], "rescue"), _of(runs["port"], "rescue")
    for k in ("candidates", "accepted", "capped_to"):
        assert tr[k] == jr[k], k
    (jq,), (tq,) = (_of(runs["jax"], "cell_qc_summary"),
                    _of(runs["port"], "cell_qc_summary"))
    for k in ("num_cells", "thresholds", "flag_counts", "num_flagged"):
        assert tq[k] == jq[k], (k, tq[k], jq[k])
    # the event agrees with the port's own table
    qc = runs["tscrt"].cell_qc()
    assert tq["num_flagged"] == int((~qc["qc_pass"]).sum())


def test_run_end_closes_the_log(runs):
    """The last line is run_end with status ok, counting the events
    before it (its own seq), with the run's phase ledger."""
    events = runs["port"]
    end = events[-1]
    assert end["event"] == "run_end" and end["status"] == "ok"
    assert end["events_emitted"] == end["seq"] == len(events) - 1
    assert end["phases"] == runs["tscrt"].phase_report


def test_run_end_snapshot_series_match_jax(runs):
    """The run_end metrics_snapshots carry the same series names, apart
    from the compile-derived series and the device-memory pair."""
    def series(events):
        (snap,) = [e for e in _of(events, "metrics_snapshot")
                   if e["phase"] == "run_end"]
        return sorted(k for k in snap["metrics"]
                      if not k.startswith(NOT_COMPARED))
    assert series(runs["port"]) == series(runs["jax"])
    assert 'pert_planes_moved_per_iter{step="step2"}' in series(runs["port"])


@pytest.mark.parametrize("schema", ["port", "jax"])
def test_every_port_line_is_valid(runs, schema):
    """Every line of the port's log validates under the port's and the
    JAX package's schema, and the file as a whole under both."""
    validator = port_schema if schema == "port" else jax_schema
    path = runs["tscrt"].run_log_path
    for event in runs["port"]:
        assert validator.validate_event(event) == [], event
    assert validator.validate_run(path) == []


@pytest.mark.parametrize("name", ["runlog_schema.json",
                                  "metrics_manifest.json"])
def test_obs_contract_copies_are_byte_identical(name):
    """The port's schema and metrics catalogue are the JAX package's
    files, byte for byte."""
    port = REPO / "scdna_replication_tools_tpu_torch" / "obs" / name
    ref = REPO / "scdna_replication_tools_tpu" / "obs" / name
    assert port.read_bytes() == ref.read_bytes()


def test_pert_report_renders_the_port_log(runs):
    """tools/pert_report.py, unchanged, renders the port's log with its
    phase, fit, model-health, decision, rescue and metrics sections
    filled (no placeholder)."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import pert_report
    finally:
        sys.path.remove(str(REPO / "tools"))
    text = pert_report.render_report(runs["tscrt"].run_log_path)
    for heading in ("## Phase waterfall", "## Model health",
                    "## Decision trail"):
        assert heading in text, heading
    for placeholder in ("_no phase events_", "_no fit_end events_",
                        "_no model-health events", "_no control_decision",
                        "_no rescue events", "_no metrics_snapshot"):
        assert placeholder not in text, placeholder


def _small(sim_data, **kw):  # noqa: F811
    sim_s, sim_g = sim_data
    return TorchScRT(sim_s.copy(), sim_g.copy(), device="cpu",
                     **dict(COLUMNS, max_iter=30, min_iter=10,
                            run_step3=False), **kw)


def test_a_raise_closes_the_log_with_error(sim_data, tmp_path,  # noqa: F811
                                           monkeypatch):
    """A raise inside the run leaves a readable log whose last line is
    run_end with status error and the exception's type and message."""
    def boom(self):
        raise RuntimeError("step 1 failed on purpose")
    monkeypatch.setattr(port_runner.PertInference, "run_step1", boom)
    scrt = _small(sim_data, telemetry_path=str(tmp_path / "err.jsonl"))
    with pytest.raises(RuntimeError, match="on purpose"):
        scrt.infer(level="pert")
    events = _events(tmp_path / "err.jsonl")
    assert events[0]["event"] == "run_start"
    end = events[-1]
    assert end["event"] == "run_end" and end["status"] == "error"
    assert end["error"] == {"type": "RuntimeError",
                            "message": "step 1 failed on purpose"}
    assert port_schema.validate_run(tmp_path / "err.jsonl") == []


def test_a_failed_write_disables_the_log_and_the_fit_goes_on(
        sim_data, tmp_path, monkeypatch, caplog):  # noqa: F811
    """A write that fails mid-run disables the log with one warning; the
    fit finishes and the lines written before stay readable."""
    class FailingJson:
        calls = 0

        @classmethod
        def dumps(cls, *a, **k):
            cls.calls += 1
            if cls.calls > 4:
                raise OSError("disk full")
            return json.dumps(*a, **k)
    monkeypatch.setattr(port_runlog, "json", FailingJson)
    scrt = _small(sim_data, telemetry_path=str(tmp_path / "full.jsonl"))
    with caplog.at_level(logging.WARNING,
                         logger="scdna_replication_tools_tpu_torch"):
        cn_s, supp_s, _, _ = scrt.infer(level="pert")
    warnings = [r for r in caplog.records if "run log disabled" in
                r.getMessage()]
    assert len(warnings) == 1
    assert len(cn_s) and scrt.steps[1].fit.num_iters > 0
    events = _events(tmp_path / "full.jsonl")
    assert events[0]["event"] == "run_start"
    assert [e["seq"] for e in events] == list(range(len(events)))
    assert len(events) < FailingJson.calls and events[-1]["event"] != \
        "run_end"


def test_auto_resolves_under_the_root_with_the_retention_cap(tmp_path,
                                                            monkeypatch):
    """'auto' names a fresh file under the run-log root and prunes the
    root to the newest AUTO_RETAIN_RUNS - 1 logs before the run adds
    its own."""
    monkeypatch.setattr(port_runlog, "AUTO_ROOT", tmp_path)
    cap = port_runlog.AUTO_RETAIN_RUNS
    for i in range(cap + 10):
        old = tmp_path / f"old_{i:03d}.jsonl"
        old.write_text("{}\n")
        os.utime(old, (1_000_000 + i, 1_000_000 + i))
    log = port_runlog.RunLog.create("auto")
    assert Path(log.path).parent == tmp_path
    assert not Path(log.path).exists()
    kept = sorted(p.name for p in tmp_path.glob("*.jsonl"))
    assert len(kept) == cap - 1
    assert kept[0] == f"old_{11:03d}.jsonl"
    assert port_runlog.RunLog.create(None).enabled is False


def test_metrics_textfile_is_prometheus_text(runs):
    """The port's metrics_textfile passes the JAX package's exposition
    check (tests/test_metrics.py): HELP/TYPE blocks, sample lines of the
    exposition grammar, each sample of a TYPE'd name that the JAX
    catalogue declares with that type; its stable counters equal the
    run_end snapshot's."""
    text = (runs["root"] / "port.prom").read_text()
    assert text.endswith("\n")
    catalogue = jax_metrics.manifest_metrics()
    types, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            assert catalogue[name]["type"] == kind, name
            types[name] = kind
            continue
        assert _SAMPLE_RE.match(line), f"bad exposition line: {line!r}"
        key, value = line.rsplit(" ", 1)
        base = key.split("{")[0]
        stripped = base.rsplit("_", 1)[0] if base.endswith(
            ("_bucket", "_sum", "_count")) else base
        assert base in types or stripped in types, line
        samples[key] = float(value)
    (snap,) = [e for e in _of(runs["port"], "metrics_snapshot")
               if e["phase"] == "run_end"]
    for key, entry in snap["metrics"].items():
        if entry["type"] == "counter" and key != "pert_runlog_events_total":
            assert samples[key] == entry["value"], key
    assert "pert_fit_wall_seconds{step=\"step2\"}" in samples


def test_library_loads_become_compile_events(monkeypatch):
    """A step's library load is one compile event: ``disk_hit`` with
    its load seconds when that call loaded a library built before,
    ``hit`` when the process had it loaded already; valid under the
    schema and counted by the registry as JAX's are."""
    monkeypatch.setattr(_cuda, "_LIBS", {})
    monkeypatch.setattr(_cuda, "BUILD_INFO", {"adam": {
        "seconds": 0.0, "path": "libadam-0123456789abcdef.so",
        "log": "cached", "key_hash": "0123456789abcdef",
        "cache": "disk_hit"}})

    def load(name):
        _cuda._LIBS[name] = object()
        _cuda.BUILD_INFO[name]["load_seconds"] = 0.001
        return _cuda._LIBS[name]
    monkeypatch.setattr(_cuda, "library", load)
    first, again = _cuda.load_event("adam"), _cuda.load_event("adam")
    assert first["cache"] == "disk_hit"
    assert first["deserialize_seconds"] == 0.001
    assert again["cache"] == "hit" and again["compile_seconds"] == 0.0
    reg = port_metrics.MetricsRegistry()
    for payload in (first, again):
        assert payload["key_hash"] == "0123456789abcdef"
        assert payload["label"] == "adam.cu"
        assert port_schema.validate_event(
            {"event": "compile", "seq": 0, "t": 0.0, **payload}) == []
        reg.record_event("compile", payload)
    snap = reg.snapshot(stable_only=False)
    assert snap["pert_aot_disk_hits_total"]["value"] == 1
    assert snap["pert_compile_cache_hits_total"]["value"] == 1


def test_runner_driven_directly_opens_its_own_log(
        sim_data, tmp_path, monkeypatch):  # noqa: F811
    """Under a facade whose log is off, PertInference.run() opens a
    session of its own from telemetry_path and closes it with run_end."""
    scrt = _small(sim_data, telemetry_path=str(tmp_path / "r.jsonl"))
    real, made = port_runlog.RunLog.create, []

    def create(value, run_name="pert"):
        # the facade's log (the first) is off, the runner's is not
        made.append(real(value if made else None, run_name))
        return made[-1]
    monkeypatch.setattr(port_runlog.RunLog, "create", staticmethod(create))
    scrt.infer(level="pert")
    assert len(made) == 2 and not made[0].enabled
    events = _events(tmp_path / "r.jsonl")
    assert events[0]["event"] == "run_start"
    assert events[-1]["event"] == "run_end"
    assert events[-1]["status"] == "ok"
    assert [e["step"] for e in _of(events, "fit_end")] == ["step1", "step2"]


def test_a_runner_opens_its_log_and_registry_in_run(
        sim_data, tmp_path):  # noqa: F811
    """Building a runner writes no file and installs no registry; run(),
    driven without the facade, writes its own log from telemetry_path
    and retires the registry it installed."""
    from scdna_replication_tools_tpu_torch.config import PertConfig
    from scdna_replication_tools_tpu_torch.data.loader import (
        build_pert_inputs,
    )
    scrt = _small(sim_data, telemetry_path=None)
    scrt._ensure_clones(scrt.cols.assign_col)
    s, g1 = build_pert_inputs(scrt.cn_s, scrt.cn_g1, scrt.cols)
    clones = sorted(scrt.cn_g1["clone_id"].astype(str).unique())

    def clone_idx(cn, cell_ids):
        per_cell = cn.drop_duplicates("cell_id").set_index(
            "cell_id")["clone_id"].astype(str)
        return np.array([clones.index(per_cell[c]) for c in cell_ids],
                        np.int32)
    path = tmp_path / "direct.jsonl"
    runner = port_runner.PertInference(
        s, g1, PertConfig(max_iter=30, min_iter=10, run_step3=False,
                          telemetry_path=str(path)),
        clone_idx_s=clone_idx(scrt.cn_s, s.cell_ids),
        clone_idx_g1=clone_idx(scrt.cn_g1, g1.cell_ids),
        num_clones=len(clones), device="cpu")
    assert not path.exists()
    assert not port_metrics.current().enabled
    assert not runner.run_log.enabled and not runner.metrics.enabled
    runner.run()
    assert not port_metrics.current().enabled
    assert runner.metrics.enabled
    events = _events(path)
    assert port_schema.validate_run(path) == []
    assert events[-1]["event"] == "run_end"
    assert events[-1]["status"] == "ok"
    assert [e["step"] for e in _of(events, "fit_end")] == ["step1", "step2"]
