"""The port's slice as a whole: ``scRT(...).infer('pert')`` from the
PyTorch package against the JAX package on the same simulator frames.

Both run the reference-faithful path (controller, QC and mirror rescue
off) with the default ``g1_composite`` prior, so step 2 is dense and
step 3 sparse; the port runs on ``device='cpu'`` through the plain
versions of its kernels.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from scdna_replication_tools_tpu.api import scRT as JaxScRT
from scdna_replication_tools_tpu.models.simulator import pert_simulator
from scdna_replication_tools_tpu_torch import scRT as TorchScRT

from test_torch_model import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]

OPTS = dict(input_col="reads", clone_col="clone_id", assign_col="copy",
            cn_prior_method="g1_composite", max_iter=300, min_iter=100,
            rt_prior_col=None, run_step3=True, controller=False, qc=False,
            mirror_rescue=False, telemetry_path=None)


@pytest.fixture(scope="module")
def sim_data(synthetic_frames):
    df_s, df_g = synthetic_frames
    sim_s, sim_g = pert_simulator(
        df_s, df_g, num_reads=50_000, rt_cols=["rt_A", "rt_B"],
        clones=["A", "B"], lamb=0.75, betas=[0.5, 0.0], a=10.0, seed=11)
    for df in (sim_s, sim_g):
        df["reads"] = df["true_reads_norm"]
        df["state"] = df["true_somatic_cn"].astype(int)
        df["copy"] = df["true_somatic_cn"].astype(float)
    return sim_s, sim_g


@pytest.fixture(scope="module")
def outputs(sim_data):
    sim_s, sim_g = sim_data
    jax_out = JaxScRT(sim_s.copy(), sim_g.copy(), compile_cache_dir=None,
                      **OPTS).infer(level="pert")
    torch_out = TorchScRT(sim_s.copy(), sim_g.copy(), device="cpu",
                          **OPTS).infer(level="pert")
    return jax_out, torch_out


def _merged(jax_df, torch_df):
    keys = ["cell_id", "chr", "start"]
    cols = ["model_cn_state", "model_rep_state", "model_tau"]
    return pd.merge(jax_df[keys + cols], torch_df[keys + cols], on=keys,
                    suffixes=("_jax", "_torch"))


@pytest.mark.parametrize("frame", [0, 2], ids=["s_cells", "g1_cells"])
def test_states_and_tau_agree_with_jax(outputs, frame):
    """CN and replication states agree on >= 99% of bins and per-cell
    tau correlates >= 0.99 with the JAX run (the two fits round
    differently, so a few near-tied bins may decode apart)."""
    (jax_out, torch_out) = outputs
    m = _merged(jax_out[frame], torch_out[frame])
    assert len(m) == len(jax_out[frame]) == len(torch_out[frame])
    for col in ("model_cn_state", "model_rep_state"):
        agree = (m[f"{col}_jax"] == m[f"{col}_torch"]).mean()
        assert agree >= 0.99, (col, agree)
    tau = m.groupby("cell_id")[["model_tau_jax", "model_tau_torch"]].first()
    r = np.corrcoef(tau["model_tau_jax"], tau["model_tau_torch"])[0, 1]
    assert r >= 0.99, r


def test_lambda_agrees_with_jax(outputs):
    (jax_out, torch_out) = outputs
    lam = [o[1].query("param == 'model_lambda'")["value"].iloc[0]
           for o in (jax_out, torch_out)]
    assert abs(lam[0] - lam[1]) < 1e-3, lam


def test_port_recovers_simulated_truth(outputs):
    """The simulate-and-recover bars of tests/test_end_to_end.py."""
    _, (cn_s, supp_s, cn_g1, supp_g1) = outputs
    assert (cn_s["model_rep_state"] == cn_s["true_rep"]).mean() > 0.80
    assert (cn_s["model_cn_state"] == cn_s["true_somatic_cn"]).mean() > 0.90
    per_cell = cn_s.groupby("cell_id").agg(
        tau=("model_tau", "first"), true_t=("true_t", "first"))
    assert np.corrcoef(per_cell["tau"], per_cell["true_t"])[0, 1] > 0.8
    lamb = supp_s.query("param == 'model_lambda'")["value"].iloc[0]
    assert 0.5 < lamb < 0.95
    loss_s = supp_s.query("param == 'loss_s'")["value"].to_numpy()
    assert np.isfinite(loss_s).all() and loss_s[-1] < loss_s[0]
    for col in ["model_cn_state", "model_rep_state", "model_tau", "model_u",
                "model_rho", "model_p_rep"]:
        assert col in cn_s.columns and col in cn_g1.columns, col


@pytest.mark.parametrize("option", [
    dict(loci_shards=2), dict(num_shards=None),
    dict(executable_cache_dir="auto"), dict(executable_cache_dir="ec"),
    dict(num_shards=2), dict(num_shards=0)])
def test_unported_options_raise(sim_data, outputs, option, tmp_path,
                                monkeypatch):
    """A JAX option the port lacks raises NotImplementedError naming the
    ROADMAP item; it is never silently replaced.  The shard counts are
    ported (ROADMAP A12): without a process group, num_shards None or 0
    (every rank of the group) is the one-rank run and equals the plain
    run's frames, and a grid of two ranks raises ValueError naming
    init_distributed rather than run as one rank.  The compiled-program
    store is ported (ROADMAP A14): on the CPU its fits run eagerly
    (``uncacheable``) and the frames equal the plain run's."""
    sim_s, sim_g = sim_data
    # a relative store directory lands in the working directory
    monkeypatch.chdir(tmp_path)
    if option.get("num_shards", 1) in (None, 0) \
            or "executable_cache_dir" in option:
        scrt = TorchScRT(sim_s.copy(), sim_g.copy(), device="cpu",
                         **{**OPTS, **option})
        assert scrt.mesh is None
        got = scrt.infer(level="pert")
        for frame in (0, 2):
            pd.testing.assert_frame_equal(got[frame], outputs[1][frame])
        return
    with pytest.raises(ValueError, match="init_distributed"):
        TorchScRT(sim_s, sim_g, device="cpu", **{**OPTS, **option})


@pytest.mark.parametrize("option", [
    dict(clone_col=None), dict(cell_chunk=8), dict(cn_hmm_self_prob=0.9)])
def test_clone_discovery_chunking_and_viterbi_options_are_taken(sim_data,
                                                                option):
    """The options of ROADMAP A9 and A10's clone discovery reach the
    run (they raised before the port carried them)."""
    sim_s, sim_g = sim_data
    scrt = TorchScRT(sim_s, sim_g, device="cpu", **{**OPTS, **option})
    for key, value in option.items():
        if key == "clone_col":
            assert scrt.clone_col is None and scrt.cols.clone_col is None
        else:
            assert getattr(scrt.config, key) == value


@pytest.mark.parametrize("option", [
    dict(heartbeat_dir="hb"), dict(faults="oom@step2/fit"),
    dict(watchdog_chunk_seconds=5.0), dict(watchdog_compile_seconds=60.0),
    dict(checkpoint_dir="ck", resume="off", checkpoint_every=2)])
def test_durable_run_options_are_taken(sim_data, option):
    """The durable runs' options (ROADMAP A8) reach the run's config."""
    sim_s, sim_g = sim_data
    scrt = TorchScRT(sim_s, sim_g, device="cpu", **{**OPTS, **option})
    for key, value in option.items():
        assert getattr(scrt.config, key) == value


@pytest.mark.parametrize("option", [
    dict(trace_spans=True), dict(trace_parent="00aa11bb22cc33dd:r0.1"),
    dict(request_id="req-1"), dict(slab_width=4)])
def test_serving_and_tracing_options_are_taken(sim_data, option):
    """Span tracing (ROADMAP A11b) and the serving worker's per-request
    identity (A13) reach the run's config."""
    sim_s, sim_g = sim_data
    scrt = TorchScRT(sim_s, sim_g, device="cpu", **{**OPTS, **option})
    for key, value in option.items():
        assert getattr(scrt.config, key) == value


@pytest.mark.parametrize("option", [
    dict(enum_impl="binary_xla"), dict(enum_impl="pallas"),
    dict(enum_impl="binary_interpret"), dict(optimizer_state_dtype="float16"),
    dict(fused_adam="xla")])
def test_backend_specific_values_raise(sim_data, option):
    """The JAX package's backend-specific values have no meaning in the
    port ('auto' and 'binary' each run the CUDA kernels on the GPU and
    their plain versions on the CPU): ValueError, not a silent
    substitute."""
    sim_s, sim_g = sim_data
    with pytest.raises(ValueError, match=next(iter(option))):
        TorchScRT(sim_s, sim_g, device="cpu", **{**OPTS, **option})


# the observability and serving modules, among the modules the check
# walks
OBS_MODULES = ("obs.schema", "obs.metrics", "obs.heartbeat", "obs.runlog",
               "obs.spans", "obs.meter", "obs.summary", "utils.fileio",
               "utils.profiling", "serve.buckets", "serve.queue",
               "serve.slab", "serve.worker", "serve.cli", "parallel",
               "parallel.distributed", "parallel.mesh")


def test_port_imports_without_jax():
    """Importing the port (every module, the run log's obs/ and utils/
    modules and the serving worker among them) and chip_smoke.py pulls
    in no JAX, and no import statement of chip_smoke.py or of any module
    of the port (their functions may import lazily) names JAX or the JAX
    package."""
    code = (
        "import ast, sys, importlib, pkgutil\n"
        "import scdna_replication_tools_tpu_torch as p\n"
        "walked = set()\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "    walked.add(m.name[len(p.__name__) + 1:])\n"
        f"missing = set({OBS_MODULES!r}) - walked\n"
        "assert not missing, missing\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('scdna_replication_tools_tpu.')"
        " or m == 'scdna_replication_tools_tpu']\n"
        "assert not bad, bad\n"
        "import pathlib\n"
        "files = [chip_smoke.__file__] + sorted(str(f) for f in"
        " pathlib.Path(p.__path__[0]).rglob('*.py'))\n"
        "for f in files:\n"
        "    tree = ast.parse(open(f).read())\n"
        "    names = [a.name for n in ast.walk(tree)"
        " if isinstance(n, ast.Import) for a in n.names] + [n.module for n"
        " in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]\n"
        "    bad = [n for n in names if n.split('.')[0] in"
        " ('jax', 'scdna_replication_tools_tpu')]\n"
        "    assert not bad, (f, bad)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=REPO)
    assert res.returncode == 0, res.stderr
