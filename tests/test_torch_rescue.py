"""The mirror rescue and its per-cell scoring against the JAX package.

``per_cell_objective`` (the per-cell log-joint through the unfused
``enum_loglik``), ``PertInference._mirror_rescue`` on a step-2 state
carried over from the JAX package and corrupted into the mirrored basin
(as tests/test_mirror_rescue.py does), and ``scRT(mirror_rescue=True)``
frames.  The port runs on the CPU through its plain versions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.api import scRT as JaxScRT
from scdna_replication_tools_tpu.config import PertConfig as JaxPertConfig
from scdna_replication_tools_tpu.infer.runner import (
    PertInference as JaxPertInference,
)
from scdna_replication_tools_tpu.models import pert as jpert
from scdna_replication_tools_tpu.models.simulator import pert_simulator
from scdna_replication_tools_tpu.obs.runlog import RunLog
from scdna_replication_tools_tpu_torch import scRT as TorchScRT
from scdna_replication_tools_tpu_torch import weights
from scdna_replication_tools_tpu_torch.config import PertConfig
from scdna_replication_tools_tpu_torch.infer.runner import (
    PertInference,
    StepOutput,
)
from scdna_replication_tools_tpu_torch.infer.svi import FitResult
from scdna_replication_tools_tpu_torch.models import pert as tpert
from scdna_replication_tools_tpu_torch.ops import _cuda
from scdna_replication_tools_tpu_torch.ops.transforms import to_unit_interval

from test_mirror_rescue import _corrupt_to_mirror, _workload
from test_torch_model import _build, _inputs, one_torch_thread  # noqa: F401
from test_torch_pipeline import OPTS, _merged


def _case(kind, binary, seed):
    """Objective inputs of test_torch_model at 1e3 concentrations (dense
    and sparse): at 1e6 the parameter-free Dirichlet normaliser's lgamma
    terms are ~1e7 per bin, where XLA's and PyTorch's float32 lgamma
    differ by 2-4.  ``*_flat`` kinds have no prior data term, so the
    enumerated likelihood is a large share of each cell's objective."""
    inp = _inputs(kind, seed=seed, prior_scale=1e-3)
    inp["fields"] = {k: v * np.float32(1e-3) if k == "eta_w" else v
                     for k, v in inp["fields"].items()}
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
    if binary:
        jspec = jpert.PertModelSpec(enum_impl="binary_interpret",
                                    **inp["spec_kw"])
        tspec = tpert.PertModelSpec(binary_pi=True, **inp["spec_kw"])
        z = np.asarray(jpert.init_params(jspec, jbatch, jfixed,
                                         t_init=inp["t_init"])
                       ["pi_bin_logits"])
        rng = inp["rng"]
        if inp["flat"]:
            z = rng.normal(0, 2, z.shape)
        params = {k: v for k, v in params.items() if k != "pi_logits"}
        params["pi_bin_logits"] = (z + rng.normal(0, 0.1, z.shape)) \
            .astype(np.float32)
    # unit-scale GC-coefficient widths: at the init's 1e-4 the betas
    # prior is ~ -5e5 per cell for the seeded betas noise, and float32
    # sums of that size would set the comparison's scale
    params["beta_stds_raw"] = np.zeros_like(params["beta_stds_raw"])
    return inp, jspec, tspec, jbatch, tbatch, jfixed, params


# Per cell, relative to |objective|: float32 sums over 200 loci of terms
# that the two backends round differently (XLA's gammaln in the JAX
# joint, the Stirling series here; log_softmax in other orders).  With
# the 1e3 prior the Dirichlet term's sums (~1e5 per cell) and its
# normaliser's lgamma set the reading (up to 1.4e-5); without it the
# enumerated term does (up to 1.4e-6, 2.7e-3 absolute on the cell's
# enumerated sum).  A dropped (state, rep) weight or a swapped state
# moves a cell's enumerated sum by O(1-100), >= 4e-4 of the flat kinds'
# objectives (~2.5e3).
PCO_TOL = {"prior": 3e-5, "flat": 1e-5}


@pytest.mark.parametrize("binary", [False, True], ids=["cat", "binary"])
@pytest.mark.parametrize("kind", ["dense", "sparse", "dense_flat",
                                  "sparse_flat"])
def test_per_cell_objective_matches_jax(kind, binary):
    """The port's per-cell scoring (unfused enumeration, plain version)
    against JAX ``per_cell_objective`` (the dense XLA joint), both
    encodings and both prior encodings (``PCO_TOL``)."""
    inp, jspec, tspec, jbatch, tbatch, jfixed, params = _case(
        kind, binary, seed=31 + 2 * int(binary))
    ref = np.asarray(jpert.per_cell_objective(
        jspec, {k: jnp.asarray(v) for k, v in params.items()}, jfixed,
        jbatch))
    got = tpert.per_cell_objective(
        tspec, weights.params_from_jax(params, "cpu"),
        weights.fixed_from_jax(inp["fixed"], "cpu"), tbatch).numpy()
    assert got.shape == ref.shape == (inp["reads"].shape[0],)
    rel = np.abs(got - ref) / np.abs(ref)
    tol = PCO_TOL["flat" if kind.endswith("flat") else "prior"]
    assert float(rel.max()) < tol, float(rel.max())


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_per_cell_objective_decomposes_log_joint(kind):
    """sum over real cells of per_cell_objective + the global priors ==
    log_joint: the unfused scoring (enum_loglik) and the fused training
    objective compute the same model, so an accepted rescue raises the
    fit's objective (the JAX test of the same name)."""
    inp, _, tspec, _, tbatch, _, params = _case(kind, False, seed=41)
    tparams = weights.params_from_jax(params, "cpu")
    tfixed = weights.fixed_from_jax(inp["fixed"], "cpu")
    total = float(tpert.log_joint(tspec, tparams, tfixed, tbatch))
    per_cell = tpert.per_cell_objective(tspec, tparams, tfixed, tbatch)
    glob = float(tpert._global_log_prior(tpert._sites(tspec, tparams,
                                                      tfixed)))
    recon = float((per_cell * tbatch.mask).sum()) + glob
    assert abs(recon - total) <= abs(total) * 1e-5, (recon, total)


# ---------------------------------------------------------------------------
# _mirror_rescue on a carried-over step-2 state
# ---------------------------------------------------------------------------

# the JAX test's workload and budgets, at 1e3 clone-prior concentrations
# (the scoring's Dirichlet normaliser then agrees across backends)
RESCUE_CFG = dict(max_iter=250, min_iter=60, max_iter_step1=100,
                  min_iter_step1=30, run_step3=False,
                  cn_prior_method="g1_clones", cn_prior_weight=1e3,
                  mirror_max_iter=300, mirror_min_iter=50)


@pytest.fixture(scope="module")
def step2_jax(synthetic_frames):
    """JAX steps 1-2 on tests/test_mirror_rescue.py's engineered-tau
    workload, then three late-S cells moved into the mirrored basin."""
    s, g1, true_t, clone_idx = _workload(synthetic_frames)
    # no persistent compilation cache and no run log: either would switch
    # on process-wide JAX state for every later test of this xdist worker
    cache_dir = jax.config.jax_compilation_cache_dir
    inf = JaxPertInference(
        s, g1, JaxPertConfig(enum_impl="xla", compile_cache_dir=None,
                             telemetry_path=None, **RESCUE_CFG),
        clone_idx_s=clone_idx, clone_idx_g1=clone_idx, num_clones=2)
    step1 = inf.run_step1()
    step2 = inf.run_step2(step1, inf.build_etas())
    late = list(np.flatnonzero(true_t > 0.85))[:3]
    return (inf, _corrupt_to_mirror(step2, late), late,
            (cache_dir, jax.config.jax_compilation_cache_dir))


def test_jax_reference_run_leaves_the_compile_cache_alone(step2_jax):
    """The JAX runner this module builds must not switch on the
    persistent compilation cache: its default ('auto') does so for the
    whole process, and the later tests of the same xdist worker would
    then read programs that other workers wrote there."""
    before, after = step2_jax[3]
    assert after == before


def _to_port(step) -> StepOutput:
    """A JAX StepOutput as the port's: same spec fields, batch arrays,
    conditioning and fitted parameters."""
    js, jb = step.spec, step.batch
    spec = tpert.PertModelSpec(
        P=js.P, K=js.K, L=js.L, tau_mode=js.tau_mode, step1=js.step1,
        cond_beta_means=js.cond_beta_means, cond_rho=js.cond_rho,
        cond_a=js.cond_a, fixed_lamb=js.fixed_lamb,
        sparse_etas=js.sparse_etas, binary_pi=js.binary_pi)

    def t(x, dtype=torch.float32):
        return None if x is None else torch.tensor(np.asarray(x),
                                                   dtype=dtype)
    batch = tpert.PertBatch(
        reads=t(jb.reads), libs=t(jb.libs, torch.int64),
        gamma_feats=t(jb.gamma_feats), mask=t(jb.mask),
        loci_mask=t(jb.loci_mask), etas=t(jb.etas), eta_idx=t(jb.eta_idx),
        eta_w=t(jb.eta_w))
    fit = FitResult(params=weights.params_from_jax(step.fit.params, "cpu"),
                    losses=np.asarray(step.fit.losses),
                    num_iters=int(step.fit.num_iters), converged=False,
                    nan_abort=False)
    return StepOutput(fit, spec, weights.fixed_from_jax(step.fixed, "cpu"),
                      batch, 0.0)


def _final_objective(package, step, params):
    """(cells,) per-cell objective of a rescued step under the rescue's
    conditioning (every global site fixed at the step-2 fit)."""
    if package == "jax":
        spec = dataclasses.replace(step.spec, cond_rho=True, cond_a=True)
        c = jpert.constrained(step.spec, params, step.fixed)
        fixed = dict(step.fixed, rho=c["rho"], a=c["a"])
        return np.asarray(jpert.per_cell_objective(spec, params, fixed,
                                                   step.batch))
    spec = dataclasses.replace(step.spec, cond_rho=True, cond_a=True)
    c = tpert._sites(step.spec, params, step.fixed)
    fixed = dict(step.fixed, rho=c["rho"], a=c["a"])
    with torch.no_grad():
        return tpert.per_cell_objective(spec, params, fixed,
                                        step.batch).numpy()


@pytest.mark.parametrize("max_cells", [256, 1], ids=["all", "capped"])
def test_mirror_rescue_matches_jax(step2_jax, max_cells):
    """From the same corrupted step-2 state: the same candidates, the same
    accepted cells (every corrupted cell restored to tau > 0.5), the same
    cap (the most boundary-extreme first), and per-cell objectives of the
    spliced fits within 1e-5 of JAX's (two independent float32 sub-fits
    of 300 iterations, compared near their optimum).  The CPU path
    launches no kernel."""
    jinf, corrupted, late, _ = step2_jax
    jinf.config = dataclasses.replace(jinf.config, mirror_max_cells=max_cells)
    jres = jinf._mirror_rescue(corrupted, corrupted.batch)

    port_in = _to_port(corrupted)
    tinf = PertInference(jinf.s, jinf.g1, PertConfig(
        mirror_max_cells=max_cells, **RESCUE_CFG), device="cpu")
    _cuda.reset_launches()
    tres = tinf._mirror_rescue(port_in, port_in.batch)
    assert sum(_cuda.LAUNCHES.values()) == 0

    assert tinf.mirror_rescue_stats == jinf.mirror_rescue_stats
    assert tinf.mirror_rescue_stats["candidates"] >= len(late)
    for key in ("candidates", "accepted"):
        np.testing.assert_array_equal(tinf._rescue_cells[key],
                                      jinf._rescue_cells[key])
    accepted = tinf._rescue_cells["accepted"]
    if max_cells == 1:
        assert tinf.mirror_rescue_stats["capped_to"] == 1
        assert len(accepted) <= 1
    else:
        assert set(late) <= set(accepted.tolist())
    tau = to_unit_interval(tres.fit.params["tau_raw"]).numpy()
    assert all(tau[i] > 0.5 for i in accepted)
    # cells outside the accepted set keep their step-2 parameters
    rest = np.setdiff1d(np.arange(tau.size), accepted)
    for key in ("tau_raw", "u"):
        np.testing.assert_array_equal(
            tres.fit.params[key].numpy()[rest],
            port_in.fit.params[key].numpy()[rest])
    jobj = _final_objective("jax", jres, jres.fit.params)
    tobj = _final_objective("torch", tres, tres.fit.params)
    rel = np.abs(tobj - jobj) / np.abs(jobj)
    assert float(rel.max()) < 1e-5, float(rel.max())


# ---------------------------------------------------------------------------
# scRT(mirror_rescue=True)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rescued_outputs(synthetic_frames):
    """scRT of both packages with the rescue on, on a late-S cohort whose
    fitted taus sit near 0.73-0.9.  The tau window's upper edge is moved
    to 0.8 on both configs so that about half the cells are candidates
    (none crosses the default 0.9 at this size)."""
    df_s, df_g = synthetic_frames
    sim_s, sim_g = pert_simulator(
        df_s, df_g, num_reads=50_000, rt_cols=["rt_A", "rt_B"],
        clones=["A", "B"], lamb=0.75, betas=[0.5, 0.0], a=10.0, seed=11,
        tau_range=(0.85, 0.97))
    for df in (sim_s, sim_g):
        df["reads"] = df["true_reads_norm"]
        df["state"] = df["true_somatic_cn"].astype(int)
        df["copy"] = df["true_somatic_cn"].astype(float)
    opts = dict(OPTS, max_iter=150, min_iter=50, run_step3=False,
                mirror_rescue=True)
    narrow = dict(mirror_tau_hi=0.8, mirror_max_iter=200)
    jax_scrt = JaxScRT(sim_s.copy(), sim_g.copy(), compile_cache_dir=None,
                       **opts)
    jax_scrt.config = dataclasses.replace(jax_scrt.config, **narrow)
    port = TorchScRT(sim_s.copy(), sim_g.copy(), device="cpu", **opts)
    port.config = dataclasses.replace(port.config, **narrow)
    return (jax_scrt.infer(level="pert"), port.infer(level="pert"),
            jax_scrt, port)


def test_scrt_mirror_rescue_frames_match_jax(rescued_outputs):
    """The rescue ran on both sides with the same statistics, which land
    in the supplementary table as mirror_rescue_{candidates,accepted}
    rows; CN and replication states agree on >= 99 % of bins and tau
    correlates >= 0.99, as without the rescue."""
    jax_out, torch_out, jax_scrt, port = rescued_outputs
    assert port.mirror_rescue_stats == jax_scrt.mirror_rescue_stats
    assert port.mirror_rescue_stats["candidates"] > 0
    assert port.mirror_rescue_fit.fit.num_iters > 0
    # no cap at this size: every candidate was re-fitted
    assert len(port.mirror_rescue_fit.cells) \
        == port.mirror_rescue_stats["candidates"]
    rows = [o[1][o[1]["param"].str.startswith("mirror_rescue_")]
            .reset_index(drop=True) for o in (jax_out, torch_out)]
    assert list(rows[1]["param"]) == ["mirror_rescue_candidates",
                                      "mirror_rescue_accepted"]
    assert rows[0].equals(rows[1])
    m = _merged(jax_out[0], torch_out[0])
    assert len(m) == len(jax_out[0]) == len(torch_out[0])
    for col in ("model_cn_state", "model_rep_state"):
        assert (m[f"{col}_jax"] == m[f"{col}_torch"]).mean() >= 0.99, col
    tau = m.groupby("cell_id")[["model_tau_jax", "model_tau_torch"]].first()
    assert np.corrcoef(tau["model_tau_jax"], tau["model_tau_torch"])[0, 1] \
        >= 0.99


# ---------------------------------------------------------------------------
# measurement: the gated mirror rescue of both packages on chip_smoke.py's
# simulated frames (not a test)
# ---------------------------------------------------------------------------

def measure_gated_rescue(cells: int, loci: int, g1_cells: int,
                         configs=("default",)) -> dict:
    """Both packages' ``scRT(..., telemetry_path=None)`` on the CPU on
    chip_smoke.py's simulated frames at ``cells`` S + ``g1_cells`` G1
    cells x ``loci`` loci (its flagship shape cut in scale only): the
    default config (controller, QC, gated rescue; 1e6 composite prior,
    tau window [0.1, 0.9]) and, with ``"ungated"`` in ``configs``, the
    always-on rescue without the controller (QC on, which moves no fit).
    Per package: the decisions, the gate's trigger, the candidate and
    accepted cell sets, each re-fitted cell's scoring margin (sub-fit
    minus step-2 per-cell objective; accepted when positive), tau
    correlation with the simulated truth, and the wall seconds."""
    import sys
    import time
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from scdna_replication_tools_tpu.infer import runner as jax_runner
    from scdna_replication_tools_tpu_torch.infer import runner as port_runner

    chip_smoke.CELLS, chip_smoke.LOCI, chip_smoke.G1_CELLS = \
        cells, loci, g1_cells
    cn_s, cn_g1 = chip_smoke.simulate_frames()
    opts = dict(input_col="reads", clone_col="clone_id", assign_col="copy",
                cn_prior_method="g1_composite", max_iter=300, min_iter=100,
                rt_prior_col=None, telemetry_path=None)
    extra = {"default": {},
             "ungated": dict(controller=False)}
    out = {"shape": [cells, g1_cells, loci]}
    for cfg in configs:
        for package in ("jax", "port"):
            log = []

            class Log(RunLog):
                def __init__(self):
                    super().__init__(None)

                def emit(self, event, **payload):
                    log.append((event, payload))
                    super().emit(event, **payload)
            mp = pytest.MonkeyPatch()
            # the rescue's two per-cell scorings (step-2 and sub-fit
            # parameters), kept to give each candidate's margin
            scores = []
            runner = jax_runner if package == "jax" else port_runner

            def scored(*a, _orig=runner.per_cell_objective, **k):
                out = _orig(*a, **k)
                scores.append(np.asarray(out, np.float64))
                return out
            mp.setattr(runner, "per_cell_objective", scored)
            t0 = time.perf_counter()
            if package == "jax":
                mp.setattr(RunLog, "create",
                           classmethod(lambda cls, *a, **k: Log()))
                scrt = JaxScRT(cn_s.copy(), cn_g1.copy(),
                               compile_cache_dir=None, **opts, **extra[cfg])
            else:
                scrt = TorchScRT(cn_s.copy(), cn_g1.copy(), device="cpu",
                                 run_log=Log(), **opts, **extra[cfg])
            try:
                frames = scrt.infer(level="pert")
            finally:
                mp.undo()
            wall = time.perf_counter() - t0
            per_cell = frames[0].groupby("cell_id").agg(
                tau=("model_tau", "first"), true_t=("true_t", "first"))
            rec = {"wall_s": wall,
                   "stats": dict(scrt.mirror_rescue_stats or {}),
                   "tau_r": float(np.corrcoef(per_cell["tau"],
                                              per_cell["true_t"])[0, 1]),
                   "decisions": [
                       {k: p[k] for k in ("step", "action", "iter", "budget")}
                       for e, p in log if e == "control_decision"],
                   "gate_trigger": [p["trigger"] for e, p in log
                                    if e == "control_decision"
                                    and p["action"].startswith("rescue")]}
            qc = scrt.cell_qc()
            if len(scores) == 2:
                # per_cell_objective(new) - (orig) per re-fitted cell, in
                # the rescue's candidate order (the QC table's cell order
                # when no cap applies)
                fitted = qc.loc[qc["rescue_candidate"], "cell_id"]
                if len(fitted) == len(scores[0]):
                    rec["margins"] = dict(zip(
                        fitted, (scores[1] - scores[0]).tolist()))
            rec["candidates"] = sorted(qc.loc[qc["rescue_candidate"],
                                              "cell_id"])
            rec["accepted"] = sorted(qc.loc[qc["rescue_accepted"],
                                            "cell_id"])
            rec["qc_flags"] = qc["qc_flags"].value_counts().to_dict()
            out[f"{cfg} {package}"] = rec
            print(cfg, package, {k: v for k, v in rec.items()
                                 if k not in ("candidates", "margins")},
                  flush=True)
    return out


if __name__ == "__main__":
    # python tests/test_torch_rescue.py CELLS LOCI G1_CELLS OUT.json
    # [default] [ungated]: the measurement above (default config alone
    # without a config name), from the repository root with
    # JAX_PLATFORMS=cpu and the repository on PYTHONPATH
    import json
    import sys

    import conftest  # noqa: F401  (JAX on the CPU, before its first use)

    n, l, g, path = sys.argv[1:5]
    result = measure_gated_rescue(int(n), int(l), int(g),
                                  tuple(sys.argv[5:]) or ("default",))
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1, default=float)
