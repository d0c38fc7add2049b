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
        mirror_max_cells=max_cells, telemetry_path=None, **RESCUE_CFG),
        device="cpu")
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

def _simulated(cells: int, loci: int, g1_cells: int):
    """chip_smoke.py's simulated frames cut to ``cells`` S + ``g1_cells``
    G1 cells x ``loci`` loci."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    chip_smoke.CELLS, chip_smoke.LOCI, chip_smoke.G1_CELLS = \
        cells, loci, g1_cells
    return chip_smoke.simulate_frames()


MEASURE_OPTS = dict(input_col="reads", clone_col="clone_id",
                    assign_col="copy", cn_prior_method="g1_composite",
                    max_iter=300, min_iter=100, rt_prior_col=None,
                    telemetry_path=None)


def measure_gated_rescue(cells: int, loci: int, g1_cells: int,
                         configs=("default",)) -> dict:
    """Both packages' ``scRT`` on the CPU on
    chip_smoke.py's simulated frames at ``cells`` S + ``g1_cells`` G1
    cells x ``loci`` loci (its flagship shape cut in scale only): the
    default config (controller, QC, gated rescue; 1e6 composite prior,
    tau window [0.1, 0.9]) and, with ``"ungated"`` in ``configs``, the
    always-on rescue without the controller (QC on, which moves no fit).
    Per package: the decisions, the gate's trigger, the candidate and
    accepted cell sets, each re-fitted cell's scoring margin (sub-fit
    minus step-2 per-cell objective; accepted when positive), tau
    correlation with the simulated truth, and the wall seconds."""
    import json
    import tempfile
    import time
    from pathlib import Path

    from scdna_replication_tools_tpu.infer import runner as jax_runner
    from scdna_replication_tools_tpu_torch.infer import runner as port_runner

    cn_s, cn_g1 = _simulated(cells, loci, g1_cells)
    extra = {"default": {},
             "ungated": dict(controller=False)}
    out = {"shape": [cells, g1_cells, loci]}
    logs = tempfile.mkdtemp()
    for cfg in configs:
        for package in ("jax", "port"):
            # each package's own run log, read back for its decisions
            opts = dict(MEASURE_OPTS, **extra[cfg],
                        telemetry_path=str(Path(logs) / f"{package}.jsonl"))
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
                scrt = JaxScRT(cn_s.copy(), cn_g1.copy(),
                               compile_cache_dir=None, **opts)
            else:
                scrt = TorchScRT(cn_s.copy(), cn_g1.copy(), device="cpu",
                                 **opts)
            try:
                frames = scrt.infer(level="pert")
            finally:
                mp.undo()
            wall = time.perf_counter() - t0
            log = [json.loads(line) for line in
                   Path(scrt.run_log_path).read_text().splitlines()]
            decisions = [e for e in log if e["event"] == "control_decision"]
            per_cell = frames[0].groupby("cell_id").agg(
                tau=("model_tau", "first"), true_t=("true_t", "first"))
            rec = {"wall_s": wall,
                   "stats": dict(scrt.mirror_rescue_stats or {}),
                   "tau_r": float(np.corrcoef(per_cell["tau"],
                                              per_cell["true_t"])[0, 1]),
                   "decisions": [
                       {k: d[k] for k in ("step", "action", "iter", "budget")}
                       for d in decisions],
                   "gate_trigger": [d["trigger"] for d in decisions
                                    if d["action"].startswith("rescue")]}
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


def _run_capturing(package: str, frames, **extra) -> dict:
    """One package's ``scRT`` on ``frames``, recording each step fit as
    ``_fit`` returns it, the step-2 state as it enters the mirror
    rescue, the rescue's result and its two per-cell scorings."""
    from scdna_replication_tools_tpu.infer import runner as jax_runner
    from scdna_replication_tools_tpu_torch.infer import runner as port_runner

    runner = jax_runner if package == "jax" else port_runner
    store = {"fits": {}, "scores": [], "fit_maps": []}
    mp = pytest.MonkeyPatch()

    def fit_map(*a, _orig=runner.fit_map, **k):
        res = _orig(*a, **k)
        store["fit_maps"].append(res)
        return res

    def rescue_fit_map(loss_fn, params0, args, _orig=runner.fit_map, **k):
        # the sub-fit's call, with a copy of its start (JAX's fit
        # donates it)
        store["subfit_call"] = (loss_fn, _copy(params0), args, k)
        return fit_map(loss_fn, params0, args, **k)

    def fit(self, *a, _orig=runner.PertInference._fit, **k):
        out = _orig(self, *a, **k)
        store["fits"][a[-1] if len(a) >= 7 else k["step_name"]] = out.fit
        return out

    def rescue(self, out, batch, _orig=runner.PertInference._mirror_rescue):
        store.update(runner=self, step2=out)
        before = len(store["fit_maps"])
        mp.setattr(runner, "fit_map", rescue_fit_map)
        try:
            store["rescued"] = _orig(self, out, batch)
        finally:
            mp.setattr(runner, "fit_map", fit_map)
        # the rescue's sub-fit, when it ran one
        store["subfit"] = store["fit_maps"][before] \
            if len(store["fit_maps"]) > before else None
        return store["rescued"]

    def scored(*a, _orig=runner.per_cell_objective, **k):
        res = _orig(*a, **k)
        store["scores"].append(np.asarray(res, np.float64))
        return res
    mp.setattr(runner, "fit_map", fit_map)
    mp.setattr(runner.PertInference, "_fit", fit)
    mp.setattr(runner.PertInference, "_mirror_rescue", rescue)
    mp.setattr(runner, "per_cell_objective", scored)
    cn_s, cn_g1 = frames
    opts = dict(MEASURE_OPTS, **extra)
    if package == "jax":
        scrt = JaxScRT(cn_s.copy(), cn_g1.copy(), compile_cache_dir=None,
                       **opts)
    else:
        scrt = TorchScRT(cn_s.copy(), cn_g1.copy(), device="cpu", **opts)
    try:
        store["frames"] = scrt.infer(level="pert")
    finally:
        mp.undo()
    store["scrt"] = scrt
    return store


def _copy(params: dict) -> dict:
    return {k: v.clone() if isinstance(v, torch.Tensor) else np.array(v)
            for k, v in params.items()}


def _as_np(v) -> np.ndarray:
    return (v.detach().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v)).astype(np.float64)


def _subfits_apart(jcall, tcall, iters=(1, 2, 10, 100, 200)) -> dict:
    """The two rescues' sub-fits from their captured calls: how far the
    starts lie apart, the gradients' sign disagreements at the starts,
    and how far the parameters lie apart after ``iters`` iterations of
    each package's ``fit_map``."""
    from scdna_replication_tools_tpu.infer.svi import fit_map as jfit_map
    from scdna_replication_tools_tpu_torch.infer.svi import (
        fit_map as tfit_map,
    )

    jl, jp, ja, jk = jcall
    tl, tp, ta, tk = tcall
    rec = {"start_max_abs": {k: float(np.abs(_as_np(jp[k])
                                              - _as_np(tp[k])).max())
                             for k in jp}}
    gj = jax.grad(lambda p: jl(p, *ja))({k: jnp.asarray(v)
                                         for k, v in jp.items()})
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tl(leaves, *ta).backward()
    rec["gradient_signs"] = {}
    for k in jp:
        a, b = _as_np(gj[k]), _as_np(leaves[k].grad)
        flips = np.sign(a) != np.sign(b)
        rec["gradient_signs"][k] = {
            "entries": int(a.size), "flips": int(flips.sum()),
            "max_abs_g": float(np.abs(a).max()),
            "median_abs_g": float(np.median(np.abs(a))),
            "max_abs_g_at_flip": float(np.abs(a[flips]).max())
            if flips.any() else None}
    rec["apart_after"] = {}
    for n in iters:
        fj = jfit_map(jl, {k: jnp.asarray(np.array(v)) for k, v in jp.items()},
                      ja, **dict(jk, max_iter=n, min_iter=n))
        ft = tfit_map(tl, _copy(tp), ta, **dict(tk, max_iter=n, min_iter=n))
        row = {k: float(np.abs(_as_np(fj.params[k])
                               - _as_np(ft.params[k])).max())
               for k in jp}
        sig = [1.0 / (1.0 + np.exp(-_as_np(f.params["tau_raw"])))
               for f in (fj, ft)]
        row["tau"] = float(np.abs(sig[0] - sig[1]).max())
        row["pi_entries_apart"] = int((np.abs(
            _as_np(fj.params["pi_logits"])
            - _as_np(ft.params["pi_logits"])) > 1e-3).sum())
        rec["apart_after"][n] = row
    return rec


def _tau(step) -> np.ndarray:
    tau = step.fit.params["tau_raw"]
    if isinstance(tau, torch.Tensor):
        return to_unit_interval(tau).numpy().astype(np.float64)
    return np.asarray(1.0 / (1.0 + np.exp(-np.asarray(tau, np.float64))))


def _loss_offset(step) -> float:
    """JAX's minus the port's loss of the same step-2 state: what the two
    objectives disagree on at equal parameters (the parameter-free
    Dirichlet normaliser, whose float32 lgamma of 1e6 concentrations
    XLA and PyTorch round differently)."""
    port = _to_port(step)
    jl = float(jpert.pert_loss(step.spec, step.fit.params, step.fixed,
                               step.batch))
    with torch.no_grad():
        tl = float(tpert.pert_loss(port.spec, port.fit.params, port.fixed,
                                   port.batch))
    return jl - tl


def _parting(a, b, offset: float = 0.0) -> dict:
    """Where two loss trajectories part: the per-iteration relative gap,
    less ``offset`` (the two objectives' gap at equal parameters), and
    the first iteration at which it exceeds 1e-6 (about eight float32
    ulps), 1e-5 and 1e-4."""
    n = min(len(a), len(b))
    a = np.asarray(a[:n], np.float64)
    b = np.asarray(b[:n], np.float64)
    rel = np.abs(a - b - offset) / np.abs(a)

    def first(tol):
        over = np.flatnonzero(rel > tol)
        return int(over[0]) if over.size else None
    return {"iters": [len(a), len(b)], "offset": offset,
            "first_parting_iter": {str(t): first(t)
                                   for t in (1e-6, 1e-5, 1e-4)},
            "rel_gap_at": {int(i): float(rel[i])
                           for i in (0, 1, 2, 5, 10, 25, 50, 100, 150, 200,
                                     250, n - 1) if i < n}}


def _start_parting(a, b) -> dict:
    """:func:`_parting` of two fits from the same parameters: their gap
    at iteration 0 is the objectives' offset."""
    return _parting(a, b, offset=float(a[0]) - float(b[0]))


def measure_carried_rescue(cells: int, loci: int, g1_cells: int) -> dict:
    """The always-on rescue without the controller (``controller=False``)
    in both packages, then JAX's step-2 state, as it entered JAX's
    rescue, carried into the port's ``PertInference._mirror_rescue``
    (``_to_port``).  Returns the two step-2 loss trajectories' parting
    iteration, the per-cell tau gap of the two step-2 fits, each
    rescue's candidates, accepted cells and scoring margins (sub-fit
    minus step-2 per-cell objective) by cell id, the carried rescue's
    agreement with JAX's (statistics, accepted cells, the spliced fits'
    per-cell objectives) and where the two sub-fits' loss trajectories
    part from the shared start; and, for scale, JAX's rescue from its own
    step-2 state with its parameters moved by one float32 ulp and by 1e-5
    of themselves."""
    from scdna_replication_tools_tpu.infer import runner as jax_runner
    from scdna_replication_tools_tpu_torch.infer import runner as port_runner

    frames = _simulated(cells, loci, g1_cells)
    runs = {p: _run_capturing(p, frames, controller=False)
            for p in ("jax", "port")}
    jrun, trun = runs["jax"], runs["port"]
    jinf = jrun["runner"]
    ids = np.asarray(jinf._step2_data.cell_ids)

    def rescue_rec(inf, scores):
        cand = inf._rescue_cells.get("fitted", inf._rescue_cells[
            "candidates"])
        rec = {"stats": dict(inf.mirror_rescue_stats),
               "candidates": sorted(ids[inf._rescue_cells["candidates"]]),
               "accepted": sorted(ids[inf._rescue_cells["accepted"]])}
        if len(scores) == 2:
            rec["margins"] = dict(zip(ids[cand].tolist(),
                                      (scores[1] - scores[0]).tolist()))
        return rec
    offset = _loss_offset(jrun["step2"])
    out = {"shape": [cells, g1_cells, loci],
           "step1_losses": _start_parting(jrun["fits"]["step1"].losses,
                                          trun["fits"]["step1"].losses),
           "step2_losses_raw": _parting(jrun["fits"]["step2"].losses,
                                        trun["fits"]["step2"].losses),
           "step2_losses": _parting(jrun["fits"]["step2"].losses,
                                    trun["fits"]["step2"].losses,
                                    offset=offset)}
    gap = np.abs(_tau(jrun["step2"]) - _tau(trun["step2"]))
    n = len(ids)
    out["step2_tau_gap"] = {"max": float(gap[:n].max()),
                            "cell": str(ids[int(np.argmax(gap[:n]))]),
                            "iters": [int(jrun["fits"]["step2"].num_iters),
                                      int(trun["fits"]["step2"].num_iters)]}
    # the JAX dict of _rescue_cells has no "fitted" entry: with no cap its
    # re-fitted cells are its candidates
    out["jax"] = rescue_rec(jinf, jrun["scores"])
    out["port"] = rescue_rec(trun["runner"], trun["scores"])

    tinf = PertInference(
        jinf.s, jinf.g1, trun["scrt"].config,
        clone_idx_s=jinf.clone_idx_s, clone_idx_g1=jinf.clone_idx_g1,
        num_clones=jinf.num_clones, device="cpu")
    port_in = _to_port(jrun["step2"])
    scores, calls = [], []
    mp = pytest.MonkeyPatch()

    def scored(*a, _orig=port_runner.per_cell_objective, **k):
        res = _orig(*a, **k)
        scores.append(np.asarray(res, np.float64))
        return res

    def called(loss_fn, params0, args, _orig=port_runner.fit_map, **k):
        calls.append((loss_fn, _copy(params0), args, k))
        return _orig(loss_fn, params0, args, **k)
    mp.setattr(port_runner, "per_cell_objective", scored)
    mp.setattr(port_runner, "fit_map", called)
    try:
        tres = tinf._mirror_rescue(port_in, port_in.batch)
    finally:
        mp.undo()
    carried = rescue_rec(tinf, scores)
    jobj = _final_objective("jax", jrun["rescued"],
                            jrun["rescued"].fit.params)
    tobj = _final_objective("torch", tres, tres.fit.params)
    # the port's scoring of JAX's spliced parameters: the two rescued
    # fits compared under one objective, apart from the scorers' gap
    jres_port = _to_port(jrun["rescued"])
    tobj_j = _final_objective("torch", jres_port, jres_port.fit.params)
    rel = np.abs(tobj - jobj) / np.abs(jobj)
    rel_fit = np.abs(tobj - tobj_j) / np.abs(tobj_j)
    rel_scorer = np.abs(tobj_j - jobj) / np.abs(jobj)
    carried.update(
        same_stats=carried["stats"] == out["jax"]["stats"],
        same_accepted=carried["accepted"] == out["jax"]["accepted"],
        objective_rel_max=float(rel[:n].max()),
        objective_rel_max_one_scorer=float(rel_fit[:n].max()),
        scorer_rel_max=float(rel_scorer[:n].max()))
    out["carried"] = carried
    # the two rescues' sub-fits from the same state: where their loss
    # trajectories part, less their gap at the shared start (the
    # objectives' parameter-free offset)
    jsub = jrun["subfit"].losses
    tsub = tinf.rescue_fit.fit.losses
    out["subfit_losses"] = _start_parting(jsub, tsub)
    out["subfits"] = _subfits_apart(jrun["subfit_call"], calls[0])
    # JAX against itself: its rescue from its own step-2 state with half
    # of every parameter's entries moved by one float32 ulp, and with
    # every entry moved by 1e-5 of itself (the size of the two
    # objectives' gradient gap at a shared state); the sub-fit starts
    # from tau, betas and beta_stds (pi and u are re-seeded)
    rng = np.random.default_rng(0)
    state = {k: np.array(v) for k, v in jrun["step2"].fit.params.items()}
    nudges = {
        "jax_nudged_one_ulp": lambda v: np.where(
            rng.random(v.shape) < 0.5, np.nextafter(v, np.float32(np.inf)),
            v),
        "jax_nudged_rel_1e-5": lambda v: (v * (1.0 + 1e-5 * rng.standard_normal(
            v.shape))).astype(np.float32),
    }
    for name, nudge in nudges.items():
        step = jrun["step2"]
        nudged = dataclasses.replace(step, fit=dataclasses.replace(
            step.fit, params={k: jnp.asarray(nudge(v))
                              for k, v in state.items()}))
        scores = []
        mp = pytest.MonkeyPatch()

        def jax_scored(*a, _orig=jax_runner.per_cell_objective, **k):
            res = _orig(*a, **k)
            scores.append(np.asarray(res, np.float64))
            return res
        mp.setattr(jax_runner, "per_cell_objective", jax_scored)
        try:
            jinf._mirror_rescue(nudged, nudged.batch)
        finally:
            mp.undo()
        out[name] = rescue_rec(jinf, scores)
    return out


def measure_controller_replay(cells: int, loci: int, g1_cells: int) -> dict:
    """Both packages' default ``scRT`` (controller on); then JAX's step-2
    loss and gradient-norm history, window by window up to iteration
    150, through JAX's and the port's ``controller.evaluate`` (with the
    doctor under it), the verdict chain threaded as the fit loop threads
    it; the port's own history through the port's; and where the two
    step-2 loss trajectories part."""
    from scdna_replication_tools_tpu.obs import controller as jctl
    from scdna_replication_tools_tpu_torch.obs import controller as tctl

    frames = _simulated(cells, loci, g1_cells)
    runs = {p: _run_capturing(p, frames) for p in ("jax", "port")}
    cfgs = {"jax": runs["jax"]["scrt"].config,
            "port": runs["port"]["scrt"].config}
    max_iter, min_iter = cfgs["port"].max_iter, cfgs["port"].min_iter
    every = cfgs["port"].fit_diag_every

    def replay(fit, ctl, cfg, upto=150):
        policy = ctl.ControllerPolicy.from_config(cfg, max_iter)
        d = fit.diagnostics
        prev, reseeds, anchor, rows = None, 0, 0, []
        for w in range(every, upto + 1, every):
            grad = np.asarray(d["grad_norm"])[np.asarray(d["iter"]) < w]
            decision, prev = ctl.evaluate(
                policy, losses=np.asarray(fit.losses[:w]), it=w,
                budget=max_iter, min_iter=min_iter,
                grad_norm_first=float(grad[0]) if grad.size else None,
                grad_norm_last=float(grad[-1]) if grad.size else None,
                exhausted=False, reseeds_done=reseeds,
                prev_verdict=prev, stagnation_start=anchor)
            action = decision["action"] if decision else None
            rows.append({"iter": w, "verdict": prev, "action": action})
            if action == "reseed":
                reseeds, prev, anchor = reseeds + 1, None, w
            elif action == "early_stop":
                break
        return rows
    jfit, tfit = runs["jax"]["fits"]["step2"], runs["port"]["fits"]["step2"]
    out = {"shape": [cells, g1_cells, loci],
           "jax_history": {"jax": replay(jfit, jctl, cfgs["jax"]),
                           "port": replay(jfit, tctl, cfgs["port"])},
           "port_history": replay(tfit, tctl, cfgs["port"]),
           "decisions": {p: [{k: d[k] for k in ("action", "iter")}
                             for d in runs[p]["fits"]["step2"].decisions]
                         for p in runs},
           "step1_losses": _start_parting(
               runs["jax"]["fits"]["step1"].losses,
               runs["port"]["fits"]["step1"].losses),
           "step2_losses": _parting(jfit.losses, tfit.losses,
                                    offset=_loss_offset(runs["jax"]["step2"])
                                    if "step2" in runs["jax"] else 0.0)}
    out["same_verdicts"] = out["jax_history"]["jax"] \
        == out["jax_history"]["port"]
    return out


def _double(x):
    return x.double() if isinstance(x, torch.Tensor) \
        and x.is_floating_point() else x


def _step_as_double(step: StepOutput) -> StepOutput:
    """A port StepOutput with every floating tensor widened to float64."""
    b = step.batch
    batch = tpert.PertBatch(
        **{k: _double(getattr(b, k)) for k in (
            "reads", "libs", "gamma_feats", "mask", "etas", "cn_obs",
            "rep_obs", "t_alpha", "t_beta", "loci_mask", "eta_idx",
            "eta_w")})
    fit = dataclasses.replace(step.fit, params={
        k: _double(v) for k, v in step.fit.params.items()})
    return dataclasses.replace(step, fit=fit, batch=batch, fixed={
        k: _double(v) for k, v in step.fixed.items()})


def measure_float64_witness(cells: int, loci: int, g1_cells: int) -> dict:
    """JAX's step-2 state of the always-on rescue (``controller=False``)
    carried into the port's ``PertInference._mirror_rescue`` twice: in
    float32 (as ``carried`` measures it) and in float64, the exact
    reference the two float32 packages are held against.  The float64
    rescue runs the port's own code with every float32 tensor it makes
    widened (``torch.float32`` read as float64 for the call, Adam's
    moments too) and its sub-fit started from the float32 rescue's start
    widened, so only the arithmetic's width differs.  Returns the three
    rescues' accepted cells and scoring margins by cell id (JAX float32,
    port float32, port float64), and the sign disagreements of JAX's and
    the port's float32 gradients with the float64 gradient at the
    sub-fit's start."""
    from scdna_replication_tools_tpu.infer import runner as jax_runner
    from scdna_replication_tools_tpu_torch.infer import runner as port_runner
    from scdna_replication_tools_tpu_torch.ops import adam_kernel

    frames = _simulated(cells, loci, g1_cells)
    jrun = _run_capturing("jax", frames, controller=False)
    jinf = jrun["runner"]
    ids = np.asarray(jinf._step2_data.cell_ids)
    cn_s, cn_g1 = frames
    cfg = TorchScRT(cn_s.copy(), cn_g1.copy(), device="cpu",
                    controller=False, **MEASURE_OPTS).config

    def carried(widen: bool, start=None) -> tuple:
        tinf = PertInference(
            jinf.s, jinf.g1, cfg, clone_idx_s=jinf.clone_idx_s,
            clone_idx_g1=jinf.clone_idx_g1, num_clones=jinf.num_clones,
            device="cpu")
        port_in = _to_port(jrun["step2"])
        if widen:
            port_in = _step_as_double(port_in)
        scores, calls = [], []
        mp = pytest.MonkeyPatch()

        def scored(*a, _orig=port_runner.per_cell_objective, **k):
            res = _orig(*a, **k)
            scores.append((np.asarray(res, np.float64), res.dtype))
            return res

        def called(loss_fn, params0, args, _orig=port_runner.fit_map, **k):
            if start is not None:
                params0 = {k2: start[k2].double() for k2 in params0}
            calls.append((loss_fn, _copy(params0), args, k))
            res = _orig(loss_fn, params0, args, **k)
            calls.append({k2: v.dtype for k2, v in res.params.items()})
            return res
        mp.setattr(port_runner, "per_cell_objective", scored)
        mp.setattr(port_runner, "fit_map", called)
        if widen:
            mp.setattr(torch, "float32", torch.float64)
            mp.setattr(adam_kernel, "_MOMENT_DTYPES",
                       {"float32": torch.float64,
                        "bfloat16": torch.bfloat16})
        try:
            tinf._mirror_rescue(port_in, port_in.batch)
        finally:
            mp.undo()
        cand = tinf._rescue_cells["fitted"]
        rec = {"accepted": sorted(ids[tinf._rescue_cells["accepted"]]),
               "margins": dict(zip(ids[cand].tolist(),
                                   (scores[1][0] - scores[0][0]).tolist())),
               "score_dtypes": [str(d) for _, d in scores],
               "subfit_param_dtypes": {k: str(v)
                                       for k, v in calls[1].items()},
               "subfit_iters": int(tinf.rescue_fit.fit.num_iters)}
        return rec, calls[0]

    f32, call32 = carried(False)
    f64, call64 = carried(True, start=call32[1])
    jcand = jinf._rescue_cells["candidates"]
    jscores = jrun["scores"]
    out = {"shape": [cells, g1_cells, loci],
           "jax_float32": {
               "accepted": sorted(ids[jinf._rescue_cells["accepted"]]),
               "margins": dict(zip(ids[jcand].tolist(),
                                   (jscores[1] - jscores[0]).tolist()))},
           "port_float32": f32, "port_float64": f64}
    # the gradients at the sub-fit's start: JAX's and the port's float32
    # against the port's float64
    jl, jp, ja, _ = jrun["subfit_call"]
    gj = jax.grad(lambda p: jl(p, *ja))({k: jnp.asarray(v)
                                         for k, v in jp.items()})

    def grad(call, widen):
        loss_fn, p0, args, _ = call
        leaves = {k: v.clone().requires_grad_(True) for k, v in p0.items()}
        mp = pytest.MonkeyPatch()
        if widen:
            mp.setattr(torch, "float32", torch.float64)
        try:
            loss_fn(leaves, *args).backward()
        finally:
            mp.undo()
        return {k: _as_np(v.grad) for k, v in leaves.items()}
    g32, g64 = grad(call32, False), grad(call64, True)

    def err(g, k):
        d = g - g64[k]
        return {"flips": int((np.sign(g) != np.sign(g64[k])).sum()),
                "rel_l2": float(np.linalg.norm(d)
                                / max(np.linalg.norm(g64[k]), 1e-300)),
                "max_abs": float(np.abs(d).max())}
    out["gradients_against_float64"] = {
        k: {"entries": int(g64[k].size),
            "jax_float32": err(_as_np(gj[k]), k),
            "port_float32": err(g32[k], k),
            "jax_port_flips": int((np.sign(_as_np(gj[k]))
                                   != np.sign(g32[k])).sum())}
        for k in g64}
    # the port's float32 rescue from JAX's state with half of every
    # parameter's entries moved by one float32 ulp (as JAX is nudged in
    # measure_carried_rescue): how far its margins move on their own
    rng = np.random.default_rng(0)
    step = jrun["step2"]
    state = {k: np.array(v) for k, v in step.fit.params.items()}
    nudged = {k: jnp.asarray(np.where(rng.random(v.shape) < 0.5,
                                      np.nextafter(v, np.float32(np.inf)),
                                      v)) for k, v in state.items()}
    jrun["step2"] = dataclasses.replace(step, fit=dataclasses.replace(
        step.fit, params=nudged))
    try:
        out["port_float32_nudged_one_ulp"], _ = carried(False)
    finally:
        jrun["step2"] = step
    # the port's float32 rescue with PyTorch's lgamma and digamma in place
    # of the kernels' Stirling series (the TPU kernel's _lgamma_ge1, which
    # the port reproduces), and JAX's rescue through its own Pallas
    # kernels in interpret mode (the arithmetic it runs on the TPU) in
    # place of XLA's gammaln: which of the two float32 arithmetics
    # decides a cell
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as tek
    mp = pytest.MonkeyPatch()
    mp.setattr(tek, "lgamma_ge1", torch.lgamma)
    mp.setattr(tek, "lgamma_digamma_ge1",
               lambda z: (torch.lgamma(z), torch.digamma(z)))
    try:
        out["port_float32_library_lgamma"], _ = carried(False)
    finally:
        mp.undo()
    pallas = dataclasses.replace(step, spec=dataclasses.replace(
        step.spec, enum_impl="pallas_interpret"))
    scores = []
    mp = pytest.MonkeyPatch()

    def jax_scored(*a, _orig=jax_runner.per_cell_objective, **k):
        res = _orig(*a, **k)
        scores.append(np.asarray(res, np.float64))
        return res
    mp.setattr(jax_runner, "per_cell_objective", jax_scored)
    try:
        jinf._mirror_rescue(pallas, pallas.batch)
    finally:
        mp.undo()
    jcand = jinf._rescue_cells["candidates"]
    out["jax_float32_pallas_interpret"] = {
        "accepted": sorted(ids[jinf._rescue_cells["accepted"]]),
        "margins": dict(zip(ids[jcand].tolist(),
                            (scores[1] - scores[0]).tolist()))}
    return out


if __name__ == "__main__":
    # python tests/test_torch_rescue.py CELLS LOCI G1_CELLS OUT.json
    # [default] [ungated] | carried | float64 | replay: the measurements
    # above
    # (default config alone without a mode name), from the repository
    # root with JAX_PLATFORMS=cpu and the repository on PYTHONPATH
    import json
    import sys

    import conftest  # noqa: F401  (JAX on the CPU, before its first use)

    n, l, g, path = sys.argv[1:5]
    modes = tuple(sys.argv[5:]) or ("default",)
    if modes == ("carried",):
        result = measure_carried_rescue(int(n), int(l), int(g))
    elif modes == ("float64",):
        result = measure_float64_witness(int(n), int(l), int(g))
    elif modes == ("replay",):
        result = measure_controller_replay(int(n), int(l), int(g))
    else:
        result = measure_gated_rescue(int(n), int(l), int(g), modes)
    with open(path, "w") as fh:
        json.dump(result, fh, indent=1, default=float)
