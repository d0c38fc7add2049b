"""``cell_chunk`` in the port against the JAX package's ``lax.map``
chunking (``models/pert.py:852-900``) and its runner padding
(``infer/runner.py:566-576``).

The objective is held to JAX's chunked loss (1e-5 relative, the dense
prior's parameter-free normaliser left out as in
test_torch_model.py) and gradients (1e-4 of each one's largest entry,
pi_logits also within a few ulps of the 1e6 prior).  The pipeline runs
on cell counts that the chunk does not divide, so the padding is
exercised, with the Viterbi decode on.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.api import scRT as JaxScRT
from scdna_replication_tools_tpu.models import pert as jpert
from scdna_replication_tools_tpu.models.simulator import pert_simulator
from scdna_replication_tools_tpu_torch import scRT as TorchScRT
from scdna_replication_tools_tpu_torch import weights
from scdna_replication_tools_tpu_torch.models import pert as tpert

from test_torch_model import (  # noqa: F401
    _build,
    _inputs,
    _normaliser_sum,
    one_torch_thread,
)


@pytest.mark.parametrize("kind,chunk", [("step1", 4), ("dense", 4),
                                        ("sparse", 4), ("dense", 6)])
def test_chunked_loss_and_gradients_match_jax(kind, chunk):
    inp = _inputs(kind, seed={"step1": 11, "dense": 12, "sparse": 13}[kind])
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
    jspec = dataclasses.replace(jspec, cell_chunk=chunk)
    tspec = dataclasses.replace(tspec, cell_chunk=chunk)

    jloss, jgrads = jax.value_and_grad(
        lambda p: jpert.pert_loss(jspec, p, jfixed, jbatch))(
        {k: jnp.asarray(v) for k, v in params.items()})
    tparams = {k: v.requires_grad_(True) for k, v in
               weights.params_from_jax(params, "cpu").items()}
    tfixed = weights.fixed_from_jax(inp["fixed"], "cpu")
    tloss = tpert.pert_loss(tspec, tparams, tfixed, tbatch)
    tgrads = torch.autograd.grad(tloss, list(tparams.values()))

    jl, tl = float(jloss), float(tloss.detach())
    if kind == "dense":
        jl += _normaliser_sum(inp, jax.scipy.special.gammaln, jnp.asarray)
        tl += _normaliser_sum(inp, torch.lgamma, torch.from_numpy)
    assert abs(tl - jl) / abs(jl) < 1e-5, (tl, jl)
    for name, tg in zip(tparams, tgrads):
        jg = np.asarray(jgrads[name])
        tol = 1e-4 * np.max(np.abs(jg))
        if name == "pi_logits" and kind != "step1":
            tol += 4 * np.finfo(np.float32).eps * 1e6
        err = float(np.max(np.abs(tg.numpy() - jg)))
        assert err < tol, (name, err, tol)


@pytest.mark.parametrize("kind", ["step1", "dense", "sparse"])
def test_chunked_objective_equals_unchunked(kind):
    """The port's chunked loss and gradients against its own unchunked
    ones: the per-bin terms are the same, the sums' order differs."""
    inp = _inputs(kind, seed=21)
    _, tspec, _, tbatch, _, params = _build(inp)
    tfixed = weights.fixed_from_jax(inp["fixed"], "cpu")

    def run(spec):
        p = {k: v.requires_grad_(True) for k, v in
             weights.params_from_jax(params, "cpu").items()}
        loss = tpert.pert_loss(spec, p, tfixed, tbatch)
        return loss.detach(), torch.autograd.grad(loss, list(p.values()))

    l_wh, g_wh = run(tspec)
    l_ch, g_ch = run(dataclasses.replace(tspec, cell_chunk=3))
    assert abs(float(l_ch - l_wh)) <= 1e-6 * abs(float(l_wh)) + 1.0
    for a, b in zip(g_ch, g_wh):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


def test_chunk_must_divide_the_cells():
    inp = _inputs("dense", seed=22)
    _, tspec, _, tbatch, _, params = _build(inp)
    with pytest.raises(ValueError, match="not divisible by cell_chunk=5"):
        tpert.pert_loss(dataclasses.replace(tspec, cell_chunk=5),
                        weights.params_from_jax(params, "cpu"),
                        weights.fixed_from_jax(inp["fixed"], "cpu"), tbatch)


OPTS = dict(input_col="reads", clone_col="clone_id", assign_col="copy",
            cn_prior_method="g1_composite", max_iter=120, min_iter=60,
            rt_prior_col=None, controller=False, qc=False,
            mirror_rescue=False, telemetry_path=None, cell_chunk=5,
            cn_hmm_self_prob=0.99)


@pytest.fixture(scope="module")
def chunked_runs(synthetic_frames):
    """Both packages' scRT with cell_chunk=5 (24 S and 24 G1 cells pad
    to 25, step 1's doubled G1 cells to 50) and the Viterbi decode."""
    df_s, df_g = synthetic_frames
    sim_s, sim_g = pert_simulator(
        df_s, df_g, num_reads=50_000, rt_cols=["rt_A", "rt_B"],
        clones=["A", "B"], lamb=0.75, betas=[0.5, 0.0], a=10.0, seed=5)
    for df in (sim_s, sim_g):
        df["reads"] = df["true_reads_norm"]
        df["state"] = df["true_somatic_cn"].astype(int)
        df["copy"] = df["true_somatic_cn"].astype(float)
    jax_scrt = JaxScRT(sim_s.copy(), sim_g.copy(), compile_cache_dir=None,
                       **OPTS)
    torch_scrt = TorchScRT(sim_s.copy(), sim_g.copy(), device="cpu", **OPTS)
    return (jax_scrt, jax_scrt.infer("pert")), \
        (torch_scrt, torch_scrt.infer("pert"))


def test_runner_pads_cells_to_the_chunk(chunked_runs):
    (_, _), (scrt, _) = chunked_runs
    step1, step2, step3 = scrt.steps
    assert step1.batch.reads.shape[0] == 50
    assert step2.batch.reads.shape[0] == 25
    assert step3.batch.reads.shape[0] == 25
    assert all(s.spec.cell_chunk == 5 for s in scrt.steps)
    assert float(step2.batch.mask.sum()) == 24.0


@pytest.mark.parametrize("frame", [0, 2], ids=["s_cells", "g1_cells"])
def test_chunked_viterbi_pipeline_agrees_with_jax(chunked_runs, frame):
    """cn/rep alike on >= 99 % of bins, tau r >= 0.99 (the fits round
    differently, as in test_torch_pipeline.py)."""
    (_, jout), (_, tout) = chunked_runs
    keys = ["cell_id", "chr", "start"]
    cols = ["model_cn_state", "model_rep_state", "model_tau"]
    m = jout[frame][keys + cols].merge(tout[frame][keys + cols], on=keys,
                                       suffixes=("_jax", "_torch"))
    assert len(m) == len(jout[frame]) == len(tout[frame])
    for col in ("model_cn_state", "model_rep_state"):
        assert (m[f"{col}_jax"] == m[f"{col}_torch"]).mean() >= 0.99, col
    tau = m.groupby("cell_id")[["model_tau_jax", "model_tau_torch"]].first()
    assert np.corrcoef(tau["model_tau_jax"], tau["model_tau_torch"])[0, 1] \
        >= 0.99
