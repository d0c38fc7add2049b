"""The port's simulator (``models/simulator.py``) against the JAX one.

The draws are each package's own, so JAX's tau, GC-beta noise and
replication draws go through the port's seam (``tau=``, ``beta_noise=``,
``rep=``): phi, the total CN, theta and delta are then held to JAX's
arithmetic (float32 rounding, 1e-6 relative), and the port's NB counts
to their moments (mean and variance of the Gamma-Poisson mixture).  The
pandas front end gives JAX's columns and shapes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from scdna_replication_tools_tpu.models import simulator as jsim
from scdna_replication_tools_tpu.ops.gc import gc_features, gc_rate
from scdna_replication_tools_tpu_torch.models import simulator as tsim

from test_torch_model import one_torch_thread  # noqa: F401

BETAS = [0.5, -0.2]
LAMB, A, NUM_READS = 0.75, 10.0, 50_000.0


def _inputs(seed=0, cells=9, loci=150):
    rng = np.random.default_rng(seed)
    cn = rng.integers(1, 5, (cells, loci)).astype(np.float32)
    gammas = rng.uniform(0.35, 0.6, loci).astype(np.float32)
    rho = rng.uniform(0, 1, loci).astype(np.float32)
    libs = rng.integers(0, 2, cells).astype(np.int32)
    return cn, gammas, rho, libs


def _jax_theta(cn_total, cell_betas, gammas, u_guess):
    feats = gc_features(jnp.asarray(gammas), len(BETAS) - 1)
    return np.asarray(u_guess * cn_total * gc_rate(cell_betas, feats))


def test_s_phase_deterministic_parts_match_jax_on_jax_draws():
    cn, gammas, rho, libs = _inputs()
    j = jsim.simulate_s_reads(jax.random.PRNGKey(3), cn, gammas, rho, libs,
                              NUM_READS, LAMB, BETAS, A, num_libraries=2)
    stds = np.logspace(0.0, -1, 2).astype(np.float32)
    noise = (np.asarray(j["betas"]) - np.asarray(BETAS, np.float32)) / stds
    gen = torch.Generator()
    gen.manual_seed(0)
    t = tsim.simulate_s_reads(gen, cn, gammas, rho, libs, NUM_READS, LAMB,
                              BETAS, A, num_libraries=2,
                              tau=np.asarray(j["tau"]), beta_noise=noise,
                              rep=np.asarray(j["rep"]))
    np.testing.assert_allclose(t["p_rep"].numpy(), np.asarray(j["p_rep"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(t["total_cn"].numpy(),
                                  np.asarray(j["total_cn"]))
    np.testing.assert_allclose(t["betas"].numpy(), np.asarray(j["betas"]),
                               rtol=1e-6, atol=1e-7)
    u_guess = NUM_READS / (1.5 * cn.shape[1] * np.mean(cn))
    theta = _jax_theta(np.asarray(j["total_cn"]), j["betas"], gammas,
                       u_guess)
    np.testing.assert_allclose(t["theta"].numpy(), theta, rtol=1e-6)
    np.testing.assert_allclose(
        t["delta"].numpy(), np.maximum(theta * (1 - LAMB) / LAMB, 1.0),
        rtol=1e-6)
    reads = t["reads"].numpy()
    assert reads.dtype == np.float32 and (reads >= 0).all()
    np.testing.assert_array_equal(
        t["reads_norm"].numpy(),
        np.floor(reads / reads.sum(1, keepdims=True) * NUM_READS))


def test_g_phase_deterministic_parts_match_jax_on_jax_draws():
    cn, gammas, _, libs = _inputs(seed=1)
    j = jsim.simulate_g_reads(jax.random.PRNGKey(4), cn, gammas, libs,
                              NUM_READS, LAMB, BETAS, num_libraries=2)
    stds = np.logspace(0.0, -1, 2).astype(np.float32)
    noise = (np.asarray(j["betas"]) - np.asarray(BETAS, np.float32)) / stds
    gen = torch.Generator()
    gen.manual_seed(0)
    t = tsim.simulate_g_reads(gen, cn, gammas, libs, NUM_READS, LAMB, BETAS,
                              num_libraries=2, beta_noise=noise)
    u_guess = NUM_READS / (1.0 * cn.shape[1] * np.mean(cn))
    theta = _jax_theta(cn, j["betas"], gammas, u_guess)
    np.testing.assert_allclose(t["theta"].numpy(), theta, rtol=1e-6)


def test_nb_counts_hold_their_moments():
    """NB(delta, lamb): mean delta lamb / (1 - lamb), variance
    mean / (1 - lamb); over 2e5 draws the mean is held to 0.5 % and the
    standardized residuals' mean square to 3 %."""
    cn = np.full((40, 5000), 2.0, np.float32)
    gammas = np.full(5000, 0.45, np.float32)
    gen = torch.Generator()
    gen.manual_seed(7)
    t = tsim.simulate_g_reads(gen, cn, gammas, np.zeros(40, np.int32),
                              40 * 5000.0, LAMB, [0.0, 0.0])
    mean = t["delta"].double() * LAMB / (1 - LAMB)
    reads = t["reads"].double()
    assert abs(float(reads.mean() / mean.mean()) - 1.0) < 5e-3
    z2 = float(((reads - mean) ** 2 / (mean / (1 - LAMB))).mean())
    assert abs(z2 - 1.0) < 0.03


def test_seeded_draws_repeat():
    cn, gammas, rho, libs = _inputs(seed=2)
    outs = []
    for _ in range(2):
        gen = torch.Generator()
        gen.manual_seed(11)
        outs.append(tsim.simulate_s_reads(gen, cn, gammas, rho, libs,
                                          NUM_READS, LAMB, BETAS, A,
                                          num_libraries=2))
    for k in outs[0]:
        assert torch.equal(outs[0][k], outs[1][k]), k


@pytest.mark.parametrize("tau_range", [None, (0.85, 0.97)])
def test_pert_simulator_frames_match_jax(synthetic_frames, tau_range):
    df_s, df_g = synthetic_frames
    kw = dict(num_reads=50_000, rt_cols=["rt_A", "rt_B"], clones=["A", "B"],
              lamb=LAMB, betas=[0.5, 0.0], a=A, seed=5, tau_range=tau_range)
    js, jg = jsim.pert_simulator(df_s.copy(), df_g.copy(), **kw)
    ts, tg = tsim.pert_simulator(df_s.copy(), df_g.copy(), device="cpu",
                                 **kw)
    for j, t in ((js, ts), (jg, tg)):
        assert list(t.columns) == list(j.columns)
        assert len(t) == len(j)
        keys = ["cell_id", "chr", "start"]
        pd.testing.assert_frame_equal(
            t[keys].sort_values(keys).reset_index(drop=True),
            j[keys].sort_values(keys).reset_index(drop=True))
        assert np.isfinite(t["true_reads_norm"]).all()
    tau = ts.groupby("cell_id")["true_t"].first()
    lo, hi = tau_range or (0.0, 1.0)
    assert tau.between(lo, hi).all()
    np.testing.assert_array_equal(
        ts["true_total_cn"], ts["true_somatic_cn"] * (ts["true_rep"] + 1))
    sums = ts.groupby("cell_id")["true_reads_norm"].sum()
    assert (sums <= 50_000).all() and (sums > 50_000 - 150 * 1.0).all()
