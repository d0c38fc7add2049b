"""Parity of the port's fixed-budget ``fit_map`` with the JAX fit loop.

Both fits start from the same parameters and inputs; the JAX side runs
the step-2 objective through the interpreted fused kernel and the
interpreted fused Adam (``fused_adam='pallas_interpret'``), or, with
bfloat16 moments, the XLA fused Adam (``fused_adam='xla'``) and the
binary encoding through the interpreted binary kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.infer import svi as jsvi
from scdna_replication_tools_tpu.infer.runner import _PertLossFn
from scdna_replication_tools_tpu.models import pert as jpert
from scdna_replication_tools_tpu_torch import weights
from scdna_replication_tools_tpu_torch.infer import svi as tsvi
from scdna_replication_tools_tpu_torch.infer.runner import (
    _PertLossFn as _TorchLossFn,
)
from scdna_replication_tools_tpu_torch.models import pert as tpert

from test_torch_model import _build, _inputs, one_torch_thread  # noqa: F401


def _fits(kind, max_iter, min_iter, rel_tol, seed, binary=False,
          moment_dtype="float32"):
    # dense prior at 1e3-scale concentrations: at the production 1e6 the
    # loss is (etas - 1) * log_pi summed over bins, and an ulp of pi moves
    # it by ~1e6 ulps, which would measure float32 conditioning rather
    # than the loop (test_torch_model holds the 1e6 objective)
    inp = _inputs(kind, seed=seed, prior_scale=1e-3)
    if binary and kind == "sparse":
        # the same 1e3 scale for the one-hot prior: under the binary
        # encoding its 1e6 weight meets logits of |z| ~ 15, and two
        # trajectories a float32 ulp apart read losses ~1e3 apart
        inp["fields"] = inp["init_fields"] = {
            k: v * np.float32(1e-3) if k == "eta_w" else v
            for k, v in inp["fields"].items()}
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
    fused_adam = "pallas_interpret"
    if binary:
        jspec = jpert.PertModelSpec(enum_impl="binary_interpret",
                                    **inp["spec_kw"])
        tspec = tpert.PertModelSpec(binary_pi=True, **inp["spec_kw"])
        params = {k: v for k, v in params.items() if k != "pi_logits"}
        params["pi_bin_logits"] = np.asarray(jpert.init_params(
            jspec, jbatch, jfixed, t_init=inp["t_init"])["pi_bin_logits"])
    if moment_dtype != "float32":
        fused_adam = "xla"
    jfit = jsvi.fit_map(_PertLossFn(spec=jspec),
                        {k: jnp.asarray(v) for k, v in params.items()},
                        (jfixed, jbatch), max_iter=max_iter,
                        min_iter=min_iter, rel_tol=rel_tol,
                        fused_adam=fused_adam, moment_dtype=moment_dtype)
    tfit = tsvi.fit_map(_TorchLossFn(tspec),
                        weights.params_from_jax(params, "cpu"),
                        (weights.fixed_from_jax(inp["fixed"], "cpu"),
                         tbatch),
                        max_iter=max_iter, min_iter=min_iter,
                        rel_tol=rel_tol, device="cpu",
                        moment_dtype=moment_dtype)
    return jfit, tfit


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_fit_trajectory_matches_jax(kind):
    """30 iterations: every loss within 1e-5 of the trajectory's largest
    magnitude (the losses may cross zero; float32 sums in other orders),
    and the final
    parameters within 1e-3 of each leaf's scale (float32 rounding of the
    two backends compounds through 30 Adam steps; Adam's normalised
    step turns a relative gradient difference into an absolute
    parameter one of at most lr per step where |g| is near zero)."""
    jfit, tfit = _fits(kind, 30, 30, 1e-6, seed=7)
    assert tfit.num_iters == jfit.num_iters == 30
    assert not tfit.nan_abort and not tfit.converged
    jl = np.asarray(jfit.losses, np.float64)
    diff = tfit.losses.astype(np.float64) - jl
    rel = np.abs(diff).max() / np.abs(jl).max()
    assert rel < 1e-5, rel
    assert tfit.losses[-1] < tfit.losses[0]
    jp = jfit.params
    for k, v in tfit.params.items():
        ref = np.asarray(jp[k])
        err = np.max(np.abs(v.numpy() - ref))
        assert err < 1e-3 * max(1.0, np.max(np.abs(ref))), (k, float(err))
    # the Adam state carried across equals the port's own
    state = weights.opt_state_from_jax(jfit.opt_state, "cpu")
    assert int(state.count) == int(tfit.opt_state.count) == 30
    assert set(state.mu) == set(tfit.opt_state.mu)


@pytest.mark.parametrize("kind,binary", [("dense", False), ("sparse", True),
                                         ("dense", True)],
                         ids=["dense", "sparse_binary", "dense_binary"])
def test_bf16_moment_trajectory_matches_jax(kind, binary):
    """30 iterations with the pi parameter's moments stored in bfloat16,
    against JAX ``fit_map(fused_adam='xla', moment_dtype='bfloat16')``,
    categorical and binary.  Losses within 1e-5 of the trajectory's
    largest magnitude, as the float32 trajectory.  Final parameters:
    where the two sides' float32 moments straddle a bfloat16 rounding
    boundary, the stored moments differ by one bfloat16 ulp (2^-8
    relative), and where m' = (1 - b1) g + b1 m nearly cancels that can
    swing a later step of that element by a sizeable part of lr.  So
    each leaf is held to 1e-3 of its scale on all but 0.1 % of its
    elements and every element to lr / 2; readings (seed 27): 3 of
    31,200 categorical pi elements beyond 1e-3 of scale (max 0.0156),
    none of the binary ones.  The moments' dtypes agree with the JAX
    state: the pi parameter's bfloat16, every other one float32."""
    jfit, tfit = _fits(kind, 30, 30, 1e-6, seed=27, binary=binary,
                       moment_dtype="bfloat16")
    assert tfit.num_iters == jfit.num_iters == 30
    assert not tfit.nan_abort
    jl = np.asarray(jfit.losses, np.float64)
    rel = np.abs(tfit.losses.astype(np.float64) - jl).max() / np.abs(jl).max()
    assert rel < 1e-5, rel
    assert tfit.losses[-1] < tfit.losses[0]
    for k, v in tfit.params.items():
        ref = np.asarray(jfit.params[k])
        err = np.abs(v.numpy() - ref)
        beyond = int((err >= 1e-3 * max(1.0, np.max(np.abs(ref)))).sum())
        assert beyond <= 1e-3 * err.size, (k, beyond, err.size)
        assert err.max() < 0.05 / 2, (k, float(err.max()))
    pi = "pi_bin_logits" if binary else "pi_logits"
    assert pi in tfit.params
    state = weights.opt_state_from_jax(jfit.opt_state, "cpu")
    for moments, jmoments in ((tfit.opt_state.mu, state.mu),
                              (tfit.opt_state.nu, state.nu)):
        assert set(moments) == set(jmoments)
        for k, m in moments.items():
            want = torch.bfloat16 if k == pi else torch.float32
            assert m.dtype == jmoments[k].dtype == want, (k, m.dtype)


def test_make_opt_state_moment_dtypes():
    """A fresh state: zero moments, the pi parameter's in the asked
    dtype and the rest float32; no pi key, all float32."""
    params = {"pi_bin_logits": torch.ones(4, 2, 3, dtype=torch.float32),
              "u": torch.ones(2, dtype=torch.float32)}
    st = tsvi.make_opt_state(params, "bfloat16")
    assert st.mu["pi_bin_logits"].dtype == torch.bfloat16
    assert st.nu["u"].dtype == torch.float32
    assert not any(t.any() for t in (*st.mu.values(), *st.nu.values()))
    assert tsvi.pi_param_name({"x": params["u"]}) is None
    st = tsvi.make_opt_state({"x": params["u"]}, "bfloat16")
    assert st.mu["x"].dtype == torch.float32


def test_convergence_stop_matches_jax():
    """With a loose rel_tol both loops stop at the same iteration: the
    update lands before the test, the window is losses[i-9:i], and the
    test starts at min_iter."""
    jfit, tfit = _fits("sparse", 60, 12, 5e-2, seed=8)
    assert jfit.converged and tfit.converged
    assert tfit.num_iters == jfit.num_iters < 60


def test_window_stat_matches_jax():
    losses = np.array([5, 4, 3.5, 0, 0, 0], np.float32)
    for i in range(6):
        for win in (1, 3, 6):
            ref = float(jsvi._window_stat(jnp.asarray(losses), i, win))
            assert float(tsvi._window_stat(losses, i, win)) == ref


def test_fit_map_requires_a_device_choice():
    """No device given and no GPU: fit_map raises instead of running on
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the no-GPU refusal cannot be shown")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsvi.fit_map(lambda p: (p["x"] ** 2).sum(),
                     {"x": torch.ones(3)}, max_iter=2)


def test_binary_fit_under_the_dense_composite_prior_runs_its_budget():
    """Under a dense composite-like prior at the production 1e6 scale
    (three hot states per bin, 1e6 / 4e5 / 2e5) the Kb binary planes
    cannot hold the prior's several modes, and the loss stays ~2e9.  The
    JAX binary fit (XLA path, the same stop rule) runs its whole
    300-iteration budget there, and so does the port's: the port's
    300-of-300 binary step 2 on the card is the JAX package's behaviour,
    not a fault of the port.  Both trajectories agree to 1e-5 of the
    loss (reading 2.8e-6: float32 sums near 2e9, whose ulp is 128-256)."""
    inp = _inputs("dense", seed=7)
    _, _, jbatch, tbatch, jfixed, _ = _build(inp)
    jspec = jpert.PertModelSpec(enum_impl="binary_xla", **inp["spec_kw"])
    tspec = tpert.PertModelSpec(binary_pi=True, **inp["spec_kw"])
    params = {k: np.asarray(v) for k, v in jpert.init_params(
        jspec, jbatch, jfixed, t_init=inp["t_init"]).items()}
    kw = dict(max_iter=300, min_iter=100, rel_tol=1e-6)
    jfit = jsvi.fit_map(_PertLossFn(spec=jspec),
                        {k: jnp.asarray(v) for k, v in params.items()},
                        (jfixed, jbatch), fused_adam="xla", **kw)
    tfit = tsvi.fit_map(_TorchLossFn(tspec),
                        weights.params_from_jax(params, "cpu"),
                        (weights.fixed_from_jax(inp["fixed"], "cpu"),
                         tbatch), device="cpu", **kw)
    for fit in (jfit, tfit):
        assert fit.num_iters == 300 and not fit.converged
        assert not fit.nan_abort and fit.losses[-1] > 1e9
    jl, tl = (np.asarray(f.losses, np.float64) for f in (jfit, tfit))
    assert np.max(np.abs(tl - jl)) <= 1e-5 * np.max(np.abs(jl))
