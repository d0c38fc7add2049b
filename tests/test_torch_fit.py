"""Parity of the port's fixed-budget ``fit_map`` with the JAX fit loop.

Both fits start from the same parameters and inputs; the JAX side runs
the step-2 objective through the interpreted fused kernel and the
interpreted fused Adam (``fused_adam='pallas_interpret'``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.infer import svi as jsvi
from scdna_replication_tools_tpu.infer.runner import _PertLossFn
from scdna_replication_tools_tpu_torch import weights
from scdna_replication_tools_tpu_torch.infer import svi as tsvi
from scdna_replication_tools_tpu_torch.infer.runner import (
    _PertLossFn as _TorchLossFn,
)

from test_torch_model import _build, _inputs, one_torch_thread  # noqa: F401


def _fits(kind, max_iter, min_iter, rel_tol, seed):
    # dense prior at 1e3-scale concentrations: at the production 1e6 the
    # loss is (etas - 1) * log_pi summed over bins, and an ulp of pi moves
    # it by ~1e6 ulps, which would measure float32 conditioning rather
    # than the loop (test_torch_model holds the 1e6 objective)
    inp = _inputs(kind, seed=seed, prior_scale=1e-3)
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
    jfit = jsvi.fit_map(_PertLossFn(spec=jspec),
                        {k: jnp.asarray(v) for k, v in params.items()},
                        (jfixed, jbatch), max_iter=max_iter,
                        min_iter=min_iter, rel_tol=rel_tol,
                        fused_adam="pallas_interpret")
    tfit = tsvi.fit_map(_TorchLossFn(tspec),
                        weights.params_from_jax(params, "cpu"),
                        (weights.fixed_from_jax(inp["fixed"], "cpu"),
                         tbatch),
                        max_iter=max_iter, min_iter=min_iter,
                        rel_tol=rel_tol, device="cpu")
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
