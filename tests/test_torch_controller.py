"""The convergence doctor, the adaptive controller and the chunked fit
loop against the JAX package.

* The doctor (``obs/doctor.py``) and the controller policy
  (``obs/controller.py``) are copies: on the synthetic loss tails of
  tests/test_model_health.py and tests/test_controller.py the two
  packages return equal verdict and decision dicts.
* The port's fit loop launches a chunk of iterations and reads the host
  once per chunk, masking the iterations after the stop on the device.
  Its trajectory and stop iteration equal JAX ``fit_map``'s with the
  stop at the first, a middle and the last iteration of a chunk, and on
  a loss that turns NaN mid-chunk.
* The controlled fit (``fit_map(controller=...)``) makes the same
  decisions as JAX's on small PERT problems, and the re-seed
  perturbation equals JAX's on JAX's draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.infer import svi as jsvi
from scdna_replication_tools_tpu.infer.runner import _PertLossFn
from scdna_replication_tools_tpu.models import pert as jpert
from scdna_replication_tools_tpu.obs import controller as jctl
from scdna_replication_tools_tpu.obs import doctor as jdoc
from scdna_replication_tools_tpu.ops.gc import gc_features as jgc
from scdna_replication_tools_tpu_torch import weights
from scdna_replication_tools_tpu_torch.infer import svi as tsvi
from scdna_replication_tools_tpu_torch.infer.runner import (
    _PertLossFn as _TorchLossFn,
)
from scdna_replication_tools_tpu_torch.models import pert as tpert
from scdna_replication_tools_tpu_torch.obs import controller as tctl
from scdna_replication_tools_tpu_torch.obs import doctor as tdoc
from scdna_replication_tools_tpu_torch.ops.gc import gc_features

from test_torch_model import _build, _inputs, one_torch_thread  # noqa: F401

# ---------------------------------------------------------------------------
# doctor and policy: the same signals give equal dicts
# ---------------------------------------------------------------------------


def _descent(n=50, hi=2000.0, lo=1000.0):
    return list(np.linspace(hi, lo, n))


def _floor_tail(n_descent=100, n_flat=100, noise=0.02, seed=0):
    rng = np.random.default_rng(seed)
    return (list(np.linspace(100.0, 10.0, n_descent))
            + list(10.0 + noise * rng.standard_normal(n_flat)))


def _spiked(losses, at, value):
    losses = list(losses)
    losses[at] = value
    return losses


def _oscillating():
    rng = np.random.default_rng(3)
    return list(np.linspace(100.0, 60.0, 100)) + list(
        60.0 + 15.0 * (-1.0) ** np.arange(60) + rng.standard_normal(60))


_FLAT = _descent() + [1000.0] * 30
_K = 16
# name -> (function name, positional losses, keyword signals); the
# scenarios of tests/test_model_health.py:63-168
DOCTOR_CASES = {
    "flat_tail": ("classify_loss_tail", _FLAT, {}),
    "oscillating": ("classify_loss_tail",
                    _descent() + list(1000.0 + 50.0 * (-1.0)
                                      ** np.arange(30)), {}),
    "oscillating_other_phase": (
        "classify_loss_tail",
        _descent() + list(1000.0 + 50.0 * (-1.0) ** (np.arange(30) + 1)),
        {}),
    "rising": ("classify_loss_tail",
               _descent() + list(np.linspace(1000.0, 1500.0, 16)), {}),
    "budget_exhausted": ("classify_loss_tail", _descent(n=80), {}),
    "nan_tail": ("classify_loss_tail", _descent() + [np.nan], {}),
    "two_samples": ("classify_loss_tail", [1.0, 2.0], {}),
    "one_sample_report": ("diagnose_fit", [1.0], {}),
    "empty_report": ("diagnose_fit", [], {}),
    "single_with_grads": ("diagnose_fit", [1000.0],
                          dict(grad_norm_first=100.0, grad_norm_last=1.0)),
    "part_window": ("diagnose_fit", [1000.0] * (_K - 1),
                    dict(window=_K, min_samples=_K)),
    "full_window": ("diagnose_fit",
                    list(np.linspace(2000.0, 1000.0, 40)) + [1000.0] * _K,
                    dict(window=_K, min_samples=_K)),
    "grad_stuck": ("diagnose_fit", _FLAT,
                   dict(grad_norm_first=100.0, grad_norm_last=90.0)),
    "grad_rested": ("diagnose_fit", _FLAT,
                    dict(grad_norm_first=100.0, grad_norm_last=1.0)),
    "criterion_fired": ("diagnose_fit", _FLAT,
                        dict(converged=True, grad_norm_first=100.0,
                             grad_norm_last=90.0)),
    "nan_abort_flag": ("diagnose_fit", [1000.0] * 40, dict(nan_abort=True)),
    "tail_stats_min_samples": ("tail_stats", [1.0, 2.0],
                               dict(min_samples=0)),
}


@pytest.mark.parametrize("case", sorted(DOCTOR_CASES))
def test_doctor_matches_jax(case):
    """Equal (verdict, stats) tuples or report dicts, exactly: both are
    the same stdlib arithmetic on the same host floats."""
    fn, losses, kw = DOCTOR_CASES[case]
    ref = getattr(jdoc, fn)(losses, **kw)
    got = getattr(tdoc, fn)(losses, **kw)
    assert repr(got) == repr(ref)


POLICY = dict(max_extra_iters=60, extend_step=50, stop_patience=50,
              stop_ftol=1e-3, window=16)
_EXHAUSTED = dict(it=200, budget=200, min_iter=60, exhausted=True,
                  grad_norm_first=5.0, grad_norm_last=4.0)
# name -> (losses, signals); the scenarios of
# tests/test_controller.py:77-206, each through evaluate() with the
# policy above
POLICY_CASES = {
    "descending": (list(np.linspace(100.0, 10.0, 100)),
                   dict(it=100, budget=200, min_iter=60)),
    "below_min_iter": ([5.0, 4.0], dict(it=2, budget=200, min_iter=60)),
    "thin_evidence": (_floor_tail(), dict(it=200, budget=400, min_iter=300)),
    "stagnant_floor": (_floor_tail(), dict(it=200, budget=400, min_iter=60)),
    "spike_outside_window": (_spiked(_floor_tail(), -30, 80.0),
                             dict(it=200, budget=400, min_iter=60)),
    "spike_while_improving": (
        _spiked(list(np.linspace(100.0, 10.0, 200)), -30, 80.0),
        dict(it=200, budget=400, min_iter=60)),
    "restart_unanchored": (_floor_tail()
                           + list(np.linspace(60.0, 12.0, 100)),
                           dict(it=300, budget=400, min_iter=60)),
    "restart_anchored": (_floor_tail() + list(np.linspace(60.0, 12.0, 100)),
                         dict(it=300, budget=400, min_iter=60,
                              stagnation_start=200)),
    "spike_in_window": (_spiked(_floor_tail(), -10, 80.0),
                        dict(it=200, budget=400, min_iter=60)),
    "extend": (list(np.linspace(100.0, 10.0, 200)), _EXHAUSTED),
    "extend_clipped": (list(np.linspace(100.0, 10.0, 200)),
                       dict(_EXHAUSTED, extra_granted=50)),
    "extend_spent": (list(np.linspace(100.0, 10.0, 200)),
                     dict(_EXHAUSTED, extra_granted=60)),
    "no_extend_stagnant": (_floor_tail(noise=0.0), _EXHAUSTED),
    "oscillation_first_read": (_oscillating(),
                               dict(it=160, budget=400, min_iter=60)),
    "oscillation_persistent": (_oscillating(),
                               dict(it=160, budget=400, min_iter=60,
                                    prev_verdict="oscillating")),
    "oscillation_reseeds_spent": (_oscillating(),
                                  dict(it=160, budget=400, min_iter=60,
                                       prev_verdict="oscillating",
                                       reseeds_done=1)),
    "nan_retry": ([1.0, float("nan")],
                  dict(it=2, budget=200, min_iter=60, nan=True)),
    "nan_abort": ([1.0, float("nan")],
                  dict(it=2, budget=200, min_iter=60, nan=True,
                       nan_retries_done=1)),
}


@pytest.mark.parametrize("case", sorted(POLICY_CASES))
def test_policy_matches_jax(case):
    """evaluate() returns equal (decision, verdict) pairs on both sides,
    exactly; from_config() builds equal policies."""
    losses, signals = POLICY_CASES[case]
    ref = jctl.evaluate(jctl.ControllerPolicy(**POLICY), losses=losses,
                        **signals)
    got = tctl.evaluate(tctl.ControllerPolicy(**POLICY), losses=losses,
                        **signals)
    assert repr(got) == repr(ref)


def test_policy_from_config_matches_jax():
    from scdna_replication_tools_tpu.config import PertConfig as JaxConfig
    from scdna_replication_tools_tpu_torch.config import PertConfig

    for max_iter in (150, 300):
        ref = jctl.ControllerPolicy.from_config(JaxConfig(), max_iter)
        got = tctl.ControllerPolicy.from_config(PertConfig(), max_iter)
        assert dataclass_dict(got) == dataclass_dict(ref)
    assert tctl.ACTIONS == jctl.ACTIONS


def dataclass_dict(obj):
    import dataclasses
    return dataclasses.asdict(obj)


# ---------------------------------------------------------------------------
# the chunked loop against JAX fit_map
# ---------------------------------------------------------------------------

CHUNK = 10


def _sparse_fit_inputs(seed=8):
    """The sparse step-2 objective of test_torch_model at 1e3
    concentrations (test_torch_fit's trajectory parity problem)."""
    inp = _inputs("sparse", seed=seed, prior_scale=1e-3)
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
    return inp, jspec, tspec, jbatch, tbatch, jfixed, params


def _jax_fit(inp, jspec, jbatch, jfixed, params, **kw):
    return jsvi.fit_map(_PertLossFn(spec=jspec),
                        {k: jnp.asarray(v) for k, v in params.items()},
                        (jfixed, jbatch), fused_adam="pallas_interpret",
                        **kw)


def _torch_fit(inp, tspec, tbatch, params, **kw):
    return tsvi.fit_map(_TorchLossFn(tspec),
                        weights.params_from_jax(params, "cpu"),
                        (weights.fixed_from_jax(inp["fixed"], "cpu"),
                         tbatch), device="cpu", **kw)


@pytest.fixture(scope="module")
def sparse_problem():
    return _sparse_fit_inputs()


def _rel_tol_stopping_at(losses, target, min_iter):
    """A rel_tol at which the reference's criterion first fires at
    iteration ``target`` of this trajectory, with at least 20 % margin
    on both sides (so float32 differences between the two packages'
    trajectories cannot move the stop)."""
    L = np.asarray(losses, np.float32)
    ld = [np.inf] + [float(jsvi._window_stat(jnp.asarray(L), i, 9))
                     / abs(float(L[0]) - float(L[i]))
                     for i in range(1, len(L))]
    lo = min(ld[min_iter:target])
    assert lo > 1.2 * ld[target], (target, lo, ld[target])
    return float(np.sqrt(lo * ld[target]))


@pytest.mark.parametrize("target", [20, 35, 29],
                         ids=["first_of_chunk", "middle", "last_of_chunk"])
def test_chunked_stop_matches_jax(sparse_problem, target):
    """The port reads the host once per chunk of 10 iterations and masks
    the iterations after the stop.  With rel_tol set so that the
    criterion first fires at iteration ``target`` (position 0, 5 and 9
    of its chunk), both packages stop there; trajectories within 1e-5 of
    the largest loss, the ring's samples too; the port launched the
    whole chunk and its masked iterations moved nothing (parameters
    within 1e-3 of each leaf's scale, test_torch_fit's bound)."""
    inp, jspec, tspec, jbatch, tbatch, jfixed, params = sparse_problem
    probe = _jax_fit(inp, jspec, jbatch, jfixed, params, max_iter=45,
                     min_iter=45)
    tol = _rel_tol_stopping_at(probe.losses, target, min_iter=12)
    kw = dict(max_iter=60, min_iter=12, rel_tol=tol, diag_every=CHUNK)
    jfit = _jax_fit(inp, jspec, jbatch, jfixed, params, **kw)
    tfit = _torch_fit(inp, tspec, tbatch, params, **kw)
    assert jfit.converged and tfit.converged
    assert tfit.num_iters == jfit.num_iters == target + 1
    assert tfit.timings["dispatched"] == -(-(target + 1) // CHUNK) * CHUNK
    jl = np.asarray(jfit.losses, np.float64)
    rel = np.abs(tfit.losses - jl).max() / np.abs(jl).max()
    assert rel < 1e-5, rel
    np.testing.assert_array_equal(tfit.diagnostics["iter"],
                                  jfit.diagnostics["iter"])
    np.testing.assert_allclose(tfit.diagnostics["loss"],
                               jfit.diagnostics["loss"], rtol=1e-5)
    np.testing.assert_allclose(tfit.diagnostics["grad_norm"],
                               jfit.diagnostics["grad_norm"], rtol=1e-3)
    np.testing.assert_allclose(tfit.diagnostics["param_norm"],
                               jfit.diagnostics["param_norm"], rtol=1e-5)
    assert int(tfit.opt_state.count) == target + 1
    for k, v in tfit.params.items():
        ref = np.asarray(jfit.params[k])
        err = np.max(np.abs(v.numpy() - ref))
        assert err < 1e-3 * max(1.0, np.max(np.abs(ref))), (k, float(err))


def _poison_jax(params, ceiling):
    x = params["x"]
    return jnp.sum((x - 10.0) ** 2) + jnp.sum(jnp.sqrt(ceiling - x))


def _poison_torch(params, ceiling):
    x = params["x"]
    return torch.sum((x - 10.0) ** 2) + torch.sum(torch.sqrt(ceiling - x))


def test_nan_mid_chunk_matches_jax():
    """A loss that walks off a sqrt cliff turns NaN inside a chunk: both
    stop at the same iteration with nan_abort, the finite losses equal
    within float32 rounding, the NaN iteration's update landed and the
    masked iterations after it left the parameters alone (equal to
    JAX's, NaN where JAX's are)."""
    kw = dict(max_iter=400, min_iter=1, learning_rate=0.5, diag_every=10)
    jfit = jsvi.fit_map(_poison_jax, {"x": jnp.zeros((4,), jnp.float32)},
                        (6.0,), **kw)
    tfit = tsvi.fit_map(_poison_torch, {"x": torch.zeros(4)}, (6.0,),
                        device="cpu", **kw)
    assert jfit.nan_abort and tfit.nan_abort
    assert tfit.num_iters == jfit.num_iters
    assert tfit.num_iters % 10 not in (0, 1), "NaN at a chunk edge"
    assert tfit.timings["dispatched"] > tfit.num_iters
    np.testing.assert_allclose(tfit.losses, np.asarray(jfit.losses),
                               rtol=1e-6)
    np.testing.assert_allclose(tfit.params["x"].numpy(),
                               np.asarray(jfit.params["x"]), rtol=1e-6)
    assert int(tfit.opt_state.count) == tfit.num_iters


def test_nan_escalation_matches_jax():
    """The controlled fit on the same self-poisoning loss: an escalate
    decision with a reduced-learning-rate retry from the best-loss
    checkpoint, then (when it poisons again) an abort; both packages
    decide the same at the same iterations."""
    kw = dict(max_iter=400, min_iter=1, learning_rate=0.5, diag_every=10)

    def policy(mod):
        return mod.ControllerPolicy(max_extra_iters=0, stop_patience=0,
                                    window=10**6)
    jfit = jsvi.fit_map(_poison_jax, {"x": jnp.zeros((4,), jnp.float32)},
                        (4.0,), controller=policy(jctl), **kw)
    tfit = tsvi.fit_map(_poison_torch, {"x": torch.zeros(4)}, (4.0,),
                        device="cpu", controller=policy(tctl), **kw)
    assert [d["action"] for d in jfit.decisions][:1] == ["escalate"]
    assert repr(tfit.decisions) == repr(jfit.decisions)
    assert (tfit.num_iters, tfit.nan_abort, tfit.converged) \
        == (jfit.num_iters, jfit.nan_abort, jfit.converged)
    np.testing.assert_allclose(tfit.losses, np.asarray(jfit.losses),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# the controlled fit on small PERT problems
# ---------------------------------------------------------------------------

SPEC_KW = dict(P=5, K=2, L=1, tau_mode="param", fixed_lamb=True)
LAMB = np.float32(0.75)


def _small_problem(seed):
    """tests/test_controller.py's problem (8 cells x 30 loci, P = 5, a
    dense prior at 100 on state 2) with lambda fixed, as the port's
    enumeration requires."""
    rng = np.random.default_rng(seed)
    reads = rng.poisson(40, (8, 30)).astype(np.float32)
    gammas = rng.uniform(0.35, 0.6, 30).astype(np.float32)
    etas = np.ones((8, 30, 5), np.float32)
    etas[:, :, 2] = 100.0
    jbatch = jpert.PertBatch(
        reads=jnp.asarray(reads), libs=jnp.zeros(8, jnp.int32),
        gamma_feats=jgc(jnp.asarray(gammas), 2),
        mask=jnp.ones((8,), jnp.float32), etas=jnp.asarray(etas))
    tbatch = tpert.PertBatch(
        reads=torch.from_numpy(reads), libs=torch.zeros(8, dtype=torch.int64),
        gamma_feats=gc_features(torch.from_numpy(gammas), 2),
        mask=torch.ones(8), etas=torch.from_numpy(etas))
    jspec = jpert.PertModelSpec(**SPEC_KW)
    params = {k: np.asarray(v) for k, v in jpert.init_params(
        jspec, jbatch, {"lamb": jnp.asarray(LAMB)},
        t_init=np.full(8, 0.4, np.float32)).items()}
    return jspec, tpert.PertModelSpec(**SPEC_KW), jbatch, tbatch, params


CONTROLLED = {
    # the stagnation stop fires inside the budget (test_controller's
    # _eager_stop_fit)
    "early_stop": (dict(max_extra_iters=0, stop_patience=10,
                        stop_ftol=0.02, window=16),
                   dict(max_iter=120, min_iter=20), 5),
    # the budget runs out mid-descent: extensions up to the cap
    "extend": (dict(max_extra_iters=30, extend_step=20, stop_patience=0,
                    window=16), dict(max_iter=40, min_iter=20), 5),
}


@pytest.mark.parametrize("case", sorted(CONTROLLED))
def test_controlled_fit_decides_as_jax(case):
    """fit_map(controller=...) on a small PERT problem: the same
    decisions (action, iteration, budget, grant) at the same chunk
    boundaries, the same iterations, final budget and verdict.  Every
    site but lambda is learned here, and the two float32 trajectories
    drift apart to ~2.6e-4 of the loss by the decisions (readings: 0.17
    of 3572, 0.91 of 3587), so the triggers' signals -- tail statistics
    normalised by the fit's total improvement -- are held to 2 % of each
    value (readings: rel_var 1.0e-2, drift 1.8e-3, rel_improvement
    3.0e-3, grad_decay 1.8e-4)."""
    pkw, fkw, seed = CONTROLLED[case]
    jspec, tspec, jbatch, tbatch, params = _small_problem(seed)
    jfit = jsvi.fit_map(_PertLossFn(spec=jspec),
                        {k: jnp.asarray(v) for k, v in params.items()},
                        ({"lamb": jnp.asarray(LAMB)}, jbatch),
                        diag_every=10,
                        controller=jctl.ControllerPolicy(**pkw), **fkw)
    tfit = tsvi.fit_map(_TorchLossFn(tspec),
                        weights.params_from_jax(params, "cpu"),
                        ({"lamb": torch.tensor(LAMB)}, tbatch),
                        diag_every=10, device="cpu",
                        controller=tctl.ControllerPolicy(**pkw), **fkw)
    assert jfit.decisions, "the policy never acted on this problem"

    def key(d):
        return (d["action"], d["iter"], d["budget"], d.get("iters_granted"))
    assert [key(d) for d in tfit.decisions] == \
        [key(d) for d in jfit.decisions]
    assert (tfit.num_iters, tfit.budget, tfit.converged) == \
        (jfit.num_iters, jfit.budget, jfit.converged)
    assert tfit.verdict == jfit.verdict
    for td, jd in zip(tfit.decisions, jfit.decisions):
        for name, jv in jd["trigger"].items():
            tv = td["trigger"][name]
            if isinstance(jv, float):
                assert abs(tv - jv) <= 2e-2 * abs(jv), (name, tv, jv)
            else:
                assert tv == jv, name


# ---------------------------------------------------------------------------
# the re-seed perturbation and the ring's decode
# ---------------------------------------------------------------------------

def _jax_draws(params, seed, salt):
    """JAX _perturb_params's standard normal draws, leaf by leaf."""
    key = jax.random.fold_in(jax.random.PRNGKey(seed), salt)
    names = sorted(params)
    keys = jax.random.split(key, len(names))
    return {k: np.array(jax.random.normal(kk, params[k].shape,
                                          jnp.float32))
            for k, kk in zip(names, keys)}


def test_perturb_params_on_jax_draws():
    """Given JAX's draws, the port's perturbation equals JAX's within
    1e-6 of each leaf's scale (the two std reductions round apart);
    its own draws are deterministic in (seed, salt) and move every leaf
    by a fraction of its spread."""
    params = {"a": np.ones((8,), np.float32),
              "b": np.linspace(-2.0, 2.0, 16).astype(np.float32),
              "c": np.random.default_rng(1).normal(size=(3, 5))
              .astype(np.float32)}
    ref = jsvi._perturb_params({k: jnp.asarray(v) for k, v in params.items()},
                               0.02, seed=7, salt=1)
    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    noise = {k: torch.from_numpy(v) for k, v in
             _jax_draws(params, 7, 1).items()}
    got = tsvi._perturb_params(tparams, 0.02, 7, 1, noise=noise)
    for k in params:
        scale = max(1.0, float(np.abs(params[k]).max()))
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=1e-6 * scale, err_msg=k)
    own = tsvi._perturb_params(tparams, 0.02, 7, 1)
    again = tsvi._perturb_params(tparams, 0.02, 7, 1)
    other = tsvi._perturb_params(tparams, 0.02, 7, 2)
    for k in params:
        assert torch.equal(own[k], again[k])
        assert not torch.equal(own[k], other[k])
        assert 0 < float((own[k] - tparams[k]).abs().max()) < 1.0


@pytest.mark.parametrize("num_iters,i0,every", [(0, 0, 25), (7, 0, 5),
                                                (300, 0, 25), (2000, 0, 25),
                                                (130, 40, 10)])
def test_decode_diag_matches_jax(num_iters, i0, every):
    ring = np.random.default_rng(num_iters).normal(
        size=(tsvi.DIAG_RING, 3)).astype(np.float32)
    ref = jsvi._decode_diag(ring, num_iters, i0, every)
    got = tsvi._decode_diag(ring, num_iters, i0, every)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]))
