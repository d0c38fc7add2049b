"""Parity of the port's unfused enumeration (``enum_loglik``, plain
versions on the CPU) with the JAX unfused kernel run through the Pallas
interpreter and with the JAX tests' XLA oracle.

``enum_loglik`` takes a cells-major log-simplex as given (no softmax, no
Dirichlet term); its VJP gives dmu, dlog_pi and dphi.  The port's CUDA
kernels repeat the plain versions' arithmetic (tests/test_torch_gpu.py
holds them against each other on the card).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.ops import enum_kernel as jek
from scdna_replication_tools_tpu_torch.ops import _cuda
from scdna_replication_tools_tpu_torch.ops import enum_kernel as tek

from test_enum_kernel import _xla_oracle
from test_torch_model import one_torch_thread  # noqa: F401


def _problem(C=16, L=300, P=13, seed=0):
    """L = 300 is ragged against the TPU kernel's (8, 512) tile.  Reads
    around mu * chi with mu down to 0.2, so the low-chi slots, where
    delta sits at its clamp of 1, carry posterior weight; a random
    non-uniform log-simplex, so a swapped state index shows."""
    rng = np.random.default_rng(seed)
    mu = rng.uniform(0.2, 30, (C, L)).astype(np.float32)
    reads = rng.poisson(mu * rng.integers(1, 7, (C, L))).astype(np.float32)
    logits = rng.normal(0, 2, (C, L, P)).astype(np.float32)
    log_pi = np.asarray(jax.nn.log_softmax(jnp.asarray(logits), -1))
    phi = rng.uniform(0.01, 0.99, (C, L)).astype(np.float32)
    g = rng.normal(0, 1, (C, L)).astype(np.float32)
    return dict(reads=reads, mu=mu, log_pi=log_pi, phi=phi, g=g,
                lamb=np.float32(0.75))


def _jax(pb, oracle=False):
    """JAX value and (dmu, dlog_pi, dphi) cotangents via jax.vjp, through
    the interpreted kernel or the XLA oracle."""
    reads, lamb = jnp.asarray(pb["reads"]), jnp.float32(pb["lamb"])
    if oracle:
        def fn(m, lp, f):
            return _xla_oracle(reads, m, lp, f, lamb, P=lp.shape[-1])
    else:
        def fn(m, lp, f):
            return jek.enum_loglik(reads, m, lp, f, lamb, True)
    out, vjp = jax.vjp(fn, jnp.asarray(pb["mu"]), jnp.asarray(pb["log_pi"]),
                       jnp.asarray(pb["phi"]))
    return [np.asarray(a) for a in (out, *vjp(jnp.asarray(pb["g"])))]


def _torch(pb, log_pi=None):
    """Port value and (dmu, dlog_pi, dphi) through ``enum_loglik``."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in pb.items()}
    mu = t["mu"].clone().requires_grad_(True)
    lp = (t["log_pi"] if log_pi is None else log_pi).clone() \
        .requires_grad_(True)
    phi = t["phi"].clone().requires_grad_(True)
    out = tek.enum_loglik(t["reads"], mu, lp, phi, t["lamb"])
    grads = torch.autograd.grad(out, (mu, lp, phi), t["g"])
    return [a.detach().numpy() for a in (out, *grads)]


def _floored(a, b):
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


def _per_bin(a, b):
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


# Against the interpreted TPU kernel: the same float32 operations in the
# same order, so the two differ by the backends' exp/log rounding.  out
# is held per bin (|a - b| / (1 + |b|)); dmu, dlog_pi and dphi, sums of
# posterior weights (each in [0, 1]) times g ~ 1 and slopes, to max(1,
# max|.|): a weight sent to the wrong state, or a dropped one, moves an
# entry by O(0.1-1).  The weights exp(nb - lse) carry the float32 ulps of
# nb (up to ~1e3 here) as a relative error: readings at P = 13 and 7 up
# to 2.8e-5 (out), 7.8e-6 (dmu), 4.6e-5 (dlog_pi) and 1.7e-5 (dphi),
# the bounds of the fused flat-prior checks (test_torch_enum_kernel.py).
TOL = {"out": 2e-4, "dmu": 2e-4, "dlog_pi": 2e-4, "dphi": 2e-4}

# Against the XLA oracle (jax.scipy gammaln, the log-pmf summed whole and
# logsumexp over the (P, 2) tensor): the Stirling series differs from
# gammaln by < 3e-6 relative, which at nb ~ 1e3 is up to ~3e-3 absolute
# in a weight's exponent.  The JAX tests hold their kernel to the oracle
# at 1e-3 per bin; so are out and the cotangents here (readings up to
# 4.9e-5, 1.7e-5, 6.9e-5 and 3.0e-5).
TOL_ORACLE = {"out": 1e-3, "dmu": 1e-3, "dlog_pi": 1e-3, "dphi": 1e-3}

NAMES = ("out", "dmu", "dlog_pi", "dphi")


def _check(got, ref, tol):
    for name, a, b in zip(NAMES, got, ref):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.isfinite(a).all(), name
        err = _per_bin(a, b) if name == "out" else _floored(a, b)
        assert err < tol[name], (name, err)


@pytest.mark.parametrize("P", [13, 7])
def test_plain_enum_loglik_matches_jax_kernel(P):
    """Value and the three cotangents against JAX ``enum_loglik`` run
    through the Pallas interpreter, on a ragged grid (``TOL``)."""
    pb = _problem(P=P, seed=P)
    _check(_torch(pb), _jax(pb), TOL)


@pytest.mark.parametrize("P", [13, 7])
def test_plain_enum_loglik_matches_xla_oracle(P):
    """Value and cotangents against the XLA oracle of
    tests/test_enum_kernel.py (``TOL_ORACLE``)."""
    pb = _problem(C=8, L=200, P=P, seed=20 + P)
    _check(_torch(pb), _jax(pb, oracle=True), TOL_ORACLE)


def test_extreme_values_stay_finite_and_match_jax():
    """tests/test_enum_kernel.py's extremes: zero-read bins, ~zero and
    huge rates, phi at its clamp bounds, a near-one-hot simplex.  Against
    the interpreted kernel at ``TOL`` (per bin for dmu: the 5e4-read bin
    and the 1e4 rate put |dmu| at O(1e3) in a few bins, where both sides
    carry float32 rounding of that size) and against the oracle per bin
    at 1e-3, as the JAX test holds its kernel."""
    pb = _problem(C=8, L=128, seed=13)
    reads, mu, phi = pb["reads"], pb["mu"], pb["phi"]
    reads[0, :] = 0.0
    reads[:, 0] = 0.0
    reads[1, 1] = 5e4
    mu[2, :] = 1e-6
    mu[3, :] = 1e4
    phi[4, :] = 0.001
    phi[5, :] = 0.999
    logits = np.random.default_rng(13).normal(0, 2, pb["log_pi"].shape)
    logits[6, :, 0] = 40.0
    pb["log_pi"] = np.asarray(jax.nn.log_softmax(
        jnp.asarray(logits.astype(np.float32)), -1))
    got, ref = _torch(pb), _jax(pb)
    for name, a, b in zip(NAMES, got, ref):
        assert np.isfinite(a).all(), name
        err = _floored(a, b) if name in ("dlog_pi", "dphi") \
            else _per_bin(a, b)
        assert err < TOL[name], (name, err)
    assert _per_bin(got[0], _jax(pb, oracle=True)[0]) < 1e-3


def test_plain_backward_matches_autograd_of_plain_forward():
    """enum_bwd_plain is an explicit backward; autograd through
    enum_fwd_plain differentiates the Stirling series where the backward
    uses the digamma series (the two agree to ~1e-6 relative): 1e-4 of
    max(1, max|.|).  The backward's weights normalise against ll less
    the hoisted read term, so a wrong hoist would show here."""
    pb = _problem(C=8, L=64, seed=3)
    t = {k: torch.from_numpy(np.array(v)) for k, v in pb.items()}
    scal = tek.scalars(t["lamb"])
    mu, lp, phi = (t[k].clone().requires_grad_(True)
                   for k in ("mu", "log_pi", "phi"))
    ll = tek.enum_fwd_plain(t["reads"], mu, lp, phi, scal)
    auto = torch.autograd.grad(ll, (mu, phi, lp), t["g"])
    expl = tek.enum_bwd_plain(t["reads"], t["mu"], t["log_pi"], t["phi"],
                              scal, ll.detach(), t["g"])
    for name, a, b in zip(("dmu", "dphi", "dlog_pi"), expl, auto):
        assert _floored(a.numpy(), b.numpy()) < 1e-4, name


def test_unfused_and_fused_share_the_enumeration():
    """With a flat prior (etas = 1) the fused forward's lse is the
    unfused ll less its hoisted read term, on the same log-simplex."""
    pb = _problem(C=6, L=90, seed=4)
    t = {k: torch.from_numpy(np.array(v)) for k, v in pb.items()}
    scal = tek.scalars(t["lamb"])
    lp_t = t["log_pi"].permute(2, 0, 1).contiguous()
    ll = tek.enum_fwd_plain(t["reads"], t["mu"], t["log_pi"], t["phi"],
                            scal)
    out, lse = tek.fused_fwd_plain(t["reads"], t["mu"], lp_t, t["phi"],
                                   scal, etas_t=torch.ones_like(lp_t))
    hoisted = t["reads"] * scal[0] - tek.lgamma_ge1(t["reads"] + 1.0)
    assert torch.allclose(ll, lse + hoisted, rtol=0, atol=1e-4)
    assert torch.allclose(ll, out, rtol=0, atol=1e-4)


def test_layout_contract_and_gradient_contract():
    """Cells-major in and out, as the JAX entry point: a state-major
    log_pi raises, and so does a non-contiguous one (the kernels read
    each bin's P floats where they lie); dlog_pi comes back cells-major.
    reads and lamb get silent zero cotangents; the CPU path launches
    nothing."""
    pb = _problem(C=4, L=40, seed=5)
    t = {k: torch.from_numpy(np.array(v)) for k, v in pb.items()}
    lp_t = t["log_pi"].permute(2, 0, 1).contiguous()
    with pytest.raises(ValueError, match="CELLS-MAJOR"):
        tek.enum_loglik(t["reads"], t["mu"], lp_t, t["phi"], t["lamb"])
    with pytest.raises(ValueError, match="contiguous"):
        tek.enum_loglik(t["reads"], t["mu"], lp_t.permute(1, 2, 0),
                        t["phi"], t["lamb"])
    with pytest.raises(ValueError, match="lse/g"):
        tek.enum_bwd(t["reads"], t["mu"], t["log_pi"], t["phi"],
                     tek.scalars(t["lamb"]), t["reads"], t["reads"][:, 1:])
    _cuda.reset_launches()
    got = _torch(pb)
    assert got[2].shape == pb["log_pi"].shape
    assert sum(_cuda.LAUNCHES.values()) == 0

    reads = t["reads"].clone().requires_grad_(True)
    lamb = t["lamb"].clone().requires_grad_(True)
    ll = tek.enum_loglik(reads, t["mu"], t["log_pi"], t["phi"], lamb)
    dr, dl = torch.autograd.grad(ll.sum(), (reads, lamb))
    assert not dr.any() and not dl.any()


def _chip_smoke():
    """chip_smoke.py as a module: its inputs, ll_scale and TOL_ENUM."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rep1_to_next_state(slots):
    """The rep-1 pair of the shared chi = 2 slot reads lp[2], not lp[1]."""
    return [(chi, [(s + 1, r) if chi == 2.0 and r == 1 else (s, r)
                   for s, r in pairs]) for chi, pairs in slots]


def _drop_first_pair(slots):
    """The (s = 0, rep = 0) pair leaves the sweep."""
    return [(chi, [p for p in pairs if p != (0, 0)]) for chi, pairs in slots]


@pytest.mark.parametrize("fault", [_rep1_to_next_state, _drop_first_pair],
                         ids=["rep1_next_state", "drop_s0_r0"])
def test_chip_smoke_measures_catch_a_planted_forward_fault(monkeypatch,
                                                          fault):
    """chip_smoke.py holds the unfused forward kernel to its plain version
    per bin on |ll - ll_plain| / ll_scale (TOL_ENUM['ll'] = 1e-5) and
    per_cell_objective per cell on the sum over loci of the same
    (TOL_ENUM['per_cell'] = 1e-6).  A forward whose chi sweep misroutes
    one (state, rep) pair, as a wrong slot table in the kernel would, must
    read above both on chip_smoke.py's own kernel inputs: here the plain
    forward with the faulty slot table against the correct one (readings
    at 32 x 257: rep1_next_state 0.75 per bin, 8.1e-5 per cell;
    drop_s0_r0 0.34 and 2.1e-5)."""
    cs = _chip_smoke()
    gen = torch.Generator().manual_seed(cs.SEED)
    x = cs.kernel_inputs(32, 257, gen, torch.device("cpu"))
    args = (x["reads"], x["mu"], x["log_pi"], x["phi"],
            tek.scalars(x["lamb"]))
    ok = tek.enum_fwd_plain(*args)
    table = tek.chi_slots
    monkeypatch.setattr(tek, "chi_slots", lambda P: fault(table(P)))
    d = tek.enum_fwd_plain(*args) - ok
    scale = cs.ll_scale(ok, args[0], args[4])
    per_bin = float((d.abs() / scale).max())
    per_cell = float((d.sum(dim=1).abs() / scale.sum(dim=1)).max())
    assert per_bin > cs.TOL_ENUM["ll"], per_bin
    assert per_cell > cs.TOL_ENUM["per_cell"], per_cell


def test_wrapper_constants_match_the_kernel_source():
    """The wrappers' block size (which picks enum_bwd's launch key) and
    state limit are the CUDA source's THREADS and MAXP."""
    import re
    src = (_cuda.CSRC_DIR / _cuda.SOURCES["enum_fused"]).read_text()
    found = {k: int(v) for k, v in re.findall(
        r"constexpr int (THREADS|MAXP) = (\d+);", src)}
    assert found == {"THREADS": tek.THREADS, "MAXP": tek.MAX_P}
