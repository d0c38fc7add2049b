"""Parity of the port's fused enumeration (plain versions) with the JAX
fused kernels run through the Pallas interpreter.

The port's CUDA kernels repeat the plain versions' arithmetic; on the
CPU the wrappers take the plain versions, which these tests hold
against ``enum_loglik_fused`` / ``enum_loglik_fused_sparse``
(``interpret=True``) in value and in all three cotangents.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import digamma as sp_digamma
from scipy.special import gammaln as sp_gammaln

from scdna_replication_tools_tpu.ops import enum_kernel as jek
from scdna_replication_tools_tpu_torch.ops import enum_kernel as tek

from test_torch_model import one_torch_thread  # noqa: F401


def _problem(C=16, L=300, P=13, seed=0, sparse=False, flat=False):
    # L=300 is ragged against the TPU kernel's (8, 512) tile.  flat=True
    # gives the prior no data term (etas = 1, or eta_w = 0), so that out
    # minus lse is the hoisted read term alone and every cotangent is
    # the enumeration's own, at O(|g|) scale
    rng = np.random.default_rng(seed)
    reads = rng.poisson(40, (C, L)).astype(np.float32)
    mu = rng.uniform(2, 30, (C, L)).astype(np.float32)
    pi_t = rng.normal(0, 2, (P, C, L)).astype(np.float32)
    phi = rng.uniform(0.01, 0.99, (C, L)).astype(np.float32)
    g = rng.normal(0, 1, (C, L)).astype(np.float32)
    if sparse:
        idx = rng.integers(0, P, (C, L)).astype(np.float32)
        w = np.where(rng.uniform(size=(C, L)) < 0.8, 1e6, 0.0) \
            .astype(np.float32)
        prior = (idx, np.zeros_like(w) if flat else w)
    else:
        etas = rng.uniform(0.3, 5.0, (P, C, L)).astype(np.float32)
        # composite-like bins: a few states carrying 1e5-1e6 weight
        hot = rng.integers(0, P, (C, L))
        np.put_along_axis(etas, hot[None], 1e6, axis=0)
        prior = (np.ones_like(etas) if flat else etas,)
    if flat:
        # reads around mu * chi with mu down to 0.2, so that the low-chi
        # slots, where delta = mu * chi * q sits at its clamp of 1, carry
        # posterior weight
        mu = rng.uniform(0.2, 30, (C, L)).astype(np.float32)
        reads = rng.poisson(mu * rng.integers(1, 7, (C, L))) \
            .astype(np.float32)
    return dict(reads=reads, mu=mu, pi_t=pi_t, phi=phi, g=g, prior=prior,
                lamb=np.float32(0.75))


def _jax_fused(pb):
    """JAX value and (dmu, dpi, dphi) cotangents via jax.vjp."""
    lamb = jnp.float32(pb["lamb"])
    prior = [jnp.asarray(x) for x in pb["prior"]]
    if len(prior) == 1:
        fn = lambda m, p, f: jek.enum_loglik_fused(  # noqa: E731
            jnp.asarray(pb["reads"]), m, p, f, prior[0], lamb, True)
    else:
        fn = lambda m, p, f: jek.enum_loglik_fused_sparse(  # noqa: E731
            jnp.asarray(pb["reads"]), m, p, f, prior[0], prior[1], lamb,
            True)
    out, vjp = jax.vjp(fn, jnp.asarray(pb["mu"]), jnp.asarray(pb["pi_t"]),
                       jnp.asarray(pb["phi"]))
    dmu, dpi, dphi = vjp(jnp.asarray(pb["g"]))
    return [np.asarray(a) for a in (out, dmu, dpi, dphi)]


def _torch_fused(pb):
    """Port value and (dmu, dpi, dphi) through the public autograd entry
    points (the plain versions on CPU tensors)."""
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in pb.items()
         if k != "prior"}
    prior = [torch.from_numpy(x) for x in pb["prior"]]
    mu = t["mu"].clone().requires_grad_(True)
    pi_t = t["pi_t"].clone().requires_grad_(True)
    phi = t["phi"].clone().requires_grad_(True)
    if len(prior) == 1:
        out = tek.enum_loglik_fused(t["reads"], mu, pi_t, phi, prior[0],
                                    t["lamb"])
    else:
        out = tek.enum_loglik_fused_sparse(t["reads"], mu, pi_t, phi,
                                           prior[0], prior[1], t["lamb"])
    dmu, dpi, dphi = torch.autograd.grad(out, (mu, pi_t, phi), t["g"])
    return [a.detach().numpy() for a in (out, dmu, dpi, dphi)]


def _rel(a, b):
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30))


# The two compute the same float32 operations in the same order, so they
# differ by the backends' exp/log rounding summed over at most 26 terms
# per bin: 1e-5 of the largest magnitude.  dmu and dphi sum posterior
# weights times slopes of opposite sign (psi differences; -1/(1-phi) and
# 1/phi up to 100), whose cancellation leaves a larger share of that
# rounding: 1e-4.
TOL = {"out": 1e-5, "dpi": 1e-5, "dmu": 1e-4, "dphi": 1e-4}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("P", [13, 7])
def test_plain_fused_matches_jax_kernel(sparse, P):
    """Value and all three cotangents against the interpreted TPU kernel
    (tolerances: ``TOL``)."""
    pb = _problem(P=P, sparse=sparse, seed=P + int(sparse))
    ref = _jax_fused(pb)
    got = _torch_fused(pb)
    for name, a, b in zip(("out", "dmu", "dpi", "dphi"), got, ref):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.isfinite(a).all(), name
        assert _rel(a, b) < TOL[name], (name, _rel(a, b))


def _elementwise(a, b):
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def _floored(a, b):
    return float(np.max(np.abs(a - b)) / max(1.0, float(np.max(np.abs(b)))))


# With a flat prior every cotangent is a sum of posterior weights (each
# in [0, 1]) times |g| ~ 1 and slopes, so a wrong weight, a weight sent
# to the wrong state or a dropped sum over weights moves some entry by
# O(0.1-1).  The two backends differ by their float32 exp/log ulps:
# readings up to 3.3e-5 (out, per bin), 2.1e-5 (dmu), 3.7e-5 (dpi) and
# 1.8e-5 (dphi, of max(1, max|.|)) over the four cases; bounds 2e-4.
# Planted in a copy of fused_bwd_plain, a dropped `tot += gw` reads dpi
# 0.97-1.36, the rep = 1 weight sent to dlp[chi] 0.80-1.26, and the
# delta clamp's gate left out of dmu 0.58-1.26.
TOL_FLAT = {"out": 2e-4, "dmu": 2e-4, "dpi": 2e-4, "dphi": 2e-4}


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("P", [13, 7])
def test_plain_fused_enumeration_part_matches_jax(sparse, P):
    """The enumeration's own share of value and cotangents, which the 1e6
    concentrations of test_plain_fused_matches_jax would swamp: with a
    flat prior, out is x log(lamb) - lgamma(x + 1) + lse (held per bin,
    |a - b| / (1 + |b|)) and dpi is the posterior weights less softmax
    times their sum (held to max(1, max|dpi|), an absolute bound here).
    Tolerances: ``TOL_FLAT``."""
    pb = _problem(P=P, sparse=sparse, seed=40 + P + int(sparse), flat=True)
    ref = _jax_fused(pb)
    got = _torch_fused(pb)
    assert _elementwise(got[0], ref[0]) < TOL_FLAT["out"], \
        ("out", _elementwise(got[0], ref[0]))
    for name, a, b in zip(("dmu", "dpi", "dphi"), got[1:], ref[1:]):
        assert np.isfinite(a).all(), name
        assert _floored(a, b) < TOL_FLAT[name], (name, _floored(a, b))


def test_extreme_values_stay_finite_and_match_jax():
    """Zero-read bins, ~zero and huge rates, phi at its clamp bounds and
    a near-one-hot simplex (tests/test_enum_kernel.py's extremes).
    Per-bin relative bounds ``TOL`` (1.0 floor): the 5e4-read bin has
    |out| in the thousands, where both sides carry O(1e-3) absolute
    float32 rounding."""
    pb = _problem(C=8, L=128, seed=13)
    reads, mu, phi, pi_t = pb["reads"], pb["mu"], pb["phi"], pb["pi_t"]
    reads[0, :] = 0.0
    reads[:, 0] = 0.0
    reads[1, 1] = 5e4
    mu[2, :] = 1e-6
    mu[3, :] = 1e4
    phi[4, :] = 0.001
    phi[5, :] = 0.999
    pi_t[0, 6, :] = 40.0
    ref = _jax_fused(pb)
    got = _torch_fused(pb)
    for name, a, b in zip(("out", "dmu", "dpi", "dphi"), got, ref):
        assert np.isfinite(a).all(), name
        rel = np.max(np.abs(a - b) / (np.abs(b) + 1.0))
        assert rel < TOL[name], (name, float(rel))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_plain_backward_matches_autograd_of_plain_forward(sparse):
    """fused_bwd_plain is an explicit backward; torch autograd through
    fused_fwd_plain differentiates the Stirling series instead of using
    the digamma series, which agree to ~1e-6 relative: 1e-4 bound."""
    pb = _problem(C=8, L=64, sparse=sparse, seed=3)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in pb.items()
         if k != "prior"}
    prior = [torch.from_numpy(x) for x in pb["prior"]]
    kw = dict(etas_t=prior[0]) if len(prior) == 1 else \
        dict(eta_idx=prior[0], eta_w=prior[1])
    scal = tek.scalars(t["lamb"])
    mu = t["mu"].clone().requires_grad_(True)
    pi_t = t["pi_t"].clone().requires_grad_(True)
    phi = t["phi"].clone().requires_grad_(True)
    out, lse = tek.fused_fwd_plain(t["reads"], mu, pi_t, phi, scal, **kw)
    auto = torch.autograd.grad(out, (mu, phi, pi_t), t["g"])
    expl = tek.fused_bwd_plain(t["reads"], t["mu"], t["pi_t"], t["phi"],
                               scal, lse.detach(), t["g"], **kw)
    for name, a, b in zip(("dmu", "dphi", "dpi"), expl, auto):
        assert _rel(a.numpy(), b.numpy()) < 1e-4, \
            (name, _rel(a.numpy(), b.numpy()))


def test_series_against_torch_special_functions():
    """The Stirling-series lgamma/digamma (the TPU kernel's, kept so
    kernel, plain version and JAX agree) against torch.lgamma /
    torch.digamma on [1, 5e4]: lgamma within 3e-6 relative (1.0 floor),
    digamma within 1e-4 absolute, as tests/test_enum_kernel.py holds the
    JAX series against scipy."""
    z = torch.from_numpy(np.random.default_rng(1)
                         .uniform(1.0, 5e4, 50000).astype(np.float32))
    lg = tek.lgamma_ge1(z).double()
    dg = tek.lgamma_digamma_ge1(z)[1].double()
    lg_ref = torch.lgamma(z.double())
    dg_ref = torch.digamma(z.double())
    rel = (lg - lg_ref).abs() / lg_ref.abs().clamp(min=1.0)
    assert float(rel.max()) < 3e-6
    assert float((dg - dg_ref).abs().max()) < 1e-4
    # and the fused pair's lgamma equals the lone series bit for bit
    assert torch.equal(tek.lgamma_digamma_ge1(z)[0], tek.lgamma_ge1(z))
    # same series as JAX's: the two differ only by XLA's and PyTorch's
    # float32 log (a few ulps), which (zz - 0.5) * log(zz) scales up
    jlg = np.asarray(jek._lgamma_ge1(jnp.asarray(z.numpy())))
    assert np.max(np.abs(jlg - tek.lgamma_ge1(z).numpy())
                  / np.maximum(np.abs(jlg), 1.0)) < 1e-5
    assert np.max(np.abs(sp_gammaln(z.numpy().astype(np.float64))
                         - lg_ref.numpy())) < 1e-6
    assert np.max(np.abs(sp_digamma(z.numpy().astype(np.float64))
                         - dg_ref.numpy())) < 1e-6


@pytest.mark.parametrize("P", [1, 2, 7, 13, 16])
def test_chi_slots_match_jax(P):
    assert tek.chi_slots(P) == jek._chi_slots(P)


def test_layout_contract_and_device_dispatch():
    """Cells-major pi raises like the JAX kernel; a tensor that is on
    neither the CPU nor a CUDA device is refused instead of falling back
    to the plain version."""
    pb = _problem(C=4, L=32, seed=5)
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in pb.items()
         if k != "prior"}
    etas_t = torch.from_numpy(pb["prior"][0])
    with pytest.raises(ValueError, match="STATE-MAJOR"):
        tek.enum_loglik_fused(t["reads"], t["mu"],
                              t["pi_t"].permute(1, 2, 0), t["phi"],
                              etas_t.permute(1, 2, 0), t["lamb"])
    # the kernels read three scalars and a cotangent per bin: shorter
    # operands are refused before any pointer is handed over
    scal = tek.scalars(t["lamb"])
    with pytest.raises(ValueError, match=r"\(3,\)"):
        tek.fused_fwd(t["reads"], t["mu"], t["pi_t"], t["phi"], scal[:2],
                      etas_t=etas_t)
    with pytest.raises(ValueError, match="lse/g"):
        tek.fused_bwd(t["reads"], t["mu"], t["pi_t"], t["phi"], scal,
                      t["reads"], t["reads"][:, :-1], etas_t=etas_t)
    meta ={k: v.to("meta") for k, v in t.items()}
    with pytest.raises(ValueError, match="CUDA device"):
        tek.fused_fwd(meta["reads"], meta["mu"], meta["pi_t"], meta["phi"],
                      torch.zeros(3, device="meta"),
                      etas_t=etas_t.to("meta"))
