"""Parity of the port's independent-binary pi encoding with the JAX package.

The encoding (arXiv 2206.00093) stores Kb = ceil(log2 P) logit planes
instead of P: state s's logit is the sum of its set bits' planes.  Here
the port's code tables and the plain binary forms of the fused
enumeration are held against the JAX package, whose binary kernels run
through the Pallas interpreter (``interpret=True``);
``test_torch_binary_model.py`` holds the binary model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.ops import enum_kernel as jek
from scdna_replication_tools_tpu_torch.ops import enum_kernel as tek

from test_torch_enum_kernel import TOL, TOL_FLAT, _elementwise, _floored, \
    _problem, _rel
from test_torch_model import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("P", range(2, 17))
def test_code_tables_match_jax(P):
    """Kb, the per-state bit tuples, the (P, Kb) bit matrix and the
    planes-per-iteration traffic model, for every P the kernels take."""
    assert tek.binary_code_width(P) == jek.binary_code_width(P)
    assert tek.state_codes(P) == jek._state_codes(P)
    np.testing.assert_array_equal(tek.binary_code_matrix(P),
                                  jek.binary_code_matrix(P))
    for binary in (False, True):
        for sparse in (False, True):
            for mdt in ("float32", "bfloat16"):
                kw = dict(binary=binary, sparse_etas=sparse, moment_dtype=mdt)
                assert tek.planes_per_iter(P, **kw) == \
                    jek.planes_per_iter(P, **kw), kw


def test_planes_per_iter_of_binary_bf16_is_48():
    """The 'binary + bf16 moments' row of the traffic table: 48 planes
    per step-2 iteration at P = 13 with the sparse prior, against 146
    for the categorical float32 default."""
    assert tek.planes_per_iter(13, binary=True, moment_dtype="bfloat16") == 48
    assert tek.planes_per_iter(13) == 146


def _binary_problem(P, seed, sparse, flat):
    pb = _problem(P=P, seed=seed, sparse=sparse, flat=flat)
    Kb = tek.binary_code_width(P)
    pb["z_t"] = np.random.default_rng(seed + 1000) \
        .normal(0, 2, (Kb,) + pb["reads"].shape).astype(np.float32)
    pb["P"] = P
    return pb


def _jax_binary(pb):
    """JAX value and (dmu, dz, dphi) cotangents via jax.vjp of the
    interpreted binary kernels."""
    lamb = jnp.float32(pb["lamb"])
    prior = [jnp.asarray(x) for x in pb["prior"]]
    reads, P = jnp.asarray(pb["reads"]), pb["P"]
    if len(prior) == 1:
        fn = lambda m, z, f: jek.enum_loglik_fused_binary(  # noqa: E731
            reads, m, z, f, prior[0], lamb, P, True)
    else:
        fn = lambda m, z, f: jek.enum_loglik_fused_sparse_binary(  # noqa: E731
            reads, m, z, f, prior[0], prior[1], lamb, P, True)
    out, vjp = jax.vjp(fn, jnp.asarray(pb["mu"]), jnp.asarray(pb["z_t"]),
                       jnp.asarray(pb["phi"]))
    dmu, dz, dphi = vjp(jnp.asarray(pb["g"]))
    return [np.asarray(a) for a in (out, dmu, dz, dphi)]


def _torch_binary(pb):
    """Port value and (dmu, dz, dphi) through the public autograd entry
    points (the plain versions on CPU tensors)."""
    t = {k: torch.from_numpy(np.asarray(pb[k]))
         for k in ("reads", "mu", "z_t", "phi", "g", "lamb")}
    prior = [torch.from_numpy(x) for x in pb["prior"]]
    mu, z_t, phi = (t[k].clone().requires_grad_(True)
                    for k in ("mu", "z_t", "phi"))
    if len(prior) == 1:
        out = tek.enum_loglik_fused_binary(t["reads"], mu, z_t, phi, prior[0],
                                           t["lamb"], pb["P"])
    else:
        out = tek.enum_loglik_fused_sparse_binary(
            t["reads"], mu, z_t, phi, prior[0], prior[1], t["lamb"], pb["P"])
    dmu, dz, dphi = torch.autograd.grad(out, (mu, z_t, phi), t["g"])
    return [a.detach().numpy() for a in (out, dmu, dz, dphi)]


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("P", [13, 7])
def test_plain_binary_matches_jax_kernel(sparse, P):
    """Value and all three cotangents against the interpreted binary TPU
    kernels with the 1e6 prior (tolerances ``TOL``, as the categorical
    pair: dz is a sum of at most P/2 dpi terms of the same rounding)."""
    pb = _binary_problem(P, seed=60 + P + int(sparse), sparse=sparse,
                         flat=False)
    ref = _jax_binary(pb)
    got = _torch_binary(pb)
    for name, a, b in zip(("out", "dmu", "dpi", "dphi"), got, ref):
        assert a.shape == b.shape, (name, a.shape, b.shape)
        assert np.isfinite(a).all(), name
        assert _rel(a, b) < TOL[name], (name, _rel(a, b))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("P", [13, 7])
def test_plain_binary_enumeration_part_matches_jax(sparse, P):
    """With the flat prior (etas = 1, eta_w = 0) dz is the enumeration's
    own share, O(|g|), where a misrouted bit moves entries by O(0.1-1):
    held per bin (out) and to max(1, max|.|) (cotangents) at
    ``TOL_FLAT``.  Readings of dz: 2.4e-5-2.9e-5.  Planted in a copy of
    the plain backward, a dz fold that adds dpi_s to plane Kb-1-k in
    place of plane k reads 1.32-1.50 here."""
    pb = _binary_problem(P, seed=80 + P + int(sparse), sparse=sparse,
                         flat=True)
    ref = _jax_binary(pb)
    got = _torch_binary(pb)
    assert _elementwise(got[0], ref[0]) < TOL_FLAT["out"], \
        ("out", _elementwise(got[0], ref[0]))
    for name, a, b in zip(("dmu", "dpi", "dphi"), got[1:], ref[1:]):
        assert np.isfinite(a).all(), name
        assert _floored(a, b) < TOL_FLAT[name], (name, _floored(a, b))


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_plain_binary_backward_matches_autograd(sparse):
    """The explicit binary backward against torch autograd through the
    plain binary forward (Stirling-series derivative vs the digamma
    series, ~1e-6 relative: 1e-4 bound)."""
    pb = _binary_problem(13, seed=3, sparse=sparse, flat=False)
    t = {k: torch.from_numpy(np.asarray(pb[k]))
         for k in ("reads", "mu", "z_t", "phi", "g", "lamb")}
    prior = [torch.from_numpy(x) for x in pb["prior"]]
    kw = dict(etas_t=prior[0]) if len(prior) == 1 else \
        dict(eta_idx=prior[0], eta_w=prior[1])
    scal = tek.scalars(t["lamb"])
    mu, z_t, phi = (t[k].clone().requires_grad_(True)
                    for k in ("mu", "z_t", "phi"))
    out, lse = tek.fused_fwd_plain(t["reads"], mu, z_t, phi, scal,
                                   binary_P=13, **kw)
    auto = torch.autograd.grad(out, (mu, phi, z_t), t["g"])
    expl = tek.fused_bwd_plain(t["reads"], t["mu"], t["z_t"], t["phi"], scal,
                               lse.detach(), t["g"], binary_P=13, **kw)
    for name, a, b in zip(("dmu", "dphi", "dz"), expl, auto):
        assert a.shape == b.shape, name
        assert _rel(a.numpy(), b.numpy()) < 1e-4, \
            (name, _rel(a.numpy(), b.numpy()))


def test_binary_shape_contract():
    """P planes where Kb are expected are refused naming Kb, as the JAX
    kernel does; so is an etas tensor of Kb planes."""
    pb = _binary_problem(13, seed=5, sparse=False, flat=False)
    t = {k: torch.from_numpy(np.asarray(pb[k]))
         for k in ("reads", "mu", "z_t", "phi", "lamb")}
    etas_t = torch.from_numpy(pb["prior"][0])
    pi_t = torch.from_numpy(pb["pi_t"])
    with pytest.raises(ValueError, match="Kb=4"):
        tek.enum_loglik_fused_binary(t["reads"], t["mu"], pi_t, t["phi"],
                                     etas_t, t["lamb"], 13)
    with pytest.raises(ValueError, match="etas_t"):
        tek.enum_loglik_fused_binary(t["reads"], t["mu"], t["z_t"], t["phi"],
                                     etas_t[:4], t["lamb"], 13)
    with pytest.raises(ValueError, match="Kb=4"):
        tek.enum_loglik_fused_sparse_binary(
            t["reads"], t["mu"], t["z_t"][:3], t["phi"], t["reads"],
            t["reads"], t["lamb"], 13)
