"""Parity of the port's PERT objective and decode with the JAX model.

Both packages start from the same parameters (the JAX ``init_params``
plus seeded noise, carried across with ``weights.params_from_jax``) on
the same NumPy inputs.  The JAX side runs the fused steps through the
Pallas interpreter (``enum_impl='pallas_interpret'``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.special import gammaln as sp_gammaln

from scdna_replication_tools_tpu.models import pert as jpert
from scdna_replication_tools_tpu.ops.gc import gc_features as jgc_features
from scdna_replication_tools_tpu_torch import weights
from scdna_replication_tools_tpu_torch.models import pert as tpert
from scdna_replication_tools_tpu_torch.ops.gc import gc_features

P, K, C, L = 13, 4, 12, 200


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread for the port's tests: their tensors are tiny,
    and PyTorch's idle pool threads spin on the cores that the other test
    workers share (same wall time, a quarter of the CPU time)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _inputs(kind, seed=0, prior_scale=1.0):
    """``kind``: step1, dense or sparse; dense_flat / sparse_flat give
    the prior no data term (etas = 1, eta_w = 0), so the pi_logits
    gradient is the enumeration's alone."""
    kind, _, flat = kind.partition("_")
    rng = np.random.default_rng(seed)
    cn = rng.integers(1, 6, (C, L)).astype(np.float32)
    reads = rng.poisson(30 * cn).astype(np.float32)
    gammas = rng.uniform(0.35, 0.6, L).astype(np.float32)
    libs = rng.integers(0, 2, C).astype(np.int32)
    mask = np.ones(C, np.float32)
    mask[-1] = 0.0                                     # one padded cell
    fields = {}
    if kind == "step1":
        fields = dict(cn_obs=cn, rep_obs=rng.integers(0, 2, (C, L))
                      .astype(np.float32))
    elif kind == "dense":
        etas = np.ones((C, L, P), np.float32)
        for w in (1e6, 4e5, 2e5):                      # composite-like
            np.put_along_axis(etas, rng.integers(0, P, (C, L, 1)),
                              w * prior_scale, -1)
        fields = dict(etas=etas)
    else:
        fields = dict(eta_idx=cn.copy(),
                      eta_w=np.where(rng.uniform(size=(C, L)) < 0.9, 1e6,
                                     0.0).astype(np.float32))
    init_fields = fields
    if flat:
        # init_params reads the ploidy guess off the prior, so the init
        # keeps the composite one
        fields = {k: np.ones_like(v) if k == "etas" else
                  np.zeros_like(v) if k == "eta_w" else v
                  for k, v in fields.items()}
    fixed = {}
    if kind != "step1":
        fixed = dict(beta_means=rng.normal(0, 0.3, (2, K + 1))
                     .astype(np.float32), lamb=np.float32(0.7))
    if kind == "sparse":
        fixed.update(rho=rng.uniform(0, 1, L).astype(np.float32),
                     a=np.float32(9.0))
    spec_kw = dict(P=P, K=K, L=2)
    if kind == "step1":
        spec_kw.update(tau_mode="beta_default", step1=True)
    else:
        spec_kw.update(tau_mode="param", cond_beta_means=True,
                       fixed_lamb=True, sparse_etas=kind == "sparse")
        if kind == "sparse":
            spec_kw.update(cond_rho=True, cond_a=True)
    return dict(reads=reads, libs=libs, gammas=gammas, mask=mask,
                fields=fields, init_fields=init_fields, fixed=fixed,
                spec_kw=spec_kw, flat=bool(flat),
                t_init=rng.uniform(0.1, 0.9, C).astype(np.float32),
                rng=rng)


def _jax_batch(inp, fields):
    return jpert.PertBatch(
        reads=jnp.asarray(inp["reads"]), libs=jnp.asarray(inp["libs"]),
        gamma_feats=jgc_features(jnp.asarray(inp["gammas"]), K),
        mask=jnp.asarray(inp["mask"]),
        **{k: jnp.asarray(v) for k, v in fields.items()})


def _build(inp):
    jspec = jpert.PertModelSpec(enum_impl="pallas_interpret",
                                **inp["spec_kw"])
    tspec = tpert.PertModelSpec(**inp["spec_kw"])
    jbatch = _jax_batch(inp, inp["fields"])
    tbatch = tpert.PertBatch(
        reads=torch.from_numpy(inp["reads"]),
        libs=torch.from_numpy(inp["libs"]).long(),
        gamma_feats=gc_features(torch.from_numpy(inp["gammas"]), K),
        mask=torch.from_numpy(inp["mask"]),
        **{k: torch.from_numpy(v) for k, v in inp["fields"].items()})
    jfixed = {k: jnp.asarray(v) for k, v in inp["fixed"].items()}
    params = jpert.init_params(jspec, _jax_batch(inp, inp["init_fields"]),
                               jfixed, t_init=inp["t_init"])
    # seeded noise so every gradient is exercised away from the init
    rng = inp["rng"]
    params = {k: np.asarray(v) + rng.normal(0, 0.1, np.shape(v))
              .astype(np.float32) for k, v in params.items()}
    if inp["flat"]:
        # spread the simplex so every state carries posterior weight
        params["pi_logits"] = rng.normal(0, 2, params["pi_logits"].shape) \
            .astype(np.float32)
    return jspec, tspec, jbatch, tbatch, jfixed, params


def _normaliser_sum(inp, lgamma, xp):
    """Masked sum of the dense prior's parameter-free Dirichlet
    normaliser, computed with one backend's float32 lgamma."""
    etas = xp(inp["fields"]["etas"])
    per_bin = lgamma(etas.sum(-1)) - lgamma(etas).sum(-1)
    return float((per_bin * xp(inp["mask"])[:, None]).sum())


@pytest.mark.parametrize("kind", ["step1", "dense", "sparse", "dense_flat",
                                  "sparse_flat"])
def test_pert_loss_value_and_gradients_match_jax(kind):
    """Loss within 1e-5 relative: float32 sums over ~2.4k bins in
    different reduction orders.  The dense prior's normaliser is left
    out of that comparison: its two lgamma terms are ~2e7 per bin, where
    XLA's and PyTorch's float32 lgamma differ by an ulp or two (2 to 4
    per bin; test_dirichlet_pi_term_matches_jax bounds it), and it is
    constant in the parameters.  Gradients within 1e-4 of each one's
    largest entry; pi_logits also within a few float32 ulps of the
    prior's concentration (1e6), because dpi = dlp - softmax * sum(dlp)
    cancels terms of that size.  With the 1e6 prior those allowances come
    to ~1e2 and would hide the enumeration's own share of the pi
    gradient, which is O(1) per entry: the *_flat kinds (no prior data
    term, spread pi_logits) hold that share to 3e-4 of its largest
    entry."""
    inp = _inputs(kind, seed={"step1": 1, "dense": 2, "sparse": 3,
                              "dense_flat": 7, "sparse_flat": 8}[kind])
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)

    jloss, jgrads = jax.value_and_grad(
        lambda p: jpert.pert_loss(jspec, p, jfixed, jbatch))(
        {k: jnp.asarray(v) for k, v in params.items()})

    tparams = {k: v.requires_grad_(True) for k, v in
               weights.params_from_jax(params, "cpu").items()}
    tfixed = weights.fixed_from_jax(inp["fixed"], "cpu")
    tloss = tpert.pert_loss(tspec, tparams, tfixed, tbatch)
    tgrads = torch.autograd.grad(tloss, list(tparams.values()))

    jl, tl = float(jloss), float(tloss.detach())
    if kind.startswith("dense"):
        jl += _normaliser_sum(inp, jax.scipy.special.gammaln, jnp.asarray)
        tl += _normaliser_sum(inp, torch.lgamma, torch.from_numpy)
    assert np.isfinite(tl)
    assert abs(tl - jl) / abs(jl) < 1e-5, (tl, jl)
    assert set(tparams) == set(jgrads)
    eta_max = 1e6 if kind in ("dense", "sparse") else 1.0
    for name, tg in zip(tparams, tgrads):
        jg = np.asarray(jgrads[name])
        assert tg.shape == jg.shape, name
        tol = 1e-4 * np.max(np.abs(jg))
        if name == "pi_logits" and inp["flat"]:
            # the posterior weights exp(nb - lse) carry the float32 ulps
            # of nb (~1e3 at these reads): readings 6.5e-5 and 5.7e-5
            # of max|grad| ~ 1, where a misrouted or dropped weight
            # moves an entry by O(0.1)
            tol = 3e-4 * np.max(np.abs(jg))
        elif name == "pi_logits":
            tol += 4 * np.finfo(np.float32).eps * eta_max
        err = float(np.max(np.abs(tg.numpy() - jg)))
        assert err < tol, (name, err, tol)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_init_params_match_jax(kind):
    """init_params agrees with JAX key for key (same layouts)."""
    inp = _inputs(kind, seed=4)
    jspec, tspec, jbatch, tbatch, jfixed, _ = _build(inp)
    jp = jpert.init_params(jspec, jbatch, jfixed, t_init=inp["t_init"])
    tp = tpert.init_params(tspec, tbatch,
                           weights.fixed_from_jax(inp["fixed"], "cpu"),
                           t_init=inp["t_init"])
    assert set(jp) == set(tp)
    for k in jp:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_decode_matches_jax(kind):
    """MAP cn/rep equal bin for bin; p_rep within 1e-4 (the joint logits
    go through lgamma on both backends); slabbed decode equals the
    one-pass decode."""
    inp = _inputs(kind, seed=5)
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
    jcn, jrep, jprep = (np.asarray(a) for a in jpert.decode_discrete(
        jspec, {k: jnp.asarray(v) for k, v in params.items()}, jfixed,
        jbatch))
    tparams = weights.params_from_jax(params, "cpu")
    tfixed = weights.fixed_from_jax(inp["fixed"], "cpu")
    tcn, trep, tprep = tpert.decode_discrete(tspec, tparams, tfixed, tbatch)
    np.testing.assert_array_equal(tcn.numpy(), jcn)
    np.testing.assert_array_equal(trep.numpy(), jrep)
    np.testing.assert_allclose(tprep.numpy(), jprep, atol=1e-4)
    slabbed = tpert.decode_discrete(tspec, tparams, tfixed, tbatch,
                                    cell_chunk=5)
    for a, b in zip(slabbed, (tcn, trep, tprep)):
        assert torch.equal(a, b)


def test_dirichlet_pi_term_matches_jax():
    """The full Dirichlet term (data + normaliser) keeps the JAX
    parenthesisation: the normaliser's two lgamma terms (~2e7 at these
    concentrations) cancel to ~1e2 before the data term is added.  Per
    bin, the two backends' float32 lgamma differ by a few ulps of ~2e7
    (spacing 2), so the bound is 4 ulps of the largest lgamma argument's
    value; adding the data term first would miss it by far more."""
    for kind in ("dense", "sparse"):
        inp = _inputs(kind, seed=6)
        jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
        log_pi = jax.nn.log_softmax(
            jnp.transpose(jnp.asarray(params["pi_logits"]), (1, 2, 0)), -1)
        ref = np.asarray(jpert._dirichlet_pi_term(P, jbatch, log_pi,
                                                  kind == "sparse"))
        got = tpert._dirichlet_pi_term(
            P, tbatch, torch.from_numpy(np.array(log_pi)),
            kind == "sparse").numpy()
        w = inp["fields"].get("etas", inp["fields"].get("eta_w"))
        top = np.float32(sp_gammaln(np.float64(w.max()) * P))
        assert np.max(np.abs(got - ref)) <= 4 * np.spacing(top), kind
