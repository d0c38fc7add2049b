"""Parity of the port's binary-encoded PERT model with the JAX model.

Under ``enum_impl='binary'`` the pi parameter is ``pi_bin_logits``, Kb =
ceil(log2 P) planes (arXiv 2206.00093).  The binary init, ``binary_log_pi``,
``pert_loss`` with its gradients and the decode are held against JAX
``PertModelSpec(enum_impl='binary_interpret')``, whose binary kernels run
through the Pallas interpreter, from the same parameters and inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.models import pert as jpert
from scdna_replication_tools_tpu_torch import weights
from scdna_replication_tools_tpu_torch.models import pert as tpert

from test_torch_model import _build, _inputs, one_torch_thread  # noqa: F401


def _binary_build(kind, seed):
    inp = _inputs(kind, seed=seed)
    inp["spec_kw"] = dict(inp["spec_kw"])
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
    jspec = jpert.PertModelSpec(enum_impl="binary_interpret",
                                **inp["spec_kw"])
    tspec = tpert.PertModelSpec(binary_pi=True, **inp["spec_kw"])
    params = {k: v for k, v in params.items() if k != "pi_logits"}
    jinit = jpert.init_params(jspec, jbatch, jfixed, t_init=inp["t_init"])
    rng = inp["rng"]
    z = np.asarray(jinit["pi_bin_logits"])
    if inp["flat"]:
        # spread the simplex so that every state carries posterior weight
        z = rng.normal(0, 2, z.shape)
    params["pi_bin_logits"] = (z + rng.normal(0, 0.1, z.shape)) \
        .astype(np.float32)
    return inp, jspec, tspec, jbatch, tbatch, jfixed, params


def _assert_logits_close(tz, jz):
    """z = logit(q) of float32 bit marginals q that the two backends sum
    over P in their own orders: an ulp of q (2^-24 near 1) moves z by
    2^-24 / (q (1 - q)), up to ~1e-2 where 1 - q ~ 1e-5 under the 1e6
    concentrations.  Held per element to 1e-5 plus 8 such ulps."""
    q = 1.0 / (1.0 + np.exp(-jz.astype(np.float64)))
    bound = 1e-5 + 8 * 2.0 ** -24 / (q * (1.0 - q))
    assert np.all(np.abs(tz - jz) <= bound), \
        float(np.max(np.abs(tz - jz) / bound))


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_binary_init_and_log_pi_match_jax(kind):
    """``_init_binary_pi`` (the dense mean-field and the sparse sign
    forms) and ``binary_log_pi`` against JAX (the dense form's logits to
    the conditioning of ``_assert_logits_close``; the sparse form and
    log_pi to 1e-5)."""
    inp, jspec, tspec, jbatch, tbatch, jfixed, params = _binary_build(
        kind, seed=9)
    jz = np.asarray(jpert._init_binary_pi(jspec, jbatch))
    tz = tpert._init_binary_pi(tspec, tbatch).numpy()
    assert tz.shape == jz.shape == (4,) + inp["reads"].shape
    if kind == "dense":
        _assert_logits_close(tz, jz)
    else:
        np.testing.assert_allclose(tz, jz, rtol=1e-5, atol=1e-5)
    z = params["pi_bin_logits"]
    jlp = np.asarray(jpert.binary_log_pi(jspec, jnp.asarray(z)))
    tlp = tpert.binary_log_pi(tspec, torch.from_numpy(z)).numpy()
    assert tlp.shape == jlp.shape == inp["reads"].shape + (13,)
    np.testing.assert_allclose(tlp, jlp, rtol=1e-5, atol=1e-5)
    # the full init dicts agree key for key
    jp = jpert.init_params(jspec, jbatch, jfixed, t_init=inp["t_init"])
    tp = tpert.init_params(tspec, tbatch,
                           weights.fixed_from_jax(inp["fixed"], "cpu"),
                           t_init=inp["t_init"])
    assert set(jp) == set(tp) and "pi_bin_logits" in tp
    for k in jp:
        if k == "pi_bin_logits" and kind == "dense":
            _assert_logits_close(tp[k].numpy(), np.asarray(jp[k]))
            continue
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("kind", ["dense", "sparse", "dense_flat",
                                  "sparse_flat"])
def test_binary_pert_loss_and_gradients_match_jax(kind):
    """The binary objective against JAX ``PertModelSpec(enum_impl=
    'binary_interpret')``, with the bounds of test_torch_model's
    categorical case: loss within 1e-5 relative (the dense prior's
    parameter-free normaliser left out, as there), gradients within 1e-4
    of their largest entry, pi_bin_logits within 3e-4 under the flat
    prior and within a few float32 ulps of 1e6 under the prior."""
    inp, jspec, tspec, jbatch, tbatch, jfixed, params = _binary_build(
        kind, seed={"dense": 12, "sparse": 13, "dense_flat": 17,
                    "sparse_flat": 18}[kind])
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
        etas = inp["fields"]["etas"]
        mask = inp["mask"][:, None]
        jl += float((np.asarray(jax.scipy.special.gammaln(etas.sum(-1))
                                - jax.scipy.special.gammaln(etas).sum(-1))
                     * mask).sum())
        te = torch.from_numpy(etas)
        tl += float(((torch.lgamma(te.sum(-1)) - torch.lgamma(te).sum(-1))
                     * torch.from_numpy(mask)).sum())
    assert np.isfinite(tl)
    assert abs(tl - jl) / abs(jl) < 1e-5, (tl, jl)
    assert set(tparams) == set(jgrads)
    for name, tg in zip(tparams, tgrads):
        jg = np.asarray(jgrads[name])
        assert tg.shape == jg.shape, name
        tol = 1e-4 * np.max(np.abs(jg))
        if name == "pi_bin_logits" and inp["flat"]:
            tol = 3e-4 * np.max(np.abs(jg))
        elif name == "pi_bin_logits":
            tol += 4 * np.finfo(np.float32).eps * 1e6
        err = float(np.max(np.abs(tg.numpy() - jg)))
        assert err < tol, (name, err, tol)


def test_binary_decode_matches_jax():
    """MAP cn/rep of the binary model equal bin for bin, p_rep within
    1e-4, and the slabbed decode (pi_bin_logits sliced on its cells
    axis) equals the one-pass decode."""
    inp, jspec, tspec, jbatch, tbatch, jfixed, params = _binary_build(
        "sparse", seed=15)
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
