"""The port's Viterbi CN decode (``models/hmm.py``,
``models.pert.decode_discrete_hmm``) against the JAX package's.

The paths are held equal on the same emissions (ties to the first
maximal state, restarts at chromosome starts); from the same joint
logits at least 99.9 % of bins decode alike (the two logsumexps over the
replication axis may differ in the last bit, which can tip a near tie).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.models import hmm as jhmm
from scdna_replication_tools_tpu.models import pert as jpert
from scdna_replication_tools_tpu_torch import weights
from scdna_replication_tools_tpu_torch.models import hmm as thmm
from scdna_replication_tools_tpu_torch.models import pert as tpert

from test_torch_model import _build, _inputs, one_torch_thread  # noqa: F401

ALIKE = 0.999


@pytest.mark.parametrize("P,self_prob", [(13, 0.99), (7, 0.9), (2, 0.5)])
def test_transition_matrix_equals_jax(P, self_prob):
    np.testing.assert_array_equal(
        thmm.transition_log_probs(P, self_prob).numpy(),
        np.asarray(jhmm.transition_log_probs(P, self_prob)))


@pytest.mark.parametrize("seed", [0, 1])
def test_viterbi_paths_equal_jax_on_the_same_emissions(seed):
    rng = np.random.default_rng(seed)
    cells, loci, P = 7, 160, 13
    emissions = rng.normal(0, 3, (cells, loci, P)).astype(np.float32)
    # exact ties in some bins: the first maximal state wins in both
    emissions[:, 10:20, 4] = emissions[:, 10:20, 2] = 50.0
    restart = np.zeros(loci, np.float32)
    restart[[0, 40, 41, 100]] = 1.0
    log_trans = np.array(jhmm.transition_log_probs(P, 0.95))
    ref = np.asarray(jhmm.viterbi_paths(jnp.asarray(emissions),
                                        jnp.asarray(restart),
                                        jnp.asarray(log_trans)))
    got = thmm.viterbi_paths(torch.from_numpy(emissions), restart,
                             torch.from_numpy(log_trans))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_hmm_decode_from_the_same_joint_logits():
    rng = np.random.default_rng(2)
    joint = rng.normal(0, 4, (9, 300, 13, 2)).astype(np.float32)
    restart = np.r_[1.0, np.zeros(149), 1.0, np.zeros(149)] \
        .astype(np.float32)
    ref = [np.asarray(a) for a in jhmm.hmm_decode(jnp.asarray(joint),
                                                  jnp.asarray(restart),
                                                  0.99)]
    got = [t.numpy() for t in thmm.hmm_decode(torch.from_numpy(joint),
                                              restart, 0.99)]
    assert (got[0] == ref[0]).mean() >= ALIKE
    assert (got[1] == ref[1]).mean() >= ALIKE
    np.testing.assert_allclose(got[2], ref[2], atol=1e-5)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_decode_discrete_hmm_matches_jax(kind):
    """From the same fitted-state parameters: cn and rep alike on at
    least 99.9 % of bins, p_rep within 1e-4, the entropy planes within
    1e-4; the slabbed decode equals the one-pass decode."""
    inp = _inputs(kind, seed=5)
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
    restart = np.zeros(tbatch.reads.shape[1], np.float32)
    restart[[0, 77, 150]] = 1.0
    ref = [np.asarray(a) for a in jpert.decode_discrete_hmm(
        jspec, {k: jnp.asarray(v) for k, v in params.items()}, jfixed,
        jbatch, jnp.asarray(restart), 0.99, want_entropy=True)]
    tparams = weights.params_from_jax(params, "cpu")
    tfixed = weights.fixed_from_jax(inp["fixed"], "cpu")
    got = [t.numpy() for t in tpert.decode_discrete_hmm(
        tspec, tparams, tfixed, tbatch, restart, 0.99, want_entropy=True)]
    assert (got[0] == ref[0]).mean() >= ALIKE
    assert (got[1] == ref[1]).mean() >= ALIKE
    for a, b in zip(got[2:], ref[2:]):
        np.testing.assert_allclose(a, b, atol=1e-4)
    slabbed = tpert.decode_discrete_hmm(tspec, tparams, tfixed, tbatch,
                                        restart, 0.99, cell_chunk=5)
    for a, b in zip(slabbed, got[:3]):
        np.testing.assert_array_equal(a.numpy(), b)
