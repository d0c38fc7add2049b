"""Model-health QC of the port against the JAX package: the posterior-
entropy planes and their per-cell aggregates, the posterior-predictive
check on JAX's own replicate draws (through the port's ``replicates=``
seam) and the port's sampler on its distribution, and the controller's
rescue gate in each of its four branches.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.config import PertConfig as JaxPertConfig
from scdna_replication_tools_tpu.infer import svi as jsvi
from scdna_replication_tools_tpu.infer.runner import (
    PertInference as JaxPertInference,
)
from scdna_replication_tools_tpu.infer.runner import StepOutput as JaxStep
from scdna_replication_tools_tpu.models import pert as jpert
from scdna_replication_tools_tpu.obs.runlog import RunLog
from scdna_replication_tools_tpu.ops.gc import gc_rate as jgc_rate
from scdna_replication_tools_tpu_torch import weights
from scdna_replication_tools_tpu_torch.config import PertConfig
from scdna_replication_tools_tpu_torch.infer.runner import PertInference
from scdna_replication_tools_tpu_torch.models import pert as tpert
from scdna_replication_tools_tpu_torch.obs.runlog import RunLog as PortRunLog
from scdna_replication_tools_tpu_torch.ops.dists import (
    nb_sample,
    seeded_generator,
)

from conftest import dense_inputs_from_frames
from test_torch_model import _build, _inputs, one_torch_thread  # noqa: F401
from test_torch_rescue import _to_port


def _case(kind, seed):
    inp = _inputs(kind, seed=seed)
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
    return (inp, jspec, tspec, jbatch, tbatch, jfixed, params,
            weights.params_from_jax(params, "cpu"),
            weights.fixed_from_jax(inp["fixed"], "cpu"))


# ---------------------------------------------------------------------------
# posterior entropy
# ---------------------------------------------------------------------------

def test_entropy_from_joint_matches_jax_and_its_corners():
    """On random joint logits (with underflowed states) the two packages'
    normalized entropies agree within 5e-6 (float32 logsumexp over the 26
    states and the p log p sums in other orders; readings up to 1.5e-6,
    ~12 float32 ulps at 0.5); a uniform joint reads 1 and a certain one
    0."""
    rng = np.random.default_rng(3)
    joint = rng.normal(0, 4, (6, 50, 13, 2)).astype(np.float32)
    joint[0, :5, 3:, :] = -np.inf
    ref = jpert.entropy_from_joint(jnp.asarray(joint))
    got = tpert.entropy_from_joint(torch.from_numpy(joint))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-6)
    flat = torch.zeros(2, 3, 13, 2)
    for t in tpert.entropy_from_joint(flat):
        np.testing.assert_allclose(t.numpy(), 1.0, atol=1e-6)
    sure = torch.full((2, 3, 13, 2), -1e4)
    sure[..., 4, 1] = 0.0
    for t in tpert.entropy_from_joint(sure):
        assert float(t.abs().max()) == 0.0


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_decode_with_entropy_matches_jax(kind):
    """decode_discrete(want_entropy=True): the MAP planes as without it
    (bin for bin), the entropy planes within 1e-4 of JAX's (the joint
    logits go through lgamma on both backends, as p_rep in
    test_torch_model); posterior_entropy returns the same planes, and a
    slabbed decode equals the one-pass one."""
    inp, jspec, tspec, jbatch, tbatch, jfixed, params, tp, tf = \
        _case(kind, 11)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref = [np.asarray(a) for a in jpert.decode_discrete(
        jspec, jp, jfixed, jbatch, want_entropy=True)]
    got = tpert.decode_discrete(tspec, tp, tf, tbatch, want_entropy=True)
    assert len(got) == len(ref) == 5
    plain = tpert.decode_discrete(tspec, tp, tf, tbatch)
    for a, b in zip(got[:3], plain):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[0].numpy(), ref[0])
    np.testing.assert_array_equal(got[1].numpy(), ref[1])
    for a, b in zip(got[3:], ref[3:]):
        np.testing.assert_allclose(a.numpy(), b, atol=1e-4)
    pe = tpert.posterior_entropy(tspec, tp, tf, tbatch)
    assert torch.equal(pe[0], got[3]) and torch.equal(pe[1], got[4])
    slabbed = tpert.decode_discrete(tspec, tp, tf, tbatch, cell_chunk=5,
                                    want_entropy=True)
    for a, b in zip(slabbed, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("want_max", [False, True])
def test_entropy_aggregates_match_jax(want_max):
    """Per-cell mean/max entropy and the low-confidence fraction over the
    real loci (a loci mask with masked loci), within 1e-6."""
    rng = np.random.default_rng(4)
    cn = rng.uniform(0, 1, (9, 40)).astype(np.float32)
    rep = rng.uniform(0, 1, (9, 40)).astype(np.float32)
    lmask = (rng.uniform(size=40) < 0.8).astype(np.float32)
    ref = jpert.entropy_aggregates_from_planes(
        jnp.asarray(cn), jnp.asarray(rep), jnp.asarray(lmask), 0.5,
        want_max=want_max)
    got = tpert.entropy_aggregates_from_planes(
        torch.from_numpy(cn), torch.from_numpy(rep), torch.from_numpy(lmask),
        0.5, want_max=want_max)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_cell_entropy_aggregates_match_jax(kind):
    """The rescue gate's standalone aggregates, within 1e-4 (the planes'
    bound)."""
    inp, jspec, tspec, jbatch, tbatch, jfixed, params, tp, tf = \
        _case(kind, 12)
    ref = jpert.cell_entropy_aggregates(
        jspec, {k: jnp.asarray(v) for k, v in params.items()}, jfixed,
        jbatch, entropy_thresh=0.3)
    got = tpert.cell_entropy_aggregates(tspec, tp, tf, tbatch,
                                        entropy_thresh=0.3)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


# ---------------------------------------------------------------------------
# posterior-predictive check
# ---------------------------------------------------------------------------

def _jax_replicates(jspec, params, jfixed, jbatch, cn, rep, seed, R):
    """JAX _ppc_slab's replicate read counts, drawn the way it draws them
    (one slab: fold_in(PRNGKey(seed), 0), split per replicate, gamma on
    the first half of each key, Poisson on the second)."""
    c = jpert.constrained(jspec, params, jfixed)
    lamb = c["lamb"]
    omega = jgc_rate(c["betas"], jbatch.gamma_feats)
    theta = c["u"][:, None] * omega * jnp.asarray(cn, jnp.float32) \
        * (1.0 + jnp.asarray(rep, jnp.float32))
    delta = jnp.maximum(theta * (1.0 - lamb) / lamb, 1.0)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    out = []
    for k in jax.random.split(key, R):
        kg, kp = jax.random.split(k)
        rate = jax.random.gamma(kg, delta) * lamb / (1.0 - lamb)
        out.append(np.asarray(jax.random.poisson(kp, rate), np.float32))
    return np.stack(out)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_ppc_on_jax_replicates_matches_jax(kind):
    """ppc_discrepancy on JAX's own replicate draws (the ``replicates=``
    seam) at the JAX decode's MAP states: observed deviance within 1e-5
    and the z-score within 1e-3 absolute of JAX's (deviances are sums of
    float32 lgamma over 200 loci, ~1e3; z divides their spread by the
    replicate std).  The draws reproduce JAX's z-score to the same bound,
    so the seam carries JAX's replicates.  A slabbed pass agrees with
    the one-pass one within 1e-5 relative (the same float32 sums over
    tensors of other shapes; readings 1.5e-6)."""
    inp, jspec, tspec, jbatch, tbatch, jfixed, params, tp, tf = \
        _case(kind, 13)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    cn, rep, _ = (np.asarray(a) for a in jpert.decode_discrete(
        jspec, jp, jfixed, jbatch))
    R, seed = 8, 5
    ref_dev, ref_z = (np.asarray(a) for a in jpert.ppc_discrepancy(
        jspec, jp, jfixed, jbatch, jax.random.PRNGKey(seed),
        num_replicates=R, maps=(cn, rep)))
    reps = _jax_replicates(jspec, jp, jfixed, jbatch, cn, rep, seed, R)
    dev, z = (a.numpy() for a in tpert.ppc_discrepancy(
        tspec, tp, tf, tbatch, maps=(cn, rep), replicates=reps,
        num_replicates=R))
    np.testing.assert_allclose(dev, ref_dev, rtol=1e-5)
    np.testing.assert_allclose(z, ref_z, atol=1e-3)
    slabbed = tpert.ppc_discrepancy(tspec, tp, tf, tbatch, maps=(cn, rep),
                                    replicates=reps, cell_chunk=5)
    for a, b in zip(slabbed, (dev, z)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-5)


def test_ppc_own_draws_are_seeded():
    """Without the seam the port draws its own replicates, the same for
    the same seed and not for another; z is finite."""
    inp, jspec, tspec, jbatch, tbatch, jfixed, params, tp, tf = \
        _case("dense", 14)
    a = tpert.ppc_discrepancy(tspec, tp, tf, tbatch, seed=3)
    b = tpert.ppc_discrepancy(tspec, tp, tf, tbatch, seed=3)
    c = tpert.ppc_discrepancy(tspec, tp, tf, tbatch, seed=4)
    assert torch.equal(a[1], b[1]) and torch.equal(a[0], c[0])
    assert not torch.equal(a[1], c[1])
    assert bool(torch.isfinite(a[1]).all())


@pytest.mark.parametrize("delta,lamb", [(1.0, 0.75), (30.0, 0.75),
                                        (400.0, 0.5)])
def test_nb_sampler_mean_and_variance(delta, lamb):
    """Gamma-then-Poisson draws of NB(delta, lamb): over 200,000 draws
    the sample mean within 5 standard errors of delta lamb / (1 - lamb)
    and the sample variance within 5 % of delta lamb / (1 - lamb)^2."""
    n = 200_000
    d = torch.full((n,), delta)
    y = nb_sample(d, torch.tensor(lamb), 1,
                  seeded_generator(0, int(delta), "cpu"))[0].double()
    mean = delta * lamb / (1 - lamb)
    var = mean / (1 - lamb)
    assert abs(float(y.mean()) - mean) < 5 * np.sqrt(var / n)
    assert abs(float(y.var()) / var - 1.0) < 0.05


# ---------------------------------------------------------------------------
# the controller's rescue gate
# ---------------------------------------------------------------------------

class _Recorder(RunLog):
    """A disabled JAX RunLog that also keeps every event."""

    def __init__(self):
        super().__init__(None)
        self.events = []

    def emit(self, event, **payload):
        self.events.append((event, payload))
        super().emit(event, **payload)


GATE = {
    # name -> (taus of cells 0 and 1, config overrides, expected action)
    "extreme_tau_in": ((0.005, 0.95), {}, "rescue"),
    "entropy_in": ((0.05, 0.95), dict(qc_entropy_thresh=0.0), "rescue"),
    "skip": ((0.05, 0.95), dict(qc_entropy_thresh=0.9999), "rescue_skip"),
    "qc_off": ((0.05, 0.95), dict(qc=False), "rescue_skip"),
}


@pytest.mark.parametrize("case", sorted(GATE))
def test_rescue_gate_matches_jax(synthetic_frames, case, tmp_path):
    """_gate_rescue on the same step-2 state (two boundary-tau cells,
    every other cell at 0.5): the same action and trigger as JAX's --
    the extreme-tau test gates an extreme candidate in; otherwise, with
    qc, the entropy signal decides (a threshold of 0 marks every bin
    low-confidence, one of 0.9999 none); without qc the gate skips on the
    extreme-tau test alone.  Counts exactly, signals within 1e-4.  The
    port's events are read from the run log open around its runner."""
    taus, overrides, action = GATE[case]
    s, g1, clone_idx = dense_inputs_from_frames(synthetic_frames)
    inp, jspec, tspec, jbatch, tbatch, jfixed, params, _, _ = _case("dense",
                                                                    15)
    tau = np.full(inp["reads"].shape[0], 0.5, np.float32)
    tau[:2] = taus
    params = dict(params, tau_raw=np.log(tau / (1 - tau)).astype(np.float32))
    jfit = jsvi.FitResult(params={k: jnp.asarray(v) for k, v in
                                  params.items()},
                          losses=np.zeros(7, np.float32), num_iters=7,
                          converged=False, nan_abort=False, budget=9)
    jstep = JaxStep(jfit, jspec, jfixed, jbatch, 0.0)
    jlog = _Recorder()
    jinf = JaxPertInference(
        s, g1, JaxPertConfig(compile_cache_dir=None, telemetry_path=None,
                             **overrides),
        clone_idx_s=clone_idx, clone_idx_g1=clone_idx, num_clones=2,
        run_log=jlog)
    jran = jinf._gate_rescue(jstep, jbatch)
    tstep = _to_port(jstep)
    tstep = dataclasses.replace(tstep, fit=dataclasses.replace(
        tstep.fit, budget=9), fixed=weights.fixed_from_jax(inp["fixed"],
                                                            "cpu"))
    tlog = PortRunLog(str(tmp_path / "gate.jsonl"))
    with tlog.session():
        tinf = PertInference(s, g1, PertConfig(**overrides), device="cpu")
        assert tinf.run_log is tlog
        tran = tinf._gate_rescue(tstep, tstep.batch)
    assert tran == jran == (action == "rescue")
    tevents = [json.loads(line) for line in
               (tmp_path / "gate.jsonl").read_text().splitlines()]
    (jd,) = [p for e, p in jlog.events if e == "control_decision"]
    (td,) = [p for p in tevents if p["event"] == "control_decision"]
    assert td["action"] == jd["action"] == action
    for k in ("step", "iter", "budget", "thresholds", "detail"):
        assert td[k] == jd[k], k
    assert set(td["trigger"]) == set(jd["trigger"])
    for k, jv in jd["trigger"].items():
        if isinstance(jv, float):
            assert abs(td["trigger"][k] - jv) <= 1e-4, (k, td["trigger"][k],
                                                        jv)
        else:
            assert td["trigger"][k] == jv, k
    if action == "rescue_skip":
        assert tinf.mirror_rescue_stats == jinf.mirror_rescue_stats
        # a skip leaves the rescue event of a 0-accepted pass
        (jr,) = [p for e, p in jlog.events if e == "rescue"]
        (tr,) = [p for p in tevents if p["event"] == "rescue"]
        assert {k: tr[k] for k in jr} == jr
