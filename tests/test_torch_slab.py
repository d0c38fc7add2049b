"""The port's slab program (``infer/svi._run_fit_chunk_slab``) and its
dispatcher seam, against the port's solo chunk and the JAX package.

Part one holds the contract of the JAX ``tests/test_slab.py`` on its toy
quadratic loss: packed lanes equal their solo chunks (JAX allows a packed
lane ~1 ulp per step, and so do these pins: atol 1e-6 on the parameters,
rtol 1e-5 on the losses), a parked lane (``stop == i0``) passes through
bit for bit, ``slab_fill`` refills a lane that then advances from its own
state, and the coordinator packs concurrent dispatches, keeps a singleton
bit-identical with its solo chunk and degrades a slab that fails as a
unit lane by lane.  The port's toy slab is also held to JAX's solo chunk
program (atol 1e-6).

Part two runs one chunk of the real step-2 (dense prior) and step-3
(sparse prior) objective for W = 3 small requests, each with its own
data, parameters, lambda and iteration window, through the port's
``dispatch_chunk_slab`` and JAX's ``_run_fit_chunk_slab`` (the JAX
objective through its plain XLA enumeration, Adam through optax): the
per-iteration losses within 1e-5 of the trajectory's magnitude and the
parameters within 1e-3 of each leaf's scale, the tolerances of
``test_torch_fit.py``'s 30-iteration trajectories at the same 1e-3 prior
scale; a parked lane bit for bit.  Then the batched plain kernels and
the batched autograd (``torch.func.vmap`` through the fused objective's
vmap rule) against per-lane solo calls, bit for bit on the CPU.
"""

import dataclasses
import gc
import threading
import weakref

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
from scdna_replication_tools_tpu_torch.models import pert as tpert
from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
from scdna_replication_tools_tpu_torch.ops.adam_kernel import adam_constants
from scdna_replication_tools_tpu_torch.serve.slab import SlabFitCoordinator

from test_torch_model import _build, _inputs, one_torch_thread  # noqa: F401

MAX_ITER = 32
CONV_WINDOW = 8
N = 4  # toy parameter size
SK = dict(conv_window=CONV_WINDOW, b1=0.8, b2=0.99, diag_every=4)
# every tensor the tests make is float32 by name: an xdist worker may
# have run a test that sets float64 as PyTorch's default
F32 = dict(dtype=torch.float32)


def _toy_loss(params, target):
    return torch.sum((params["x"] - target) ** 2)


def _block(seed):
    """One lane's chunk state from a seed (fresh tensors each call)."""
    rng = np.random.RandomState(seed)
    params = {"x": torch.tensor(rng.randn(N), dtype=torch.float32)}
    target = torch.tensor(rng.randn(N), dtype=torch.float32)
    return (params, tsvi.make_opt_state(params),
            torch.zeros(MAX_ITER, dtype=torch.float32),
            torch.zeros((tsvi.DIAG_RING, 3), dtype=torch.float32), target)


def _loop(min_iter=4):
    return tsvi._Loop(min_iter=min_iter, rel_tol=1e-9, win=CONV_WINDOW,
                      diag_every=SK["diag_every"], b1=0.8, b2=0.99,
                      moment_dtype="float32")


def _solo(seed, i0, stop, min_iter=4):
    params, state, losses, diag, target = _block(seed)
    c, _ = tsvi._launch_chunk(_toy_loss, (target,),
                              tsvi._Carry(params, state, losses, diag), i0,
                              stop, _loop(min_iter),
                              adam_constants(0.05, 0.8, 0.99, "cpu"))
    return c, tsvi._read_chunk(c, stop)


def _slab(seeds, i0s, stops, blocks=None):
    blocks = blocks or [_block(s) for s in seeds]
    return tsvi._run_fit_chunk_slab(
        _toy_loss, tsvi.slab_pack([b[0] for b in blocks]),
        tsvi.slab_pack([b[1] for b in blocks]),
        tsvi.slab_pack([b[2] for b in blocks]),
        tsvi.slab_pack([b[3] for b in blocks]), i0s, stops,
        [4] * len(i0s), [1e-9] * len(i0s), [0.05] * len(i0s),
        tsvi.slab_pack([(b[4],) for b in blocks]), **SK)


def test_slab_lanes_match_solo_chunks_and_jax():
    seeds = (3, 11, 29)
    i_s, params, state, losses, diag, conv, nan, launched = _slab(
        seeds, [0, 0, 0], [16, 16, 16])
    assert launched == 16
    for b, seed in enumerate(seeds):
        c, read = _solo(seed, 0, 16)
        assert int(i_s[b]) == read.i == 16
        assert bool(conv[b]) == read.converged
        assert bool(nan[b]) == read.is_nan
        np.testing.assert_allclose(params["x"][b].numpy(),
                                   c.params["x"].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(losses[b].numpy(), c.losses.numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(diag[b].numpy(), c.diag.numpy(),
                                   rtol=1e-5, atol=1e-6)
        # the JAX chunk program on the same lane
        p0, _, _, _, target = _block(seed)
        jp = {"x": jnp.asarray(p0["x"].numpy())}
        out = jsvi._run_fit_chunk(
            lambda p, t: jnp.sum((p["x"] - t) ** 2), jp,
            jsvi.make_opt_state(jp), jnp.zeros(MAX_ITER, jnp.float32),
            jnp.zeros((jsvi.DIAG_RING, 3), jnp.float32), jnp.asarray(0),
            jnp.asarray(16), jnp.asarray(4), jnp.asarray(1e-9),
            jnp.asarray(0.05), (jnp.asarray(target.numpy()),), **SK)
        np.testing.assert_allclose(params["x"][b].numpy(),
                                   np.asarray(out[1]["x"]), rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(losses[b].numpy(), np.asarray(out[3]),
                                   rtol=1e-5, atol=1e-5)


def test_slab_parks_a_lane_bit_for_bit():
    seeds = (3, 11, 29)
    _, params, state, losses, diag, _, _, _ = _slab(seeds, [0, 5, 0],
                                                    [16, 5, 16])
    p0, s0, l0, d0, _ = _block(11)
    assert torch.equal(params["x"][1], p0["x"])
    assert torch.equal(state.mu["x"][1], s0.mu["x"])
    assert torch.equal(state.nu["x"][1], s0.nu["x"])
    assert int(state.count[1]) == int(s0.count)
    assert torch.equal(losses[1], l0) and torch.equal(diag[1], d0)
    for b, seed in ((0, 3), (2, 29)):
        c, _ = _solo(seed, 0, 16)
        np.testing.assert_allclose(params["x"][b].numpy(),
                                   c.params["x"].numpy(), rtol=0, atol=1e-6)


def test_slab_refill_advances_the_fresh_lane_from_its_own_state():
    blocks = [_block(3), _block(11)]
    i_s, params, state, losses, diag, _, _, _ = _slab(None, [0, 0], [8, 8],
                                                      blocks)
    assert [int(v) for v in i_s] == [8, 8]
    fresh = _block(29)
    params = tsvi.slab_fill(params, 1, fresh[0])
    state = tsvi.slab_fill(state, 1, fresh[1])
    losses = tsvi.slab_fill(losses, 1, fresh[2])
    diag = tsvi.slab_fill(diag, 1, fresh[3])
    targets = tsvi.slab_fill(tsvi.slab_pack([(b[4],) for b in blocks]), 1,
                             (fresh[4],))
    i_s, params2, _, losses2, _, _, _, _ = tsvi._run_fit_chunk_slab(
        _toy_loss, params, state, losses, diag, [8, 0], [16, 8], [4, 4],
        [1e-9, 1e-9], [0.05, 0.05], targets, **SK)
    assert [int(v) for v in i_s] == [16, 8]
    c, _ = _solo(3, 0, 16)
    np.testing.assert_allclose(params2["x"][0].numpy(),
                               c.params["x"].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(losses2[0].numpy(), c.losses.numpy(),
                               rtol=1e-5, atol=1e-5)
    c, _ = _solo(29, 0, 8)
    np.testing.assert_allclose(tsvi.slab_block(params2, 1)["x"].numpy(),
                               c.params["x"].numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(losses2[1].numpy(), c.losses.numpy(),
                               rtol=1e-5, atol=1e-5)


# -- the coordinator --------------------------------------------------------


def _call(seed, i0=0, stop=16):
    params, state, losses, diag, target = _block(seed)
    args = (params, state, losses, diag, i0, stop, 4, 1e-9, 0.05, (target,))

    def solo(a):
        c = tsvi._Carry(a[0], a[1], a[2], a[3])
        c, n = tsvi._launch_chunk(_toy_loss, a[9], c, a[4], a[5], _loop(),
                                  adam_constants(a[8], 0.8, 0.99, "cpu"))
        return c, n, tsvi._read_chunk(c, a[5])
    return tsvi.ChunkCall(loss_fn=_toy_loss, args=args,
                          static_kwargs=dict(SK, moment_dtype="float32"),
                          solo=solo)


def _rendezvous(coord, calls):
    """Every fitter registers before any dispatches, as a worker's lane
    threads do long before their next chunk; each thread is joined with
    a bound."""
    box = {}

    def run(key, call):
        try:
            box[key] = coord.dispatch(call)
        except BaseException as exc:  # noqa: BLE001 — read by the test
            box[key] = exc
    for _ in calls:
        coord.fit_begin()
    threads = [threading.Thread(target=run, args=kv, daemon=True)
               for kv in calls.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    for _ in calls:
        coord.fit_end()
    return box


def test_coordinator_packs_concurrent_dispatches():
    coord = SlabFitCoordinator(2, window_seconds=2.0)
    box = _rendezvous(coord, {s: _call(s) for s in (3, 11)})
    assert coord.packed_dispatches == 1 and coord.packed_lanes == 2
    for seed in (3, 11):
        carry, launched, read = box[seed]
        c, ref = _solo(seed, 0, 16)
        assert launched == 16 and read.i == ref.i == 16
        np.testing.assert_allclose(carry.params["x"].numpy(),
                                   c.params["x"].numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(read.losses, ref.losses, rtol=1e-5,
                                   atol=1e-5)
        assert read.converged == ref.converged
        assert read.is_nan == ref.is_nan


def test_coordinator_singleton_stays_bit_exact():
    coord = SlabFitCoordinator(2, window_seconds=0.05)
    box = _rendezvous(coord, {3: _call(3)})
    assert coord.packed_dispatches == 0 and coord.dispatches == 1
    carry, _, read = box[3]
    c, ref = _solo(3, 0, 16)
    assert torch.equal(carry.params["x"], c.params["x"])
    np.testing.assert_array_equal(read.losses, ref.losses)


def test_coordinator_slab_failure_degrades_lane_by_lane():
    """A slab that fails as a unit (a static the slab program refuses)
    retries every lane alone; only the lane whose own solo fails reports
    an error."""
    coord = SlabFitCoordinator(2, window_seconds=2.0)
    good, bad = _call(3), _call(11)
    for c in (good, bad):
        c.static_kwargs["fused_adam"] = "pallas"

    def poison(a):
        raise RuntimeError("lane poison")
    bad.solo = poison
    box = _rendezvous(coord, {"good": good, "bad": bad})
    assert coord.packed_dispatches == 0
    assert isinstance(box["bad"], RuntimeError)
    assert "lane poison" in str(box["bad"])
    carry, _, _ = box["good"]
    c, _ = _solo(3, 0, 16)
    assert torch.equal(carry.params["x"], c.params["x"])


def test_dispatch_seam_is_thread_local():
    tsvi.set_chunk_dispatcher("marker")
    seen = {}
    t = threading.Thread(
        target=lambda: seen.update(d=tsvi.get_chunk_dispatcher()))
    t.start()
    t.join(timeout=10)
    assert tsvi.get_chunk_dispatcher() == "marker" and seen["d"] is None
    tsvi.set_chunk_dispatcher(None)
    assert tsvi.get_chunk_dispatcher() is None


# -- the real objective: one chunk of W = 3 requests ------------------------


CHUNK = 10
LANES = ((7, 0, CHUNK), (8, 0, CHUNK - 3), (9, 4, 4))  # (seed, i0, stop)


def _lane(kind, seed):
    inp = _inputs(kind, seed=seed, prior_scale=1e-3)
    jspec, tspec, jbatch, tbatch, jfixed, params = _build(inp)
    jspec = type(jspec)(enum_impl="xla", **inp["spec_kw"])
    return dict(jspec=jspec, tspec=tspec, jbatch=jbatch, tbatch=tbatch,
                jfixed=jfixed, tfixed=weights.fixed_from_jax(inp["fixed"],
                                                             "cpu"),
                params=params)


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_slab_chunk_of_the_objective_matches_jax(kind):
    """Step 2 (dense prior) or step 3 (sparse prior): three requests with
    their own data and lambda, lanes 0 and 1 live over different windows
    and lane 2 parked, through the port's dispatch_chunk_slab and the
    JAX slab program."""
    lanes = [_lane(kind, seed) for seed, _, _ in LANES]
    buf = 2 * CHUNK
    calls, jargs = [], []
    for lane, (_, i0, stop) in zip(lanes, LANES):
        tp = weights.params_from_jax(lane["params"], "cpu")
        state = tsvi.make_opt_state(tp)
        args = (tp, state, torch.zeros(buf, **F32),
                torch.zeros((tsvi.DIAG_RING, 3), **F32), i0, stop, 4, 1e-9,
                0.05, (lane["tfixed"], lane["tbatch"]))
        calls.append(tsvi.ChunkCall(
            loss_fn=_TorchLossFn(lanes[0]["tspec"]), args=args,
            static_kwargs=dict(conv_window=9, b1=0.8, b2=0.99, diag_every=5,
                               moment_dtype="float32"), solo=None))
        jp = {k: jnp.asarray(v) for k, v in lane["params"].items()}
        jargs.append((jp, jsvi.make_opt_state(jp),
                      jnp.zeros(buf, jnp.float32),
                      jnp.zeros((jsvi.DIAG_RING, 3), jnp.float32),
                      (lane["jfixed"], lane["jbatch"])))
    assert len({c.signature() for c in calls}) == 1
    outs = tsvi.dispatch_chunk_slab(calls, width=4)
    jout = jsvi._run_fit_chunk_slab(
        _PertLossFn(spec=lanes[0]["jspec"]),
        jsvi.slab_pack([a[0] for a in jargs]),
        jsvi.slab_pack([a[1] for a in jargs]),
        jsvi.slab_pack([a[2] for a in jargs]),
        jsvi.slab_pack([a[3] for a in jargs]), [i for _, i, _ in LANES],
        [s for _, _, s in LANES], [4] * 3, [1e-9] * 3, [0.05] * 3,
        jsvi.slab_pack([a[4] for a in jargs]), conv_window=9, b1=0.8,
        b2=0.99, diag_every=5)
    j_i, j_params, _, j_losses = jout[:4]
    for b, ((carry, launched, read), (_, i0, stop)) in enumerate(
            zip(outs, LANES)):
        assert read.i == int(j_i[b]) == stop
        assert launched == stop - i0
        jl = np.asarray(j_losses[b][:stop], np.float64)
        if stop > i0:
            rel = np.abs(read.losses[i0:stop] - jl[i0:]).max() \
                / np.abs(jl[i0:]).max()
            assert rel < 1e-5, (b, rel)
            assert read.losses[stop - 1] < read.losses[i0]
        for k, v in carry.params.items():
            ref = np.asarray(j_params[k][b])
            if stop == i0:
                # parked: the lane's own parameters, bit for bit
                assert torch.equal(v, calls[b].args[0][k]), k
                continue
            err = np.max(np.abs(v.numpy() - ref))
            assert err < 1e-3 * max(1.0, np.max(np.abs(ref))), (b, k, err)
    parked = outs[2][0]
    assert torch.equal(parked.losses, calls[2].args[2])
    assert torch.equal(parked.state.mu["pi_logits"],
                       calls[2].args[1].mu["pi_logits"])


@pytest.mark.parametrize("sparse", [False, True])
def test_batched_plain_kernels_and_autograd_equal_solo_calls(sparse):
    """On the CPU the batched wrappers take the batched plain versions,
    each lane a solo plain call bit for bit, and vmap of the fused
    objective (the rule's batched autograd) gives each lane the solo
    value and gradients bit for bit."""
    W = 3
    g = torch.Generator().manual_seed(5)
    f32 = dict(dtype=torch.float32)
    reads = torch.randint(0, 60, (W, 6, 40), generator=g).float()
    mu = 1 + 20 * torch.rand(W, 6, 40, generator=g, **f32)
    pi = torch.randn(W, 13, 6, 40, generator=g, **f32)
    phi = 0.05 + 0.9 * torch.rand(W, 6, 40, generator=g, **f32)
    etas = 1 + 3 * torch.rand(W, 13, 6, 40, generator=g, **f32)
    eidx = torch.randint(0, 13, (W, 6, 40), generator=g).float()
    ew = 1e3 * torch.rand(W, 6, 40, generator=g, **f32)
    lamb = torch.tensor([0.6, 0.7, 0.8], **f32)
    scal = torch.stack([ek.scalars(x) for x in lamb])
    prior = dict(eta_idx=eidx, eta_w=ew) if sparse else dict(etas_t=etas)
    out, lse = ek.fused_fwd(reads, mu, pi, phi, scal, **prior)
    grads = ek.fused_bwd(reads, mu, pi, phi, scal, lse,
                                 torch.ones_like(out), **prior)
    for b in range(W):
        lp = {k: v[b] for k, v in prior.items()}
        o, s = ek.fused_fwd(reads[b], mu[b], pi[b], phi[b], scal[b], **lp)
        d = ek.fused_bwd(reads[b], mu[b], pi[b], phi[b], scal[b], s,
                         torch.ones_like(o), **lp)
        assert torch.equal(out[b], o) and torch.equal(lse[b], s)
        for a, c in zip(grads, d):
            assert torch.equal(a[b], c)

    def obj(m, p, f, r, pr, lam):
        if sparse:
            return ek.enum_loglik_fused_sparse(r, m, p, f, pr[0], pr[1], lam)
        return ek.enum_loglik_fused(r, m, p, f, pr[0], lam)
    pr = (eidx, ew) if sparse else (etas,)
    leaves = [t.clone().requires_grad_(True) for t in (mu, pi, phi)]
    val = torch.func.vmap(obj)(*leaves, reads, pr, lamb)
    gr = torch.autograd.grad((val * 1.5).sum(), leaves)
    for b in range(W):
        solo = [t[b].clone().requires_grad_(True) for t in (mu, pi, phi)]
        v = obj(*solo, reads[b], tuple(x[b] for x in pr), lamb[b])
        gs = torch.autograd.grad((v * 1.5).sum(), solo)
        assert torch.equal(val[b], v)
        for a, c in zip(gr, gs):
            assert torch.equal(a[b], c)


def test_binary_block_axis_is_refused_by_name():
    """The batched binary form is not ported (ROADMAP B1): vmap of the
    binary objective says so."""
    f32 = dict(dtype=torch.float32)
    zb = torch.randn(2, 4, 3, 5, **f32)
    r, m, f = torch.ones(2, 3, 5, **f32), torch.ones(2, 3, 5, **f32), \
        torch.full((2, 3, 5), 0.5, **f32)
    with pytest.raises(NotImplementedError, match="B1"):
        torch.func.vmap(lambda a, b, c, d: ek.enum_loglik_fused_binary(
            a, b, c, d, torch.ones(13, 3, 5, **f32),
            torch.tensor(0.7, **f32), 13))(r, m, zb, f)


def test_a_chunk_leaves_its_entry_state_untouched():
    """A chunk steps its later iterations in place, on planes it made
    itself: the entry carry, which the controlled loop keeps for its
    best-loss checkpoint and emergency save, is left as it was, and the
    result equals stepping into new tensors every iteration."""
    lane = _lane("dense", 7)
    tp = weights.params_from_jax(lane["params"], "cpu")
    state = tsvi.make_opt_state(tp)
    before = {k: v.clone() for k, v in tp.items()}
    m_before = {k: v.clone() for k, v in state.mu.items()}
    loop = tsvi._Loop(min_iter=4, rel_tol=1e-9, win=9, diag_every=5,
                      b1=0.8, b2=0.99, moment_dtype="float32")
    const = adam_constants(0.05, 0.8, 0.99, "cpu")
    args = (lane["tfixed"], lane["tbatch"])
    c, n = tsvi._launch_chunk(_TorchLossFn(lane["tspec"]), args,
                              tsvi._Carry(tp, state, torch.zeros(20, **F32),
                                          torch.zeros((tsvi.DIAG_RING, 3),
                                                      **F32)),
                              0, 8, loop, const)
    assert n == 8
    for k in tp:
        assert torch.equal(tp[k], before[k]) and torch.equal(
            state.mu[k], m_before[k]), k
    # the same iterations, each into new tensors
    ref = tsvi._Carry(before, tsvi.make_opt_state(before),
                      torch.zeros(20, **F32),
                      torch.zeros((tsvi.DIAG_RING, 3), **F32))
    flag = dict(dtype=torch.bool)
    ref = tsvi._Carry(ref.params, ref.state, ref.losses, ref.diag,
                      i=torch.zeros((), dtype=torch.int32),
                      done=torch.zeros((), **flag),
                      converged=torch.zeros((), **flag),
                      is_nan=torch.zeros((), **flag))
    for it in range(8):
        ref = tsvi._iteration(_TorchLossFn(lane["tspec"]), args, ref, it,
                              loop, const)
    for k in tp:
        assert torch.equal(c.params[k], ref.params[k]), k
        assert torch.equal(c.state.nu[k], ref.state.nu[k]), k
    assert torch.equal(c.losses, ref.losses)


class _Ledger:
    def __init__(self):
        self.booked = []

    def book_chunk(self, **kw):
        self.booked.append(kw)


@pytest.mark.parametrize("lanes", [1, 2], ids=["solo", "packed"])
def test_coordinator_frees_a_chunks_entry_state_without_a_collection(lanes):
    """A dispatched chunk's entry state (its call's tensors) is freed as
    soon as its last user drops it, with the garbage collector off: the
    cost-booking thunks hold host values, not the pending entries (a
    cycle through them pinned each chunk's entry state, and each slab's
    stacked state, until a full collection; four flagship lanes ran the
    card out of memory that way, where a serial run never did)."""
    coord = SlabFitCoordinator(2, window_seconds=5.0)
    ledger = _Ledger()
    calls = {k: dataclasses.replace(_call(3 + k), meter=(ledger, {}))
             for k in range(lanes)}
    refs = [weakref.ref(c.args[0]["x"]) for c in calls.values()]
    gc.collect()
    gc.disable()
    try:
        box = _rendezvous(coord, calls)
        assert not any(isinstance(v, BaseException) for v in box.values())
        assert len(ledger.booked) == lanes
        assert coord.packed_dispatches == (1 if lanes == 2 else 0)
        del calls, box
        assert [r() is None for r in refs] == [True] * lanes
    finally:
        gc.enable()
