"""The device-counter iteration of the port's fit loop against its
host-integer iteration, on the CPU.

``infer/svi._iteration_dev`` is the form a CUDA graph captures: every
index is the device count (the loss slot, the ring's slot, the window of
the convergence test) and the ``min_iter`` test is a device ``where``.
Run eagerly (``_launch_chunk(..., form='device')``) it must give what
the host-integer ``_iteration`` gives, bit for bit, over whole chunks:
both ring forms (a chunk of 25 with the ring every 25, a ragged one with
it every 5, no ring), ``min_iter`` inside and outside a chunk, a fit
that stops inside a chunk (its later iterations masked), and the
controller's chunks through ``fit_map``.  The store's program logic
(bind, replay, snapshot, the ``compile`` events) runs on the CPU with a
stand-in for the CUDA graph that replays its iteration eagerly; the
graphs themselves run in ``tests/test_torch_gpu.py``.  The existing
parity tests hold the trajectory to JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu_torch.config import PertConfig
from scdna_replication_tools_tpu_torch.infer import aotcache
from scdna_replication_tools_tpu_torch.infer import svi
from scdna_replication_tools_tpu_torch.infer.runner import _PertLossFn
from scdna_replication_tools_tpu_torch.models import pert as tpert
from scdna_replication_tools_tpu_torch.obs.controller import ControllerPolicy
from scdna_replication_tools_tpu_torch.ops.adam_kernel import adam_constants
from scdna_replication_tools_tpu_torch.ops.gc import gc_features

from test_torch_model import K, _inputs, one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def float32_default():
    """The objective's leaves are float32 whatever default dtype an
    earlier test in the process left behind."""
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_default_dtype(before)


def _problem(kind, seed=3):
    """(loss function, parameters, loss arguments) of a small step-1,
    dense or sparse objective (12 cells x 200 loci, P = 13), the
    parameters the port's init plus seeded noise."""
    inp = _inputs(kind, seed=seed, prior_scale=1e-3)
    spec = tpert.PertModelSpec(**inp["spec_kw"])
    batch = tpert.PertBatch(
        reads=torch.from_numpy(inp["reads"]),
        libs=torch.from_numpy(inp["libs"]).long(),
        gamma_feats=gc_features(torch.from_numpy(inp["gammas"]), K),
        mask=torch.from_numpy(inp["mask"]),
        **{k: torch.from_numpy(v) for k, v in inp["fields"].items()})
    fixed = {k: torch.as_tensor(v) for k, v in inp["fixed"].items()}
    params = tpert.init_params(spec, batch, fixed,
                               t_init=torch.from_numpy(inp["t_init"]))
    gen = torch.Generator().manual_seed(seed)
    params = {k: v + 0.1 * torch.randn(v.shape, generator=gen,
                                       dtype=v.dtype)
              for k, v in params.items()}
    return _PertLossFn(spec), params, (fixed, batch)


def _loop(max_iter, min_iter, rel_tol, diag_every):
    return svi._Loop(min_iter=min_iter, rel_tol=rel_tol,
                     win=min(9, max_iter), diag_every=diag_every, b1=0.8,
                     b2=0.99, moment_dtype="float32")


def _run_chunks(form, kind, bounds, max_iter, min_iter, rel_tol,
                diag_every):
    loss_fn, params, args = _problem(kind)
    loop = _loop(max_iter, min_iter, rel_tol, diag_every)
    carry = svi._Carry(params, svi.make_opt_state(params),
                       torch.zeros(max_iter),
                       torch.zeros((svi.DIAG_RING, 3)) if diag_every
                       else None)
    const = adam_constants(0.05, 0.8, 0.99, "cpu")
    reads, entry = [], None
    for i0, stop in bounds:
        entry = {k: v.clone() for k, v in carry.params.items()}
        before = {k: v for k, v in carry.params.items()}
        carry, launched = svi._launch_chunk(loss_fn, args, carry, i0, stop,
                                            loop, const, form=form)
        assert launched == stop - i0
        # the chunk's entry state stays as it was
        for k in entry:
            assert torch.equal(before[k], entry[k])
        reads.append(svi._read_chunk(carry, stop))
    return carry, reads


def _tensors(c: svi._Carry) -> list:
    leaves: list = []
    svi._flatten(c, leaves)
    return leaves


CASES = {
    # chunks of 25 with the ring every 25; min_iter inside the 2nd chunk
    "ring25_min_inside": ("dense", [(0, 25), (25, 50)], 50, 30, 1e-6, 25),
    # a ragged start, the ring every 5 (several diagnostic rows a chunk)
    "ring5_ragged": ("sparse", [(0, 7), (7, 19), (19, 31)], 40, 10, 1e-6,
                     5),
    # no ring (HOST_READ_EVERY chunks); min_iter beyond every chunk
    "no_ring_min_outside": ("step1", [(0, 25), (25, 40)], 60, 50, 1e-6, 0),
    # the criterion fires inside the first chunk: the rest is masked
    "stops_inside": ("dense", [(0, 25)], 50, 3, 0.5, 25),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_counter_chunks_equal_host_integer_chunks(case):
    kind, bounds, max_iter, min_iter, rel_tol, diag_every = CASES[case]
    host, host_reads = _run_chunks("host", kind, bounds, max_iter,
                                   min_iter, rel_tol, diag_every)
    dev, dev_reads = _run_chunks("device", kind, bounds, max_iter,
                                 min_iter, rel_tol, diag_every)
    for a, b in zip(_tensors(host), _tensors(dev)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in zip(host_reads, dev_reads):
        assert (a.i, a.converged, a.is_nan) == (b.i, b.converged, b.is_nan)
        np.testing.assert_array_equal(a.losses, b.losses)
        if a.diag is not None:
            np.testing.assert_array_equal(a.diag, b.diag)
    if case == "stops_inside":
        assert host_reads[0].converged and host_reads[0].i < 25
    else:
        assert host_reads[-1].i == bounds[-1][1]


def _controlled_fit(form, monkeypatch, kind="dense", max_iter=150):
    """A controlled fit_map whose chunks run the given iteration form."""
    loss_fn, params, args = _problem(kind)
    orig = svi._launch_chunk

    def launch(*a, **kw):
        return orig(*a, **{**kw, "form": form})
    monkeypatch.setattr(svi, "_launch_chunk", launch)
    cfg = PertConfig(controller_stop_patience=25, controller_extend_step=25)
    try:
        return svi.fit_map(loss_fn, params, args, max_iter=max_iter,
                           min_iter=50, rel_tol=1e-9, device="cpu",
                           diag_every=25, controller=ControllerPolicy
                           .from_config(cfg, max_iter))
    finally:
        monkeypatch.setattr(svi, "_launch_chunk", orig)


def _same_fit(a: svi.FitResult, b: svi.FitResult) -> None:
    np.testing.assert_array_equal(a.losses, b.losses)
    assert (a.num_iters, a.converged, a.nan_abort, a.budget) == \
        (b.num_iters, b.converged, b.nan_abort, b.budget)
    assert a.decisions == b.decisions
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert torch.equal(a.opt_state.count, b.opt_state.count)
    for k in a.opt_state.mu:
        assert torch.equal(a.opt_state.mu[k], b.opt_state.mu[k])
        assert torch.equal(a.opt_state.nu[k], b.opt_state.nu[k])
    for key in ("iter", "loss", "grad_norm", "param_norm"):
        np.testing.assert_array_equal(a.diagnostics[key],
                                      b.diagnostics[key])


def test_controller_chunks_equal_across_iteration_forms(monkeypatch):
    host = _controlled_fit("host", monkeypatch)
    dev = _controlled_fit("device", monkeypatch)
    _same_fit(host, dev)
    assert host.num_iters >= 50


# ---------------------------------------------------------------------------
# the store's program logic with a stand-in for the CUDA graph
# ---------------------------------------------------------------------------

class _EagerProgram(svi._ChunkProgram):
    """A chunk program whose "graph" of a form runs the device-counter
    iteration eagerly on the program's buffers (the CPU has no CUDA
    graph): what the store, bind, replay and snapshot do around a real
    graph is the same."""

    def capture(self, form):
        self.graphs[form] = lambda: svi._iteration_dev(
            self.loss_fn, self.args, self.static, self.loop, self.const,
            form == "diag")
        self.counts[form] = {}
        return 0.0

    def replay(self, form):
        self.graphs[form]()

    def after_last(self):
        pass

    def mark_last(self):
        pass

    def release(self):
        self.graphs.clear()
        self.static = self.args = self.const = None


class EagerPassProgram(svi._PassProgram):
    """A pass program whose "graph" of a form runs the form's stage
    eagerly on the program's buffers (the CPU has no CUDA graph); its
    capture runs the warm-up a real capture runs first."""

    def capture(self, form):
        self._rewind()
        for _ in range(svi.GRAPH_WARMUPS):
            self._step(form)
        self.graphs[form] = form
        self.counts[form] = {}
        return 0.0

    def replay(self, form):
        self._step(form)

    def after_last(self):
        pass

    def mark_last(self):
        pass

    def release(self):
        self.graphs.clear()
        self._drop_buffers()


def use_eager_passes(monkeypatch):
    """Decode and PPC calls on the CPU resolve stand-in programs in the
    current store."""
    def resolve(tag, spec, dev, mesh, static_kwargs):
        scope = aotcache.current_scope()
        return None if scope is None \
            else svi._PassPrograms(scope, tag, spec, static_kwargs)
    monkeypatch.setattr(svi, "resolve_slab_program", resolve)
    monkeypatch.setattr(svi, "_PassProgram", EagerPassProgram)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)


@pytest.fixture
def eager_programs(monkeypatch):
    """Fits on the CPU resolve stand-in programs in the current store."""
    def of(loss_fn, dev, tag, loop):
        scope = aotcache.current_scope()
        return None if scope is None \
            else svi._FitPrograms(scope, tag, loss_fn, loop)
    monkeypatch.setattr(svi._FitPrograms, "of", staticmethod(of))
    monkeypatch.setattr(svi, "_ChunkProgram", _EagerProgram)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)


def test_store_programs_replay_the_eager_fit(eager_programs, monkeypatch,
                                             tmp_path):
    """Under a run scope a controlled fit resolves one program, captures
    each form once (``miss``), replays it for every iteration and equals
    the eager fit bit for bit; a second fit of the same key in the same
    scope finds both forms (``hit``) and also equals its eager twin; the
    scope's end frees the program."""
    eager = _controlled_fit("host", monkeypatch)
    with aotcache.run_scope(str(tmp_path / "store"), "cfg") as scope:
        first = _controlled_fit("host", monkeypatch)
        second = _controlled_fit("host", monkeypatch)
        assert scope.store.program_count() == 1
        assert aotcache.live_program_count() >= 1
    _same_fit(eager, first)
    _same_fit(eager, second)
    assert [(e["label"], e["cache"]) for e in first.programs] == \
        [("chunk:diag", "miss"), ("chunk:plain", "miss")]
    assert [(e["label"], e["cache"]) for e in second.programs] == \
        [("chunk:diag", "hit"), ("chunk:plain", "hit")]
    assert first.timings["captures"] == 2 and \
        first.timings["replays"] == first.timings["dispatched"]
    assert scope.store.closed and scope.store.program_count() == 0
    assert aotcache.current_scope() is None


def test_program_snapshot_does_not_alias_its_buffers(eager_programs,
                                                     tmp_path):
    """A chunk's output carry is a copy: the next chunk's replays never
    write into what the chunk loop kept (the best-loss parameters, a
    checkpoint's tensors)."""
    loss_fn, params, args = _problem("dense")
    loop = _loop(50, 50, 1e-6, 25)
    carry = svi._Carry(params, svi.make_opt_state(params), torch.zeros(50),
                       torch.zeros((svi.DIAG_RING, 3)))
    const = adam_constants(0.05, 0.8, 0.99, "cpu")
    with aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        progs = svi._FitPrograms(scope, "chunk", loss_fn, loop)
        out1, _ = svi._launch_chunk(loss_fn, args, carry, 0, 25, loop, const,
                                    programs=progs)
        kept = {k: v.clone() for k, v in out1.params.items()}
        out2, _ = svi._launch_chunk(loss_fn, args, out1, 25, 50, loop,
                                    const, programs=progs)
        prog = scope.store._programs[progs._digest]
        for k in kept:
            assert torch.equal(out1.params[k], kept[k])
            assert out1.params[k].data_ptr() != \
                prog.static.params[k].data_ptr()
        assert not torch.equal(out2.params["pi_logits"], kept["pi_logits"])
        assert prog.busy == 0


def test_program_rebinds_other_loss_arguments(eager_programs, tmp_path):
    """A program serves another fit of the same shapes: its loss
    arguments are copied into the program's own buffers, so the first
    fit's batch is never written and each fit equals its eager run."""
    kw = dict(max_iter=30, min_iter=30, device="cpu", diag_every=0)
    fits = {}
    for seed in (3, 4):
        loss_fn, params, args = _problem("sparse", seed=seed)
        fits[seed] = (loss_fn, params, args,
                      svi.fit_map(loss_fn, params, args, **kw))
    with aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        got = {}
        for seed in (3, 4):
            loss_fn, params, args, _ = fits[seed]
            reads0 = args[1].reads.clone()
            got[seed] = svi.fit_map(loss_fn, params, args, **kw)
            assert torch.equal(args[1].reads, reads0)
        assert scope.store.program_count() == 1
    for seed in (3, 4):
        _same = fits[seed][3]
        np.testing.assert_array_equal(got[seed].losses, _same.losses)
        for k in _same.params:
            assert torch.equal(got[seed].params[k], _same.params[k])
    assert [e["cache"] for e in got[4].programs] == ["hit"]


def test_concurrent_fits_of_one_program_each_equal_their_eager_run(
        eager_programs, tmp_path):
    """Fits of the same key on several threads at once (a serving
    worker's requests) share one program; its lock lets one chunk at a
    time step the buffers, so each fit equals its eager run bit for bit.
    Eight threads, a short switch interval to interleave them."""
    import sys
    import threading

    kw = dict(max_iter=30, min_iter=30, device="cpu", diag_every=5)
    problems = [_problem("sparse", seed=seed) for seed in range(3, 11)]
    eager = [svi.fit_map(*p, **kw) for p in problems]
    got = [None] * len(problems)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    # the process-wide store, as a serving worker activates it; each
    # thread's run scope shares it
    root = str(tmp_path / "store")
    store = aotcache.activate(root)
    try:
        def fit(k):
            with aotcache.run_scope(root, None):
                got[k] = svi.fit_map(*problems[k], **kw)
        threads = [threading.Thread(target=fit, args=(k,))
                   for k in range(len(problems))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        assert not any(t.is_alive() for t in threads)
        assert store.program_count() == 1
    finally:
        sys.setswitchinterval(interval)
        aotcache.deactivate()
    assert store.closed and store.program_count() == 0
    for a, b in zip(eager, got):
        np.testing.assert_array_equal(a.losses, b.losses)
        for k in a.params:
            assert torch.equal(a.params[k], b.params[k]), k


def test_store_releases_idle_programs_past_its_caps(eager_programs,
                                                    tmp_path):
    """Past ``max_programs`` the least recently used idle program is
    released; one that a chunk is replaying stays."""
    store = aotcache.ExecutableStore(str(tmp_path / "s"), max_programs=1)

    class Prog:
        nbytes = 10
        released = False

        def release(self):
            self.released = True
    a, b = Prog(), Prog()
    assert store.adopt("a", lambda: a) is a
    assert store.adopt("b", lambda: b) is b
    store.trim()
    assert not a.released and not b.released     # both in use
    store.done_with(a)
    store.trim()
    assert a.released and not b.released
    assert store.acquire("a") is None and store.acquire("b") is b
    store.close()
    assert b.released


def test_cpu_fit_under_a_store_says_uncacheable(tmp_path):
    """A fit on the CPU runs the host-integer form under a store and says
    so once; without a store it reports no program at all."""
    loss_fn, params, args = _problem("dense")
    kw = dict(max_iter=10, min_iter=10, device="cpu")
    plain = svi.fit_map(loss_fn, params, args, **kw)
    with aotcache.run_scope(str(tmp_path / "store"), None):
        stored = svi.fit_map(loss_fn, params, args, **kw)
    assert plain.programs == []
    assert [(e["cache"], e["reason"]) for e in stored.programs] == \
        [("uncacheable", "fit on cpu")]
    np.testing.assert_array_equal(plain.losses, stored.losses)


def test_fit_result_programs_default_empty():
    assert svi.FitResult(params={}, losses=np.zeros(0), num_iters=0,
                         converged=False, nan_abort=False).programs == []
    assert "programs" in {f.name for f in dataclasses.fields(svi.FitResult)}
