"""The serving slab's CUDA-graph form, the store's program records and the
serving worker's warm-up, on the CPU.

* The device-counter slab iteration (``infer/svi._slab_iteration_dev``,
  what a slab program's graphs capture: every lane fact read from a
  static table at a device-held iteration index) run eagerly by
  ``_device_slab`` here equals the eager slab bit for bit: staggered lanes, a parked lane, a lane that converges and
  one that turns NaN inside the chunk, the ring on and off; and JAX's
  ``_run_fit_chunk_slab`` on ``test_torch_slab.py``'s toy slab within
  that file's tolerance.
* The store's slab programs (``dispatch_chunk_slab`` under a run scope)
  with a stand-in for the CUDA graph that replays its iteration eagerly:
  bit for bit the eager dispatch, one program per key (the same
  signature twice: one digest; W = 2 and W = 4: two), each form captured
  once, the lanes' ``compile`` events ``slab{W}:<form>``.
* Program records: written at a capture, read back and rebuilt
  (``svi.precapture``) under the digest the original fit computed, a
  fit after the rebuild finding only ``hit``s and equal to its eager
  run; a truncated record quarantined; the directory's LRU cap over
  both kinds of record.
* The worker's warm-up ranking (``serve/worker.rank_warmup_entries``)
  chooses the records JAX's ``ServeWorker._warmup_executables`` chooses,
  in its order, with the previous worker's ``buckets_served`` ledger and
  without one.

The graphs themselves run in ``tests/test_torch_gpu.py``.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.infer import svi as jsvi
from scdna_replication_tools_tpu_torch.infer import aotcache, svi
from scdna_replication_tools_tpu_torch.serve import worker as tworker
from scdna_replication_tools_tpu_torch.serve.queue import SpoolQueue

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_slab import MAX_ITER, SK, _block, _toy_loss
from test_torch_svi_graphable import (
    _EagerProgram,
    _problem,
    use_eager_passes,
)


@pytest.fixture(autouse=True)
def float32_default():
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_default_dtype(before)


def _nan_toy(params, target):
    """The toy loss, NaN once x[0] < 0 (its gradient 0 until then)."""
    x = params["x"]
    return torch.sum((x - target) ** 2) + 0.0 * torch.log(x[0])


def _lanes(seeds, cross=()):
    """The toy blocks of ``seeds``; a lane in ``cross`` starts at x[0] =
    0.2 with target[0] = -1, so its loss turns NaN a few steps in."""
    out = []
    for b, seed in enumerate(seeds):
        params, state, losses, diag, target = _block(seed)
        params["x"][0] = 0.2 if b in cross else 1.0
        target[0] = -1.0 if b in cross else 2.0
        out.append((params, state, losses, diag, target))
    return out


# (i0s, stops, min_iters, rel_tols, NaN lanes, ring)
CASES = {
    "staggered": ([0, 3, 8], [24, 20, 32], [4, 4, 4], [1e-9] * 3, (), True),
    "parked": ([0, 5, 0], [16, 5, 16], [4, 4, 4], [1e-9] * 3, (), True),
    "converges": ([0, 0, 2], [32, 32, 30], [4, 4, 4], [1e-9, 0.5, 1e-9],
                  (), True),
    "nan": ([0, 0, 0], [24, 24, 24], [4, 4, 4], [1e-9] * 3, (1,), True),
    "no_ring": ([0, 3, 3], [16, 16, 3], [4, 4, 4], [1e-9, 0.5, 1e-9], (0,),
                False),
}


def _device_slab(loss_fn, params0, opt_state0, losses0, diag0, i0, stop,
                 min_iter, rel_tol, lr, loss_args, conv_window, b1, b2,
                 diag_every, moment_dtype="float32"):
    """``svi._run_fit_chunk_slab``'s arguments and results, computed by
    the device-counter iteration that the slab program's graphs capture
    (``svi._slab_iteration_dev``), run eagerly on copies of the stacked
    state: the lane table zero-padded past the chunk as the program's
    static table is, one iteration per column in its form."""
    K = max(max(s - i for i, s in zip(i0, stop)), 0)
    tab, _ = svi._lane_table(i0, stop, min_iter, conv_window,
                             losses0.shape[1], diag_every,
                             torch.device("cpu"))
    full = np.zeros((6, K + 1, len(i0)), np.int64)
    full[:, :K] = tab
    s = svi._slab_state(svi._clone_tree(params0), svi._clone_tree(opt_state0),
                        losses0.clone(),
                        None if diag0 is None else diag0.clone(), i0, stop,
                        rel_tol, lr, b1, b2, torch.from_numpy(full))
    keys = list(params0)
    arg_leaves: list = []
    batched = svi._slab_loss(loss_fn, keys,
                             svi._flatten(tuple(loss_args), arg_leaves))
    for form in svi._slab_forms(tab, diag0 is not None):
        svi._slab_iteration_dev(batched, keys, arg_leaves, s, form,
                                conv_window, b1, b2, moment_dtype)
    return (s.i, s.params, s.state, s.losses, s.diag, s.converged, s.is_nan,
            K)


def _slab(blocks, case, form):
    i0s, stops, mins, tols, _, ring = case
    sk = dict(SK) if ring else dict(SK, diag_every=0)
    run = _device_slab if form == "device" else svi._run_fit_chunk_slab
    return run(
        _nan_toy, svi.slab_pack([b[0] for b in blocks]),
        svi.slab_pack([b[1] for b in blocks]),
        svi.slab_pack([b[2] for b in blocks]),
        svi.slab_pack([b[3] for b in blocks]) if ring else None, i0s, stops,
        mins, tols, [0.05, 0.04, 0.05], svi.slab_pack([(b[4],)
                                                       for b in blocks]),
        **sk)


def _leaves(tree):
    out: list = []
    svi._flatten(tree, out)
    return out


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (a NaN is equal to itself)."""
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.numpy().tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("name", sorted(CASES))
def test_device_counter_slab_equals_the_eager_slab(name):
    case = CASES[name]
    seeds = (3, 11, 29)
    host = _slab(_lanes(seeds, case[4]), case, "host")
    dev = _slab(_lanes(seeds, case[4]), case, "device")
    assert host[7] == dev[7]
    for a, b in zip(_leaves(host[:7]), _leaves(dev[:7])):
        assert _same(a, b), name
    i_s, conv, nan = host[0], host[5], host[6]
    if name == "converges":
        assert bool(conv[1]) and int(i_s[1]) < 32 and not bool(conv[0])
    if name == "nan":
        assert bool(nan[1]) and 0 < int(i_s[1]) < 24 and not bool(nan[0])
    if name == "parked":
        blocks = _lanes(seeds)
        assert torch.equal(host[1]["x"][1], blocks[1][0]["x"])
        assert torch.equal(host[3][1], blocks[1][2])


def test_device_counter_slab_matches_jax_on_the_toy_slab():
    """``test_torch_slab.test_slab_lanes_match_solo_chunks_and_jax``'s
    lanes (its tolerances: atol 1e-6 on the parameters, rtol 1e-5 on
    the losses and the ring) through the device-counter form and JAX's
    slab program."""
    seeds, i0s, stops = (3, 11, 29), [0, 2, 0], [16, 16, 9]
    blocks = [_block(s) for s in seeds]
    out = _device_slab(
        _toy_loss, svi.slab_pack([b[0] for b in blocks]),
        svi.slab_pack([b[1] for b in blocks]),
        svi.slab_pack([b[2] for b in blocks]),
        svi.slab_pack([b[3] for b in blocks]), i0s, stops, [4] * 3,
        [1e-9] * 3, [0.05] * 3, svi.slab_pack([(b[4],) for b in blocks]),
        **SK)
    jp = [{"x": jnp.asarray(b[0]["x"].numpy())} for b in blocks]
    ref = jsvi._run_fit_chunk_slab(
        lambda p, t: jnp.sum((p["x"] - t) ** 2), jsvi.slab_pack(jp),
        jsvi.slab_pack([jsvi.make_opt_state(p) for p in jp]),
        jnp.zeros((3, MAX_ITER), jnp.float32),
        jnp.zeros((3, svi.DIAG_RING, 3), jnp.float32), jnp.asarray(i0s),
        jnp.asarray(stops), jnp.asarray([4] * 3), jnp.asarray([1e-9] * 3),
        jnp.asarray([0.05] * 3),
        (jnp.asarray(np.stack([b[4].numpy() for b in blocks])),), **SK)
    np.testing.assert_array_equal(out[0].numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(out[1]["x"].numpy(), np.asarray(ref[1]["x"]),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out[3].numpy(), np.asarray(ref[3]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[4].numpy(), np.asarray(ref[4]),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# the store's slab programs, with a stand-in graph
# ---------------------------------------------------------------------------

class _EagerSlabProgram(svi._SlabProgram):
    """A slab program whose "graph" of a form runs the device-counter
    slab iteration eagerly on the program's buffers; its capture runs
    the warm-up iterations a real capture runs on the buffers first."""

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


@pytest.fixture
def eager_programs(monkeypatch):
    """Solo fits, packed dispatches and the decode and PPC passes on the
    CPU resolve stand-in programs in the current store."""
    def of(loss_fn, dev, tag, loop):
        scope = aotcache.current_scope()
        return None if scope is None \
            else svi._FitPrograms(scope, tag, loss_fn, loop)
    monkeypatch.setattr(svi._FitPrograms, "of", staticmethod(of))
    monkeypatch.setattr(svi, "_ChunkProgram", _EagerProgram)
    monkeypatch.setattr(svi, "_SlabProgram", _EagerSlabProgram)
    monkeypatch.setattr(svi, "_slab_scope",
                        lambda loss_fn, dev: aotcache.current_scope())
    use_eager_passes(monkeypatch)


def _calls(kind, seeds, windows, rel_tol=1e-9, min_iter=4):
    """ChunkCalls of the real objective (``_problem``: 12 cells x 200
    loci), one lane per seed with its (i0, stop) window, each with a
    fit's store view when a scope is current."""
    calls = []
    loop = svi._Loop(min_iter=min_iter, rel_tol=rel_tol, win=9,
                     diag_every=5, b1=0.8, b2=0.99, moment_dtype="float32")
    scope = aotcache.current_scope()
    for seed, (i0, stop) in zip(seeds, windows):
        loss_fn, params, args = _problem(kind, seed=seed)
        state = svi.make_opt_state(params)
        args_c = (params, state, torch.zeros(40),
                  torch.zeros((svi.DIAG_RING, 3)), i0, stop, min_iter,
                  rel_tol, 0.05, args)
        calls.append(svi.ChunkCall(
            loss_fn=loss_fn, args=args_c,
            static_kwargs=dict(conv_window=9, b1=0.8, b2=0.99,
                               diag_every=5, moment_dtype="float32"),
            solo=None, programs=None if scope is None
            else svi._FitPrograms(scope, "chunk", loss_fn, loop)))
    return calls


def _outs(outs):
    return [t for o in outs for t in _leaves((o[0].params, o[0].state,
                                              o[0].losses, o[0].diag))] \
        + [o[1] for o in outs]


def test_slab_programs_replay_the_eager_dispatch(eager_programs, tmp_path):
    """Packed dispatches under a store equal the eager dispatches bit for
    bit (their reads too); the same key twice is one program (its forms
    ``hit`` the second time), W = 2 and W = 4 two programs; each lane's
    fit gets one ``slab{W}:<form>`` event per program and form, and its
    replays; the dispatch's timings name the program."""
    windows3 = [(0, 10), (0, 7), (4, 4)]
    eager = svi.dispatch_chunk_slab(_calls("dense", (3, 4, 5), windows3), 4)
    eager2 = svi.dispatch_chunk_slab(_calls("dense", (3, 4), windows3[:2]),
                                     2)
    with aotcache.run_scope(str(tmp_path / "store"), "cfg") as scope:
        t1, t2, t3 = {}, {}, {}
        calls = _calls("dense", (3, 4, 5), windows3)
        got = svi.dispatch_chunk_slab(calls, 4, t1)
        again = svi.dispatch_chunk_slab(_calls("dense", (3, 4, 5), windows3),
                                        4, t2)
        got2 = svi.dispatch_chunk_slab(_calls("dense", (3, 4), windows3[:2]),
                                       2, t3)
        assert scope.store.program_count() == 2
        assert t1["program"] == t2["program"] != t3["program"]
        assert set(t1["forms"].values()) == {"miss"}
        assert set(t2["forms"].values()) == {"hit"}
        assert t1["replays"] == t1["launched"] == 10
        events = calls[0].programs.events
        assert {e["label"] for e in events} == {
            f"slab4:{f}" for f in t1["forms"]}
        assert all(e["cache"] == "miss" and e["tag"] == "slab4"
                   for e in events)
        assert calls[1].programs.replays == 7
        assert calls[2].programs.replays == 0
    for a, b in ((eager, got), (eager, again), (eager2, got2)):
        for x, y in zip(_outs(a), _outs(b)):
            if isinstance(x, torch.Tensor):
                assert _same(x, y)
            else:
                assert x == y
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x[2].losses, y[2].losses)
            np.testing.assert_array_equal(x[2].diag, y[2].diag)
            assert (x[2].i, x[2].converged) == (y[2].i, y[2].converged)


def test_a_form_captured_after_a_full_chunk_stays_in_the_table(
        eager_programs, tmp_path):
    """A dispatch that replays its program's every column (a full chunk)
    leaves the device-held slab iteration at the end of the table; a
    later dispatch that needs a form not captured yet (the convergence
    test, once the lanes pass min_iter) warms it up from the first
    column, and equals its eager dispatch."""
    windows = [[(0, 10), (0, 10)], [(10, 20), (10, 20)]]
    with aotcache.run_scope(str(tmp_path / "store"), None):
        t1, t2 = {}, {}
        svi.dispatch_chunk_slab(_calls("dense", (3, 4), windows[0],
                                       min_iter=12), 2, t1)
        got = svi.dispatch_chunk_slab(_calls("dense", (3, 4), windows[1],
                                             min_iter=12), 2, t2)
    assert t1["program"] == t2["program"]
    assert "conv" not in t1["forms"] and t2["forms"]["conv"] == "miss"
    eager = svi.dispatch_chunk_slab(_calls("dense", (3, 4), windows[1],
                                           min_iter=12), 2)
    for x, y in zip(_outs(eager), _outs(got)):
        assert _same(x, y) if isinstance(x, torch.Tensor) else x == y


def test_slab_outputs_do_not_alias_the_program(eager_programs, tmp_path):
    """A lane's output carry outlives the next replay of its program."""
    with aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        out = svi.dispatch_chunk_slab(_calls("sparse", (3, 4),
                                             [(0, 10), (0, 10)]), 2)
        kept = out[0][0].params["pi_logits"].clone()
        svi.dispatch_chunk_slab(_calls("sparse", (5, 6),
                                       [(0, 10), (0, 10)]), 2)
        assert torch.equal(out[0][0].params["pi_logits"], kept)
        prog = next(iter(scope.store._programs.values()))
        assert out[0][0].params["pi_logits"].data_ptr() \
            != prog.static.params["pi_logits"].data_ptr()


# ---------------------------------------------------------------------------
# program records
# ---------------------------------------------------------------------------

def _fit(kind, seed, **kw):
    loss_fn, params, args = _problem(kind, seed=seed)
    return svi.fit_map(loss_fn, params, args, max_iter=20, min_iter=20,
                       device="cpu", diag_every=5, **kw)


def _program_entries(store):
    return [e for e in store.entries() if e["meta"].get("kind") == "program"]


def test_records_rebuild_programs_that_a_fit_then_hits(eager_programs,
                                                       tmp_path):
    """A fit's capture writes its program's record (the digest, the tag,
    the forms, the shapes); a store on the same directory in a fresh
    scope rebuilds the program from it (``precapture``: the rebuilt key
    must give the recorded digest) and a fit of the same key then finds
    every form (``hit``) and equals its eager run; a slab program's
    record rebuilds as well."""
    root = str(tmp_path / "store")
    eager = _fit("dense", 3)
    with aotcache.run_scope(root, "cfg"):
        first = _fit("dense", 3)
        calls = _calls("dense", (3, 4), [(0, 10), (0, 10)])
        svi.dispatch_chunk_slab(calls, 2)
    digests = {e["meta"]["tag"]: e["digest"] for e in
               _program_entries(aotcache.ExecutableStore(root))}
    assert set(digests) == {"fit", "slab2"}
    assert {e["cache"] for e in first.programs} == {"miss"}
    store = aotcache.activate(root)
    try:
        rebuilt = {tag: svi.precapture(store, d, "cpu")
                   for tag, d in digests.items()}
        assert store.program_count() == 2
        assert rebuilt["fit"]["forms"] == ["diag", "plain"]
        assert sorted(rebuilt["fit"]["key_hashes"]) == sorted(
            e["key_hash"] for e in first.programs)
        with aotcache.run_scope(root, "cfg"):
            second = _fit("dense", 3)
            calls = _calls("dense", (3, 4), [(0, 10), (0, 10)])
            t = {}
            svi.dispatch_chunk_slab(calls, 2, t)
        assert {e["cache"] for e in second.programs} == {"hit"}
        assert set(t["forms"].values()) == {"hit"}
        assert t["program"] == digests["slab2"]
        assert sorted(e["key_hash"] for e in calls[0].programs.events) \
            == sorted(rebuilt["slab2"]["key_hashes"])
    finally:
        aotcache.deactivate()
    np.testing.assert_array_equal(eager.losses, second.losses)
    for k in eager.params:
        assert torch.equal(eager.params[k], second.params[k])


def test_truncated_record_is_quarantined(eager_programs, tmp_path):
    root = str(tmp_path / "store")
    with aotcache.run_scope(root, None):
        _fit("sparse", 3)
    store = aotcache.ExecutableStore(root)
    (entry,) = _program_entries(store)
    path = store.path(entry["digest"])
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(blob[:len(blob) // 2])
    with pytest.raises(LookupError):
        svi.precapture(store, entry["digest"], "cpu")
    assert os.path.exists(path + ".bad") and not os.path.exists(path)
    assert _program_entries(store) == []


def test_record_of_another_key_is_refused_and_quarantined(eager_programs,
                                                         tmp_path):
    """A record whose key does not rebuild to its digest (renamed to
    another digest) raises and is quarantined."""
    root = str(tmp_path / "store")
    with aotcache.run_scope(root, None):
        _fit("sparse", 3)
    store = aotcache.ExecutableStore(root)
    (entry,) = _program_entries(store)
    other = "0" * 32
    os.replace(store.path(entry["digest"]), store.path(other))
    with pytest.raises(ValueError, match="rebuild its key"):
        svi.precapture(store, other, "cpu")
    assert os.path.exists(store.path(other) + ".bad")


def test_directory_cap_evicts_program_and_library_records(eager_programs,
                                                          tmp_path):
    """Program records share the library records' LRU cap."""
    root = str(tmp_path / "store")
    store = aotcache.ExecutableStore(root, max_entries=2)
    store.save("lib", "kernel_library:x", b"so")
    os.utime(store.path("lib"), (1, 1))
    with aotcache.run_scope(root, None):
        _fit("sparse", 3)
        _fit("dense", 3)
    assert len(os.listdir(root)) == 3
    store._evict()
    names = sorted(os.listdir(root))
    assert len(names) == 2 and "lib.pertexec" not in names
    assert len(_program_entries(store)) == 2


# ---------------------------------------------------------------------------
# the warm-up's ranking, against JAX's
# ---------------------------------------------------------------------------

class _StubStore:
    """The store surface a warm-up reads: ``entries()`` and ``preload``
    (each preload recorded)."""

    def __init__(self, entries):
        self._entries = entries
        self.chosen: list = []
        self.max_program_bytes = None

    def entries(self):
        return [dict(e) for e in self._entries]

    def preload(self, digest):
        self.chosen.append(digest)
        return True

    def program_bytes(self):
        return 0


def _entries():
    """Records of three buckets' shapes (programs and slab programs: a
    leading W), a kernel library without shapes, with mtimes that tie
    within a bucket's traffic and differ across."""
    shapes = {"c1024xl8192": [[13, 1024, 8192], [4, 13, 1024, 8192]],
              "c256xl2048": [[256, 2048], [2, 256, 2048]],
              "c512xl4096": [[512, 4096]]}
    out = []
    for k, (bucket, shp) in enumerate(sorted(shapes.items())):
        for j, s in enumerate(shp):
            out.append({"digest": f"{bucket}-{j}", "mtime": 100.0 + 3 * k + j,
                        "meta": {"shapes": [s, [5]]}})
    out.append({"digest": "library", "mtime": 500.0, "meta": {}})
    return out


@pytest.mark.parametrize("ledger", [
    {"c1024xl8192": 3, "c256xl2048": 5},
    {"c512xl4096": 1, "c256xl2048": 1, "c1024xl8192": 1},
    {"c64xl64": 2},
    None], ids=["traffic", "ties", "unseen", "no_ledger"])
def test_warmup_chooses_jax_records_in_jax_order(tmp_path, monkeypatch,
                                                 ledger):
    from scdna_replication_tools_tpu.infer import aotcache as jaot
    from scdna_replication_tools_tpu.serve import worker as jworker
    from scdna_replication_tools_tpu.serve.queue import (
        SpoolQueue as JSpoolQueue,
    )

    chosen = {}
    for arm in ("jax", "torch"):
        root = tmp_path / arm
        queue = (JSpoolQueue if arm == "jax" else SpoolQueue)(root)
        queue.ensure_dirs()
        if ledger is not None:
            queue.status_path.write_text(json.dumps(
                {"kind": "pert_serve_status", "buckets_served": ledger}))
        store = _StubStore(_entries())
        if arm == "jax":
            monkeypatch.setattr(jaot, "activate", lambda root: store)
            w = jworker.ServeWorker(queue,
                                    executable_cache_dir=str(root / "x"))
        else:
            w = tworker.ServeWorker(queue, device="cpu",
                                    executable_cache_dir=str(root / "x"))
            w._store = store
        w._warmup_executables()
        chosen[arm] = store.chosen
    assert chosen["torch"] == chosen["jax"]
    # a ledger of buckets no record serves leaves nothing to warm
    assert bool(chosen["torch"]) == (ledger != {"c64xl64": 2})
    if ledger is None:
        assert chosen["torch"][0] == "library"


def test_rank_takes_the_previous_workers_ledger(tmp_path):
    """The ledger is read at construction: a status.json rewritten later
    does not change the worker's ranking."""
    queue = SpoolQueue(tmp_path / "spool")
    queue.ensure_dirs()
    queue.status_path.write_text(json.dumps(
        {"kind": "pert_serve_status", "buckets_served": {"c256xl2048": 2}}))
    w = tworker.ServeWorker(queue, device="cpu", executable_cache_dir=None)
    queue.status_path.write_text(json.dumps(
        {"kind": "pert_serve_status", "buckets_served": {}}))
    assert w._prior_buckets == {"c256xl2048": 2}
    ranked = tworker.rank_warmup_entries(_entries(), w._prior_buckets)
    assert [e["digest"] for e in ranked] == ["c256xl2048-1", "c256xl2048-0"]


# ---------------------------------------------------------------------------
# two worker lives on one store, with stand-in graphs
# ---------------------------------------------------------------------------

def _serve_frames():
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "tools"))
    from test_serve import _frames

    return _frames(seed=3), _frames(seed=11)


def test_second_worker_life_captures_the_first_lifes_programs(
        eager_programs, tmp_path):
    """A batched worker (``max_batch=2``, two requests) whose packed
    dispatches all replay slab programs of its store (none eager, none
    degraded) and a serial worker of the same fleet on the same store
    (the solo run of the first request's data); then a second serial
    life on the batched spool: its warm-up ranks the records by the
    first life's ``buckets_served``, captures the programs again (the
    slab programs left out: a serial worker packs nothing), and once it
    is done the first request's data, submitted again, logs only
    ``hit`` events and gives the solo run's output bit for bit."""
    import threading
    import time

    import pandas as pd

    from scdna_replication_tools_tpu_torch.serve import BucketSet

    options = {"max_iter": 40, "min_iter": 15, "run_step3": False,
               "mirror_rescue": False, "seed": 0,
               "cn_prior_method": "g1_clones"}
    buckets = BucketSet(cells=(8, 16), loci=(64, 128))
    sims = _serve_frames()
    store = str(tmp_path / "store")
    batched = SpoolQueue(tmp_path / "batched")
    for rid, sim in zip(("a", "b"), sims):
        batched.submit_frames(*sim, options=options, request_id=rid)
    w1 = tworker.ServeWorker(batched, buckets=buckets, max_batch=2,
                             exit_when_idle=True, device="cpu",
                             executable_cache_dir=store)
    w1.run()
    coord = w1.slab_coordinator
    assert coord.packed_dispatches > 0
    assert coord.packed_graphed == coord.packed_dispatches
    assert coord.degraded == 0
    serial = SpoolQueue(tmp_path / "serial")
    serial.submit_frames(*sims[0], options=options, request_id="a")
    tworker.ServeWorker(serial, buckets=buckets, max_batch=1,
                        exit_when_idle=True, device="cpu",
                        executable_cache_dir=store).run()
    records = _program_entries(aotcache.ExecutableStore(store))
    assert {"chunk"} < {e["meta"]["tag"] for e in records}
    w2 = tworker.ServeWorker(batched, buckets=buckets, max_batch=1,
                             max_requests=1, device="cpu",
                             executable_cache_dir=store)
    assert w2._prior_buckets == json.loads(
        batched.status_path.read_text())["buckets_served"]
    thread = threading.Thread(target=w2.run)
    thread.start()
    deadline = time.monotonic() + 120
    while not w2._warmup_info["done"] and time.monotonic() < deadline:
        time.sleep(0.05)
    warm = dict(w2._warmup_info)
    src = batched.root / "data" / "a"
    batched.submit(str(src / "cn_s.tsv"), str(src / "cn_g1.tsv"),
                   options=options, request_id="a2")
    thread.join(timeout=300)
    assert not thread.is_alive()
    solo = [e for e in records if not e["meta"]["tag"].startswith("slab")]
    assert warm["precaptured"] == len(solo) and "error" not in warm
    events = [json.loads(line) for line in
              (batched.results_dir("a2") / "run.jsonl").read_text()
              .splitlines() if '"compile"' in line]
    assert events and {e["cache"] for e in events} == {"hit"}
    first = {e["key_hash"] for rid in ("a", "b")
             for e in (json.loads(line) for line in
                       (batched.results_dir(rid) / "run.jsonl").read_text()
                       .splitlines()) if e["event"] == "compile"}
    assert set(warm["precaptured_key_hashes"]) <= first | {
        e["key_hash"] for e in events}
    ref, got = (pd.read_csv(q.results_dir(r) / "output.tsv", sep="\t",
                            dtype={"chr": str})
                for q, r in ((serial, "a"), (batched, "a2")))
    assert ref.equals(got)
