"""The decode and posterior-predictive (PPC) slab programs of the store,
on the CPU.

* ``decode_discrete`` (with and without the entropy maps) and
  ``ppc_discrepancy`` under a run scope, with a stand-in for the CUDA
  graphs that runs each form's stage eagerly on the program's buffers
  (``test_torch_svi_graphable.EagerPassProgram``), equal the eager
  passes bit for bit, on one slab and on a ladder rung of several; the
  first slab of a key captures (``miss``), every later slab and call of
  the same shapes is a ``hit``; the outputs do not alias the program's
  buffers.
* Program records: a capture writes one (its shapes end in the slab's
  cells and loci, and the bucket's), ``svi.precapture`` rebuilds the
  program from it, a truncated record or one that does not rebuild its
  key is quarantined; a capture that fails raises, naming the pass, and
  leaves the store.
* On the CPU and on a sharded run the passes stay eager and log one
  ``uncacheable`` event each.
* ``scRT(cn_s, cn_g1, executable_cache_dir=D).infer('pert')`` logs the
  ``decode_slab`` and ``ppc`` events JAX's run logs, in its order.
* The serving worker's warm-up ranks the decode and PPC records with
  their bucket as JAX's ``_warmup_executables`` does.

The graphs themselves run in ``tests/test_torch_gpu.py``.
"""

import json
import os
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.infer import svi as jsvi
from scdna_replication_tools_tpu_torch.infer import aotcache, svi
from scdna_replication_tools_tpu_torch.models import pert as tpert
from scdna_replication_tools_tpu_torch.obs.runlog import RunLog
from scdna_replication_tools_tpu_torch.serve import worker as tworker
from scdna_replication_tools_tpu_torch.serve.queue import SpoolQueue

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_pipeline import sim_data  # noqa: F401
from test_torch_runlog import DEFAULTS
from test_torch_slab_graphs import _StubStore
from test_torch_svi_graphable import _problem, use_eager_passes


@pytest.fixture(autouse=True)
def float32_default():
    before = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    yield
    torch.set_default_dtype(before)


@pytest.fixture
def eager_passes(monkeypatch):
    use_eager_passes(monkeypatch)


class _Events:
    """The ``compile`` events emitted on this thread inside the block
    (a run log of the test's own)."""

    def __init__(self, tmp_path):
        self.log = RunLog(str(tmp_path / "events.jsonl"))

    def __enter__(self):
        self._session = self.log.session()
        self._session.__enter__()
        return self

    def __exit__(self, *exc):
        self._session.__exit__(*exc)

    def compile(self):
        return [e for e in (json.loads(line) for line in
                            Path(self.log.path).read_text().splitlines())
                if e["event"] == "compile"]


def _case(kind="dense", seed=3):
    loss_fn, params, (fixed, batch) = _problem(kind, seed=seed)
    return loss_fn.spec, params, fixed, batch


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Bit for bit (a NaN is equal to itself)."""
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.numpy().tobytes() == b.numpy().tobytes()


def _all_same(a, b) -> bool:
    return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))


def _maps(spec, params, fixed, batch):
    cn, rep, _ = tpert.decode_discrete(spec, params, fixed, batch)
    return cn.numpy(), rep.numpy()


# ---------------------------------------------------------------------------
# the programs against the eager passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 5], ids=["one_slab", "rung"])
@pytest.mark.parametrize("entropy", [False, True], ids=["plain", "entropy"])
def test_decode_program_equals_the_eager_pass(eager_passes, tmp_path,
                                              entropy, chunk):
    """``decode_discrete`` under a store equals the eager pass bit for
    bit, on one slab and on three of five cells (12 cells, the tail
    clamped); the first slab captures its forms, every later slab and a
    second call of the same shapes ``hit``; one program per key."""
    spec, params, fixed, batch = _case()
    eager = tpert.decode_discrete(spec, params, fixed, batch,
                                  cell_chunk=chunk, want_entropy=entropy)
    with _Events(tmp_path) as ev, \
            aotcache.run_scope(str(tmp_path / "store"), "cfg") as scope:
        first = tpert.decode_discrete(spec, params, fixed, batch,
                                      cell_chunk=chunk, want_entropy=entropy)
        again = tpert.decode_discrete(spec, params, fixed, batch,
                                      cell_chunk=chunk, want_entropy=entropy)
        assert scope.store.program_count() == 1
        (prog,) = scope.store._programs.values()
        assert sorted(prog.graphs) == (["decode", "entropy"] if entropy
                                       else ["decode"])
    assert len(eager) == (5 if entropy else 3)
    assert _all_same(eager, first) and _all_same(eager, again)
    slabs = 1 if chunk is None else 3
    events = ev.compile()
    assert [e["cache"] for e in events] == ["miss"] + ["hit"] * (
        2 * slabs - 1)
    assert {(e["tag"], e["label"]) for e in events} == {
        ("decode_slab", "PertModelSpec")}
    assert len({e["key_hash"] for e in events}) == 1


@pytest.mark.parametrize("chunk", [None, 5], ids=["one_slab", "rung"])
def test_ppc_program_equals_the_eager_pass(eager_passes, tmp_path, chunk):
    """``ppc_discrepancy`` under a store, its draws made in the program
    on its generator reseeded to each slab's (seed, salt), equals the
    eager pass bit for bit; another seed draws other replicates through
    the same program (a ``hit``)."""
    spec, params, fixed, batch = _case()
    maps = _maps(spec, params, fixed, batch)
    kw = dict(num_replicates=8, cell_chunk=chunk, maps=maps)
    eager = [tpert.ppc_discrepancy(spec, params, fixed, batch, seed=s, **kw)
             for s in (3, 4)]
    with _Events(tmp_path) as ev, \
            aotcache.run_scope(str(tmp_path / "store"), "cfg") as scope:
        got = [tpert.ppc_discrepancy(spec, params, fixed, batch, seed=s,
                                     **kw) for s in (3, 4)]
        assert scope.store.program_count() == 1
    for a, b in zip(eager, got):
        assert _all_same(a, b)
    assert not _same(got[0][1], got[1][1])
    slabs = 1 if chunk is None else 3
    assert [(e["tag"], e["cache"]) for e in ev.compile()] == \
        [("ppc", "miss")] + [("ppc", "hit")] * (2 * slabs - 1)


def test_ppc_with_given_replicates_is_a_program_of_its_own(eager_passes,
                                                           tmp_path):
    """The ``replicates=`` seam's draws are an operand: another key, no
    generator, the eager pass's result."""
    spec, params, fixed, batch = _case()
    maps = _maps(spec, params, fixed, batch)
    reps = np.random.default_rng(5).poisson(
        30.0, (4,) + tuple(batch.reads.shape)).astype(np.float32)
    kw = dict(num_replicates=4, maps=maps, replicates=reps)
    eager = tpert.ppc_discrepancy(spec, params, fixed, batch, **kw)
    with aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        drawn = tpert.ppc_discrepancy(spec, params, fixed, batch, maps=maps,
                                      num_replicates=4)
        got = tpert.ppc_discrepancy(spec, params, fixed, batch, **kw)
        progs = list(scope.store._programs.values())
        assert len(progs) == 2
        assert [p.gen is None for p in progs] == [False, True]
    assert _all_same(eager, got) and not _same(drawn[1], got[1])


def test_outputs_do_not_alias_the_program(eager_passes, tmp_path):
    """What a call returns outlives the next replay of its program."""
    spec, params, fixed, batch = _case()
    _, other, _, _ = _case(seed=4)
    with aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        out = tpert.decode_discrete(spec, params, fixed, batch,
                                    want_entropy=True)
        kept = [t.clone() for t in out]
        tpert.decode_discrete(spec, other, fixed, batch, want_entropy=True)
        (prog,) = scope.store._programs.values()
        buffers = {t.data_ptr() for t in prog.out + prog.ent}
        assert _all_same(out, kept)
        assert not buffers & {t.data_ptr() for t in out}


# ---------------------------------------------------------------------------
# records, failures, the uncacheable cases
# ---------------------------------------------------------------------------

def _program_entries(store):
    return [e for e in store.entries() if e["meta"].get("kind") == "program"]


def _passes(spec, params, fixed, batch, maps):
    return (tpert.decode_discrete(spec, params, fixed, batch,
                                  want_entropy=True),
            tpert.ppc_discrepancy(spec, params, fixed, batch, seed=2,
                                  maps=maps))


def test_records_rebuild_the_programs(eager_passes, tmp_path):
    """Each capture writes its program's record (tag, digest, shapes
    ending in the slab's cells and loci and the bucket's); a fresh store
    on the directory rebuilds both programs from their records alone
    (``precapture``: the rebuilt key must give the recorded digest; the
    two share the store's pass pool and lock), and
    the same calls then ``hit`` under the recorded key hashes and equal
    the eager passes."""
    spec, params, fixed, batch = _case()
    maps = _maps(spec, params, fixed, batch)
    eager = _passes(spec, params, fixed, batch, maps)
    root = str(tmp_path / "store")
    with aotcache.run_scope(root, "cfg", bucket=(16, 256)):
        _passes(spec, params, fixed, batch, maps)
    entries = _program_entries(aotcache.ExecutableStore(root))
    assert sorted(e["meta"]["tag"] for e in entries) == ["decode_slab", "ppc"]
    for e in entries:
        tails = {tuple(s[-2:]) for s in e["meta"]["shapes"]}
        assert {tuple(batch.reads.shape), (16, 256)} <= tails
    store = aotcache.activate(root)
    try:
        done = [svi.precapture(store, e["digest"], "cpu") for e in entries]
        assert store.program_count() == 2
        # the store's pass programs share one graph pool and lock
        assert len({id(p.share) for p in store._programs.values()}) == 1
        assert sorted(d["forms"] for d in done) == [
            ["decode", "entropy"], ["ppc"]]
        assert all(d["key_hashes"] == [d["digest"]] for d in done)
        with _Events(tmp_path) as ev, \
                aotcache.run_scope(root, "cfg", bucket=(16, 256)):
            got = _passes(spec, params, fixed, batch, maps)
    finally:
        aotcache.deactivate()
    events = ev.compile()
    assert [(e["tag"], e["cache"]) for e in events] == [
        ("decode_slab", "hit"), ("ppc", "hit")]
    assert {e["key_hash"] for e in events} == {d["digest"] for d in done}
    for a, b in zip(eager, got):
        assert _all_same(a, b)


def test_truncated_record_is_quarantined(eager_passes, tmp_path):
    spec, params, fixed, batch = _case()
    root = str(tmp_path / "store")
    with aotcache.run_scope(root, None):
        tpert.decode_discrete(spec, params, fixed, batch)
    store = aotcache.ExecutableStore(root)
    (entry,) = _program_entries(store)
    path = store.path(entry["digest"])
    blob = open(path, "rb").read()
    with open(path, "wb") as fh:
        fh.write(blob[:len(blob) // 2])
    with pytest.raises(LookupError):
        svi.precapture(store, entry["digest"], "cpu")
    assert os.path.exists(path + ".bad") and not os.path.exists(path)


def test_record_of_another_key_is_refused_and_quarantined(eager_passes,
                                                         tmp_path):
    spec, params, fixed, batch = _case()
    maps = _maps(spec, params, fixed, batch)
    root = str(tmp_path / "store")
    with aotcache.run_scope(root, None):
        tpert.ppc_discrepancy(spec, params, fixed, batch, seed=1, maps=maps)
    store = aotcache.ExecutableStore(root)
    (entry,) = _program_entries(store)
    other = "0" * 32
    os.replace(store.path(entry["digest"]), store.path(other))
    with pytest.raises(ValueError, match="rebuild its key"):
        svi.precapture(store, other, "cpu")
    assert os.path.exists(store.path(other) + ".bad")


def test_a_failed_capture_raises_naming_the_pass(monkeypatch, tmp_path):
    """The real program's capture on the CPU (no CUDA graph there) fails:
    the call raises, naming the pass, instead of running eagerly, and
    the program leaves the store."""
    spec, params, fixed, batch = _case()

    def resolve(tag, spec, dev, mesh, static_kwargs):
        return svi._PassPrograms(aotcache.current_scope(), tag, spec,
                                 static_kwargs)
    monkeypatch.setattr(svi, "resolve_slab_program", resolve)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    with aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        with pytest.raises(RuntimeError,
                           match="capture of the decode_slab slab pass"):
            tpert.decode_discrete(spec, params, fixed, batch)
        assert scope.store.program_count() == 0


def test_a_capture_out_of_memory_raises(eager_passes, tmp_path,
                                       monkeypatch):
    """A capture that runs the card out of memory raises as any failed
    capture does: it is not tried again, no other program is released
    for it (the store releases programs only past its caps), and the
    program leaves the store, so that a later call captures it anew and
    equals the eager pass."""
    from test_torch_svi_graphable import EagerPassProgram

    spec, params, fixed, batch = _case()
    maps = _maps(spec, params, fixed, batch)
    eager = tpert.ppc_discrepancy(spec, params, fixed, batch, seed=2,
                                  maps=maps)
    real = EagerPassProgram.capture
    failures = []

    def capture(self, form):
        if len(failures) < budget[0]:
            failures.append(form)
            raise RuntimeError(f"CUDA graph capture of the {form} failed "
                               "(OutOfMemoryError: CUDA out of memory)")
        return real(self, form)
    monkeypatch.setattr(EagerPassProgram, "capture", capture)
    budget = [0]
    with aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        tpert.decode_discrete(spec, params, fixed, batch)
        budget[0] = 1
        with pytest.raises(RuntimeError, match="out of memory"):
            tpert.ppc_discrepancy(spec, params, fixed, batch, seed=2,
                                  maps=maps)
        assert failures == ["ppc"] and scope.store.released == 0
        assert [p.tag for p in scope.store._programs.values()] \
            == ["decode_slab"]
        got = tpert.ppc_discrepancy(spec, params, fixed, batch, seed=2,
                                    maps=maps)
        assert [p.tag for p in scope.store._programs.values()] \
            == ["decode_slab", "ppc"]
    assert _all_same(eager, got)


def test_the_store_counts_the_shared_pool_once(eager_passes, tmp_path):
    """The pass programs' shared pool counts once in the store's bytes,
    beside each program's buffers; it stays counted while one program
    uses it and restarts from nothing when the last one is released; a
    new program's need counts the estimate of its pool past what the
    pool holds."""
    spec, params, fixed, batch = _case()
    maps = _maps(spec, params, fixed, batch)
    with aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        store = scope.store
        _passes(spec, params, fixed, batch, maps)
        progs = list(store._programs.values())
        assert [p.tag for p in progs] == ["decode_slab", "ppc"]
        share = progs[0].share
        assert progs[1].share is share
        share.nbytes = 1000
        buffers = sum(p.nbytes for p in progs)
        assert store.program_bytes() == buffers + 1000
        store.max_program_bytes = buffers + 1000 - 1
        store.trim()
        assert list(store._programs.values()) == progs[1:]
        assert store.program_bytes() == progs[1].nbytes + 1000
        store.max_program_bytes = 0
        store.trim()
        assert store.program_count() == 0 and share.nbytes == 0
        cells, loci = batch.reads.shape
        pool = svi.pass_pool_estimate("decode_slab", spec, {}, cells, loci)
        assert pool == svi.PASS_POOL_JOINTS * cells * loci * spec.P * 8
        operands = (params, fixed, tpert._pass_batch(batch))
        need = svi._pass_need("decode_slab", spec, {}, operands, share)
        assert need == svi._tree_bytes(operands) + pool
        share.nbytes = pool + 1
        assert svi._pass_need("decode_slab", spec, {}, operands, share) \
            == svi._tree_bytes(operands)


@pytest.mark.parametrize("entropy", [False, True], ids=["plain", "entropy"])
def test_only_the_entropy_form_keeps_the_joint_tensor(eager_passes,
                                                      tmp_path, entropy):
    """A plain decode program hands its joint tensor back to the pool
    after its capture; one with the entropy maps keeps it for the
    entropy graph."""
    spec, params, fixed, batch = _case()
    with aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        tpert.decode_discrete(spec, params, fixed, batch,
                              want_entropy=entropy)
        (prog,) = scope.store._programs.values()
        assert (prog.joint is not None) == entropy


@pytest.mark.parametrize("where", ["cpu", "sharded"])
def test_cpu_and_sharded_passes_say_uncacheable(tmp_path, where):
    """Without a stand-in, a pass on the CPU under a store, or one given
    a rank grid, runs eagerly: one ``uncacheable`` event per call, the
    eager pass's outputs, no program."""
    spec, params, fixed, batch = _case()
    maps = _maps(spec, params, fixed, batch)
    mesh = types.SimpleNamespace(size=1, rank=0, loci=1) \
        if where == "sharded" else None
    eager = _passes(spec, params, fixed, batch, maps)
    with _Events(tmp_path) as ev, \
            aotcache.run_scope(str(tmp_path / "store"), None) as scope:
        got = (tpert.decode_discrete(spec, params, fixed, batch,
                                     want_entropy=True, mesh=mesh),
               tpert.ppc_discrepancy(spec, params, fixed, batch, seed=2,
                                     maps=maps, mesh=mesh))
        assert scope.store.program_count() == 0
    for a, b in zip(eager, got):
        assert _all_same(a, b)
    assert [(e["tag"], e["cache"], e["reason"]) for e in ev.compile()] == [
        ("decode_slab", "uncacheable", "pass on cpu"),
        ("ppc", "uncacheable", "pass on cpu")]


def test_program_step_marks_the_events(eager_passes, tmp_path):
    spec, params, fixed, batch = _case()
    with _Events(tmp_path) as ev, \
            aotcache.run_scope(str(tmp_path / "store"), None):
        with svi.program_step("package_s"):
            tpert.decode_discrete(spec, params, fixed, batch)
        tpert.decode_discrete(spec, params, fixed, batch)
    assert [e.get("step") for e in ev.compile()] == ["package_s", None]


# ---------------------------------------------------------------------------
# the default run against JAX's
# ---------------------------------------------------------------------------

def _pass_events(path):
    return [(e["tag"], e["cache"]) for e in
            (json.loads(line) for line in Path(path).read_text().splitlines())
            if e["event"] == "compile"
            and e.get("tag") in ("decode_slab", "ppc")]


# the rescue gate consulting the entropy planes: every S cell a
# boundary-tau candidate, none extreme, no cell past the low-confidence
# share (the rescue skipped)
GATE = dict(mirror_tau_lo=0.45, mirror_tau_hi=0.55,
            controller_rescue_extreme_tau=1e-9, qc_frac_thresh=1.0)


@pytest.mark.parametrize("gate", [False, True],
                         ids=["default", "gate_consults_entropy"])
def test_default_run_logs_jax_decode_and_ppc_events(sim_data, monkeypatch,
                                                    tmp_path, gate):
    """``scRT(cn_s, cn_g1, executable_cache_dir=D).infer('pert')`` at the
    defaults in both packages (JAX's in-process program cache cleared
    first, each store fresh), and with the rescue gate consulting the
    entropy planes (``GATE``): the same ``(tag, cache)`` sequence of
    ``decode_slab`` and ``ppc`` events, a ``miss`` per program key and
    ``hit`` after (the gate's decode program is the packaging's); the
    port's carry their steps, and its frames equal the run without a
    store."""
    import dataclasses

    from scdna_replication_tools_tpu.api import scRT as JaxScRT
    from scdna_replication_tools_tpu.infer import aotcache as jaot
    from scdna_replication_tools_tpu_torch import scRT as TorchScRT

    sim_s, sim_g = sim_data

    def run(cls, **kw):
        scrt = cls(sim_s.copy(), sim_g.copy(), **DEFAULTS, **kw)
        if gate:
            scrt.config = dataclasses.replace(scrt.config, **GATE)
        return scrt.infer(level="pert")

    jsvi._PROGRAM_CACHE.clear()
    try:
        run(JaxScRT, compile_cache_dir=None,
            executable_cache_dir=str(tmp_path / "jax_store"),
            telemetry_path=str(tmp_path / "jax.jsonl"))
    finally:
        jaot.deactivate()
        jsvi._PROGRAM_CACHE.clear()
    plain = run(TorchScRT, device="cpu", telemetry_path=None)
    use_eager_passes(monkeypatch)
    log = tmp_path / "port.jsonl"
    stored = run(TorchScRT, device="cpu", telemetry_path=str(log),
                 executable_cache_dir=str(tmp_path / "port_store"))
    want = _pass_events(tmp_path / "jax.jsonl")
    got = _pass_events(log)
    assert got == want
    steps = [e.get("step") for e in
             (json.loads(line) for line in log.read_text().splitlines())
             if e.get("tag") in ("decode_slab", "ppc")]
    tail = [("package_s", "decode_slab"), ("step2", "ppc"),
            ("package_g1", "decode_slab")]
    head = [("step2", "decode_slab")] if gate else []
    assert list(zip(steps, [t for t, _ in got])) == head + tail
    assert [c for _, c in got] == ["miss"] + (["hit"] if gate else []) \
        + ["miss", "miss"]
    for a, b in zip(plain, stored):
        assert a.equals(b)


# ---------------------------------------------------------------------------
# the warm-up's ranking, against JAX's
# ---------------------------------------------------------------------------

def test_warmup_ranks_pass_records_with_their_bucket(eager_passes,
                                                     tmp_path, monkeypatch):
    """Decode and PPC records written in two buckets' scopes, beside a
    chunk-like record of a third bucket: JAX's ``_warmup_executables``
    and the port's choose the same records in the same order, each
    bucket's pass records together, ranked by the ledger's traffic."""
    from scdna_replication_tools_tpu.infer import aotcache as jaot
    from scdna_replication_tools_tpu.serve import worker as jworker
    from scdna_replication_tools_tpu.serve.queue import (
        SpoolQueue as JSpoolQueue,
    )

    spec, params, fixed, batch = _case()
    maps = _maps(spec, params, fixed, batch)
    root = str(tmp_path / "store")
    for bucket in ((16, 256), (32, 512)):
        with aotcache.run_scope(root, f"cfg{bucket[0]}", bucket=bucket):
            _passes(spec, params, fixed, batch, maps)
    # the records' ranking facts (a record's kind would send the port's
    # warm-up to a capture the stub store cannot serve)
    entries = [{"digest": e["digest"], "mtime": e["mtime"],
                "meta": {"shapes": e["meta"]["shapes"]}}
               for e in aotcache.ExecutableStore(root).entries()]
    assert len(entries) == 4
    entries.append({"digest": "chunk", "mtime": 1.0,
                    "meta": {"shapes": [[13, 64, 1024], [64]]}})
    ledger = {"c32xl512": 3, "c16xl256": 1, "c64xl1024": 2}
    chosen = {}
    for arm in ("jax", "torch"):
        queue_root = tmp_path / arm
        queue = (JSpoolQueue if arm == "jax" else SpoolQueue)(queue_root)
        queue.ensure_dirs()
        queue.status_path.write_text(json.dumps(
            {"kind": "pert_serve_status", "buckets_served": ledger}))
        store = _StubStore(entries)
        if arm == "jax":
            monkeypatch.setattr(jaot, "activate", lambda root: store)
            w = jworker.ServeWorker(queue, executable_cache_dir=str(
                queue_root / "x"))
        else:
            w = tworker.ServeWorker(queue, device="cpu",
                                    executable_cache_dir=str(
                                        queue_root / "x"))
            w._store = store
        w._warmup_executables()
        chosen[arm] = store.chosen
    assert chosen["torch"] == chosen["jax"]
    shapes = {e["digest"]: e["meta"]["shapes"] for e in entries}
    assert [tuple(shapes[d][-1]) if d != "chunk" else "chunk"
            for d in chosen["torch"]] == \
        [(32, 512)] * 2 + ["chunk"] + [(16, 256)] * 2
