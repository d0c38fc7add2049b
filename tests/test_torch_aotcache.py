"""The port's compiled-program store (``infer/aotcache.py``) in the cases
of JAX's ``tests/test_aotcache.py`` that have a counterpart: the key
text and digest, the disk layer's environment check, quarantine, LRU
eviction and preload, the kernel-library records that a fresh process
loads instead of running nvcc (a stand-in nvcc and loader, as
``tests/test_torch_build.py`` uses), the store's scope (nothing left
after a run, a failed one too), ``scRT(executable_cache_dir=D)`` on the
CPU (eager fits, ``uncacheable`` events, the plain run's frames bit for
bit), and the config hash of the three options this slice lifts, equal
to JAX's.  JAX's XLA-specific cases (serialize, the compile-cache
bypass) have no counterpart: a CUDA graph is not serialized.
"""

from __future__ import annotations

import json
import os
import re

import pytest

from scdna_replication_tools_tpu.config import PertConfig as JaxConfig
from scdna_replication_tools_tpu.obs.runlog import \
    _config_digest as jax_digest
from scdna_replication_tools_tpu_torch.config import PertConfig
from scdna_replication_tools_tpu_torch.infer import aotcache
from scdna_replication_tools_tpu_torch.obs import runlog as port_runlog
from scdna_replication_tools_tpu_torch.ops import _cuda
from scdna_replication_tools_tpu_torch.utils import faults

from test_torch_build import _FakeLib, _fake_nvcc
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_resilience import BASE, port_inputs, run_port


def test_canonical_key_text_scrubs_addresses():
    class Obj:
        pass

    a, b = Obj(), Obj()
    ka = aotcache.canonical_key_text(("chunk", a, (1, 2)))
    kb = aotcache.canonical_key_text(("chunk", b, (1, 2)))
    assert ka == kb and "0xADDR" in ka
    assert not re.search(r"0x[0-9a-f]{6,}", ka)


def test_key_digest_is_deterministic_and_keyed_by_every_part():
    env = {"torch_version": "2.x", "cuda_version": "12.x",
           "device_kind": "card", "compute_capability": "9.0"}
    d = aotcache.key_digest("k", env, "cfg")
    assert d == aotcache.key_digest("k", dict(env), "cfg")
    assert len(d) == 32
    assert d != aotcache.key_digest("k2", env, "cfg")
    assert d != aotcache.key_digest("k", env, "cfg2")
    assert d != aotcache.key_digest("k", {**env, "device_kind": "x"},
                                    "cfg")


def test_signature_shapes_reads_the_abstract_signature():
    key = ("chunk", "loss", (), ("skel", (((3, 5), "f32", "cuda:0"),
                                          ((3, 5), "f32", "cuda:0"),
                                          ((7,), "i32", "cuda:0"))),
           "cfg")
    assert aotcache.signature_shapes(key) == [[3, 5], [7]]
    assert aotcache.signature_shapes(("x",)) == []


ENV = {"torch_version": "t", "cuda_version": "c", "device_kind": "k",
       "compute_capability": "9.0", "nvcc_version": "n"}


def test_save_load_roundtrip_and_env_mismatch_misses(tmp_path):
    store = aotcache.ExecutableStore(str(tmp_path))
    assert store.save("d1", "key", b"\x7fELF library", meta={"a": 1},
                      env=ENV) == (True, "saved")
    payload, meta, seconds = store.load("d1", ENV)
    assert payload == b"\x7fELF library" and meta["a"] == 1
    assert seconds >= 0.0
    # another toolchain: a miss, and the record stays
    assert store.load("d1", {**ENV, "nvcc_version": "other"}) is None
    assert os.path.exists(store.path("d1"))
    assert not os.path.exists(store.path("d1") + ".bad")
    assert store.load("missing", ENV) is None


@pytest.mark.parametrize("damage", ["truncate", "garbage", "payload"])
def test_corrupt_and_truncated_entries_are_quarantined(tmp_path, damage):
    store = aotcache.ExecutableStore(str(tmp_path))
    store.save("d1", "key", b"x" * 4096, env=ENV)
    path = store.path("d1")
    data = open(path, "rb").read()
    if damage == "truncate":
        data = data[:len(data) // 2]
    elif damage == "garbage":
        data = b"not a record"
    else:
        # a flipped payload byte: the record reads, its digest does not
        i = data.index(b"x" * 64)
        data = data[:i] + b"y" + data[i + 1:]
    open(path, "wb").write(data)
    assert store.load("d1", ENV) is None
    assert not os.path.exists(path) and os.path.exists(path + ".bad")
    # a quarantined entry is invisible to probes and listings
    assert store.load("d1", ENV) is None and store.entries() == []


def test_lru_eviction_by_mtime(tmp_path):
    store = aotcache.ExecutableStore(str(tmp_path), max_entries=2)
    for i, name in enumerate(("a", "b")):
        store.save(name, name, b"p", env=ENV)
        os.utime(store.path(name), (1000 + i, 1000 + i))
    # a load touches its entry: "a" becomes the most recent
    assert store.load("a", ENV) is not None
    store.save("c", "c", b"p", env=ENV)
    assert sorted(e["digest"] for e in store.entries()) == ["a", "c"]


def test_preload_serves_the_first_load_from_ram(tmp_path):
    store = aotcache.ExecutableStore(str(tmp_path))
    store.save("d1", "key", b"payload", meta={"library": "adam"}, env=ENV)
    assert [e["meta"]["library"] for e in store.entries()] == ["adam"]
    assert store.preload("d1") is False      # this process's facts differ
    store._preloaded.clear()
    store2 = aotcache.ExecutableStore(str(tmp_path))
    store2._load_from_disk = lambda digest, env=None: (b"payload", {}, 0.1)
    assert store2.preload("d1") and store2.preloaded_count() == 1
    os.remove(store.path("d1"))
    assert store2.load("d1") == (b"payload", {}, 0.1)
    assert store2.preloaded_count() == 0


@pytest.fixture
def fake_toolchain(tmp_path, monkeypatch):
    """A stand-in nvcc and loader, an empty library cache, and fixed
    environment facts (``facts`` may be edited by a test)."""
    script, calls = _fake_nvcc(tmp_path)
    monkeypatch.setattr(_cuda, "_nvcc", lambda: str(script))
    monkeypatch.setattr(_cuda.ctypes, "CDLL", _FakeLib)
    facts = dict(ENV)
    monkeypatch.setattr(aotcache, "environment_facts",
                        lambda device=None, with_nvcc=False: dict(facts))

    def fresh_process(build):
        monkeypatch.setattr(_cuda, "BUILD_DIR", build)
        monkeypatch.setattr(_cuda, "_LIBS", {})
        monkeypatch.setattr(_cuda, "BUILD_INFO", {})
    return calls, facts, fresh_process


def test_a_fresh_process_loads_every_library_from_the_store(
        tmp_path, fake_toolchain):
    calls, facts, fresh_process = fake_toolchain
    store = aotcache.ExecutableStore(str(tmp_path / "D"))
    fresh_process(tmp_path / "build1")
    first = [_cuda.load_event(n, store) for n in _cuda.SOURCES]
    assert [e["cache"] for e in first] == ["miss"] * len(_cuda.SOURCES)
    assert len(store.entries()) == len(_cuda.SOURCES)
    built = len(calls.read_text().splitlines())
    # a new process with an empty build directory: every library a
    # disk hit from the store, no compiler run
    fresh_process(tmp_path / "build2")
    second = [_cuda.load_event(n, store) for n in _cuda.SOURCES]
    assert [e["cache"] for e in second] == ["disk_hit"] * len(second)
    assert all("deserialize_seconds" in e for e in second)
    assert len(calls.read_text().splitlines()) == built
    assert [e["key_hash"] for e in second] == [e["key_hash"] for e in first]
    # a truncated record: quarantined, the library built again, saved
    digest = _cuda.store_digest("adam")[0]
    path = store.path(digest)
    open(path, "r+b").truncate(100)
    fresh_process(tmp_path / "build3")
    third = {n: _cuda.load_event(n, store)["cache"] for n in _cuda.SOURCES}
    assert third == {"adam": "miss", "enum_fused": "disk_hit"}
    assert os.path.exists(path + ".bad") and os.path.exists(path)
    # another toolchain: a miss without quarantine
    facts["nvcc_version"] = "another"
    fresh_process(tmp_path / "build4")
    fourth = [_cuda.load_event(n, store)["cache"] for n in _cuda.SOURCES]
    assert fourth == ["miss"] * len(_cuda.SOURCES)
    assert not any(p.endswith(".bad.bad") for p in os.listdir(store.root))


def test_a_loaded_library_is_saved_to_a_store_lacking_it(tmp_path,
                                                        fake_toolchain):
    _, _, fresh_process = fake_toolchain
    fresh_process(tmp_path / "build")
    assert _cuda.load_event("adam")["cache"] == "miss"
    store = aotcache.ExecutableStore(str(tmp_path / "D"))
    assert _cuda.load_event("adam", store)["cache"] == "hit"
    assert [e["meta"]["library"] for e in store.entries()] == ["adam"]


def test_compile_cache_dir_none_builds_in_a_directory_of_the_process(
        tmp_path, fake_toolchain):
    _, _, fresh_process = fake_toolchain
    fresh_process(tmp_path / "build")
    with _cuda.build_dir_scope(None) as where:
        assert where != tmp_path / "build" and where.is_dir()
        _cuda.library("adam")
        assert os.path.dirname(_cuda.BUILD_INFO["adam"]["path"]) == \
            str(where)
    assert _cuda.build_dir() == tmp_path / "build"
    with _cuda.build_dir_scope(str(tmp_path / "mine")) as mine:
        assert mine == (tmp_path / "mine").resolve()
    assert _cuda.build_dir() == tmp_path / "build"


def _no_live_programs():
    return aotcache.live_program_count() == 0 \
        and aotcache.current_scope() is None \
        and all(s.closed for s in list(aotcache._LIVE_STORES))


def test_the_store_is_gone_after_a_run_and_a_failed_run(synthetic_frames,
                                                        tmp_path):
    inputs = port_inputs(synthetic_frames)
    cfg = dict(BASE, executable_cache_dir=str(tmp_path / "D"))
    run_port(synthetic_frames, PertConfig(**cfg), inputs)
    assert _no_live_programs()
    try:
        with pytest.raises(faults.SimulatedPreemption):
            run_port(synthetic_frames, PertConfig(
                **cfg, faults="preempt@step2/chunk#2"), inputs)
    finally:
        faults.install(None)
    assert _no_live_programs()


def test_scrt_with_a_store_on_the_cpu_is_the_plain_run(synthetic_frames,
                                                       tmp_path):
    """On the CPU every fit runs eagerly under a store: one
    ``uncacheable`` compile event per step fit, and the frames of the
    run without a store, bit for bit."""
    from test_torch_resilience import port_frames

    from scdna_replication_tools_tpu_torch import scRT

    frames = port_frames(synthetic_frames)
    opts = dict(input_col="reads", clone_col="clone_id", assign_col="state",
                rt_prior_col=None, cn_prior_method="g1_clones",
                max_iter=60, min_iter=20, mirror_rescue=False, device="cpu")
    plain = scRT(*(f.copy() for f in frames), telemetry_path=None,
                 **opts).infer("pert")
    log = tmp_path / "run.jsonl"
    stored = scRT(*(f.copy() for f in frames), telemetry_path=str(log),
                  executable_cache_dir=str(tmp_path / "D"),
                  **opts).infer("pert")
    for a, b in zip(plain, stored):
        assert a.equals(b)
    events = [json.loads(line) for line in log.read_text().splitlines()]
    compiled = [(e["step"], e["cache"]) for e in events
                if e["event"] == "compile"]
    assert compiled == [("step1", "uncacheable"), ("step2", "uncacheable"),
                        ("step3", "uncacheable")]
    end = [e for e in events if e["event"] == "metrics_snapshot"][-1]
    assert end["metrics"]["pert_compile_cache_uncacheable_total"][
        "value"] == 3


@pytest.mark.parametrize("values", [
    dict(),
    dict(profile_dir="/tmp/prof", compile_cache_dir=None,
         executable_cache_dir="/tmp/store"),
    dict(compile_cache_dir="/tmp/cc", executable_cache_dir="auto")])
def test_config_hash_equals_jax_for_the_lifted_fields(values):
    """profile_dir and compile_cache_dir are hashed, executable_cache_dir
    is not, in both packages: one setting, one hash."""
    assert port_runlog._config_digest(PertConfig(**values)) == \
        jax_digest(JaxConfig(**values))


def test_program_digest_drops_the_execution_only_fields():
    _program_config_digest = aotcache.program_config_digest
    base = _program_config_digest(PertConfig())
    for moved in (dict(checkpoint_dir="/a"), dict(profile_dir="/b"),
                  dict(compile_cache_dir=None), dict(telemetry_path="/c"),
                  dict(request_id="r7"), dict(executable_cache_dir="/d")):
        assert _program_config_digest(PertConfig(**moved)) == base
    assert _program_config_digest(PertConfig(max_iter=7)) != base
