"""The port's checkpoint format, manifest identity and resume against the
JAX package's.

* ``save_step`` in both packages on the same state (float32 and bfloat16
  Adam moments, with the controller's resume state): the same keys, the
  same dtypes, the same bytes in every array (the bfloat16 moments as
  the same uint16 bit views), and topology stamps with the same keys;
* each package's ``load_step`` reading the other's file, and the port's
  ``restore_opt_state`` against ``weights.opt_state_from_jax``;
* the integrity cases (footer round trip, truncation, bit flip, the
  ``.prev`` fallback, a missing canonical file, a footerless legacy file,
  the unstamped v1 refusal) on files either package wrote, held to the
  outcome of JAX's loader on the same directory;
* the data fingerprint and the config hash, through each package's
  loader and runner, for the default config and a durable one;
* the cross-package resume under ``resume='auto'``, both ways: one
  package killed at ``step2/chunk#3``, the other resuming its directory
  with ``fingerprint_verified=True`` from the same iteration, its
  continued step-2 losses tracking the first package's uninterrupted run
  within tests/test_torch_fit.py's trajectory tolerance (1e-5 of the
  trajectory's largest magnitude, at 1e3 prior concentrations), and the
  same controller decisions (no draw enters this configuration's).
"""

import json
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.config import PertConfig as JaxConfig
from scdna_replication_tools_tpu.infer import checkpoint as jckpt
from scdna_replication_tools_tpu.infer import manifest as jmanifest
from scdna_replication_tools_tpu.infer.runner import (
    PertInference as JaxInference,
)
from scdna_replication_tools_tpu.infer.svi import make_opt_state
from scdna_replication_tools_tpu.obs.runlog import _config_digest as jdigest
from scdna_replication_tools_tpu.utils import faults as jfaults
from scdna_replication_tools_tpu_torch import weights
from scdna_replication_tools_tpu_torch.config import (
    UNPORTED_FIELDS,
    PertConfig,
)
from scdna_replication_tools_tpu_torch.infer import checkpoint as ckpt
from scdna_replication_tools_tpu_torch.infer import manifest as manifest_mod
from scdna_replication_tools_tpu_torch.infer.runner import PertInference
from scdna_replication_tools_tpu_torch.obs.runlog import _config_digest
from scdna_replication_tools_tpu_torch.utils import faults

from conftest import dense_inputs_from_frames  # noqa: E402
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_resilience import (  # noqa: F401
    BASE,
    _clear_fault_plan,
    events_of,
    port_inputs,
    run_port,
)


_CACHE_DIR_AT_IMPORT = jax.config.jax_compilation_cache_dir


@pytest.fixture(autouse=True)
def _clear_jax_fault_plan():
    yield
    jfaults.install(None)


# ---------------------------------------------------------------------------
# the file format
# ---------------------------------------------------------------------------

C, L, P = 6, 10, 13


def _state(moment_dtype: str, seed: int = 3):
    """(params as NumPy, a JAX optax state with random moments and count
    7, a controller state dict): one step-2 fit's checkpointable state."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    params = {"a_raw": rng.normal(size=()).astype(f32),
              "tau_raw": rng.normal(size=C).astype(f32),
              "u": rng.normal(size=C).astype(f32),
              "betas": rng.normal(size=(C, 5)).astype(f32),
              "beta_stds_raw": rng.normal(size=(1, 5)).astype(f32),
              "rho_raw": rng.normal(size=L).astype(f32),
              "pi_logits": rng.normal(size=(P, C, L)).astype(f32)}
    jstate = make_opt_state({k: jnp.asarray(v) for k, v in params.items()},
                            moment_dtype=moment_dtype)
    leaves, treedef = jax.tree_util.tree_flatten(jstate)
    filled = [jnp.asarray(7, jnp.int32)] + [
        jnp.asarray(rng.normal(size=leaf.shape) * 1e-2, leaf.dtype)
        for leaf in leaves[1:]]
    jstate = jax.tree_util.tree_unflatten(treedef, filled)
    ctrl = {"reseeds": 1, "extra_granted": 25, "nan_retries": 0,
            "lr": 0.05, "budget": 125, "stagnation_anchor": 50,
            "prev_verdict": "plateaued", "best_loss": -123.5,
            "best_it": 50, "diag": rng.normal(size=(64, 3)).astype(f32),
            "diag_i0": 0,
            "best_params": {k: v + f32(1) for k, v in params.items()}}
    return params, jstate, ctrl


def _save_both(tmp_path, moment_dtype):
    params, jstate, ctrl = _state(moment_dtype)
    losses = np.linspace(10.0, 1.0, 60).astype(np.float32)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jpath = jckpt.save_step(
        str(jdir), "step2", params, losses, opt_state=jstate, num_iters=50,
        converged=False, extra=jckpt.pack_controller_state(ctrl))
    tstate = weights.opt_state_from_jax(jstate, "cpu")
    tparams = weights.params_from_jax(params, "cpu")
    tctrl = dict(ctrl, best_params=weights.params_from_jax(
        ctrl["best_params"], "cpu"))
    tpath = ckpt.save_step(
        str(tdir), "step2", tparams, losses, opt_state=tstate, num_iters=50,
        converged=False, extra=ckpt.pack_controller_state(tctrl))
    return params, jstate, tstate, jpath, tpath


def _flat(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_save_step_writes_jax_format(tmp_path, moment_dtype):
    """Same keys, dtypes and array bytes as JAX's save_step; bfloat16
    moments as the same uint16 bit views; the topology stamps share
    their keys, one process and no mesh."""
    *_, jpath, tpath = _save_both(tmp_path, moment_dtype)
    jflat, tflat = _flat(jpath), _flat(tpath)
    assert sorted(jflat) == sorted(tflat)
    bf16 = [k for k in jflat if k.startswith("leafdtype.")]
    assert len(bf16) == (2 if moment_dtype == "bfloat16" else 0)  # pi m, v
    for key in jflat:
        a, b = jflat[key], tflat[key]
        if key == "meta.topology":
            ja, tb = json.loads(str(a)), json.loads(str(b))
            assert sorted(ja) == sorted(tb)
            for k in ("format", "process_count", "process_index",
                      "mesh_axes", "param_layouts"):
                assert ja[k] == tb[k], k
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.tobytes() == b.tobytes(), key
    assert str(tflat["meta.opt_moment_dtype"]) == moment_dtype


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_each_package_loads_the_others_file(tmp_path, moment_dtype):
    """JAX's load_step + restore_opt_state rebuild the optax state from
    the port's file bit for bit, and the port's load_step +
    restore_opt_state rebuild weights.opt_state_from_jax of the JAX state
    from JAX's file."""
    params, jstate, tstate, jpath, tpath = _save_both(tmp_path,
                                                      moment_dtype)
    jp, jl, jx = jckpt.load_step(os.path.dirname(tpath), "step2")
    back = jckpt.restore_opt_state(jx, jp, 0.05, 0.8, 0.99)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jstate)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for k, v in params.items():
        np.testing.assert_array_equal(jp[k], v)
    assert jckpt.restore_controller_state(jx)["budget"] == 125

    tp, tl, tx = ckpt.load_step(os.path.dirname(jpath), "step2")
    state = ckpt.restore_opt_state(tx, tp, "cpu")
    ref = weights.opt_state_from_jax(jstate, "cpu")
    assert state.count.dtype == torch.int32 and int(state.count) == 7
    for name in ("mu", "nu"):
        got, want = getattr(state, name), getattr(ref, name)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), (name, k)
    np.testing.assert_array_equal(tl, jl)
    ctrl = ckpt.restore_controller_state(tx)
    assert ctrl["prev_verdict"] == "plateaued" and ctrl["best_it"] == 50
    assert sorted(ctrl["best_params"]) == sorted(params)
    assert int(tx["meta.num_iters"]) == 50 \
        and not bool(tx["meta.converged"])


def _save_dummy(package, d, value=1.0):
    mod = jckpt if package == "jax" else ckpt
    return mod.save_step(str(d), "step2",
                         {"tau_raw": np.full(8, value, np.float32)},
                         np.array([3.0, 2.0, float(value)], np.float32))


def _truncate(path):
    with open(path, "r+b") as fh:
        fh.truncate(os.path.getsize(path) // 2)


def _bitflip(path):
    blob = bytearray(pathlib.Path(path).read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    pathlib.Path(path).write_bytes(bytes(blob))


def _strip_footer(path):
    blob = pathlib.Path(path).read_bytes()
    pathlib.Path(path).write_bytes(blob[:-48])


def _unstamped_v1(d):
    """A footered npz without a format stamp whose pi_logits is 3-D."""
    import io

    buf = io.BytesIO()
    np.savez(buf, **{"param.pi_logits": np.zeros((2, 3, 4), np.float32),
                     "losses": np.zeros(3, np.float32)})
    payload = buf.getvalue()
    import hashlib
    import struct

    d.mkdir(parents=True, exist_ok=True)
    (d / "pert_step2.npz").write_bytes(
        payload + b"PERTCK01" + struct.pack("<Q", len(payload))
        + hashlib.sha256(payload).digest())


CASES = {
    "roundtrip": lambda pkg, d: _save_dummy(pkg, d),
    "truncated": lambda pkg, d: _truncate(_save_dummy(pkg, d)),
    "bitflip": lambda pkg, d: _bitflip(_save_dummy(pkg, d)),
    "prev_fallback": lambda pkg, d: (
        _save_dummy(pkg, d, 1.0),
        faults.corrupt_file(_save_dummy(pkg, d, 2.0))),
    "missing_canonical": lambda pkg, d: (
        _save_dummy(pkg, d, 1.0), os.unlink(_save_dummy(pkg, d, 2.0))),
    "footerless_legacy": lambda pkg, d: _strip_footer(_save_dummy(pkg, d)),
    "unstamped_v1": lambda pkg, d: _unstamped_v1(d),
}


def _outcome(load, d):
    """The loader's outcome on ``d``: the restored tau value or the
    exception type."""
    try:
        params, _, _ = load(str(d), "step2")
    except Exception as exc:  # noqa: BLE001 — the outcome compared
        return type(exc).__name__
    return float(np.asarray(params.get("tau_raw", [np.nan]))[0])


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_integrity_outcomes_match_jax(tmp_path, case, writer):
    CASES[case](writer, tmp_path)
    want = {"roundtrip": 1.0, "truncated": "CheckpointCorrupt",
            "bitflip": "CheckpointCorrupt", "prev_fallback": 1.0,
            "missing_canonical": 1.0, "footerless_legacy": 1.0,
            "unstamped_v1": "ValueError"}[case]
    assert _outcome(jckpt.load_step, tmp_path) == want
    assert _outcome(ckpt.load_step, tmp_path) == want


def test_sharded_generation_is_refused_not_misread(tmp_path):
    """A step that a multi-process JAX run committed as a sharded
    generation is read, never misread (the port refused it before
    ROADMAP A12): its two hosts' halves merge into the full tau, as JAX's
    loader merges them; a single file saved after it wins over it, and
    the commit pointer it supersedes is retired."""
    from test_topology_resume import _write_generation

    full = np.arange(24.0, dtype=np.float32)
    _write_generation(tmp_path, full)
    for load in (jckpt.load_step, ckpt.load_step):
        params, _, extra = load(str(tmp_path), "step2")
        np.testing.assert_array_equal(params["tau_raw"], full)
        assert int(extra["meta.num_iters"]) == 10
    _save_dummy("port", tmp_path, 5.0)
    assert not (tmp_path / "pert_step2.commit.json").exists()
    for load in (jckpt.load_step, ckpt.load_step):
        params, _, _ = load(str(tmp_path), "step2")
        assert float(params["tau_raw"][0]) == 5.0


def test_quarantine_stale_matches_jax(tmp_path):
    for pkg in ("jax", "port"):
        d = tmp_path / pkg
        _save_dummy(pkg, d, 1.0)
        _save_dummy(pkg, d, 2.0)
    assert jckpt.quarantine_stale(str(tmp_path / "jax")) \
        == ckpt.quarantine_stale(str(tmp_path / "port")) == 2
    assert sorted(p.name for p in (tmp_path / "jax").iterdir()) \
        == sorted(p.name for p in (tmp_path / "port").iterdir())


# ---------------------------------------------------------------------------
# identity: the manifest, the data fingerprint and the config hash
# ---------------------------------------------------------------------------


def test_manifest_roundtrip_and_match(tmp_path):
    a = np.arange(100, dtype=np.float32).reshape(10, 10)
    fp = manifest_mod.data_fingerprint(a)
    assert fp == jmanifest.data_fingerprint(a)
    b = a.copy()
    b[3, 3] += 1.0
    assert fp != manifest_mod.data_fingerprint(b)
    assert fp != manifest_mod.data_fingerprint(a.astype(np.float64))
    m = manifest_mod.RunManifest(tmp_path)
    m.begin_run("cfg123", fp, run_log_path="run.jsonl")
    m.update_step("step1", "complete", num_iters=40)
    jm = jmanifest.RunManifest.load(tmp_path)   # JAX reads the port's
    assert jm.match("cfg123", fp) == (True, "data fingerprint verified")
    assert jm.step("step1")["status"] == "complete"
    m2 = manifest_mod.RunManifest.load(tmp_path)
    assert m2.match("cfg123", "deadbeef")[0] is False
    ok, reason = m2.match("other-config", fp)
    assert ok and "config hash differs" in reason
    (tmp_path / manifest_mod.MANIFEST_NAME).write_text("{not json")
    assert manifest_mod.RunManifest.load(tmp_path).match("x", "y")[0] \
        is False


def test_unported_fields_are_the_jax_fields_the_port_lacks():
    """UNPORTED_FIELDS holds exactly the JAX PertConfig fields the port
    does not carry, each at its JAX default."""
    import dataclasses

    jax_fields = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port_fields = {f.name for f in dataclasses.fields(PertConfig)}
    assert set(UNPORTED_FIELDS) == set(jax_fields) - port_fields
    assert port_fields <= set(jax_fields)
    for name, (default, _) in UNPORTED_FIELDS.items():
        assert jax_fields[name] == default, name


DURABLE = dict(checkpoint_dir="/data/ck", resume="force",
               checkpoint_every=2, faults="preempt@step2/chunk#3",
               retry_max_attempts=3, retry_backoff_seconds=0.25,
               watchdog_compile_seconds=30.0, watchdog_chunk_seconds=5.0,
               heartbeat_dir="/data/hb", heartbeat_interval_seconds=1.0,
               max_iter=300, optimizer_state_dtype="bfloat16")


@pytest.mark.parametrize("kw", [{}, DURABLE], ids=["default", "durable"])
def test_config_digest_equals_jax(kw):
    assert _config_digest(PertConfig(**kw)) == jdigest(JaxConfig(**kw))


@pytest.mark.parametrize("kw", [{}, dict(checkpoint_every=2,
                                         watchdog_chunk_seconds=60.0)],
                         ids=["default", "durable"])
def test_runner_identity_verifies_across_packages(synthetic_frames,
                                                  tmp_path, kw):
    """The JAX runner records its identity; the port's runner on the
    same frames reads the same data fingerprint.  The JAX runner keeps
    its persistent compilation cache off (as every JAX run of these
    tests), a field the port hashes at its default 'auto', so the two
    config hashes are each package's digest of its own setting."""
    d = str(tmp_path / "ck")
    js, jg, jci = dense_inputs_from_frames(synthetic_frames)
    jcfg = JaxConfig(checkpoint_dir=d, telemetry_path=None,
                     compile_cache_dir=None, **kw)
    JaxInference(js, jg, jcfg, clone_idx_s=jci, clone_idx_g1=jci,
                 num_clones=2)
    s, g1, ci = port_inputs(synthetic_frames)
    for a, b in ((s.reads, js.reads), (s.states, js.states),
                 (g1.reads, jg.reads), (g1.states, jg.states)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert s.rt_prior is None and js.rt_prior is None
    cfg = PertConfig(checkpoint_dir=d, telemetry_path=None, **kw)
    inf = PertInference(s, g1, cfg, clone_idx_s=ci, clone_idx_g1=ci,
                        num_clones=2, device="cpu")
    assert inf._resume_ok
    assert inf._resume_reason.startswith("data verified; config hash "
                                         f"differs (manifest "
                                         f"{jdigest(jcfg)}, current "
                                         f"{_config_digest(cfg)})")
    assert _config_digest(cfg) == jdigest(JaxConfig(
        checkpoint_dir=d, telemetry_path=None, **kw))
    doc = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert doc["hash_excludes"] == sorted(
        __import__("scdna_replication_tools_tpu.config", fromlist=["x"])
        .NON_HASH_FIELDS)
    assert len(doc["runs"]) == 2


# ---------------------------------------------------------------------------
# the cross-package resume
# ---------------------------------------------------------------------------

# the resilience configuration at 1e3 prior concentrations (the
# trajectory tolerance's regime); the JAX side keeps its persistent
# compilation cache off, as every JAX run of the port's tests does
XBASE = dict(BASE, cn_prior_weight=1e3)
KILL = "preempt@step2/chunk#3"


def run_jax(frames, **kw):
    s, g1, ci = dense_inputs_from_frames(frames)
    inf = JaxInference(s, g1, JaxConfig(**{**XBASE, "compile_cache_dir": None,
                                           **kw}),
                       clone_idx_s=ci, clone_idx_g1=ci, num_clones=2)
    return inf.run()


@pytest.fixture(scope="module")
def uninterrupted(synthetic_frames):
    """Each package's uninterrupted run of the configuration."""
    jsteps = run_jax(synthetic_frames)
    _, tsteps = run_port(synthetic_frames, PertConfig(**XBASE))
    return {"jax": jsteps, "port": tsteps}


def _decisions(fit, since):
    return [(d["action"], d["iter"], d["budget"]) for d in fit.decisions
            if d["iter"] > since]


def _tracks(got, want):
    """tests/test_torch_fit.py's trajectory bar: every loss within 1e-5
    of the trajectory's largest magnitude."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err <= 1e-5, err


@pytest.mark.parametrize("killed,resumer", [("jax", "port"),
                                            ("port", "jax")])
def test_cross_package_resume(synthetic_frames, uninterrupted, tmp_path,
                              killed, resumer):
    d = str(tmp_path / "ck")
    durable = dict(checkpoint_dir=d, checkpoint_every=2)
    log = tmp_path / "resumed.jsonl"
    if killed == "jax":
        with pytest.raises(jfaults.SimulatedPreemption):
            run_jax(synthetic_frames, faults=KILL, **durable)
        _, (r1, r2, _) = run_port(synthetic_frames, PertConfig(**{
            **XBASE, **durable, "telemetry_path": str(log)}))
    else:
        with pytest.raises(faults.SimulatedPreemption):
            run_port(synthetic_frames, PertConfig(**{**XBASE, **durable,
                                                     "faults": KILL}))
        r1, r2, _ = run_jax(synthetic_frames, telemetry_path=str(log),
                            **durable)
    resumes = {e["step"]: e for e in events_of(log)
               if e["event"] == "resume"}
    assert resumes["step1"]["action"] == "restored"
    assert resumes["step2"]["action"] == "resumed"
    assert resumes["step2"]["from_iter"] == 50
    assert all(e["fingerprint_verified"] for e in resumes.values())
    assert not any(e["resharded"] for e in resumes.values())
    g1, g2, _ = uninterrupted[killed]
    # the killed package's step 1 is restored from its file, bit for bit
    np.testing.assert_array_equal(np.asarray(r1.fit.losses),
                                  np.asarray(g1.fit.losses))
    # the prefix of step 2 is the killed run's own, the rest continues
    # the killed package's trajectory
    got, want = np.asarray(r2.fit.losses), np.asarray(g2.fit.losses)
    np.testing.assert_array_equal(got[:50], want[:50])
    _tracks(got, want)
    assert _decisions(r2.fit, 50) == _decisions(g2.fit, 50)
    assert r2.fit.num_iters == g2.fit.num_iters


def test_jax_runs_leave_the_compile_cache_alone():
    """No JAX run of this module switched on the persistent compilation
    cache (its default 'auto' does so for the whole process, and the
    later tests of the same worker would read programs other workers
    wrote there)."""
    assert jax.config.jax_compilation_cache_dir == _CACHE_DIR_AT_IMPORT
