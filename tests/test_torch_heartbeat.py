"""The port's heartbeat writer (``obs/heartbeat.py``: ``HeartbeatFile``,
``RunHeartbeat``, the seam) in the cases of JAX's tests/test_watch.py
writer tests, with the JAX package's read side (``read_heartbeat``,
``freshness``, ``scan_health``, ``aggregate_health``) reading the files
the port wrote; and the live heartbeat of a port run with
``checkpoint_dir`` (``heartbeat_dir='auto'``).
"""

import json
import time

import pytest

from scdna_replication_tools_tpu.obs import heartbeat as jhb
from scdna_replication_tools_tpu_torch.config import PertConfig
from scdna_replication_tools_tpu_torch.obs import heartbeat as hb
from scdna_replication_tools_tpu_torch.obs import metrics as metrics_mod
from scdna_replication_tools_tpu_torch.utils.profiling import PhaseTimer

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_resilience import BASE, run_port


def test_heartbeat_file_seq_monotonic_and_resumes(tmp_path):
    path = tmp_path / "host_0.json"
    f = hb.HeartbeatFile(path)
    assert f.write({"a": 1}) == 1
    assert f.write({"a": 2}) == 2
    doc = json.loads(path.read_text())
    assert doc["seq"] == 2 and doc["a"] == 2
    assert doc["written_unix"] > 0
    # a restarted writer resumes the sequence, as does JAX's on the
    # port's file
    f2 = hb.HeartbeatFile(path)
    assert f2.write({"a": 3}) == 3
    assert jhb.HeartbeatFile(path).write({"a": 4}) == 4
    assert hb.HeartbeatFile(path).write({"a": 5}) == 5


def test_heartbeat_file_write_is_atomic_no_temp_litter(tmp_path):
    path = tmp_path / "host_0.json"
    f = hb.HeartbeatFile(path)
    for i in range(25):
        f.write({"payload": "x" * (i * 40), "i": i})
        assert json.loads(path.read_text())["i"] == i
    assert [p.name for p in tmp_path.iterdir()] == ["host_0.json"]


def test_heartbeat_file_never_raises_on_unwritable_path(tmp_path):
    (tmp_path / "blocker").write_text("a file where a dir must go")
    f = hb.HeartbeatFile(tmp_path / "blocker" / "host_0.json")
    assert f.write({"a": 1}) is None


def test_run_heartbeat_announces_immediately(tmp_path):
    rh = hb.RunHeartbeat(tmp_path, interval_seconds=60.0,
                         process_index=1, process_count=2)
    doc = jhb.read_heartbeat(hb.host_path(tmp_path, 1))
    assert doc["state"] == "running" and doc["seq"] == 1
    assert doc["process_count"] == 2
    assert doc["interval_seconds"] == 60.0
    assert jhb.freshness(doc, time.time()) == "fresh"
    rh.close("done")
    doc = jhb.read_heartbeat(hb.host_path(tmp_path, 1))
    assert doc["state"] == "done"
    assert jhb.freshness(doc, time.time() + 1e6) == "final"


def test_run_heartbeat_documents_have_jax_fields(tmp_path):
    """Every field JAX's writer puts in a document, the port's does."""
    hb.RunHeartbeat(tmp_path / "port", interval_seconds=1.0)
    jhb.RunHeartbeat(tmp_path / "jax", interval_seconds=1.0)
    port = jhb.read_heartbeat(hb.host_path(tmp_path / "port", 0))
    ref = jhb.read_heartbeat(jhb.host_path(tmp_path / "jax", 0))
    assert sorted(port) == sorted(ref)
    assert port["kind"] == jhb.HEARTBEAT_KIND
    assert port["version"] == jhb.HEARTBEAT_VERSION


def test_run_heartbeat_eta_projection_sane(tmp_path):
    rh = hb.RunHeartbeat(tmp_path, interval_seconds=0.0)
    rh.note_chunk(step="step2", chunk=1, iteration=25, budget=100,
                  wall_seconds=0.5, iters=25, action="continue",
                  verdict="improving")
    rh.pump(force=True)
    doc1 = jhb.read_heartbeat(hb.host_path(tmp_path, 0))
    assert doc1["ms_per_iter_ewma"] == pytest.approx(20.0)
    assert doc1["eta_seconds"] == pytest.approx(1.5)
    rh.note_chunk(step="step2", chunk=2, iteration=75, budget=100,
                  wall_seconds=1.0, iters=50, action="continue",
                  verdict="improving")
    rh.pump(force=True)
    doc2 = jhb.read_heartbeat(hb.host_path(tmp_path, 0))
    assert 0.0 < doc2["eta_seconds"] < doc1["eta_seconds"]
    assert doc2["trail"][-1] == "it75:continue/improving"
    rh.note_chunk(iteration=100, budget=100)
    rh.pump(force=True)
    assert jhb.read_heartbeat(
        hb.host_path(tmp_path, 0))["eta_seconds"] == 0.0


def test_run_heartbeat_throttle_and_fault_event_force(tmp_path):
    rh = hb.RunHeartbeat(tmp_path, interval_seconds=3600.0)
    seq0 = jhb.read_heartbeat(hb.host_path(tmp_path, 0))["seq"]
    rh.note_chunk(step="step2", chunk=1, iteration=5, budget=10)
    assert jhb.read_heartbeat(hb.host_path(tmp_path, 0))["seq"] == seq0
    rh.observe_event("retry", {})
    doc = jhb.read_heartbeat(hb.host_path(tmp_path, 0))
    assert doc["seq"] == seq0 + 1
    assert doc["faults"] == {"retry": 1}
    assert doc["iteration"] == 5
    rh.observe_event("fit_end", {})
    assert jhb.read_heartbeat(hb.host_path(tmp_path, 0))["seq"] == seq0 + 1


def test_run_heartbeat_samples_installed_registry(tmp_path):
    reg = metrics_mod.MetricsRegistry()
    metrics_mod.install(reg)
    try:
        reg.gauge("pert_device_hbm_peak_bytes").set(123.0)
        reg.counter("pert_retries_total").inc(2)
        reg.counter("pert_fit_iters_total").inc(50)  # not sampled
        rh = hb.RunHeartbeat(tmp_path, interval_seconds=0.0)
        rh.pump(force=True)
        doc = jhb.read_heartbeat(hb.host_path(tmp_path, 0))
        assert doc["metrics"]["pert_device_hbm_peak_bytes"] == 123.0
        assert doc["metrics"]["pert_retries_total"] == 2
        assert "pert_fit_iters_total" not in doc["metrics"]
        rh.note_chunk(step="s", chunk=1, iteration=50, budget=100,
                      wall_seconds=1.0, iters=50)
        rh.pump(force=True)
        snap = reg.snapshot(stable_only=False)
        assert snap["pert_run_eta_seconds"]["value"] == pytest.approx(1.0)
    finally:
        metrics_mod.uninstall(reg)


def test_module_seam_and_phase_sink_chain(tmp_path):
    rh = hb.RunHeartbeat(tmp_path, interval_seconds=0.0)
    hb.install(rh)
    try:
        assert hb.current() is rh
        hb.note_chunk(step="step2", chunk=2, iteration=9, budget=10)
        rh.pump(force=True)
        assert jhb.read_heartbeat(
            hb.host_path(tmp_path, 0))["iteration"] == 9
        timer = PhaseTimer()
        calls = []
        timer.on_add = lambda n, s: calls.append(n)
        hb.attach_phase_sink(timer)
        hb.attach_phase_sink(timer)  # re-attach is a no-op
        timer.on_add("load", 0.1)
        assert calls == ["load"]
        rh.pump(force=True)
        assert jhb.read_heartbeat(
            hb.host_path(tmp_path, 0))["phase"] == "load"
    finally:
        hb.uninstall(rh)
    hb.note_chunk(step="x")  # no-op once uninstalled
    assert hb.current() is None


def test_resolve_dir_auto_requires_checkpoint_dir(tmp_path):
    for setting, ck in (("auto", None), ("auto", str(tmp_path)),
                        (None, str(tmp_path)), ("off", str(tmp_path)),
                        (str(tmp_path / "h"), None)):
        assert hb.resolve_dir(setting, ck) == jhb.resolve_dir(setting, ck)
    assert hb.resolve_dir("auto", str(tmp_path)) == str(tmp_path / "health")


def test_jax_aggregates_port_heartbeats(tmp_path):
    """Two port writers as ranks 0 and 1 of one run: JAX's scan and
    aggregate read them as its own (straggler spread, states)."""
    a = hb.RunHeartbeat(tmp_path, interval_seconds=0.0, process_index=0,
                        process_count=2)
    b = hb.RunHeartbeat(tmp_path, interval_seconds=0.0, process_index=1,
                        process_count=2)
    a.note_chunk(step="step2", chunk=5, iteration=90, budget=100)
    b.note_chunk(step="step2", chunk=2, iteration=40, budget=100)
    a.pump(force=True)
    b.pump(force=True)
    assert [r["rank"] for r in jhb.scan_health(tmp_path)] == [0, 1]
    agg = jhb.aggregate_health(tmp_path, now=time.time())
    assert agg["straggler_spread_chunks"] == 3
    assert agg["straggler_spread_iters"] == 50
    assert agg["missing_ranks"] == [] and agg["desync"] is False
    a.close("done")
    b.close("done")
    agg = jhb.aggregate_health(tmp_path, now=time.time())
    assert agg["worst_freshness"] == "final"
    assert agg["states"] == {"done": 2}


def test_run_writes_a_live_heartbeat_under_checkpoint_dir(synthetic_frames,
                                                         tmp_path):
    """A run with checkpoint_dir writes health/host_0.json: monotonic seq
    across a killed run and its resume, a verdict trail, and the final
    state done (the killed run's stays running, to go stale)."""
    from scdna_replication_tools_tpu_torch.utils import faults

    ck = tmp_path / "ck"
    path = hb.host_path(ck / "health", 0)
    cfg = dict(BASE, checkpoint_dir=str(ck), heartbeat_interval_seconds=0.0)
    with pytest.raises(faults.SimulatedPreemption):
        run_port(synthetic_frames, PertConfig(
            **cfg, faults="preempt@step2/chunk#3"))
    killed = jhb.read_heartbeat(path)
    assert killed["state"] == "running" and killed["step"] == "step2"
    assert killed["faults"] == {"fault_injected": 1}
    assert hb.current() is None
    run_port(synthetic_frames, PertConfig(**cfg))
    done = jhb.read_heartbeat(path)
    assert done["state"] == "done" and done["seq"] > killed["seq"]
    assert done["trail"] and done["config_digest"]
    assert jhb.freshness(done, time.time() + 1e6) == "final"
