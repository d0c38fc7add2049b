"""The port's durable runs, continued from tests/test_torch_resilience.py
(same configuration, same uninterrupted run): corrupt saves degrading to
the retained previous checkpoint or to a refit, the fingerprint gate,
``resume='off'``, a grown budget, the ``resume`` value check, the
chunk watchdog and the emergency save's exact and degraded forms.  A first run that only has to leave step 1 behind is
preempted at ``step2/start``.
"""

import json
import threading

import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu_torch.config import PertConfig
from scdna_replication_tools_tpu_torch.infer import svi
from scdna_replication_tools_tpu_torch.infer.runner import PertInference
from scdna_replication_tools_tpu_torch.utils import faults

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_resilience import (  # noqa: F401
    BASE,
    _clear_fault_plan,
    assert_golden,
    events_of,
    golden,
    port_inputs,
    run_port,
)


def test_corrupted_saves_degrade_to_refit(golden, synthetic_frames,
                                          tmp_path):
    """Every step-2 write corrupted: the resume run detects it (typed,
    audited) and refits step 2, landing on the uninterrupted run."""
    _run = run_port(synthetic_frames, PertConfig(
        checkpoint_dir=str(tmp_path), faults="corrupt@step2/save#*", **BASE))
    del _run
    _, (r1, r2, _) = run_port(synthetic_frames, PertConfig(**{
        **BASE, "checkpoint_dir": str(tmp_path),
        "telemetry_path": str(tmp_path / "r.jsonl")}))
    assert_golden(r1, r2, golden)
    events = events_of(tmp_path / "r.jsonl")
    assert any(e["event"] == "degrade"
               and e["action"] == "checkpoint_discarded" for e in events)


def test_corrupt_newest_save_falls_back_to_the_previous(golden,
                                                        synthetic_frames,
                                                        tmp_path):
    """Only the step-end save corrupted: the resume falls back to the
    retained in-fit checkpoint (.prev) and resumes from there."""
    with pytest.raises(faults.SimulatedPreemption):
        run_port(synthetic_frames, PertConfig(
            checkpoint_dir=str(tmp_path), checkpoint_every=2,
            faults="corrupt@step2/save#2,preempt@step2/end", **BASE))
    _, (r1, r2, _) = run_port(synthetic_frames, PertConfig(**{
        **BASE, "checkpoint_dir": str(tmp_path), "checkpoint_every": 2,
        "telemetry_path": str(tmp_path / "r.jsonl")}))
    assert_golden(r1, r2, golden)
    step2 = [e for e in events_of(tmp_path / "r.jsonl")
             if e["event"] == "resume" and e["step"] == "step2"]
    assert step2[0]["action"] == "resumed" and step2[0]["from_iter"] == 50


def test_fingerprint_mismatch_blocks_resume(synthetic_frames, tmp_path):
    """Checkpoints fitted to OTHER data are not restored under
    resume='auto': they are quarantined and step 1 refits."""
    cfg = PertConfig(checkpoint_dir=str(tmp_path), **BASE)
    with pytest.raises(faults.SimulatedPreemption):
        run_port(synthetic_frames, PertConfig(
            checkpoint_dir=str(tmp_path), faults="preempt@step2/start",
            **BASE))
    s, g1, clone_idx = port_inputs(synthetic_frames)
    s.reads[0, :] += 7.0   # different data, same shapes
    inf2 = PertInference(s, g1, cfg, clone_idx_s=clone_idx,
                         clone_idx_g1=clone_idx, num_clones=2, device="cpu")
    assert not inf2._resume_ok and "mismatch" in inf2._resume_reason
    assert [p.name for p in tmp_path.glob("*.stale")] \
        == ["pert_step1.npz.stale"]
    assert json.loads((tmp_path / "manifest.json").read_text())["steps"] \
        == {}
    assert inf2.run_step1().wall_time > 0   # refit, not restored


def test_resume_with_grown_budget_continues_the_fit(synthetic_frames,
                                                    tmp_path):
    """A fit that exhausted a small budget un-converged RESUMES under a
    larger max_iter and runs the growth."""
    base = {**BASE, "controller_max_extra_iters": 0,
            "controller_stop_patience": 0}
    _, (_, a2, _) = run_port(synthetic_frames, PertConfig(
        checkpoint_dir=str(tmp_path), **{**base, "max_iter": 50}))
    assert a2.fit.num_iters == 50 and not a2.fit.converged
    _, (_, b2, _) = run_port(synthetic_frames, PertConfig(
        checkpoint_dir=str(tmp_path), **{**base, "max_iter": 75}))
    assert b2.fit.num_iters == 75
    np.testing.assert_array_equal(b2.fit.losses[:50], a2.fit.losses)


def test_invalid_resume_value_rejected_before_manifest_mutation(
        synthetic_frames, tmp_path):
    s, g1, clone_idx = port_inputs(synthetic_frames)
    cfg = PertConfig(checkpoint_dir=str(tmp_path), **BASE)
    PertInference(s, g1, cfg, clone_idx_s=clone_idx, clone_idx_g1=clone_idx,
                  num_clones=2, device="cpu")
    before = (tmp_path / "manifest.json").read_text()
    with pytest.raises(ValueError, match="resume"):
        PertInference(s, g1, PertConfig(checkpoint_dir=str(tmp_path),
                                        resume="no", **BASE),
                      clone_idx_s=clone_idx, clone_idx_g1=clone_idx,
                      num_clones=2, device="cpu")
    assert (tmp_path / "manifest.json").read_text() == before


def test_resume_off_refits(golden, synthetic_frames, tmp_path):
    with pytest.raises(faults.SimulatedPreemption):
        run_port(synthetic_frames, PertConfig(
            checkpoint_dir=str(tmp_path), faults="preempt@step2/start",
            **BASE))
    _, (r1, r2, _) = run_port(synthetic_frames, PertConfig(
        checkpoint_dir=str(tmp_path), resume="off", **BASE))
    assert r1.wall_time > 0 and r2.wall_time > 0
    assert_golden(r1, r2, golden)


def test_chunk_watchdog_aborts_resumably(golden, synthetic_frames, tmp_path,
                                         monkeypatch):
    """A step-2 chunk that stalls past ``watchdog_chunk_seconds`` raises
    WatchdogTimeout, audited as ``degrade watchdog_abort``; the emergency
    save it leaves resumes onto the uninterrupted run."""
    import time as _time

    orig = svi._launch_chunk
    stalls = []
    abandoned = threading.Event()

    def stalled(loss_fn, loss_args, carry, i0, *rest, **kw):
        # step 2's third chunk (step 2 fits pi_logits, step 1 does not)
        if "pi_logits" in carry.params and i0 == 50 and not stalls:
            stalls.append(i0)
            _time.sleep(6.0)
            try:
                return orig(loss_fn, loss_args, carry, i0, *rest, **kw)
            finally:
                abandoned.set()
        return orig(loss_fn, loss_args, carry, i0, *rest, **kw)

    monkeypatch.setattr(svi, "_launch_chunk", stalled)
    # a step-2 chunk takes about a second here: the deadline leaves it
    # room under load, the stall does not
    cfg = dict(BASE, checkpoint_dir=str(tmp_path / "ck"),
               checkpoint_every=0, watchdog_chunk_seconds=4.0)
    with pytest.raises(faults.WatchdogTimeout):
        run_port(synthetic_frames, PertConfig(**{
            **cfg, "telemetry_path": str(tmp_path / "w.jsonl")}))
    monkeypatch.setattr(svi, "_launch_chunk", orig)
    events = events_of(tmp_path / "w.jsonl")
    assert any(e["event"] == "degrade" and e["action"] == "watchdog_abort"
               and e["error_class"] == "hang" for e in events)
    saves = [e for e in events if e["event"] == "checkpoint"
             and e["step"] == "step2"]
    assert [e["num_iters"] for e in saves] == [50]
    # the abandoned chunk runs on in its thread, on its own tensors
    _, (r1, r2, _) = run_port(synthetic_frames, PertConfig(**cfg))
    assert_golden(r1, r2, golden)
    # a daemon thread still inside PyTorch at interpreter exit aborts
    # the process: let it finish
    assert abandoned.wait(60.0)


class _Unreadable:
    """A device state that cannot be copied to the host (a CUDA error
    leaves the context unusable)."""

    def __array__(self, *args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


def _snap(params, **kw):
    snap = dict(params=params, opt_state=None,
                losses_np=np.arange(60, dtype=np.float32), i_host=50,
                best_params={"x": torch.ones(3)}, best_it=25,
                best_loss=1.0, diag=np.ones((64, 3), np.float32),
                diag_i0=0, reseeds=0, extra_granted=0, nan_retries=0,
                lr=0.05, budget=100, stagnation_anchor=0,
                prev_verdict=None)
    snap.update(kw)
    return snap


@pytest.mark.parametrize("readable", [True, False],
                         ids=["live", "unreadable"])
def test_emergency_save_is_exact_or_degrades(readable):
    """The snapshot's live state saves exactly at its boundary; when it
    cannot be read the save rewinds to the best-loss params without Adam
    state (exact=False) and restarts the ring there, as JAX's does."""
    from scdna_replication_tools_tpu_torch.infer.svi import make_opt_state

    saved = {}
    live = {"x": torch.full((3,), 2.0)}
    snap = _snap(live if readable else {"x": _Unreadable()},
                 opt_state=make_opt_state(live))
    svi._emergency_save(lambda **kw: saved.update(kw), snap)
    if readable:
        assert saved["exact"] and saved["num_iters"] == 50
        assert torch.equal(saved["params"]["x"], live["x"])
        assert saved["state"]["diag"].all()
        assert saved["state"]["diag_i0"] == 0
    else:
        assert saved["exact"] is False and saved["opt_state"] is None
        assert saved["num_iters"] == 25
        assert torch.equal(saved["params"]["x"], torch.ones(3))
        assert not saved["state"]["diag"].any()
        assert saved["state"]["diag_i0"] == 25
    np.testing.assert_array_equal(saved["losses"],
                                  np.arange(saved["num_iters"]))


def test_inexact_save_is_audited_and_resumes_without_moments(
        synthetic_frames, tmp_path):
    """The runner's checkpoint sink audits an inexact save as ``degrade
    inexact_checkpoint``; its file resumes as a partial step with fresh
    Adam moments."""
    from scdna_replication_tools_tpu_torch.obs import runlog

    s, g1, ci = port_inputs(synthetic_frames)
    inf = PertInference(s, g1, PertConfig(checkpoint_dir=str(tmp_path),
                                          **BASE),
                        clone_idx_s=ci, clone_idx_g1=ci, num_clones=2,
                        device="cpu")
    log = runlog.RunLog(str(tmp_path / "i.jsonl"))
    with log.session():
        inf.run_log = runlog.current()
        inf._checkpoint_cb("step1")(
            params={"tau_raw": torch.zeros(48)},
            opt_state=None, losses=np.arange(25, dtype=np.float32),
            num_iters=25, state=dict(
                _snap(None), best_params=None,
                diag=np.zeros((64, 3), np.float32), diag_i0=25),
            exact=False)
    events = events_of(tmp_path / "i.jsonl")
    assert [e["action"] for e in events if e["event"] == "degrade"] \
        == ["inexact_checkpoint"]
    assert json.loads((tmp_path / "manifest.json").read_text())[
        "steps"]["step1"]["exact"] is False
    loaded = inf._load_resumable("step1", 100, None, None, None)
    params0, opt_state0, prefix, ctrl = loaded
    assert opt_state0 is None and len(prefix) == 25
    assert ctrl["best_loss"] == float("inf")   # no best params saved
