"""The port's durable runs against the JAX package's: the fault plan, the
exception taxonomy, the retry ladder and the watchdog
(``utils/faults.py``), and the port's own kill-and-resume, retry, NaN
escalation and inert paths through ``PertInference`` on the CPU (the
corrupt-save, fingerprint, resume-mode, budget-growth and watchdog
paths are in tests/test_torch_resume.py).

Every chaos case runs the port twice or more on the synthetic frames of
tests/conftest.py and holds the resumed run to the port's own
uninterrupted run bit for bit, as JAX's tests/test_resilience.py holds
JAX's.  The configuration is JAX's ``BASE`` cut to keep the file short:
the controller on with a budget that is not pinned (so the chunked,
durable fit path runs), ``rel_tol=0`` (deterministic budgets), no mirror
rescue and no step 3.  The decode and PPC ladders (the packaging side)
and the two packages' checkpoint formats are in
tests/test_torch_degradation.py and tests/test_torch_checkpoint.py.
"""

import json

import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu.utils import faults as jfaults
from scdna_replication_tools_tpu_torch.config import ColumnConfig, PertConfig
from scdna_replication_tools_tpu_torch.data.loader import build_pert_inputs
from scdna_replication_tools_tpu_torch.infer.runner import PertInference
from scdna_replication_tools_tpu_torch.obs import runlog, schema
from scdna_replication_tools_tpu_torch.utils import faults

from test_torch_model import one_torch_thread  # noqa: F401

# JAX's BASE (tests/test_resilience.py) at shorter budgets and without the
# mirror rescue: step 1 runs 30 (+25) iterations, step 2 75 (+25), one
# chunk of 25 per host read
BASE = dict(cn_prior_method="g1_clones", rel_tol=0.0, run_step3=False,
            max_iter=75, min_iter=25, max_iter_step1=30,
            min_iter_step1=10, fit_diag_every=25,
            controller_max_extra_iters=25, mirror_rescue=False,
            telemetry_path=None)

# the run-log events of the durable layer
DURABLE_EVENTS = {"fault_injected", "retry", "degrade", "resume",
                  "checkpoint"}


@pytest.fixture(autouse=True)
def _clear_fault_plan():
    """No fault plan may leak across tests (runners install theirs)."""
    yield
    faults.install(None)


def port_frames(frames):
    """The synthetic frames with the reads and states that
    conftest.dense_inputs_from_frames gives them."""
    df_s, df_g = (df.copy() for df in frames)
    rng = np.random.default_rng(0)
    for df in (df_s, df_g):
        df["reads"] = rng.poisson(
            40 * df["true_somatic_cn"].to_numpy()).astype(float)
        df["state"] = df["true_somatic_cn"].astype(int)
    return df_s, df_g


def port_inputs(frames):
    """(s, g1, clone_idx) through the port's loader, from the same frames
    as conftest.dense_inputs_from_frames gives the JAX package."""
    s, g1 = build_pert_inputs(*port_frames(frames),
                              ColumnConfig(rt_prior_col=None))
    return s, g1, np.array([0] * 12 + [1] * 12, np.int32)


def run_port(frames, config, inputs=None):
    s, g1, clone_idx = inputs or port_inputs(frames)
    inf = PertInference(s, g1, config, clone_idx_s=clone_idx,
                        clone_idx_g1=clone_idx, num_clones=2, device="cpu")
    return inf, inf.run()


def events_of(path):
    return [json.loads(line) for line in open(path).read().splitlines()]


@pytest.fixture(scope="module")
def golden(synthetic_frames, tmp_path_factory):
    """The uninterrupted run every chaos case compares to, with its log."""
    log = tmp_path_factory.mktemp("golden") / "golden.jsonl"
    inf, (step1, step2, _) = run_port(
        synthetic_frames, PertConfig(**{**BASE, "telemetry_path": str(log)}))
    return inf, step1, step2, log


# ---------------------------------------------------------------------------
# the fault plan: grammar and schedule, against JAX's FaultPlan
# ---------------------------------------------------------------------------

SITES = ["step2/chunk", "compile", "pkg/decode", "step2/save", "step1/fit",
         "qc/ppc"] * 6


@pytest.mark.parametrize("spec", [
    "preempt@step2/chunk#3,nan@step2/chunk#5,hang@compile#2:0.01,"
    "oom@pkg/decode#1-2,corrupt@step2/save#*",
    "transient@step1/fit",
    "hostloss@step2/chunk#2-3,oom@qc/ppc#*@proc*",
    "preempt@step2/chunk#2@proc0,nan@step2/chunk#4@proc1",
    "corrupt@step2/save#2-4, nan@step2/chunk#6",
])
def test_fault_schedule_matches_jax(spec):
    """The same rules parse, and the same hits fire with the same kind,
    in both packages; the audit trails agree."""
    tplan = faults.FaultPlan.from_spec(spec)
    jplan = jfaults.FaultPlan.from_spec(spec)
    assert [(r.kind, r.site, r.first, r.last, r.arg, r.proc)
            for r in tplan.rules] \
        == [(r.kind, r.site, r.first, r.last, r.arg, r.proc)
            for r in jplan.rules]
    got = [getattr(tplan.check(site), "kind", None) for site in SITES]
    want = [getattr(jplan.check(site), "kind", None) for site in SITES]
    assert got == want and any(got)
    assert tplan.fired == jplan.fired


@pytest.mark.parametrize("spec", ["explode@somewhere", "preempt-no-site",
                                  "preempt@", "nan@x#2@node3"])
def test_fault_spec_rejects_garbage_as_jax_does(spec):
    with pytest.raises(ValueError):
        jfaults.FaultPlan.from_spec(spec)
    with pytest.raises(ValueError):
        faults.FaultPlan.from_spec(spec)


def test_point_is_inert_without_a_plan():
    faults.install(None)
    assert faults.point("anything") is None


def test_resolve_plan_env_fallback(monkeypatch):
    monkeypatch.setenv(faults.ENV_VAR, "preempt@x")
    plan = faults.resolve_plan(None)
    assert plan is not None and plan.rules[0].site == "x"
    assert faults.resolve_plan("off") is None
    monkeypatch.delenv(faults.ENV_VAR)
    assert faults.resolve_plan(None) is None


def test_point_raises_and_audits_each_kind(tmp_path):
    """Each raising kind raises its typed exception after a
    ``fault_injected`` event lands on the open log."""
    log = runlog.RunLog(str(tmp_path / "f.jsonl"))
    raising = {"preempt": faults.SimulatedPreemption,
               "oom": faults.SimulatedResourceExhausted,
               "transient": faults.SimulatedTransientError,
               "hostloss": faults.SimulatedHostLoss}
    with log.session():
        for kind, exc in raising.items():
            faults.install(faults.FaultPlan.from_spec(f"{kind}@s"))
            with pytest.raises(exc):
                faults.point("s")
        faults.install(faults.FaultPlan.from_spec("nan@s,corrupt@t"))
        assert faults.point("s") == "nan" and faults.point("t") == "corrupt"
    fired = [e for e in events_of(tmp_path / "f.jsonl")
             if e["event"] == "fault_injected"]
    assert [e["kind"] for e in fired] == list(raising) + ["nan", "corrupt"]
    assert schema.validate_run(tmp_path / "f.jsonl") == []


# ---------------------------------------------------------------------------
# exception taxonomy, retry, watchdog
# ---------------------------------------------------------------------------

SHARED = [
    (faults.SimulatedPreemption("s", 1), "preemption"),
    (KeyboardInterrupt(), "preemption"),
    (faults.WatchdogTimeout("fit", 1.0), "hang"),
    (faults.SimulatedResourceExhausted("s", 1), "oom"),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating 2.8G"),
     "oom"),
    (MemoryError(), "oom"),
    (RuntimeError("CUDA out of memory. Tried to allocate 2.00 GiB"), "oom"),
    (RuntimeError("UNAVAILABLE: connection to worker lost"), "transient"),
    (ConnectionResetError("peer"), "transient"),
    (TimeoutError(), "transient"),
    (faults.SimulatedTransientError("s", 1), "transient"),
    (RuntimeError("DATA_LOSS: checkpoint shard gone"), "hostloss"),
    (RuntimeError("device lost: the system has halted"), "hostloss"),
    (faults.SimulatedHostLoss("s", 1), "hostloss"),
    (ValueError("bad shape"), "deterministic"),
    (RuntimeError("CUDA error: an illegal memory access was encountered"),
     "deterministic"),
]


@pytest.mark.parametrize("exc,kind", SHARED,
                         ids=[k + str(i) for i, (_, k) in enumerate(SHARED)])
def test_classify_exception_matches_jax(exc, kind):
    """The port's taxonomy is JAX's on every error both can raise (the
    simulated exceptions cross over by message and base class)."""
    assert faults.classify_exception(exc) == kind
    jexc = exc
    if isinstance(exc, faults.SimulatedPreemption):
        jexc = jfaults.SimulatedPreemption("s", 1)
    elif isinstance(exc, faults.WatchdogTimeout):
        jexc = jfaults.WatchdogTimeout("fit", 1.0)
    elif isinstance(exc, faults.SimulatedHostLoss):
        jexc = jfaults.SimulatedHostLoss("s", 1)
    assert jfaults.classify_exception(jexc) == kind


def test_classify_torch_out_of_memory_is_oom():
    """PyTorch's own OOM signal, whatever its message."""
    assert faults.classify_exception(
        torch.cuda.OutOfMemoryError("allocator refused")) == "oom"


def test_retry_call_retries_transient_with_backoff(tmp_path):
    sleeps = []
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise TimeoutError("transient blip")
        return "ok"

    log = runlog.RunLog(str(tmp_path / "r.jsonl"))
    with log.session():
        out = faults.retry_call(flaky, label="t", max_attempts=3,
                                base_delay=0.25, sleep=sleeps.append)
    assert out == "ok" and calls["n"] == 3
    assert sleeps == [0.25, 0.5]   # deterministic exponential ladder
    retries = [e for e in events_of(tmp_path / "r.jsonl")
               if e["event"] == "retry"]
    assert [e["attempt"] for e in retries] == [1, 2]
    assert schema.validate_run(tmp_path / "r.jsonl") == []


def test_retry_call_never_retries_deterministic_errors():
    calls = {"n": 0}

    def broken():
        calls["n"] += 1
        raise ValueError("a real bug")

    with pytest.raises(ValueError):
        faults.retry_call(broken, label="t", max_attempts=5,
                          sleep=lambda _: None)
    assert calls["n"] == 1


def test_retry_call_bounded():
    calls = {"n": 0}

    def always():
        calls["n"] += 1
        raise TimeoutError("forever")

    with pytest.raises(TimeoutError):
        faults.retry_call(always, label="t", max_attempts=2,
                          sleep=lambda _: None)
    assert calls["n"] == 3   # 1 call + 2 retries


def test_run_with_deadline():
    import time as _time

    assert faults.run_with_deadline(lambda: 42, None, "x") == 42
    assert faults.run_with_deadline(lambda: 42, 5.0, "x") == 42
    with pytest.raises(faults.WatchdogTimeout, match="hung"):
        faults.run_with_deadline(lambda: _time.sleep(2.0), 0.05, "x")

    def boom():
        raise ValueError("inner")

    with pytest.raises(ValueError, match="inner"):
        faults.run_with_deadline(boom, 5.0, "x")


def test_run_with_deadline_carries_the_callers_seams(tmp_path):
    """The worker thread fires fault points on the caller's plan and
    emits into the caller's log."""
    log = runlog.RunLog(str(tmp_path / "w.jsonl"))
    faults.install(faults.FaultPlan.from_spec("nan@w"))
    with log.session():
        assert faults.run_with_deadline(lambda: faults.point("w"), 5.0,
                                        "x", device="cpu") == "nan"
    assert [e["site"] for e in events_of(tmp_path / "w.jsonl")
            if e["event"] == "fault_injected"] == ["w"]


# ---------------------------------------------------------------------------
# chaos: kill-and-resume parity against the port's uninterrupted run
# ---------------------------------------------------------------------------


def assert_golden(r1, r2, golden):
    _, g1, g2, _ = golden
    np.testing.assert_array_equal(r1.fit.losses, g1.fit.losses)
    np.testing.assert_array_equal(r2.fit.losses, g2.fit.losses)
    for k, v in g2.fit.params.items():
        assert torch.equal(r2.fit.params[k], v), k


@pytest.mark.parametrize("site", ["step2/chunk#3", "step2/start"])
def test_kill_and_resume_parity(site, golden, synthetic_frames, tmp_path):
    """Preempt mid-fit or at a step boundary, rerun with resume='auto':
    losses and params bit-exact against the uninterrupted run, the
    decision trail a suffix of its, both logs valid and the killed one
    ending run_end 'error'."""
    _, _, g2, _ = golden
    durable = dict(checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=2)
    with pytest.raises(faults.SimulatedPreemption):
        run_port(synthetic_frames, PertConfig(**{
            **BASE, **durable, "faults": f"preempt@{site}",
            "telemetry_path": str(tmp_path / "killed.jsonl")}))
    _, (r1, r2, _) = run_port(synthetic_frames, PertConfig(**{
        **BASE, **durable, "telemetry_path": str(tmp_path / "resumed.jsonl")}))
    assert_golden(r1, r2, golden)
    g_trail = [(d["action"], d["iter"]) for d in g2.fit.decisions]
    r_trail = [(d["action"], d["iter"]) for d in r2.fit.decisions]
    assert r_trail == g_trail[len(g_trail) - len(r_trail):]
    for name in ("killed.jsonl", "resumed.jsonl"):
        assert schema.validate_run(tmp_path / name) == [], name
    killed = events_of(tmp_path / "killed.jsonl")
    assert any(e["event"] == "fault_injected" for e in killed)
    assert killed[-1]["event"] == "run_end" \
        and killed[-1]["status"] == "error"
    resumes = {e["step"]: e for e in events_of(tmp_path / "resumed.jsonl")
               if e["event"] == "resume"}
    assert resumes["step1"]["action"] == "restored"
    if site == "step2/chunk#3":
        assert resumes["step2"]["action"] == "resumed"
        assert resumes["step2"]["from_iter"] == 50
        assert resumes["step2"]["fingerprint_verified"] is True
    else:
        assert "step2" not in resumes
    manifest = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert {k: v["status"] for k, v in manifest["steps"].items()} \
        == {"step1": "complete", "step2": "complete"}
    health = json.loads((tmp_path / "ck" / "health" / "host_0.json")
                        .read_text())
    assert health["state"] == "done"


def test_injected_transient_failure_retries_and_resumes(golden,
                                                        synthetic_frames,
                                                        tmp_path):
    """A transient fault mid-fit is retried with backoff, and the retry
    RESUMES from the emergency checkpoint onto the uninterrupted run."""
    cfg = PertConfig(**{**BASE, "checkpoint_dir": str(tmp_path / "ck"),
                        "checkpoint_every": 2,
                        "retry_backoff_seconds": 0.01,
                        "faults": "transient@step2/chunk#3",
                        "telemetry_path": str(tmp_path / "t.jsonl")})
    _, (r1, r2, _) = run_port(synthetic_frames, cfg)
    assert_golden(r1, r2, golden)
    events = events_of(tmp_path / "t.jsonl")
    assert any(e["event"] == "retry" and e["label"] == "step2/fit"
               for e in events)
    assert any(e["event"] == "resume" and e["action"] == "resumed"
               and e["reason"].startswith("checkpoint written by this run")
               for e in events)
    assert schema.validate_run(tmp_path / "t.jsonl") == []


def test_injected_nan_drives_real_escalation_machinery(synthetic_frames,
                                                       tmp_path):
    """A nan fault poisons one chunk: the controller escalates through
    the diagnosable checkpoint and the reduced-LR retry, and finishes."""
    cfg = PertConfig(checkpoint_dir=str(tmp_path), checkpoint_every=0,
                     faults="nan@step2/chunk#2", **BASE)
    _, (_, s2, _) = run_port(synthetic_frames, cfg)
    esc = [d for d in s2.fit.decisions if d["action"] == "escalate"]
    assert esc and esc[0]["outcome"] == "retry"
    assert "checkpoint saved to" in esc[0]["detail"]
    assert not s2.fit.nan_abort          # the retry recovered
    assert (tmp_path / "pert_step2_nan.npz").exists()


def test_disabled_harness_is_inert(golden):
    """faults=None and no checkpoint_dir: the log carries no durable-run
    event and the run leaves no file but its log."""
    _, _, _, log = golden
    assert schema.validate_run(log) == []
    assert not [e for e in events_of(log) if e["event"] in DURABLE_EVENTS]
    assert sorted(p.name for p in log.parent.iterdir()) == [log.name]
