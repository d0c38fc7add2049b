"""A rank killed mid-fit, then the run resumed on one rank and on two: the
port's version of JAX ``tools/chaos_smoke.py --multiprocess``.

Two gloo ranks fit the synthetic frames with the durable config of
tests/test_torch_resilience.py and a checkpoint after every chunk;
``preempt@step2/chunk#2@proc1`` kills rank 1 at the top of step 2's
second chunk, just after the generation of step 2's first chunk was
committed.  With the elastic rung off (``elastic_mesh=False``;
tests/test_torch_elastic.py runs it on), rank 0's next collective fails
and it aborts too (within the collective timeout, never hanging); both
leave uncommitted emergency shards.  The committed generation survives; one rank resumes it with
``resume='auto'`` and lands within 5e-2 of the uninterrupted two-rank
trajectory, and two ranks resume it bit for bit.
"""

import json
import shutil
import time

import numpy as np
import pytest

from scdna_replication_tools_tpu_torch.config import PertConfig
from scdna_replication_tools_tpu_torch.infer import checkpoint as ckpt
from scdna_replication_tools_tpu_torch.infer.runner import PertInference
from scdna_replication_tools_tpu_torch.utils import faults

import torch_ranks
from test_torch_model import one_torch_thread  # noqa: F401

BASE = dict(cn_prior_method="g1_clones", rel_tol=0.0, run_step3=False,
            max_iter=75, min_iter=25, max_iter_step1=30, min_iter_step1=10,
            fit_diag_every=25, controller_max_extra_iters=25,
            mirror_rescue=False, telemetry_path=None, checkpoint_every=1)


@pytest.fixture(autouse=True)
def _clear_fault_plan():
    yield
    faults.install(None)


def _two_ranks(frames, tmp, **config):
    return torch_ranks.launch(2, torch_ranks.run_inference, {
        "frames": frames, "config": {**BASE, "num_shards": 2, **config}},
        tmp)


@pytest.fixture(scope="module")
def chaos(synthetic_frames, tmp_path_factory):
    root = tmp_path_factory.mktemp("chaos")
    golden, codes = _two_ranks(synthetic_frames, root / "golden",
                               checkpoint_dir=str(root / "golden_ck"))
    assert codes == [0, 0], golden
    killed_dir = root / "killed_ck"
    t0 = time.monotonic()
    killed, codes = _two_ranks(synthetic_frames, root / "killed",
                               checkpoint_dir=str(killed_dir),
                               faults="preempt@step2/chunk#2@proc1",
                               elastic_mesh=False)
    return {"golden": golden, "killed": killed, "codes": codes,
            "kill_seconds": time.monotonic() - t0, "dir": killed_dir,
            "root": root}


def test_killed_rank_ends_both_ranks_without_a_hang(chaos):
    """Rank 1 dies of the preemption; rank 0 ends with an error of its
    own, inside the launch's limit (each collective waits at most 30 s)."""
    assert chaos["codes"][0] != 0 and chaos["codes"][1] != 0
    assert "SimulatedPreemption" in chaos["killed"][1]["error"]
    assert "SimulatedPreemption" not in chaos["killed"][0]["error"]
    assert chaos["kill_seconds"] < torch_ranks.LAUNCH_TIMEOUT


def test_last_committed_generation_survives(chaos):
    d = chaos["dir"]
    doc = json.loads((d / "pert_step2.commit.json").read_text())
    assert doc["seq"] == 1 and doc["process_count"] == 2
    # the emergency shards of the kill are there, uncommitted
    assert (d / "pert_step2.s2.p1of2.npz").exists()
    _, losses, extra = ckpt.load_step(str(d), "step2")
    assert int(extra["meta.num_iters"]) == 25
    golden = chaos["golden"][0]["losses"][1]
    np.testing.assert_array_equal(np.asarray(losses)[:25], golden[:25])


def test_one_rank_resumes_the_sharded_generation(chaos, synthetic_frames):
    d = chaos["root"] / "one_rank_ck"
    shutil.copytree(chaos["dir"], d)
    s, g1, clone_idx = torch_ranks.port_inputs(synthetic_frames)
    inf = PertInference(s, g1, PertConfig(**{**BASE,
                                             "checkpoint_dir": str(d)}),
                        clone_idx_s=clone_idx, clone_idx_g1=clone_idx,
                        num_clones=2, device="cpu")
    assert inf._resume_ok, inf._resume_reason
    step1, step2, _ = inf.run()
    golden = chaos["golden"][0]["losses"]
    np.testing.assert_array_equal(step1.fit.losses, golden[0])
    np.testing.assert_array_equal(step2.fit.losses[:25], golden[1][:25])
    n = min(len(step2.fit.losses), len(golden[1]))
    rel = np.abs(step2.fit.losses[:n] - golden[1][:n]) \
        / np.abs(golden[1][:n])
    print(f"one-rank resume against the two-rank run: worst {rel.max():.3g}")
    assert len(step2.fit.losses) == len(golden[1])
    assert rel.max() < 5e-2, rel


def test_two_ranks_resume_bit_for_bit(chaos, synthetic_frames):
    d = chaos["root"] / "two_rank_ck"
    shutil.copytree(chaos["dir"], d)
    resumed, codes = _two_ranks(synthetic_frames, chaos["root"] / "resumed",
                                checkpoint_dir=str(d))
    assert codes == [0, 0], resumed
    for k in range(2):
        for r in resumed:
            np.testing.assert_array_equal(r["losses"][k],
                                          chaos["golden"][0]["losses"][k])
    np.testing.assert_array_equal(resumed[0]["tau"],
                                  chaos["golden"][0]["tau"])
