"""The elastic rung of sharded fits (JAX ``PertConfig.elastic_mesh``) in
the port: gloo ranks of ``tests/torch_ranks.launch`` fit the synthetic
frames with the durable config of tests/test_torch_sharded_chaos.py
through ``scRT`` and lose a rank (or run out of memory twice) in step 2;
the survivors re-form a smaller group and finish in the same ``infer``
call.

* the shrink rule is JAX ``parallel/mesh.shrink_mesh``'s, rung for rung,
  on JAX meshes of the same extents over the forced CPU devices, and the
  eligibility rule is JAX ``_shrink_eligible``'s with the port's own
  conditions;
* a lost rank 1 of 2 x 1 (raised, preempted, or the process killed
  outright, which nothing marks lost): rank 0
  ends on one rank with one ``degrade mesh_shrink`` and a resharded
  resume, its losses within 5e-2 of the uninterrupted two-rank run and
  its tau within the cross-topology parity of JAX's reshard tests;
* 2 x 2 losing rank 3, or rank 0: the survivors end on 1 x 2 and a
  standby rank, and all return the same frames; where rank 0 was lost,
  rank 1 commits the generations and continues its log;
* a repeated OOM on 2 x 2 gives JAX's own event sequence: a same-grid
  re-entry, then the shrink; a first OOM in each of two steps re-enters
  each step once, as JAX counts OOMs per step, on frames whose S cells
  (23) the 1 x 2 grid pads only because the launch grid's multiple is
  kept;
* a whole job preempted leaves rank 0's log closed and valid;
* ``elastic_mesh=False`` and a run without ``checkpoint_dir`` abort
  resumable, and the artifact resumes.

The spawned runs go two at a time in threads, so the file's wall is a
few launches'.  Losses are compared as tests/test_torch_sharded_chaos.py
compares its one-rank resume with the two-rank run (on 2 x 2 grids step
2's only: a sharded step 1 parts chaotically on these frames, ROADMAP
C).
"""

import concurrent.futures
import json
import shutil
import threading
import time

import jax
import numpy as np
import pytest
import torch.distributed

from scdna_replication_tools_tpu.config import PertConfig as JaxConfig
from scdna_replication_tools_tpu.infer.runner import \
    PertInference as JaxInference
from scdna_replication_tools_tpu.obs import metrics as jax_metrics
from scdna_replication_tools_tpu.obs.runlog import \
    _config_digest as jax_digest
from scdna_replication_tools_tpu.parallel import mesh as jax_mesh
from scdna_replication_tools_tpu.utils import faults as jax_faults

from scdna_replication_tools_tpu_torch.config import PertConfig
from scdna_replication_tools_tpu_torch.infer import checkpoint as ckpt
from scdna_replication_tools_tpu_torch.infer.runner import PertInference
from scdna_replication_tools_tpu_torch.obs import metrics as port_metrics
from scdna_replication_tools_tpu_torch.obs import runlog as port_runlog
from scdna_replication_tools_tpu_torch.obs.schema import validate_run
from scdna_replication_tools_tpu_torch.parallel import distributed as tdist
from scdna_replication_tools_tpu_torch.parallel.mesh import (
    RankMesh,
    grid_topology,
    shrink_grid,
    shrink_ladder,
)
from scdna_replication_tools_tpu_torch.utils import faults

import torch_ranks
from conftest import dense_inputs_from_frames
from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_sharded_chaos import BASE

# losses against the uninterrupted two-rank run (the chaos test's bar)
LOSS_TOL = 5e-2
# JAX's cross-topology tau parity (test_topology_resume._assert_tau_parity):
# every cell within 0.05 folded over the mirror, but for at most two
# boundary-extreme cells
TAU_TOL = 5e-2
TAU_OUTLIERS = 2


@pytest.fixture(autouse=True)
def _clear_fault_plan():
    yield
    faults.install(None)
    jax_faults.install(None)


def _odd(synthetic_frames):
    """The synthetic frames less their last S cell: 23 S cells, which a
    grid of two cells pads to 24 and a grid of one does not pad."""
    df_s, df_g = synthetic_frames
    last = df_s["cell_id"].iloc[-1]
    return df_s[df_s["cell_id"] != last].reset_index(drop=True), df_g


def _frames(synthetic_frames):
    """The synthetic frames as ``scRT`` reads them (reads, states and the
    ``copy`` column that the clone consensus reads)."""
    frames = torch_ranks.port_frames(synthetic_frames)
    for df in frames:
        df["copy"] = df["state"].astype(float)
    return frames


# (world, cells, loci, faults, options) of each spawned run; every run
# checkpoints into its own directory and logs into its own file
RUNS = {
    "golden": (2, 2, 1, None, {}),
    "hostloss": (2, 2, 1, "hostloss@step2/chunk#2@proc1", {}),
    "killed": (2, 2, 1, "preempt@step2/chunk#2@proc1", {}),
    # killed outright: nothing marks it lost, the meeting waits out the
    # settle window
    "exited": (2, 2, 1, None, {}),
    "lost3": (4, 2, 2, "hostloss@step2/chunk#2@proc3", {}),
    "lost0": (4, 2, 2, "hostloss@step2/chunk#2@proc0", {}),
    "oom": (4, 2, 2, "oom@step2/chunk#2-3@proc*", {}),
    "off": (2, 2, 1, "hostloss@step2/chunk#2@proc1",
            {"elastic_mesh": False}),
    "no_dir": (2, 2, 1, "hostloss@step2/chunk#2@proc1",
               {"checkpoint_dir": None}),
    "preempt_all": (2, 2, 1, "preempt@step2/chunk#2@proc*", {}),
    "oom_steps": (4, 2, 2, "oom@step1/chunk#2@proc*,"
                  "oom@step2/chunk#2-3@proc*", {}),
}
# runs on the frames less one S cell (ODD_FRAMES)
ODD = {"oom_steps"}


def _launch(name, frames, root):
    world, cells, loci, spec, extra = RUNS[name]
    d = root / name
    options = {**BASE, "num_shards": cells, "loci_shards": loci,
               "checkpoint_dir": str(d / "ck"),
               "telemetry_path": str(d / "run.jsonl"), **extra}
    if spec:
        options["faults"] = spec
    t0 = time.monotonic()
    results, codes = torch_ranks.launch(world, torch_ranks.run_elastic, {
        "frames": frames, "options": options,
        "exit_at": ("step2/chunk", 2, 1) if name == "exited" else None}, d)
    return {"results": results, "codes": codes, "dir": d,
            "log": d / "run.jsonl", "seconds": time.monotonic() - t0}


def _jax_oom_events(synthetic_frames, tmp, name):
    """JAX's own run of the OOMs of ``RUNS[name]`` on a 2 x 2 one-process
    mesh: its ``(event, label/action, error_class, from, to)`` trail."""
    s, g1, clone_idx = dense_inputs_from_frames(synthetic_frames)
    num_s = synthetic_frames[0]["cell_id"].nunique()
    log = tmp / f"jax_{name}.jsonl"
    cfg = JaxConfig(**{**BASE, "num_shards": 2, "loci_shards": 2,
                       "checkpoint_dir": str(tmp / f"jax_{name}_ck"),
                       "faults": RUNS[name][3].replace("@proc*", ""),
                       "telemetry_path": str(log),
                       "compile_cache_dir": None})
    JaxInference(s, g1, cfg, clone_idx_s=clone_idx[:num_s],
                 clone_idx_g1=clone_idx, num_clones=2).run()
    jax_faults.install(None)
    return _trail(log)


@pytest.fixture(scope="module")
def runs(synthetic_frames, tmp_path_factory):
    """Every run of ``RUNS``, two launches at a time, with JAX's OOM runs
    in this process meanwhile."""
    root = tmp_path_factory.mktemp("elastic")
    frames = _frames(synthetic_frames)
    odd = _frames(_odd(synthetic_frames))
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        futures = {name: pool.submit(_launch, name,
                                     odd if name in ODD else frames, root)
                   for name in RUNS}
        trails = {name: _jax_oom_events(
            _odd(synthetic_frames) if name in ODD else synthetic_frames,
            root, name) for name in ("oom", "oom_steps")}
        out = {name: f.result() for name, f in futures.items()}
    out["jax_trails"] = trails
    return out


def _events(path):
    return [json.loads(line) for line in open(path)]


def _trail(path):
    """The recovery ladder's ``retry`` and ``degrade`` events of a log:
    ``(event, label or action, error_class, from, to)``."""
    return [(e["event"], e.get("label") or e.get("action"),
             e.get("error_class"),
             (e.get("from_topology") or {}).get("mesh_axes"),
             (e.get("to_topology") or {}).get("mesh_axes"))
            for e in _events(path) if e["event"] in ("retry", "degrade")]


def _tau_parity(golden, got):
    folded = np.minimum(np.abs(golden - got), np.abs(golden - (1.0 - got)))
    outliers = folded >= TAU_TOL
    assert int(outliers.sum()) <= TAU_OUTLIERS, folded
    assert np.all((golden[outliers] < 0.05) | (golden[outliers] > 0.95))


def _jax_shrunk(cells, loci):
    """JAX's ``mesh_topology(shrink_mesh(...))`` of a cells x loci mesh."""
    return jax_mesh.mesh_topology(jax_mesh.shrink_mesh(
        jax_mesh.make_mesh(cells, loci_shards=loci)))


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cells,loci,survivors", [
    (4, 2, 8),   # JAX test_shrink_mesh_ladder_order
    (1, 1, 8),   # JAX test_shrink_mesh_minimal_is_exhausted
    (2, 2, 8), (8, 1, 8), (2, 4, 8), (1, 2, 8),
    (2, 2, 3), (4, 2, 3), (2, 4, 4), (1, 2, 1),
])
def test_shrink_rule_equals_jax(cells, loci, survivors, monkeypatch):
    """Every rung of the port's ladder over ``survivors`` ranks is JAX's
    over as many devices, down to exhaustion."""
    devices = jax.devices()
    mesh = jax_mesh.make_mesh(cells, loci_shards=loci)
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices[:survivors])
    want = []
    while (mesh := jax_mesh.shrink_mesh(mesh)) is not None:
        want.append(jax_mesh.mesh_topology(mesh))
    got, grid = [], (cells, loci)
    while (grid := shrink_grid(*grid, survivors)) is not None:
        got.append(grid_topology(*grid))
    assert got == want
    if (cells, loci, survivors) == (4, 2, 8):
        assert got == [{"cells": 2, "loci": 2}, {"cells": 1, "loci": 2},
                       {"cells": 1}]
    if (cells, loci) == (1, 1):
        assert got == [] and shrink_ladder(1, 1, survivors) == []


def test_shrink_ladder_walks_until_the_survivors_fit():
    """Where a halving still needs more ranks than are left, the port
    walks further rungs at once (JAX's devices never go)."""
    assert shrink_ladder(4, 1, 1) == [(2, 1), (1, 1)]
    assert shrink_ladder(2, 2, 3) == [(1, 2)]
    assert shrink_ladder(2, 1, 1) == [(1, 1)]


@pytest.fixture(scope="module")
def eligibility(synthetic_frames, tmp_path_factory):
    """(JAX's verdicts on its 4 x 2 mesh, a function giving the port's
    on a 4 x 2 grid for config changes)."""
    s, g1, clone_idx = dense_inputs_from_frames(synthetic_frames)
    jinf = JaxInference(s, g1, JaxConfig(
        **{**BASE, "num_shards": 4, "loci_shards": 2,
           "compile_cache_dir": None}),
        clone_idx_s=clone_idx, clone_idx_g1=clone_idx, num_clones=2)
    kinds = ("hostloss", "oom", "hang", "preemption", "transient",
             "deterministic")
    jax_verdicts = {k: jinf._shrink_eligible(k) for k in kinds}
    jinf._mesh = None
    jax_verdicts["one rank"] = jinf._shrink_eligible("hostloss")
    ps, pg1, pclone = torch_ranks.port_inputs(synthetic_frames)
    root = tmp_path_factory.mktemp("eligibility")

    def port(kind, mesh=True, **config):
        cfg = {**BASE, "checkpoint_dir": str(root / "ck"), **config}
        inf = PertInference(ps, pg1, PertConfig(**cfg), clone_idx_s=pclone,
                            clone_idx_g1=pclone, num_clones=2, device="cpu")
        inf.mesh = RankMesh(4, 2, 0, [], []) if mesh else None
        return inf._shrink_eligible(kind)
    return jax_verdicts, port


@pytest.mark.parametrize("case", [
    "hostloss", "oom", "hang", "preemption", "transient", "deterministic",
    "one rank", "no checkpoint_dir", "elastic_mesh=False"])
def test_shrink_eligibility_units(case, eligibility):
    """JAX ``test_shrink_eligibility_units``' verdicts, and the port's
    own three: one rank, no checkpoint directory, the rung off."""
    jax_verdicts, port = eligibility
    if case in jax_verdicts and case != "one rank":
        assert port(case) == jax_verdicts[case]
        assert port(case) == (case in ("hostloss", "oom"))
    elif case == "one rank":
        assert port("hostloss", mesh=False) is jax_verdicts[case] is False
    elif case == "no checkpoint_dir":
        assert port("hostloss", checkpoint_dir=None) is False
    else:
        assert port("hostloss", elastic_mesh=False) is False


def test_config_digest_of_elastic_mesh_equals_jax():
    """``elastic_mesh`` is hashed at its given value, as JAX hashes it."""
    for value in (False, True):
        assert port_runlog._config_digest(PertConfig(elastic_mesh=value)) \
            == jax_digest(JaxConfig(elastic_mesh=value))
    assert port_runlog._config_digest(PertConfig(elastic_mesh=False)) != \
        port_runlog._config_digest(PertConfig())


def test_a_mesh_shrink_counts_in_both_registries():
    """A ``degrade mesh_shrink`` event counts ``pert_mesh_shrinks_total``
    (which the heartbeat samples and the ``mesh-shrunk`` rule reads), as
    JAX's registry counts it; another degrade action does not."""
    values = []
    for mod in (port_metrics, jax_metrics):
        reg = mod.MetricsRegistry.create()
        for action in ("mesh_shrink", "abort_resumable", "mesh_shrink"):
            reg.record_event("degrade", {"action": action})
        snap = reg.snapshot(stable_only=False)
        values.append(snap["pert_mesh_shrinks_total"]["value"])
    assert values == [2, 2]


# ---------------------------------------------------------------------------
# the meeting and the log's hand-over, in one process
# ---------------------------------------------------------------------------

def _meet_all(rdzv, ranks, world, settle, gen=1):
    out = {}

    def meet(r):
        try:
            out[r] = rdzv.meet(gen, r, world, "hostloss", timeout=20.0,
                               settle=settle)
        except RuntimeError as exc:
            out[r] = exc
    threads = [threading.Thread(target=meet, args=(r,)) for r in ranks]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    return out


def test_rendezvous_closes_on_marks_and_after_the_settle_window(tmp_path):
    """A rank marked lost is not waited for; one killed outright is
    waited for the settle window; a rank that arrives after the close is
    refused; every survivor reads one roster."""
    rdzv = tdist.Rendezvous(str(tmp_path / "elastic"), "t")
    rdzv.mark_lost(1, 2, "SimulatedHostLoss")
    t0 = time.monotonic()
    out = _meet_all(rdzv, (0, 1), 3, settle=30.0)
    assert time.monotonic() - t0 < 10.0
    assert out[0] == out[1] == {0: "hostloss", 1: "hostloss"}
    t0 = time.monotonic()
    out = _meet_all(rdzv, (0, 2), 3, settle=0.5, gen=2)
    assert 0.4 < time.monotonic() - t0 < 10.0
    assert out[0] == out[2] == {0: "hostloss", 2: "hostloss"}
    late = _meet_all(rdzv, (1,), 3, settle=0.5, gen=2)
    assert isinstance(late[1], RuntimeError)


def test_rendezvous_waits_for_ranks_declared_alive(tmp_path):
    """A rank that declared itself alive (before its emergency save) is
    waited for past the settle window until it arrives; one declared and
    then marked lost, or killed outright, is not."""
    rdzv = tdist.Rendezvous(str(tmp_path / "elastic"), "t")
    rdzv.declare_alive(1, 2)

    def late():
        time.sleep(1.5)
        out[2] = rdzv.meet(1, 2, 4, "hostloss", timeout=20.0, settle=0.3)
    out = {}
    slow = threading.Thread(target=late)
    slow.start()
    out.update(_meet_all(rdzv, (0, 1), 4, settle=0.3))
    slow.join(30)
    assert out[0] == out[1] == out[2] == {0: "hostloss", 1: "hostloss",
                                          2: "hostloss"}
    rdzv.declare_alive(2, 2)
    rdzv.mark_lost(2, 2, "SimulatedPreemption")
    t0 = time.monotonic()
    out = _meet_all(rdzv, (0, 1), 4, settle=0.3, gen=2)
    assert time.monotonic() - t0 < 5.0
    assert out[0] == out[1] == {0: "hostloss", 1: "hostloss"}


def test_refused_rank_0_leaves_the_adopted_log_alone(
        synthetic_frames, tmp_path, monkeypatch):
    """Old rank 0, arriving after the survivors went on without it, writes
    nothing more into the run log their new rank 0 continues: no
    ``degrade`` and no ``run_end``."""
    s, g1, clone_idx = torch_ranks.port_inputs(synthetic_frames)
    inf = PertInference(s, g1, PertConfig(**{
        **BASE, "checkpoint_dir": str(tmp_path / "ck")}),
        clone_idx_s=clone_idx, clone_idx_g1=clone_idx, num_clones=2,
        device="cpu")
    inf.mesh = RankMesh(2, 1, 0, [], [])
    inf._rendezvous = tdist.Rendezvous(str(tmp_path / "elastic"), "t")
    inf._rendezvous.store.set("g1/roster", json.dumps({"1": "hostloss"}))
    monkeypatch.setattr(torch.distributed, "get_backend",
                        lambda *a: "gloo")
    path = tmp_path / "run.jsonl"
    inf.run_log = port_runlog.RunLog(str(path))
    with pytest.raises(tdist.RendezvousClosed):
        with inf.run_log.session():
            inf._elastic_rung("step2", "hostloss", RuntimeError("peer gone"))
    assert [e["event"] for e in _events(path)] == ["run_start"]


@pytest.mark.parametrize("ending", ["torn", "closed"])
def test_adopted_log_continues_a_torn_stream(tmp_path, ending):
    """The rung's new rank 0 cuts the lost writer's torn last line, or the
    ``run_end`` it closed the run with before it left (``hand_over``),
    and continues the stream: the file validates, ``seq`` runs on."""
    path = tmp_path / "run.jsonl"
    writer = port_runlog.RunLog(str(path))
    with writer.session():
        writer.emit("note", detail="before the loss")
        if ending == "torn":
            writer.relinquish()
        else:
            writer.hand_over(RuntimeError("preempted"))
    assert validate_run(path) == [] or ending == "torn"
    if ending == "torn":
        with open(path, "a") as fh:
            fh.write('{"event": "note", "seq": 2, "t": 0.1, "det')
    follower = port_runlog.RunLog(None)
    follower.follower = True
    with follower.session():
        assert port_runlog.current() is follower
        assert follower.adopt(str(path))
        follower.emit("note", detail="after the loss")
    events = _events(path)
    assert validate_run(path) == []
    assert [e["event"] for e in events] == ["run_start", "note", "note",
                                            "run_end"]
    assert events[-2]["detail"] == "after the loss"


# ---------------------------------------------------------------------------
# the spawned runs
# ---------------------------------------------------------------------------

def _survivor(run, rank=0):
    r = run["results"][rank]
    assert r is not None and "error" not in r, r
    return r


def _losses_near_golden(runs, got, steps=(0, 1)):
    golden = _survivor(runs["golden"])["losses"]
    for k in steps:
        want = np.asarray(golden[k])
        have = np.asarray(got[k])
        assert len(have) == len(want)
        rel = np.abs(have - want) / np.abs(want)
        assert rel.max() < LOSS_TOL, (k, rel.max())


@pytest.mark.parametrize("name,error", [
    ("hostloss", "SimulatedHostLoss"), ("killed", "SimulatedPreemption"),
    ("exited", None)])
def test_lost_rank_1_of_2x1_ends_on_one_rank(runs, name, error):
    run = runs[name]
    assert run["codes"][0] == 0 and run["codes"][1] != 0, run["results"]
    if error is None:
        assert run["results"][1] is None   # gone without a word
    else:
        assert error in run["results"][1]["error"]
    r0 = _survivor(run)
    assert r0["mesh"] == {} and r0["rank_after"] == (0, 1)
    assert r0["shrinks"] >= 1
    assert validate_run(run["log"]) == []
    assert _trail(run["log"]) == [
        ("degrade", "mesh_shrink", "hostloss", {"cells": 2},
         _jax_shrunk(2, 1))]
    assert _jax_shrunk(2, 1) == {"cells": 1}
    resumes = [e for e in _events(run["log"]) if e["event"] == "resume"]
    assert any(e["step"] == "step2" and e["resharded"]
               and e["action"] == "resumed" for e in resumes), resumes
    _losses_near_golden(runs, r0["losses"])
    _tau_parity(_survivor(runs["golden"])["tau"], r0["tau"])
    assert run["seconds"] < torch_ranks.LAUNCH_TIMEOUT


@pytest.mark.parametrize("name,lost", [("lost3", 3), ("lost0", 0)])
def test_2x2_losing_a_rank_ends_on_1x2_and_a_standby(runs, name, lost):
    """Every survivor returns the same frames: the 1 x 2 grid's two ranks
    and the standby rank the new rank 0 sends them to."""
    run = runs[name]
    codes = run["codes"]
    assert codes[lost] != 0 and all(
        c == 0 for k, c in enumerate(codes) if k != lost), run["results"]
    alive = [_survivor(run, k) for k in range(4) if k != lost]
    assert all(r["digest"] == alive[0]["digest"] for r in alive)
    assert [r["standby"] for r in alive] == [False, False, True]
    for r in alive[:2]:
        assert r["mesh"] == {"cells": 1, "loci": 2} == _jax_shrunk(2, 2)
        # step 1 of a 2 x 2 grid parts chaotically from the 2 x 1 run on
        # these frames (ROADMAP C); step 2 is held
        _losses_near_golden(runs, r["losses"], steps=(1,))
    assert alive[0]["rank_after"] == (0, 2)
    writer = alive[0]
    assert writer["run_log_path"] == str(run["log"])
    assert validate_run(run["log"]) == []
    trail = _trail(run["log"])
    assert trail[-1] == ("degrade", "mesh_shrink", "hostloss",
                         {"cells": 2, "loci": 2}, {"cells": 1, "loci": 2})
    assert len([t for t in trail if t[1] == "mesh_shrink"]) == 1


def test_lost_rank_0_hands_the_commit_and_the_log_to_rank_1(runs):
    """Old rank 1 is the new rank 0: it commits step 2's generations on
    the 1 x 2 group and continues the lost writer's log after its
    ``abort_resumable``."""
    run = runs["lost0"]
    d = run["dir"] / "ck"
    doc = json.loads((d / "pert_step2.commit.json").read_text())
    assert doc["process_count"] == 2
    assert doc["topology"]["mesh_axes"] == {"cells": 1, "loci": 2}
    _, losses, extra = ckpt.load_step(str(d), "step2")
    assert int(extra["meta.num_iters"]) == len(
        _survivor(run, 1)["losses"][1])
    trail = _trail(run["log"])
    assert [t[1] for t in trail] == ["abort_resumable", "mesh_shrink"]
    manifest = json.loads((d / "manifest.json").read_text())
    assert manifest["runs"][-1]["run_log"] == str(run["log"])
    assert all(s["status"] == "complete"
               for s in manifest["steps"].values())


def test_repeated_oom_on_2x2_walks_jax_trail(runs):
    """The first OOM re-enters on the same grid (JAX's ``retry``
    ``step2/fit-oom``), the repeat shrinks: the trail equals JAX's own
    run of the same fault on a 2 x 2 one-process mesh."""
    run = runs["oom"]
    assert run["codes"] == [0, 0, 0, 0], run["results"]
    trail = _trail(run["log"])
    assert trail == runs["jax_trails"]["oom"]
    assert trail == [
        ("retry", "step2/fit-oom", "oom", None, None),
        ("degrade", "mesh_shrink", "oom", {"cells": 2, "loci": 2},
         {"cells": 1, "loci": 2})]
    alive = [_survivor(run, k) for k in range(4)]
    assert all(r["digest"] == alive[0]["digest"] for r in alive)
    assert [r["standby"] for r in alive] == [False, False, True, True]
    assert validate_run(run["log"]) == []


def test_first_oom_of_each_step_reenters_as_jax_does(runs):
    """A first OOM in step 1 and another in step 2 each re-enter their
    step on the same grid (JAX counts OOMs per ``_fit`` call), and only
    step 2's repeat shrinks.  The run's 23 S cells are padded to 24 on
    the 2 x 2 launch grid; the 1 x 2 grid keeps that multiple, so step
    2's generation lands on it as it was written."""
    run = runs["oom_steps"]
    assert run["codes"] == [0, 0, 0, 0], run["results"]
    trail = _trail(run["log"])
    assert trail == runs["jax_trails"]["oom_steps"]
    assert trail == [
        ("retry", "step1/fit-oom", "oom", None, None),
        ("retry", "step2/fit-oom", "oom", None, None),
        ("degrade", "mesh_shrink", "oom", {"cells": 2, "loci": 2},
         {"cells": 1, "loci": 2})]
    alive = [_survivor(run, k) for k in range(4)]
    assert all(r["digest"] == alive[0]["digest"] for r in alive)
    assert [r["cells"][1] for r in alive[:2]] == [24, 24]
    resumes = [e for e in _events(run["log"]) if e["event"] == "resume"]
    assert any(e["step"] == "step2" and e["resharded"]
               and e["action"] == "resumed" for e in resumes), resumes
    assert validate_run(run["log"]) == []


def test_whole_job_preemption_leaves_a_valid_log(runs):
    """Every rank preempted (no survivor continues the log): rank 0
    closed its log with ``run_end`` before it left, as it does with the
    rung off."""
    run = runs["preempt_all"]
    assert run["codes"][0] != 0 and run["codes"][1] != 0
    for r in run["results"]:
        assert "SimulatedPreemption" in r["error"], r
    assert validate_run(run["log"]) == []
    events = _events(run["log"])
    assert events[-1]["event"] == "run_end"
    assert events[-1]["status"] == "error"
    assert events[-1]["error"]["type"] == "SimulatedPreemption"
    assert [t[1] for t in _trail(run["log"])] == []


def test_rung_off_aborts_resumable_and_the_artifact_resumes(runs,
                                                            synthetic_frames):
    """``elastic_mesh=False``: today's contract, on every survivor: an
    ``abort_resumable`` degrade and a resumable directory, which one
    rank then resumes onto the two-rank run's trajectory."""
    run = runs["off"]
    assert run["codes"][0] != 0 and run["codes"][1] != 0
    assert "SimulatedHostLoss" not in run["results"][0]["error"]
    assert _trail(run["log"]) == [
        ("degrade", "abort_resumable", "hostloss", None, None)]
    d = run["dir"] / "resumed_ck"
    shutil.copytree(run["dir"] / "ck", d)
    s, g1, clone_idx = torch_ranks.port_inputs(synthetic_frames)
    inf = PertInference(s, g1, PertConfig(**{**BASE,
                                             "checkpoint_dir": str(d)}),
                        clone_idx_s=clone_idx, clone_idx_g1=clone_idx,
                        num_clones=2, device="cpu")
    step1, step2, _ = inf.run()
    _losses_near_golden(runs, [step1.fit.losses, step2.fit.losses])


def test_without_checkpoint_dir_the_rung_aborts_and_says_why(runs):
    run = runs["no_dir"]
    assert run["codes"][0] != 0 and run["codes"][1] != 0
    degrades = [e for e in _events(run["log"]) if e["event"] == "degrade"]
    assert [e["action"] for e in degrades] == ["abort_resumable"]
    assert "needs checkpoint_dir" in degrades[0]["detail"]
