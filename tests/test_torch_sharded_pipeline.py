"""Sharded fits of the port on gloo ranks against JAX's one-process mesh
and against the port's own one-rank run.

* ``PertInference.run`` on the synthetic frames of
  tests/test_padding_and_chunking.py (24 S and 24 G1 cells, 120 loci,
  even, so no pad cells): the port on 2 and 2 x 2 ranks against JAX's
  ``num_shards=2`` and ``num_shards=2, loci_shards=2``, and against the
  port's one-rank run.  Step 1's iteration 0 within 1e-5 relative; steps
  2 and 3 (whose iteration 0 starts from step 1's fit) along their whole
  trajectories within 5e-2, each package's parameter-free Dirichlet
  normaliser taken out (its float32 lgamma at 1e6 concentrations differs
  between XLA and PyTorch by an ulp a bin).  Step 1's trajectory is held
  whole only where the two runs split the doubled G1 cells alike: its
  first Adam steps move ``rho`` on gradients that are rounding noise (the
  G1 and G2 copies' replication terms cancel), and on a 2 x 2 grid JAX's
  own run leaves its one-device run by 0.94 relative at iteration 2.
* ``scRT(..., num_shards=2[, loci_shards=2]).infer('pert')`` at the
  default options (the controller, the QC, the gated rescue, the run
  log) against JAX's on the same grid: the same frames in shape and
  order, decoded states alike on >= 0.99 of the bins; the QC table and
  the rescue's candidates and accepted cells as JAX's; every rank
  returns the same frames; on 2 x 1 the run log exists once (rank 0's)
  and every rank writes its heartbeat, which ``aggregate_health`` reads
  as two hosts with no missing rank.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest

from scdna_replication_tools_tpu.api import scRT as JaxScRT
from scdna_replication_tools_tpu.config import PertConfig as JaxConfig
from scdna_replication_tools_tpu.infer.runner import (
    PertInference as JaxInference,
)
from scdna_replication_tools_tpu.models.simulator import pert_simulator
from scdna_replication_tools_tpu_torch.config import PertConfig
from scdna_replication_tools_tpu_torch.infer.runner import PertInference
from scdna_replication_tools_tpu_torch.obs import heartbeat

import torch_ranks
from conftest import dense_inputs_from_frames
from test_torch_model import one_torch_thread  # noqa: F401

CFG = dict(cn_prior_method="g1_clones", max_iter=25, min_iter=12,
           run_step3=True, telemetry_path=None)
GRIDS = [(2, 1), (2, 2)]


def _jax_normaliser(step) -> float:
    """A JAX step's parameter-free Dirichlet normaliser over its real
    bins, with XLA's float32 lgamma (0 for step 1)."""
    b = step.batch
    if b.eta_w is None:
        return 0.0
    lg = jax.scipy.special.gammaln
    P = step.spec.P
    per_bin = lg(P + b.eta_w) - lg(1.0 + b.eta_w)
    lmask = b.loci_mask if b.loci_mask is not None \
        else jnp.ones(b.reads.shape[1])
    return float(jnp.sum(per_bin * b.mask[:, None] * lmask[None, :]))


@pytest.fixture(scope="module")
def jax_runs(synthetic_frames):
    s, g1, clone_idx = dense_inputs_from_frames(synthetic_frames)
    out = {}
    for cells, loci in GRIDS:
        inf = JaxInference(s, g1, JaxConfig(
            **CFG, compile_cache_dir=None, num_shards=cells,
            loci_shards=loci), clone_idx_s=clone_idx,
            clone_idx_g1=clone_idx, num_clones=2)
        steps = inf.run()
        out[(cells, loci)] = [
            np.asarray(st.fit.losses, np.float64) + _jax_normaliser(st)
            for st in steps]
    return out


@pytest.fixture(scope="module")
def port_runs(synthetic_frames, tmp_path_factory):
    s, g1, clone_idx = torch_ranks.port_inputs(synthetic_frames)
    one = PertInference(s, g1, PertConfig(**CFG), clone_idx_s=clone_idx,
                        clone_idx_g1=clone_idx, num_clones=2, device="cpu")
    steps = one.run()
    out = {(1, 1): [[np.asarray(st.fit.losses, np.float64)
                     + torch_ranks.normaliser_sum(st) for st in steps]]}
    for cells, loci in GRIDS:
        results, codes = torch_ranks.launch(
            cells * loci, torch_ranks.run_inference,
            {"frames": synthetic_frames,
             "config": {**CFG, "num_shards": cells, "loci_shards": loci}},
            tmp_path_factory.mktemp(f"ranks{cells}x{loci}"))
        assert codes == [0] * (cells * loci), results
        # the normaliser is a sum over bins: every rank's share
        norm = [sum(r["normaliser"][k] for r in results) for k in range(3)]
        out[(cells, loci)] = [
            [np.asarray(r["losses"][k], np.float64) + norm[k]
             for k in range(3)] for r in results]
        out[(cells, loci, "raw")] = results
    return out


def _rel(got, want):
    n = min(len(got), len(want))
    return np.abs(got[:n] - want[:n]) / np.abs(want[:n])


def _hold(got, want, whole_step1: bool, label: str):
    for k, (a, b) in enumerate(zip(got, want)):
        rel = _rel(a, b)
        print(f"{label} step {k + 1}: iteration 0 {rel[0]:.3g}, worst "
              f"{rel.max():.3g} over {len(rel)} iterations")
        if k == 0:
            assert rel[0] < 1e-5, (label, k, rel)
            if whole_step1:
                assert rel.max() < 5e-2, (label, k, rel)
        else:
            assert rel.max() < 5e-2, (label, k, rel)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_inference_matches_jax_mesh(jax_runs, port_runs, grid):
    _hold(port_runs[grid][0], jax_runs[grid], whole_step1=grid[1] == 1,
          label=f"port {grid} vs JAX")


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_ranks_match_the_one_rank_run(port_runs, grid):
    _hold(port_runs[grid][0], port_runs[(1, 1)][0],
          whole_step1=grid[1] == 1, label=f"port {grid} vs port 1 rank")


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_every_rank_holds_the_same_fit(port_runs, grid):
    results = port_runs[grid + ("raw",)]
    for r in results[1:]:
        for k in range(3):
            np.testing.assert_array_equal(r["losses"][k],
                                          results[0]["losses"][k])
        np.testing.assert_array_equal(r["tau"], results[0]["tau"])


# ---------------------------------------------------------------------------
# scRT at the default options
# ---------------------------------------------------------------------------

OPTS = dict(input_col="reads", clone_col="clone_id", assign_col="copy",
            cn_prior_method="g1_composite", max_iter=100, min_iter=50,
            rt_prior_col=None)


@pytest.fixture(scope="module")
def sim_data(synthetic_frames):
    df_s, df_g = synthetic_frames
    sim_s, sim_g = pert_simulator(
        df_s, df_g, num_reads=50_000, rt_cols=["rt_A", "rt_B"],
        clones=["A", "B"], lamb=0.75, betas=[0.5, 0.0], a=10.0, seed=11)
    for df in (sim_s, sim_g):
        df["reads"] = df["true_reads_norm"]
        df["state"] = df["true_somatic_cn"].astype(int)
        df["copy"] = df["true_somatic_cn"].astype(float)
    return sim_s, sim_g


@pytest.fixture(scope="module")
def scrt_grids(sim_data, tmp_path_factory):
    """grid -> (JAX scRT, its frames, the port's rank results, the port's
    directory): ``scRT(..., num_shards=cells, loci_shards=loci)`` of each
    package at the default options, each grid run once."""
    sim_s, sim_g = sim_data
    runs = {}

    def run(grid):
        if grid in runs:
            return runs[grid]
        cells, loci = grid
        jscrt = JaxScRT(sim_s.copy(), sim_g.copy(), compile_cache_dir=None,
                        telemetry_path=None, num_shards=cells,
                        loci_shards=loci, **OPTS)
        jax_out = jscrt.infer(level="pert")
        d = tmp_path_factory.mktemp(f"scrt{cells}x{loci}")
        results, codes = torch_ranks.launch(cells * loci,
                                            torch_ranks.run_scrt, {
            "frames": (sim_s, sim_g),
            "options": {**OPTS, "num_shards": cells, "loci_shards": loci,
                        "checkpoint_dir": str(d / "ck"),
                        "telemetry_path": str(d / "logs")}}, d)
        assert codes == [0] * (cells * loci), results
        runs[grid] = (jscrt, jax_out, results, d)
        return runs[grid]
    return run


@pytest.fixture(scope="module")
def scrt_runs(scrt_grids):
    _, jax_out, results, d = scrt_grids((2, 1))
    return jax_out, results, d


KEYS = ["cell_id", "chr", "start"]


def _frames_match(j, t):
    """The port's frame against JAX's: shape, columns, keys and their
    order alike; decoded states alike on >= 0.99 of the bins."""
    assert t.shape == j.shape
    assert list(t.columns) == list(j.columns)
    pd.testing.assert_frame_equal(t[KEYS].reset_index(drop=True),
                                  j[KEYS].reset_index(drop=True),
                                  check_dtype=False)
    for col in ("model_cn_state", "model_rep_state"):
        agree = (t[col].to_numpy() == j[col].to_numpy()).mean()
        print(f"{col}: {agree:.4f} of the bins alike")
        assert agree >= 0.99, (col, agree)


@pytest.mark.parametrize("frame", [0, 2], ids=["s_cells", "g1_cells"])
def test_scrt_frames_match_jax_mesh(scrt_runs, frame):
    jax_out, results, _ = scrt_runs
    _frames_match(jax_out[frame], results[0]["outputs"][frame])


@pytest.mark.parametrize("frame", [0, 2], ids=["s_cells", "g1_cells"])
def test_scrt_2x2_frames_match_jax_mesh(scrt_grids, frame):
    """The 2 x 2 grid (cells x loci) at the default options against JAX's
    ``num_shards=2, loci_shards=2``: the frames as on 2 x 1, and every
    rank returns the same ones."""
    _, jax_out, results, _ = scrt_grids((2, 2))
    _frames_match(jax_out[frame], results[0]["outputs"][frame])
    for r in results[1:]:
        assert r["digest"] == results[0]["digest"]
        assert r["rescue"] == results[0]["rescue"]


def test_scrt_ranks_return_the_same_frames(scrt_runs):
    _, results, _ = scrt_runs
    assert results[0]["digest"] == results[1]["digest"]
    assert results[0]["rescue"] == results[1]["rescue"]
    qc = results[0]["cell_qc"]
    assert len(qc) == results[0]["outputs"][0]["cell_id"].nunique()


QC_EXACT = ["cell_id", "rescue_candidate", "rescue_accepted"]
# bars of the QC columns against JAX's run on the same grid, as fractions
# of each column's scale: the spread that two fits of the same data leave
# (readings, 2 x 1 / 2 x 2: tau 5.0e-4 / 2.0e-3, mean entropies and the
# low-confidence fraction <= 4.0e-3, the maximum entropy 1.5e-2 / 8.7e-2,
# the PPC deviance 2.5e-3 / 1.3e-2; JAX's own meshes against its one
# device: the maximum 1.6e-2 / 2.4e-2, the deviance 2.7e-3 / 3.8e-3).
# The computation after the fit is held to 1e-4 on one fitted state in
# tests/test_torch_parallel.py
QC_SPREAD = {"model_tau": 1e-2, "mean_cn_entropy": 1e-2,
             "frac_low_conf": 1e-2, "mean_rep_entropy": 1e-2,
             "max_cn_entropy": 0.15, "ppc_deviance": 5e-2}


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_scrt_cell_qc_and_rescue_match_jax_mesh(scrt_grids, grid):
    """The QC table (``build_cell_qc``) and the mirror rescue of the
    sharded default run against JAX's one-process mesh run of the same
    grid: the same cells, rescue candidates and accepted cells, and the
    same rescue statistics; tau, the entropy aggregates (mean and
    maximum, the low-confidence fraction) and the observed PPC deviance
    within ``QC_SPREAD`` of each column's scale; the flags other than
    ppc_outlier alike on >= 0.95 of the cells (tests/
    test_torch_default_pipeline.py's bar for the one-rank run; ppc_z
    rests on each side's own replicate draws, and
    tests/test_torch_parallel.py holds the sharded PPC to the one-rank
    one on given replicates); ppc_z finite where JAX's is."""
    jscrt, _, results, _ = scrt_grids(grid)
    jqc, tqc = jscrt.cell_qc(), results[0]["cell_qc"]
    assert list(tqc.columns) == list(jqc.columns)
    assert len(tqc) == len(jqc)
    for col in QC_EXACT:
        assert (jqc[col].to_numpy() == tqc[col].to_numpy()).all(), col
    worst = {}
    for col, bar in QC_SPREAD.items():
        a, b = jqc[col].to_numpy(float), tqc[col].to_numpy(float)
        worst[col] = float(np.abs(a - b).max()) / max(1.0, np.abs(a).max())
        assert worst[col] <= bar, (col, worst[col])
    print(f"cell_qc {grid}: " + ", ".join(f"{k} {v:.3g}"
                                          for k, v in worst.items()))
    assert (np.isfinite(tqc["ppc_z"].to_numpy(float))
            == np.isfinite(jqc["ppc_z"].to_numpy(float))).all()

    def flags(df):
        return df["qc_flags"].map(
            lambda s: tuple(f for f in s.split(",") if f
                            and f != "ppc_outlier"))
    assert (flags(jqc) == flags(tqc)).mean() >= 0.95
    jstats = jscrt.mirror_rescue_stats
    tstats = results[0]["rescue"]
    print(f"rescue {grid}: JAX {jstats}, port {tstats}")
    assert (jstats is None) == (tstats is None)
    if jstats is not None:
        assert {k: tstats[k] for k in ("candidates", "accepted")} \
            == {k: jstats[k] for k in ("candidates", "accepted")}
    for r in results[1:]:
        assert r["rescue"] == tstats


def test_scrt_run_log_once_and_a_heartbeat_per_rank(scrt_runs):
    _, results, d = scrt_runs
    assert results[0]["run_log_path"] is not None
    assert results[1]["run_log_path"] is None
    assert [p.name for p in d.iterdir() if p.name.startswith("logs")] \
        == ["logs"]
    events = [json.loads(line) for line in
              open(results[0]["run_log_path"]).read().splitlines()]
    assert events[0]["event"] == "run_start"
    assert events[0]["process_count"] == 2
    assert any(e["event"] == "note" and e.get("mesh", {}).get("axes")
               == {"cells": 2} for e in events)
    assert events[-1]["event"] == "run_end" \
        and events[-1]["status"] == "ok"
    agg = heartbeat.aggregate_health(str(d / "ck" / "health"))
    assert agg["hosts_seen"] == 2 and agg["process_count"] == 2
    assert agg["missing_ranks"] == []
    assert sorted(p.name for p in (d / "ck" / "health").iterdir()) \
        == ["host_0.json", "host_1.json"]
