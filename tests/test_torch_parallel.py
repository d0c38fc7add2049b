"""The port's sharded-fit plumbing (``parallel/``) against the JAX
package's: the per-rank slicing, the grid's topology records, ``fit_map``
on a grid of gloo ranks against JAX's one-process mesh, the per-rank
data fingerprints and the resume consensus, and the sharded checkpoint
generations both packages write and read.

Multi-rank cases spawn gloo ranks on the CPU (``tests/torch_ranks.py``:
a ``file://`` store under the test's temporary directory, a 30 s
collective timeout, a 120 s limit per launch); the JAX references run in
this process on conftest's 8 virtual CPU devices.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu import layout as jlayout
from scdna_replication_tools_tpu.infer import checkpoint as jckpt
from scdna_replication_tools_tpu.infer import manifest as jmanifest
from scdna_replication_tools_tpu.infer.svi import fit_map as jfit_map
from scdna_replication_tools_tpu.models.pert import PertBatch as JBatch
from scdna_replication_tools_tpu.models.pert import pert_loss as jpert_loss
from scdna_replication_tools_tpu.parallel import distributed as jdist
from scdna_replication_tools_tpu.parallel import mesh as jmesh
from scdna_replication_tools_tpu_torch import layout
from scdna_replication_tools_tpu_torch.infer import checkpoint as ckpt
from scdna_replication_tools_tpu_torch.infer import manifest
from scdna_replication_tools_tpu_torch.models.pert import PertBatch
from scdna_replication_tools_tpu_torch.parallel import distributed as dist
from scdna_replication_tools_tpu_torch.parallel.mesh import (
    RankMesh,
    make_mesh,
    mesh_topology,
)

import torch_ranks
from __graft_entry__ import _toy_problem
from test_topology_resume import _host_flat, _write_generation
from test_torch_rescue import step2_jax  # noqa: F401

GRIDS = [(2, 1), (4, 1), (2, 2)]


def _grid_mesh(cells, loci, rank):
    """A RankMesh of ``rank`` on a ``cells x loci`` grid without a process
    group (its slicing and records only; no collective runs)."""
    return RankMesh(cells, loci, rank, [None] * cells, [None] * loci)


def test_init_distributed_single_process_noop():
    assert dist.init_distributed() == 1 == jdist.init_distributed()
    assert dist.process_rank_and_count() == (0, 1)


@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_host_shard_and_slicing_match_jax(monkeypatch, grid):
    """Rank by rank, the port's HostShard, batch and parameter slices of a
    full (cells x loci) problem are JAX's for the host of the same cells
    index (JAX counts hosts by process; a rank's host is its grid row),
    and the grid's topology records are JAX's for the same mesh.  The
    slices are views of ``RankMesh.tile``, the rule by which the runner
    cuts its batch and places its parameters; the per-name cells axes
    are JAX's ``layout`` rules."""
    cells, loci = grid
    rng = np.random.default_rng(0)
    C, L, P = 24, 40, 13
    full_batch = {"reads": rng.poisson(30, (C, L)).astype(np.float32),
                  "libs": np.zeros(C, np.int64),
                  "gamma_feats": rng.normal(size=(L, 5)).astype(np.float32),
                  "mask": np.ones(C, np.float32),
                  "etas": rng.uniform(1, 2, (C, L, P)).astype(np.float32)}
    full_params = {"tau_raw": rng.normal(size=C).astype(np.float32),
                   "betas": rng.normal(size=(C, 5)).astype(np.float32),
                   "pi_logits": rng.normal(size=(P, C, L)).astype(np.float32),
                   "rho_raw": rng.normal(size=L).astype(np.float32),
                   "a_raw": np.float32(1.5)}
    jmesh_ = jmesh.make_mesh(cells, loci_shards=loci)
    for rank in range(cells * loci):
        mesh = _grid_mesh(cells, loci, rank)
        monkeypatch.setattr(jax, "process_count", lambda: cells)
        monkeypatch.setattr(jax, "process_index",
                            lambda: mesh.cell_index)
        want = jdist.HostShard.for_this_process(C)
        got = dist.HostShard.for_this_process(C, mesh=mesh)
        assert (got.num_global_cells, got.lo, got.hi) \
            == (want.num_global_cells, want.lo, want.hi)
        jb = jdist.slice_local_batch(JBatch(**full_batch), want)
        tb = dist.slice_local_batch(PertBatch(**full_batch), got)
        for name in full_batch:
            np.testing.assert_array_equal(np.asarray(getattr(tb, name)),
                                          np.asarray(getattr(jb, name)))
        jp = jdist.slice_local_params(full_params, want)
        tp = dist.slice_local_params(full_params, got)
        for name in full_params:
            np.testing.assert_array_equal(tp[name], jp[name])
        # the tile adds the loci tile to the host's cells rows
        tile = mesh.tile(full_params["pi_logits"], ("P", "cells", "loci"))
        lo = mesh.loci_index * (L // loci)
        np.testing.assert_array_equal(
            tile, np.asarray(jp["pi_logits"])[:, :, lo:lo + L // loci])
        monkeypatch.undo()
        assert mesh_topology(mesh) == jmesh.mesh_topology(jmesh_)
        assert layout.param_layouts("loci" if loci > 1 else None) \
            == jlayout.param_layouts(jmesh.loci_axis(jmesh_))
    for name in PertBatch.FIELDS:
        assert layout.batch_cells_axis(name) == jlayout.batch_cells_axis(name)
    for name in full_params:
        assert layout.param_cells_axis(name) == jlayout.param_cells_axis(name)
    assert mesh_topology(None) == jmesh.mesh_topology(None) == {}
    got = dist.process_topology(_grid_mesh(cells, loci, 0))
    want = jdist.process_topology(jmesh_)
    assert set(got) == set(want)
    assert got["mesh_axes"] == want["mesh_axes"]


@pytest.mark.parametrize("shards", [dict(num_shards=2),
                                    dict(num_shards=1, loci_shards=2),
                                    dict(num_shards=0, loci_shards=3)])
def test_grid_without_a_process_group_raises(shards):
    """More than one rank and no group: ValueError naming
    init_distributed, never a quiet one-rank run."""
    with pytest.raises(ValueError, match="init_distributed|ranks"):
        make_mesh(**shards)


@pytest.mark.parametrize("shards", [dict(num_shards=1), dict(num_shards=None),
                                    dict(num_shards=0)])
def test_one_rank_grid_is_the_plain_run(shards):
    assert make_mesh(**shards) is None


def _toy_normaliser(lgamma, xp):
    """The toy prior's parameter-free Dirichlet normaliser over its bins,
    with one package's float32 lgamma (XLA's and PyTorch's differ by an
    ulp at these 1e5 concentrations, 1e2 over the toy's bins)."""
    w = xp(np.full((16, 64), 1e5 - 1.0, np.float32))
    return float((lgamma(13.0 + w) - lgamma(1.0 + w)).sum())


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_fit_map_on_ranks_matches_jax_mesh(tmp_path, grid):
    """fit_map of JAX tests/test_distributed.py's toy problem (16 cells x
    64 loci, sparse prior) on 2 and 2 x 2 gloo ranks against JAX's
    one-process ``global_mesh(2[, loci_shards=2])``: iteration 0 within
    1e-5, four iterations within 1e-3 relative, with each package's
    parameter-free normaliser taken out; every rank holds the same
    trajectory."""
    cells, loci = grid
    spec, params, fixed, batch = _toy_problem(num_cells=16, num_loci=64,
                                              enum_impl="xla", sparse=True)
    mesh = jdist.global_mesh(cells, loci_shards=loci)

    def loss_fn(p, f, b):
        return jpert_loss(spec, p, f, b, mesh=mesh)

    ref = jfit_map(loss_fn, jmesh.shard_params(
        mesh, {k: jnp.array(v, copy=True) for k, v in params.items()}),
        (fixed, jmesh.shard_batch(mesh, batch)), max_iter=4, min_iter=4,
        learning_rate=5e-2)
    want = np.asarray(ref.losses, np.float64) \
        + _toy_normaliser(jax.scipy.special.gammaln, jnp.asarray)
    results, codes = torch_ranks.launch(
        cells * loci, torch_ranks.fit_toy, {"cells": cells, "loci": loci},
        tmp_path)
    assert codes == [0] * (cells * loci), results
    got = np.asarray(results[0]["losses"], np.float64) \
        + _toy_normaliser(torch.lgamma, torch.from_numpy)
    rel = np.abs(got - want) / np.abs(want)
    print(f"fit_map {cells}x{loci}: worst relative element {rel.max():.3g} "
          f"(iteration 0: {rel[0]:.3g})")
    assert rel[0] < 1e-5, rel
    assert rel.max() < 1e-3, rel
    for r in results[1:]:
        np.testing.assert_array_equal(r["losses"], results[0]["losses"])
        np.testing.assert_array_equal(r["pi"], results[0]["pi"])


@pytest.mark.parametrize("kind", ["dense", "sparse"])
@pytest.mark.parametrize("grid", [(2, 1), (2, 2)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_after_fit_pieces_on_ranks_match_one_rank_and_jax(tmp_path, grid,
                                                          kind):
    """What runs after a fit, on 2 and 2 x 2 gloo ranks, each rank on its
    block of tests/test_torch_rescue.py's problem (12 cells, one masked,
    x 200 loci, 1e3 prior concentrations), gathered: the sums over loci
    that a loci tile splits (the init's loci means and ploidies, the
    entropy aggregates and their maximum, the PPC deviances, the
    rescue's per-cell objective, the loss's global and per-cell priors
    counted once, its parameter-free Dirichlet normaliser out) against
    the port's one-rank run, and the decode, the aggregates and the
    objective against JAX's.  Bars: the decoded states bin for bin; the
    one-rank run's planes and maxima within 1e-6, its sums within 1e-5
    relative (float32 sums in another order; readings up to 1.4e-6, in
    the printed line); the PPC z within 1e-3 absolute
    (tests/test_torch_qc.py's bar against JAX; the deviances sum in
    another order and z divides them by the replicate spread: readings
    up to 1.4e-4); JAX's as tests/test_torch_qc.py and
    tests/test_torch_rescue.py hold the one-rank run (planes 1e-4,
    ``PCO_TOL``)."""
    from scdna_replication_tools_tpu_torch import weights
    from scdna_replication_tools_tpu_torch.models import pert as tpert
    from scdna_replication_tools_tpu_torch.ops.dists import nb_sample
    from scdna_replication_tools_tpu.models import pert as jpert

    from test_torch_rescue import PCO_TOL, _case

    cells, loci = grid
    inp, jspec, tspec, jbatch, tbatch, jfixed, params = _case(
        kind, False, seed=17)
    tp = weights.params_from_jax(params, "cpu")
    tf = weights.fixed_from_jax(inp["fixed"], "cpu")
    R = 6
    with torch.no_grad():
        planes = tpert.decode_discrete(tspec, tp, tf, tbatch,
                                       want_entropy=True)
        delta, lamb, _, _ = tpert._ppc_model(tspec, tp, tf, tbatch,
                                             planes[0], planes[1])
        reps = nb_sample(delta, lamb, R, torch.Generator().manual_seed(3))
        want = {
            "init": tpert.init_params(tspec, tbatch, tf,
                                      t_init=inp["t_init"]),
            "decode": planes,
            "aggregates": tpert.entropy_aggregates_from_planes(
                planes[3], planes[4], tbatch.effective_loci_mask(), 0.3,
                want_max=True),
            "gate": tpert.cell_entropy_aggregates(
                tspec, tp, tf, tbatch, entropy_thresh=0.3),
            "ppc": tpert.ppc_discrepancy(tspec, tp, tf, tbatch,
                                         replicates=reps, num_replicates=R),
            "objective": tpert.per_cell_objective(tspec, tp, tf, tbatch),
            "loss": float(tpert.pert_loss(tspec, tp, tf, tbatch))
            + torch_ranks.batch_normaliser(tbatch)}
    payload = {
        "cells": cells, "loci": loci, "spec_kw": inp["spec_kw"],
        "batch": {k: getattr(tbatch, k).numpy() for k in PertBatch.FIELDS
                  if getattr(tbatch, k) is not None},
        "fixed": {k: v.numpy() for k, v in tf.items()},
        "params": {k: v.numpy() for k, v in tp.items()},
        "t_init": inp["t_init"], "replicates": reps.numpy()}
    results, codes = torch_ranks.launch(cells * loci, torch_ranks.after_fit,
                                        payload, tmp_path)
    assert codes == [0] * (cells * loci), results
    got = results[0]

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max())

    worst = {}
    for k, v in want["init"].items():
        worst[f"init.{k}"] = rel(got["init"][k], v.numpy())
    for i in (0, 1):
        np.testing.assert_array_equal(got["decode"][i], planes[i].numpy())
    for i in (2, 3, 4):
        np.testing.assert_allclose(got["decode"][i], planes[i].numpy(),
                                   rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["aggregates"]["max_cn_entropy"],
                               want["aggregates"]["max_cn_entropy"].numpy(),
                               rtol=0, atol=1e-6)
    for k in ("mean_cn_entropy", "frac_low_conf", "mean_rep_entropy"):
        worst[k] = rel(got["aggregates"][k], want["aggregates"][k].numpy())
    for i, t in enumerate(want["gate"]):
        worst[f"gate.{i}"] = rel(got["gate"][i], t.numpy())
    worst["ppc_deviance"] = rel(got["ppc"][0], want["ppc"][0].numpy())
    worst["objective"] = rel(got["objective"], want["objective"].numpy())
    worst["loss"] = rel(got["loss"], want["loss"])
    z = float(np.abs(got["ppc"][1] - want["ppc"][1].numpy()).max())
    print(f"after fit {cells}x{loci} {kind}: ppc z {z:.3g}, "
          + ", ".join(f"{k} {v:.3g}" for k, v in worst.items()))
    assert z < 1e-3, z
    assert max(worst.values()) < 1e-5, worst
    for r in results[1:]:
        np.testing.assert_array_equal(r["objective"], got["objective"])
        np.testing.assert_array_equal(r["ppc"][1], got["ppc"][1])
    # against JAX, at its one-device tolerances for the one-rank port
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ref = [np.asarray(a) for a in jpert.decode_discrete(
        jspec, jp, jfixed, jbatch, want_entropy=True)]
    np.testing.assert_array_equal(got["decode"][0], ref[0])
    np.testing.assert_array_equal(got["decode"][1], ref[1])
    jagg = jpert.entropy_aggregates_from_planes(
        jnp.asarray(ref[3]), jnp.asarray(ref[4]),
        jnp.asarray(tbatch.effective_loci_mask().numpy()), 0.3,
        want_max=True)
    for k, v in jagg.items():
        np.testing.assert_allclose(got["aggregates"][k], np.asarray(v),
                                   rtol=0, atol=1e-4, err_msg=k)
    jobj = np.asarray(jpert.per_cell_objective(jspec, jp, jfixed, jbatch))
    assert rel(got["objective"], jobj) < PCO_TOL["prior"]


@pytest.mark.parametrize("kind", ["step1", "dense", "sparse"])
def test_loss_gradients_on_a_2x2_grid_match_one_rank(tmp_path, kind):
    """What the fit steps on, on a 2 x 2 grid of gloo ranks: the loss
    summed over the ranks and every gradient after
    ``RankMesh.reduce_grads`` (a replicated leaf summed over the whole
    grid, ``rho`` over its column, a per-cell leaf over its row),
    gathered, against the one-rank loss and gradients on
    tests/test_torch_rescue.py's problem.  Loss within 3e-5 relative (its
    Dirichlet normaliser out; float32 sums in another order, readings up
    to 9.6e-6 on step 1's); each gradient within 1e-4 of its largest
    element (readings up to 3.6e-6)."""
    from scdna_replication_tools_tpu_torch import weights
    from scdna_replication_tools_tpu_torch.models import pert as tpert

    from test_torch_rescue import _case

    inp, _, tspec, _, tbatch, _, params = _case(kind, False, seed=23)
    tp = weights.params_from_jax(params, "cpu")
    tf = weights.fixed_from_jax(inp["fixed"], "cpu")
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss = tpert.pert_loss(tspec, leaves, tf, tbatch)
    loss.backward()
    want = float(loss) + torch_ranks.batch_normaliser(tbatch)
    payload = {
        "cells": 2, "loci": 2, "spec_kw": inp["spec_kw"],
        "batch": {k: getattr(tbatch, k).numpy() for k in PertBatch.FIELDS
                  if getattr(tbatch, k) is not None},
        "fixed": {k: v.numpy() for k, v in tf.items()},
        "params": {k: v.numpy() for k, v in tp.items()}}
    results, codes = torch_ranks.launch(4, torch_ranks.loss_grads, payload,
                                        tmp_path)
    assert codes == [0] * 4, results
    got = results[0]
    readings = {"loss": abs(got["loss"] - want) / abs(want)}
    for k, v in leaves.items():
        g = v.grad.numpy()
        readings[k] = float(np.abs(got["grads"][k] - g).max()
                            / max(np.abs(g).max(), 1e-30))
    print(f"gradients 2x2 {kind}: "
          + ", ".join(f"{k} {v:.3g}" for k, v in readings.items()))
    assert readings.pop("loss") < 3e-5
    assert max(readings.values()) < 1e-4, readings
    for r in results[1:]:
        for k in leaves:
            np.testing.assert_array_equal(r["grads"][k], got["grads"][k])


@pytest.fixture(scope="module")
def carried(step2_jax):
    """tests/test_torch_rescue.py's corrupted step-2 state (three late-S
    cells moved into the mirrored basin) through JAX's work after step
    2: ``package_step_output`` with the QC collection, ``build_cell_qc``
    and ``_mirror_rescue``; with the payload that carries the same state
    to the port's ranks."""
    import dataclasses

    import pandas as pd

    from scdna_replication_tools_tpu.config import ColumnConfig as JCols
    from scdna_replication_tools_tpu.infer import runner as jrunner
    from scdna_replication_tools_tpu_torch import weights
    from scdna_replication_tools_tpu_torch.data.loader import PertData

    from test_torch_rescue import RESCUE_CFG, _final_objective

    jinf, step, late, _ = step2_jax
    data = jinf._step2_data
    C, L = data.reads.shape
    cn_long = pd.DataFrame({
        "cell_id": np.repeat(np.asarray(data.cell_ids), L),
        "chr": np.tile(data.loci.get_level_values(0), C),
        "start": np.tile(data.loci.get_level_values(1), C)})
    lamb = float(step.fixed["lamb"])
    losses = np.asarray(step.fit.losses)
    # the QC table before this rescue, as the port's fresh runner's (the
    # fixture's run_step2 ran the gated rescue on the uncorrupted state)
    jinf._rescue_cells = jinf.mirror_rescue_stats = None
    qc = {}
    frame, supp = jrunner.package_step_output(
        cn_long, data, step, lamb, losses, losses, JCols(), qc_collect=qc)
    table = jinf.build_cell_qc(step, data, qc)
    rescued = jinf._mirror_rescue(step, step.batch)
    js, jb = step.spec, step.batch

    def port_data(d):
        return PertData(**{f.name: getattr(d, f.name)
                           for f in dataclasses.fields(PertData)})
    batch = {k: np.asarray(getattr(jb, k)) for k in PertBatch.FIELDS
             if getattr(jb, k, None) is not None}
    batch["libs"] = batch["libs"].astype(np.int64)
    payload = {
        "s": port_data(data), "g1": port_data(jinf.g1),
        "config": dict(telemetry_path=None, **RESCUE_CFG),
        "spec_kw": dict(P=js.P, K=js.K, L=js.L, tau_mode=js.tau_mode,
                        step1=js.step1, cond_beta_means=js.cond_beta_means,
                        cond_rho=js.cond_rho, cond_a=js.cond_a,
                        fixed_lamb=js.fixed_lamb,
                        sparse_etas=js.sparse_etas),
        "batch": batch,
        "fixed": {k: v.numpy() for k, v in
                  weights.fixed_from_jax(step.fixed, "cpu").items()},
        "params": {k: v.numpy() for k, v in
                   weights.params_from_jax(step.fit.params, "cpu").items()},
        "losses": losses, "lamb": lamb, "cn_long": cn_long}
    return {"frame": frame, "supp": supp, "cell_qc": table,
            "stats": dict(jinf.mirror_rescue_stats),
            "cells": {k: np.asarray(v).tolist()
                      for k, v in jinf._rescue_cells.items()},
            "objective": _final_objective("jax", rescued,
                                          rescued.fit.params),
            "late": late, "payload": payload}


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_work_after_step2_on_ranks_matches_jax(tmp_path, carried, grid):
    """The runner's work after step 2 on 2 and 2 x 2 gloo ranks, each on
    its block of the same carried-over step-2 state as JAX (the runner's
    own ``_place_params``): ``package_step_output`` gives JAX's frames
    (the same rows and columns in the same order, the decoded states
    bin for bin, the fitted values and entropies within 1e-4 of each
    column's scale); ``build_cell_qc`` JAX's table (the same cells and
    flags other than ppc_outlier, the aggregates, tau and the observed
    PPC deviance within 1e-4 of each column's scale; ppc_z rests on each
    side's replicate draws); ``_mirror_rescue`` JAX's statistics,
    candidates and accepted cells (each shard re-fits its own
    candidates), every corrupted cell restored, and the rescued step's
    per-cell objectives within 1e-5 of JAX's (tests/test_torch_rescue.py's
    bar for the one-rank run)."""
    cells, loci = grid
    results, codes = torch_ranks.launch(
        cells * loci, torch_ranks.carried_step2,
        {**carried["payload"], "cells": cells, "loci": loci}, tmp_path)
    assert codes == [0] * (cells * loci), results
    got = results[0]

    def worst(a, b, cols):
        out = {}
        for col in cols:
            x, y = a[col].to_numpy(float), b[col].to_numpy(float)
            out[col] = float(np.nanmax(np.abs(x - y))
                             / max(1.0, np.nanmax(np.abs(x))))
        return out
    jf, tf = carried["frame"], got["frame"]
    assert list(tf.columns) == list(jf.columns) and tf.shape == jf.shape
    for col in ("cell_id", "chr", "start", "model_cn_state",
                "model_rep_state"):
        np.testing.assert_array_equal(tf[col].to_numpy(), jf[col].to_numpy(),
                                      err_msg=col)
    close = [c for c in jf.columns if c.startswith("model_")
             and c not in ("model_cn_state", "model_rep_state")]
    readings = worst(jf, tf, close)
    jq, tq = carried["cell_qc"], got["cell_qc"]
    assert list(tq.columns) == list(jq.columns) and len(tq) == len(jq)
    for col in ("cell_id", "rescue_candidate", "rescue_accepted"):
        assert (tq[col].to_numpy() == jq[col].to_numpy()).all(), col
    readings.update(worst(jq, tq, ["model_tau", "mean_cn_entropy",
                                   "max_cn_entropy", "frac_low_conf",
                                   "mean_rep_entropy", "ppc_deviance"]))

    def flags(df):
        return df["qc_flags"].map(lambda s: tuple(
            f for f in s.split(",") if f and f != "ppc_outlier"))
    assert (flags(jq) == flags(tq)).all()
    rel = np.abs(got["objective"] - carried["objective"]) \
        / np.abs(carried["objective"])
    print(f"after step 2 {cells}x{loci}: rescued objective {rel.max():.3g}, "
          + ", ".join(f"{k} {v:.3g}" for k, v in readings.items()))
    assert max(readings.values()) <= 1e-4, readings
    for r in results:
        assert r["stats"] == carried["stats"]
        assert {k: r["cells"][k] for k in ("candidates", "accepted")} \
            == {k: carried["cells"][k] for k in ("candidates", "accepted")}
        np.testing.assert_array_equal(r["objective"], got["objective"])
    assert set(carried["late"]) <= set(got["cells"]["accepted"])
    assert all(got["tau"][i] > 0.5 for i in carried["late"])
    assert float(rel.max()) < 1e-5, float(rel.max())


HMM_SELF_PROB = 0.99


def test_viterbi_decode_on_a_loci_sharded_grid_matches_jax(
        tmp_path, step2_jax, carried):
    """``cn_hmm_self_prob`` on a 2 x 2 grid (cells and loci sharded):
    the runner takes the option, each rank decodes whole rows of its
    cells (the emissions gathered along its loci row) and the packaged S
    frame equals JAX's one-process 2 x 2 mesh decode of the same
    carried-over step-2 state (the CN and replication states bin for
    bin, the CN entropies within 1e-6) and the port's one-rank decode
    (the states bin for bin, the entropies within 1e-6).  The chain
    restarts at each chromosome start, so a loci tile's chain would
    differ from the whole row's: the gather is what this holds."""
    import dataclasses

    from scdna_replication_tools_tpu.config import ColumnConfig as JCols
    from scdna_replication_tools_tpu.infer import runner as jrunner

    jinf, step, _, _ = step2_jax
    pay = carried["payload"]
    jm = jmesh.make_mesh(2, loci_shards=2)
    jstep = dataclasses.replace(
        step, batch=jmesh.shard_batch(jm, step.batch),
        fixed=jmesh.replicate_fixed(jm, step.fixed),
        fit=dataclasses.replace(step.fit, params=jmesh.shard_params(
            jm, step.fit.params)))
    jframe, _ = jrunner.package_step_output(
        pay["cn_long"], jinf._step2_data, jstep, pay["lamb"], pay["losses"],
        pay["losses"], JCols(), hmm_self_prob=HMM_SELF_PROB, qc_collect={})
    payload = {**pay, "hmm": HMM_SELF_PROB}
    one = torch_ranks.hmm_decode_step2(
        0, 1, {**payload, "cells": 1, "loci": 1}, tmp_path)["frame"]
    results, codes = torch_ranks.launch(
        4, torch_ranks.hmm_decode_step2, {**payload, "cells": 2, "loci": 2},
        tmp_path)
    assert codes == [0] * 4, results
    grid = results[0]["frame"]
    for ref, label in ((jframe, "JAX 2x2 mesh"), (one, "port one rank")):
        assert list(grid.columns) == list(ref.columns), label
        for col in ("cell_id", "chr", "start", "model_cn_state",
                    "model_rep_state"):
            np.testing.assert_array_equal(grid[col].to_numpy(),
                                          ref[col].to_numpy(),
                                          err_msg=f"{label}: {col}")
        np.testing.assert_allclose(
            grid["model_cn_entropy"].to_numpy(float),
            ref["model_cn_entropy"].to_numpy(float), rtol=0, atol=1e-6,
            err_msg=label)


def test_viterbi_rows_on_a_loci_sharded_grid(tmp_path):
    """``hmm_decode`` with a mesh on 2 x 2 gloo ranks, on seeded joint
    logits (10 cells, 300 loci, two chromosomes of 100 and 200): every
    rank's tile of the paths equals the one-rank decode bit for bit (so
    the chain ran over whole rows: decoding each loci tile alone gives
    other paths on these logits) and JAX's as
    ``test_torch_hmm.test_hmm_decode_from_the_same_joint_logits`` holds
    it; the replication states and p_rep bit for bit the one-rank's."""
    import jax.numpy as jnp

    from scdna_replication_tools_tpu.models import hmm as jhmm
    from scdna_replication_tools_tpu_torch.models import hmm as thmm

    from test_torch_hmm import ALIKE

    rng = np.random.default_rng(2)
    joint = rng.normal(0, 4, (10, 300, 13, 2)).astype(np.float32)
    # the second chromosome starts inside the first loci tile
    restart = np.r_[1.0, np.zeros(99), 1.0, np.zeros(199)] \
        .astype(np.float32)
    one = [t.numpy() for t in thmm.hmm_decode(torch.from_numpy(joint),
                                              restart, HMM_SELF_PROB)]
    tiles = [thmm.hmm_decode(torch.from_numpy(joint[:, sl]), restart[sl],
                             HMM_SELF_PROB)[0].numpy()
             for sl in (slice(0, 150), slice(150, 300))]
    assert (np.concatenate(tiles, axis=1) != one[0]).any()
    results, codes = torch_ranks.launch(
        4, torch_ranks.hmm_rows, {"joint": joint, "restart": restart,
                                  "self_prob": HMM_SELF_PROB}, tmp_path)
    assert codes == [0] * 4, results
    for r in results:
        for got, want in zip(r, one):
            np.testing.assert_array_equal(got, want)
    ref = [np.asarray(a) for a in jhmm.hmm_decode(
        jnp.asarray(joint), jnp.asarray(restart), HMM_SELF_PROB)]
    assert (results[0][0] == ref[0]).mean() >= ALIKE
    assert (results[0][1] == ref[1]).mean() >= ALIKE


def test_fingerprints_and_consensus_across_ranks(tmp_path):
    """Two ranks: all_host_fingerprints gathers every rank's digest on
    every rank; combined_fingerprint equals JAX's on that map (deduped
    when the ranks agree, else hashed in rank order); consensus_ok is
    the AND over the ranks."""
    results, codes = torch_ranks.launch(2, torch_ranks.identity, None,
                                        tmp_path)
    assert codes == [0, 0], results
    for case in ("same", "differ"):
        maps = [r[case]["fps"] for r in results]
        assert maps[0] == maps[1]
        fp = {0: "0123456789abcdef",
              1: "0123456789abcdef" if case == "same" else "fedcba9876543210"}
        assert maps[0] == fp
        assert results[0][case]["combined"] \
            == jmanifest.combined_fingerprint(fp)
    assert [r["consensus"] for r in results] == [[True, False, False]] * 2
    assert manifest.all_host_fingerprints("abc") == {0: "abc"}
    assert manifest.consensus_ok(False) is False


@pytest.mark.parametrize("grid", [(2, 1), (2, 2)],
                         ids=lambda g: f"{g[0]}x{g[1]}")
def test_sharded_generation_round_trips_between_packages(tmp_path, grid):
    """A generation that 2 (2 x 2) port ranks save with the two-phase
    commit merges, in JAX's load_step and in the port's, into the full
    arrays the ranks held blocks of (parameters, Adam moments, the
    best-loss params; replicated leaves whole), with JAX's commit
    document; a later uncoordinated save stays invisible."""
    cells, loci = grid
    results, codes = torch_ranks.launch(
        cells * loci, torch_ranks.save_generation,
        {"cells": cells, "loci": loci}, tmp_path)
    assert codes == [0] * (cells * loci), results
    full = torch_ranks.generation_arrays()
    doc = json.loads((tmp_path / "ck" / "pert_step2.commit.json").read_text())
    assert doc["seq"] == 1 and doc["process_count"] == cells * loci
    assert doc["topology"]["mesh_axes"] == (
        {"cells": cells, "loci": loci} if loci > 1 else {"cells": cells})
    for load in (jckpt.load_step, ckpt.load_step):
        params, losses, extra = load(str(tmp_path / "ck"), "step2")
        for name, value in full["params"].items():
            np.testing.assert_array_equal(np.asarray(params[name]), value)
        np.testing.assert_array_equal(losses, full["losses"])
        assert int(extra["meta.num_iters"]) == 7
        names = sorted(full["params"])
        for i, name in enumerate(names):
            np.testing.assert_array_equal(
                np.asarray(extra[f"opt.{1 + i}"]), full["params"][name] * 2)
        np.testing.assert_array_equal(np.asarray(extra["best.tau_raw"]),
                                      full["params"]["tau_raw"] + 1)
        assert float(extra["ctrl.best_loss"]) == 3.5


def test_jax_generation_loads_in_the_port(tmp_path):
    """The generation JAX's tests/test_topology_resume.py writes (two
    hosts' halves of a 24-cell tau) merges in the port's load_step."""
    full = np.arange(24.0, dtype=np.float32)
    _write_generation(tmp_path, full)
    params, _, extra = ckpt.load_step(str(tmp_path), "step2")
    np.testing.assert_array_equal(params["tau_raw"], full)
    assert int(extra["meta.num_iters"]) == 10


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_uncommitted_generation_is_invisible(tmp_path, writer):
    """Crash between the shard writes and the commit: the previous
    complete generation is what both loaders see."""
    old = np.arange(24.0, dtype=np.float32)
    _write_generation(tmp_path, old, iters=10)
    save = (jckpt if writer == "jax" else ckpt)._save_step_multiprocess
    save(str(tmp_path), "step2", _host_flat(1, old + 100.0, iters=20), 2, 1,
         None, coordinate=False)
    for load in (jckpt.load_step, ckpt.load_step):
        params, _, extra = load(str(tmp_path), "step2")
        np.testing.assert_array_equal(params["tau_raw"], old)
        assert int(extra["meta.num_iters"]) == 10


def test_corrupt_committed_generation_falls_back_to_previous(tmp_path):
    old = np.arange(24.0, dtype=np.float32)
    _write_generation(tmp_path, old, iters=10)
    _write_generation(tmp_path, old + 7.0, iters=20)
    shard = tmp_path / "pert_step2.s2.p1of2.npz"
    shard.write_bytes(shard.read_bytes()[:100])
    for load in (jckpt.load_step, ckpt.load_step):
        params, _, extra = load(str(tmp_path), "step2")
        np.testing.assert_array_equal(params["tau_raw"], old)
        assert int(extra["meta.num_iters"]) == 10


def test_emergency_save_is_uncoordinated(tmp_path, monkeypatch):
    """A dying rank saves phase 1 only: its shard file, no barrier, no
    commit — the generation stays invisible (JAX's pin of the same
    name)."""
    monkeypatch.setattr(dist, "process_rank_and_count", lambda: (1, 2))
    ckpt.save_step(str(tmp_path), "step2",
                   {"tau_raw": np.ones(12, np.float32)},
                   np.zeros(2, np.float32), num_iters=2, converged=False,
                   mesh=_grid_mesh(2, 1, 1), coordinate=False)
    assert (tmp_path / "pert_step2.s1.p1of2.npz").exists()
    assert not (tmp_path / "pert_step2.commit.json").exists()
    monkeypatch.undo()
    assert ckpt.load_step(str(tmp_path), "step2") is None
    assert jckpt.load_step(str(tmp_path), "step2") is None
