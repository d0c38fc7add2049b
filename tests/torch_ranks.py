"""Multi-rank runs of the PyTorch port for the tests, on the CPU.

:func:`launch` spawns ``world`` processes (start method ``spawn``), each
joining a gloo process group through a ``file://`` store under the test's
temporary directory with a short collective timeout, and runs one of the
module-level targets below on every rank; each rank's return value comes
back pickled.  A launch has its own wall-clock limit: a rank still alive
at it is killed and the launch fails, so a hang costs seconds, not the
suite's time limit.  The children import the port and NumPy/pandas only,
never JAX.
"""

from __future__ import annotations

import os
import pickle
import time
import traceback
from pathlib import Path

import numpy as np

# a collective waits at most this long for a peer (seconds)
COLLECTIVE_TIMEOUT = 30.0
# one launch's wall-clock limit (seconds)
LAUNCH_TIMEOUT = 120.0


def launch(world: int, target, payload, tmp: Path,
           timeout: float = LAUNCH_TIMEOUT,
           collective_timeout: float = COLLECTIVE_TIMEOUT):
    """Run ``target(rank, world, payload, tmp)`` on ``world`` gloo ranks;
    returns ``(results, exitcodes)``, ``results[rank]`` the rank's return
    value or the text of the exception it raised."""
    import torch.multiprocessing as mp

    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    store = tmp / f"store-{os.getpid()}-{time.monotonic_ns()}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(
        rank, world, str(store), target, payload, str(tmp),
        collective_timeout)) for rank in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    for p in procs:
        p.join(max(deadline - time.monotonic(), 0.1))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join(10)
    if hung:
        raise TimeoutError(f"{len(hung)} of {world} ranks still running "
                           f"after {timeout} s")
    results = []
    for rank in range(world):
        path = tmp / f"rank{rank}.pkl"
        results.append(pickle.loads(path.read_bytes())
                       if path.exists() else None)
        if path.exists():
            path.unlink()
    return results, [p.exitcode for p in procs]


def _entry(rank, world, store, target, payload, tmp, collective_timeout):
    import torch

    from scdna_replication_tools_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed("gloo", f"file://{store}", world, rank,
                     timeout=collective_timeout)
    try:
        out = target(rank, world, payload, Path(tmp))
    except BaseException:
        out = {"error": traceback.format_exc()}
        Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
        raise
    Path(tmp, f"rank{rank}.pkl").write_bytes(pickle.dumps(out))
    import torch.distributed as dist

    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

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
    from scdna_replication_tools_tpu_torch.config import ColumnConfig
    from scdna_replication_tools_tpu_torch.data.loader import (
        build_pert_inputs,
    )

    s, g1 = build_pert_inputs(*port_frames(frames),
                              ColumnConfig(rt_prior_col=None))
    return s, g1, np.array([0] * 12 + [1] * 12, np.int32)


def toy_arrays(num_cells=16, num_loci=64, P=13):
    """The NumPy inputs of JAX ``__graft_entry__._toy_problem`` (seed 0)."""
    rng = np.random.default_rng(0)
    reads = rng.poisson(40, (num_cells, num_loci)).astype(np.float32)
    gammas = rng.uniform(0.35, 0.6, num_loci).astype(np.float32)
    etas = np.ones((num_cells, num_loci, P), np.float32)
    etas[:, :, 2] = 1e5
    return reads, gammas, etas


# ---------------------------------------------------------------------------
# rank targets
# ---------------------------------------------------------------------------

def fit_toy(rank, world, payload, tmp):
    """``fit_map`` on the toy problem (sparse prior) on a grid of
    ``payload['cells']`` x ``payload['loci']`` ranks: the rank's block
    of the batch and of the initial parameters, four iterations; returns
    the loss history."""
    import torch

    from scdna_replication_tools_tpu_torch.infer.runner import _PertLossFn
    from scdna_replication_tools_tpu_torch.infer.svi import fit_map
    from scdna_replication_tools_tpu_torch.models.pert import (
        PertBatch,
        PertModelSpec,
        init_params,
    )
    from scdna_replication_tools_tpu_torch.models.priors import (
        eta_batch_fields,
    )
    from scdna_replication_tools_tpu_torch.ops.gc import gc_features
    from scdna_replication_tools_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(payload["cells"], payload["loci"])
    reads, gammas, etas = toy_arrays()
    eta = eta_batch_fields(etas, allow_sparse=True, device="cpu")
    bins = ("cells", "loci")
    batch = PertBatch(
        reads=torch.as_tensor(mesh.tile(reads, bins)).contiguous(),
        libs=torch.zeros((reads.shape[0] // mesh.cells,), dtype=torch.int64),
        gamma_feats=gc_features(torch.as_tensor(
            mesh.tile(gammas, ("loci",))).contiguous(), 4),
        mask=torch.ones((reads.shape[0] // mesh.cells,)),
        eta_idx=mesh.tile(eta["eta_idx"], bins).contiguous(),
        eta_w=mesh.tile(eta["eta_w"], bins).contiguous())
    spec = PertModelSpec(P=13, K=4, L=1, tau_mode="param",
                         cond_beta_means=True, fixed_lamb=True,
                         sparse_etas=True)
    fixed = {"beta_means": torch.zeros((1, 5)),
             "lamb": torch.tensor(0.75)}
    t_init = mesh.tile(np.full(reads.shape[0], 0.4, np.float32), ("cells",))
    params = init_params(spec, batch, fixed, t_init=t_init, mesh=mesh)
    fit = fit_map(_PertLossFn(spec, mesh), params, (fixed, batch),
                  max_iter=4, min_iter=4, learning_rate=5e-2, device="cpu")
    return {"losses": fit.losses,
            "tau": mesh.gather(fit.params["tau_raw"], ("cells",)),
            "pi": mesh.gather(fit.params["pi_logits"],
                              ("P", "cells", "loci"))}


def after_fit(rank, world, payload, tmp):
    """The per-cell and per-bin pieces after a fit, on a grid of
    ``payload['cells']`` x ``payload['loci']`` ranks: each rank's block of
    the full problem in ``payload`` (``spec_kw``, ``batch``, ``fixed``,
    ``params`` and ``replicates``: NumPy arrays of the port's layouts),
    then ``init_params``, the decode with its entropy planes, the entropy
    aggregates (the QC table's, with the maximum, and the rescue gate's),
    the posterior-predictive check on the given replicates, the mirror
    rescue's ``per_cell_objective`` and the loss, each gathered to the
    full array (the loss summed over the ranks)."""
    import torch

    from scdna_replication_tools_tpu_torch import layout
    from scdna_replication_tools_tpu_torch.models import pert as tpert
    from scdna_replication_tools_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(payload["cells"], payload["loci"])
    spec = tpert.PertModelSpec(**payload["spec_kw"])
    batch = tpert.PertBatch(**{
        k: torch.as_tensor(mesh.tile(v, layout.batch_dims(k))).contiguous()
        for k, v in payload["batch"].items()})
    fixed = {k: torch.as_tensor(mesh.tile(v, ("loci",) if k == "rho"
                                          else ())).contiguous()
             for k, v in payload["fixed"].items()}
    params = {k: torch.as_tensor(mesh.tile(v, layout.param_dims(k)))
              .contiguous() for k, v in payload["params"].items()}
    bins, cells = ("cells", "loci"), ("cells",)
    out = {"init": {k: mesh.gather(v, layout.param_dims(k))
                    for k, v in tpert.init_params(
                        spec, batch, fixed, mesh=mesh,
                        t_init=mesh.tile(payload["t_init"], cells))
                    .items()}}
    with torch.no_grad():
        planes = tpert.decode_discrete(spec, params, fixed, batch,
                                       want_entropy=True)
        out["decode"] = [mesh.gather(t, bins) for t in planes]
        agg = tpert.entropy_aggregates_from_planes(
            planes[3], planes[4], batch.effective_loci_mask(), 0.3,
            want_max=True, mesh=mesh)
        out["aggregates"] = {k: mesh.gather(v, cells)
                             for k, v in agg.items()}
        out["gate"] = [mesh.gather(t, cells) for t in
                       tpert.cell_entropy_aggregates(
                           spec, params, fixed, batch, entropy_thresh=0.3,
                           mesh=mesh)]
        reps = mesh.tile(payload["replicates"], ("R",) + bins)
        out["ppc"] = [mesh.gather(t, cells) for t in tpert.ppc_discrepancy(
            spec, params, fixed, batch, replicates=reps,
            num_replicates=reps.shape[0], mesh=mesh)]
        out["objective"] = mesh.gather(tpert.per_cell_objective(
            spec, params, fixed, batch, mesh=mesh), cells)
        # the loss with the parameter-free Dirichlet normaliser out (its
        # float32 lgamma terms cancel from ~2e7 a bin)
        loss = tpert.pert_loss(spec, params, fixed, batch, mesh=mesh)
        out["loss"] = float(mesh.all_reduce(
            (loss + batch_normaliser(batch)).reshape(1))[0])
    return out


def loss_grads(rank, world, payload, tmp):
    """The loss and its gradients on a grid of ``payload['cells']`` x
    ``payload['loci']`` ranks, each rank on its block of the problem in
    ``payload`` (as :func:`after_fit`): this rank's share through
    autograd, summed by ``RankMesh.reduce_grads`` as the fit sums them
    before Adam, each gradient gathered to the full array."""
    import torch

    from scdna_replication_tools_tpu_torch import layout
    from scdna_replication_tools_tpu_torch.models import pert as tpert
    from scdna_replication_tools_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(payload["cells"], payload["loci"])
    spec = tpert.PertModelSpec(**payload["spec_kw"])
    batch = tpert.PertBatch(**{
        k: torch.as_tensor(mesh.tile(v, layout.batch_dims(k))).contiguous()
        for k, v in payload["batch"].items()})
    fixed = {k: torch.as_tensor(mesh.tile(v, ("loci",) if k == "rho"
                                          else ())).contiguous()
             for k, v in payload["fixed"].items()}
    leaves = {k: torch.as_tensor(mesh.tile(v, layout.param_dims(k)))
              .contiguous().requires_grad_(True)
              for k, v in payload["params"].items()}
    loss = tpert.pert_loss(spec, leaves, fixed, batch, mesh=mesh)
    # a leaf that this rank's share leaves out (a global prior off rank
    # 0) has a zero gradient, as in the fit's iteration
    grads = {k: torch.zeros_like(leaves[k]) if g is None else g
             for k, g in zip(leaves, torch.autograd.grad(
                 loss, list(leaves.values()), allow_unused=True))}
    loss, grads = mesh.reduce_grads(loss.detach()
                                    + batch_normaliser(batch), grads)
    return {"loss": float(loss),
            "grads": {k: mesh.gather(g, layout.param_dims(k))
                      for k, g in grads.items()}}


def _carried_step(payload, **config):
    """(``PertInference`` of ``payload['config']`` and ``config`` on the S
    and G1 data, the carried step-2 state as a ``StepOutput`` placed on
    this rank's block through the runner's own seam: ``_place_params``
    and the mesh's tile)."""
    import torch

    from scdna_replication_tools_tpu_torch import layout
    from scdna_replication_tools_tpu_torch.config import PertConfig
    from scdna_replication_tools_tpu_torch.infer.runner import (
        PertInference,
        StepOutput,
    )
    from scdna_replication_tools_tpu_torch.infer.svi import FitResult
    from scdna_replication_tools_tpu_torch.models import pert as tpert

    inf = PertInference(payload["s"], payload["g1"], PertConfig(
        num_shards=payload["cells"], loci_shards=payload["loci"],
        **payload["config"], **config), device="cpu")
    mesh = inf.mesh
    spec = tpert.PertModelSpec(**payload["spec_kw"])
    batch = tpert.PertBatch(**{
        k: torch.as_tensor(v if mesh is None
                           else mesh.tile(v, layout.batch_dims(k)))
        .contiguous() for k, v in payload["batch"].items()})
    fixed = {k: torch.as_tensor(v) for k, v in payload["fixed"].items()}
    losses = payload["losses"]
    step = StepOutput(FitResult(
        params=inf._place_params(payload["params"]), losses=losses,
        num_iters=len(losses), converged=False, nan_abort=False),
        spec, fixed, batch, 0.0)
    return inf, step


def carried_step2(rank, world, payload, tmp):
    """The runner's work after step 2 on a carried-over step-2 state, on a
    grid of ``payload['cells']`` x ``payload['loci']`` ranks:
    ``PertInference`` of ``payload['config']`` on the S and G1 data
    (``payload['s']``, ``payload['g1']``), the full step (``spec_kw``,
    ``batch``, ``fixed``, ``params``, ``losses``, NumPy arrays of the
    port's layouts) placed on this rank's block (:func:`_carried_step`),
    then ``package_step_output`` with the QC collection, ``build_cell_qc``
    and ``_mirror_rescue``; returns (rank 0) the frames and the QC table,
    and (every rank) the rescue's statistics and cells and the rescued
    step's gathered tau and per-cell objective under the rescue's
    conditioning."""
    import dataclasses

    import torch

    from scdna_replication_tools_tpu_torch.config import ColumnConfig
    from scdna_replication_tools_tpu_torch.infer.runner import (
        package_step_output,
    )
    from scdna_replication_tools_tpu_torch.models import pert as tpert
    from scdna_replication_tools_tpu_torch.ops.transforms import (
        to_unit_interval,
    )

    inf, step = _carried_step(payload)
    mesh, spec, fixed, batch = inf.mesh, step.spec, step.fixed, step.batch
    losses = payload["losses"]
    qc: dict = {}
    frame, supp = package_step_output(
        payload["cn_long"], payload["s"], step, payload["lamb"], losses,
        losses, ColumnConfig(), qc_collect=qc, mesh=mesh)
    table = inf.build_cell_qc(step, payload["s"], qc)
    rescued = inf._mirror_rescue(step, batch)
    cond = dataclasses.replace(spec, cond_rho=True, cond_a=True)
    p = rescued.fit.params
    with torch.no_grad():
        c = tpert._sites(spec, p, fixed)
        obj = tpert.per_cell_objective(
            cond, p, dict(fixed, rho=c["rho"], a=c["a"]), batch, mesh=mesh)
    return {"frame": frame if rank == 0 else None,
            "supp": supp if rank == 0 else None,
            "cell_qc": table if rank == 0 else None,
            "stats": inf.mirror_rescue_stats,
            "cells": {k: v.tolist() for k, v in inf._rescue_cells.items()},
            "tau": mesh.gather(to_unit_interval(p["tau_raw"]), ("cells",)),
            "objective": mesh.gather(obj, ("cells",))}


def hmm_decode_step2(rank, world, payload, tmp):
    """The packaging decode of a carried-over step-2 state with the
    Viterbi CN chain (``cn_hmm_self_prob=payload['hmm']``), on a grid of
    ``payload['cells']`` x ``payload['loci']`` ranks (one: no process
    group, the plain run): the runner built with the option, the step on
    this rank's block (:func:`_carried_step`), ``package_step_output``
    with the QC collection; returns (rank 0) the S frame."""
    from scdna_replication_tools_tpu_torch.config import ColumnConfig
    from scdna_replication_tools_tpu_torch.infer.runner import (
        package_step_output,
    )

    inf, step = _carried_step(payload, cn_hmm_self_prob=payload["hmm"])
    losses = payload["losses"]
    frame, _ = package_step_output(
        payload["cn_long"], payload["s"], step, payload["lamb"], losses,
        losses, ColumnConfig(), qc_collect={},
        hmm_self_prob=inf.config.cn_hmm_self_prob, mesh=inf.mesh)
    return {"frame": frame if rank == 0 else None}


def hmm_rows(rank, world, payload, tmp):
    """``models.hmm.hmm_decode`` with the mesh of a 2 x 2 grid on this
    rank's block of ``payload['joint']`` (cells, loci, P, 2), the
    restart flags of every locus; returns the three outputs gathered."""
    import torch

    from scdna_replication_tools_tpu_torch.models.hmm import hmm_decode
    from scdna_replication_tools_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2)
    joint = torch.as_tensor(mesh.tile(payload["joint"],
                                      ("cells", "loci", "P", "2")))
    out = hmm_decode(joint.contiguous(), payload["restart"],
                     payload["self_prob"], mesh=mesh)
    return [mesh.gather(t, ("cells", "loci")) for t in out]


def run_inference(rank, world, payload, tmp):
    """``PertInference.run`` of the port on the synthetic frames with
    ``payload['config']`` (a dict of PertConfig fields); returns each
    step's losses and the gathered tau."""
    from scdna_replication_tools_tpu_torch.config import PertConfig
    from scdna_replication_tools_tpu_torch.infer.runner import PertInference
    from scdna_replication_tools_tpu_torch.models.pert import _sites

    s, g1, clone_idx = port_inputs(payload["frames"])
    inf = PertInference(s, g1, PertConfig(**payload["config"]),
                        clone_idx_s=clone_idx, clone_idx_g1=clone_idx,
                        num_clones=2, device="cpu")
    steps = inf.run()
    out = {"losses": [None if st is None else st.fit.losses
                      for st in steps],
           "normaliser": [None if st is None else normaliser_sum(st)
                          for st in steps]}
    step2 = steps[1]
    tau = _sites(step2.spec, step2.fit.params, step2.fixed)["tau"]
    out["tau"] = inf._gather(tau, ("cells",))
    return out


def normaliser_sum(step) -> float:
    """This rank's share of a step's parameter-free Dirichlet normaliser
    over its real bins (0 for step 1, whose flat term is lgamma(P))."""
    return batch_normaliser(step.batch)


def batch_normaliser(b) -> float:
    """:func:`normaliser_sum` of a batch whose cache a loss filled."""
    cache = b.cache
    if "dir_norm" not in cache:
        return 0.0
    bin_mask = b.mask[:, None] * b.effective_loci_mask()[None, :]
    return float((cache["dir_norm"] * bin_mask).sum())


def run_scrt(rank, world, payload, tmp):
    """``scRT(...).infer('pert')`` of the port on ``payload['frames']``
    (the S and G1 frames) with ``payload['options']``; returns a digest
    of the four output frames, the run log's path, each step's losses
    and normaliser share, the rescue's statistics, and (rank 0) the
    frames and the QC table."""
    import pandas as pd

    from scdna_replication_tools_tpu_torch import scRT

    cn_s, cn_g1 = payload["frames"]
    scrt = scRT(cn_s.copy(), cn_g1.copy(), device="cpu",
                **payload["options"])
    outs = scrt.infer("pert")
    digest = [None if o is None else
              int(pd.util.hash_pandas_object(o, index=True).sum())
              for o in outs]
    return {"digest": digest, "run_log_path": scrt.run_log_path,
            "outputs": outs if rank == 0 else None,
            "cell_qc": scrt.cell_qc() if rank == 0
            and scrt.config.qc else None,
            "rescue": scrt.mirror_rescue_stats,
            "losses": [None if st is None else st.fit.losses
                       for st in scrt.steps],
            "normaliser": [None if st is None else normaliser_sum(st)
                           for st in scrt.steps]}



def identity(rank, world, payload, tmp):
    """The manifest's per-rank identity pieces on two ranks: the gathered
    fingerprints and their combination when the ranks agree and when
    they differ, and the consensus of three verdicts."""
    from scdna_replication_tools_tpu_torch.infer import manifest

    out = {}
    for case in ("same", "differ"):
        fp = "0123456789abcdef" if case == "same" or rank == 0 \
            else "fedcba9876543210"
        fps = manifest.all_host_fingerprints(fp)
        out[case] = {"fps": fps,
                     "combined": manifest.combined_fingerprint(fps)}
    out["consensus"] = [manifest.consensus_ok(True),
                        manifest.consensus_ok(rank == 0),
                        manifest.consensus_ok(False)]
    return out


def generation_arrays():
    """The full state a test generation holds: parameters on every
    layout (per-cell, per-locus, state-major, global) and a loss
    history."""
    rng = np.random.default_rng(5)
    C, L, P = 8, 12, 13
    return {"params": {
        "tau_raw": rng.normal(size=C).astype(np.float32),
        "u": rng.normal(size=C).astype(np.float32),
        "betas": rng.normal(size=(C, 5)).astype(np.float32),
        "pi_logits": rng.normal(size=(P, C, L)).astype(np.float32),
        "rho_raw": rng.normal(size=L).astype(np.float32),
        "a_raw": np.float32(1.25),
        "beta_stds_raw": rng.normal(size=(1, 5)).astype(np.float32)},
        "losses": np.arange(7, dtype=np.float32)}


def save_generation(rank, world, payload, tmp):
    """Each rank saves its blocks of :func:`generation_arrays` (Adam
    moments = 2 x the parameters, best-loss params = parameters + 1) as
    one coordinated generation, then an uncoordinated one."""
    import torch

    from scdna_replication_tools_tpu_torch import layout
    from scdna_replication_tools_tpu_torch.infer import checkpoint as ckpt
    from scdna_replication_tools_tpu_torch.infer.svi import AdamState
    from scdna_replication_tools_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(payload["cells"], payload["loci"])
    full = generation_arrays()
    local = {k: torch.as_tensor(np.ascontiguousarray(
        mesh.tile(np.asarray(v), layout.param_dims(k))))
        for k, v in full["params"].items()}
    state = AdamState(count=torch.tensor(7, dtype=torch.int32),
                      mu={k: v * 2 for k, v in local.items()},
                      nu={k: v * 3 for k, v in local.items()})
    extra = {"ctrl.best_loss": 3.5, "best.tau_raw": local["tau_raw"] + 1}
    d = str(tmp / "ck")
    ckpt.save_step(d, "step2", local, full["losses"], extra=extra,
                   opt_state=state, num_iters=7, converged=False,
                   mesh=mesh)
    ckpt.save_step(d, "step2", {k: v + 100 for k, v in local.items()},
                   full["losses"], num_iters=9, converged=False, mesh=mesh,
                   coordinate=False)
    return {"rank": rank}

