"""Three-step PERT inference (port of ``infer/runner.py``).

  Step 1 — G1/2 cells, each doubled as G1 (rep=0) and G2 (rep=1), cn/rep
           observed; learns lambda + per-library GC beta means/stds
           (reference: pert_model.py:228-251, 718-729).
  Step 2 — S cells with cn/rep enumerated under the CN prior
           (``cn_prior_method``; the default composite prior is dense);
           beta_means conditioned from step 1, lambda fixed
           (reference: pert_model.py:777-830).
  Step 3 — (optional) the step-2 model on the G1/2 cells with rho/a
           conditioned and the one-hot clone prior (sparse)
           (reference: pert_model.py:832-899).

Each step is one ``fit_map`` on one device, under the adaptive
controller (``obs/controller.py``) when it is active (``controller`` on,
``fit_diag_every > 0``, ``min_iter < max_iter``).  Steps 2 and 3 take the
configured pi encoding (``enum_impl='binary'``: the independent-binary
planes), step 1 stays categorical as in the JAX runner; every step
stores the pi parameter's Adam moments in ``optimizer_state_dtype``.
With ``mirror_rescue`` (the default) step 2 is followed by the mirror
rescue: always, without an active controller, or when the controller's
gate (``_gate_rescue``) finds a suspect candidate.  With ``qc`` the
packaging decode also returns the posterior-entropy planes, and
:meth:`PertInference.build_cell_qc` adds the posterior-predictive check
and the per-cell QC table.

Telemetry as in the JAX runner: the stages accumulate into a
``PhaseTimer`` (``self.phases``), and the run log receives
``control_decision``, ``fit_end``, ``fit_health``, ``nan_abort``,
``rescue``, ``cell_qc_summary`` and, at every step's end,
``metrics_snapshot``, each built after the fit from what the fit
returned (nothing is emitted, and the card is not read for the log,
inside a fit chunk).  On the GPU each step's ``compile`` phase loads the
kernel libraries before its fit and reports each as a ``compile``
event (``miss``/``disk_hit`` when that step built or loaded it, else
``hit``).  With a compiled-program store the fits' graph programs and
the decode and PPC slab programs (the rescue gate's entropy pass, the
packaging decode at each rung of its ladder, the PPC) log theirs too,
with the step they belong to.  The runner writes into the log open on
this thread
(``obs.runlog.active()``: the facade's session); a runner driven
directly opens its own from ``telemetry_path`` in :meth:`run`.

Durable runs as in the JAX runner (``checkpoint_dir``): the manifest's
identity check and the quarantine of another workload's files at
construction, a checkpoint at each step's end (step 2's before the
rescue, so a resume re-runs it) and inside controlled fits, the resume
of completed and partial steps (:meth:`_load_resumable`), the recovery
ladder of :meth:`_fit`, the fault sites ``{step}/start``, ``{step}/fit``,
``{step}/end``, ``compile``, ``qc/ppc`` and ``{prefix}/decode``, the
OOM rungs of the PPC and the decode, and the heartbeat.

Sharded fits (``num_shards`` x ``loci_shards`` ranks of a process group,
``parallel.mesh.RankMesh``): every rank holds the full frames, pads the
cells to a multiple of the cell shards (and the loci to one of the loci
shards) as JAX's ``_pad`` does, and builds its batch and parameters from
its own cells slice and loci tile (:meth:`PertInference._batch`, the
resharding seam :meth:`PertInference._place_params`): no rank holds the
global pi.  The fits run in lockstep (``infer/svi.py``); the decode, the
QC and the mirror rescue run per rank and gather the per-cell and
per-bin results on the host, so every rank returns the same frames.
Checkpoints are sharded generations (``infer/checkpoint.py``), and a
checkpoint loads as full host arrays sliced for this run's grid,
whatever grid wrote it.  A failure on any rank ends every rank's run:
the chunk read makes the verdicts common, and a collective whose peer
died raises (``hostloss``: abort resumable).  JAX's elastic rung (a
smaller grid after a host loss) is not ported.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Optional, Tuple

import numpy as np
import pandas as pd
import torch

from scdna_replication_tools_tpu_torch.config import ColumnConfig, PertConfig
from scdna_replication_tools_tpu_torch.data.loader import (
    PertData,
    attach_dense_columns,
    pad_cells,
    pad_loci,
)
from scdna_replication_tools_tpu_torch.device import resolve_device
from scdna_replication_tools_tpu_torch.infer import aotcache as aotcache_mod
from scdna_replication_tools_tpu_torch.infer import checkpoint as ckpt
from scdna_replication_tools_tpu_torch.infer import manifest as manifest_mod
from scdna_replication_tools_tpu_torch.infer.svi import (
    AdamState,
    FitResult,
    fit_map,
    pi_param_name,
    program_step,
)
from scdna_replication_tools_tpu_torch.models import priors
from scdna_replication_tools_tpu_torch.models.pert import (
    _DECODE_SLAB_BYTES,
    _sites,
    PertBatch,
    PertModelSpec,
    cell_entropy_aggregates,
    decode_discrete,
    decode_discrete_hmm,
    entropy_aggregates_from_planes,
    init_params,
    per_cell_objective,
    pert_loss,
    ppc_discrepancy,
    prime_cache,
    slice_cells,
)
from scdna_replication_tools_tpu_torch.obs import heartbeat as heartbeat_mod
from scdna_replication_tools_tpu_torch.obs import meter as meter_mod
from scdna_replication_tools_tpu_torch.obs import metrics as metrics_mod
from scdna_replication_tools_tpu_torch.obs import runlog as runlog_mod
from scdna_replication_tools_tpu_torch.obs import spans as spans_mod
from scdna_replication_tools_tpu_torch.obs.controller import ControllerPolicy
from scdna_replication_tools_tpu_torch.ops import _cuda
from scdna_replication_tools_tpu_torch.ops.enum_kernel import planes_per_iter
from scdna_replication_tools_tpu_torch.ops.gc import gc_features
from scdna_replication_tools_tpu_torch.ops.stats import guess_times, pearson_matrix
from scdna_replication_tools_tpu_torch.ops.transforms import (
    to_positive,
    to_unit_interval,
)
from scdna_replication_tools_tpu_torch import layout
from scdna_replication_tools_tpu_torch.parallel import distributed as dist_mod
from scdna_replication_tools_tpu_torch.parallel.mesh import (
    make_mesh,
    mesh_topology,
)
from scdna_replication_tools_tpu_torch.utils import faults as faults_mod
from scdna_replication_tools_tpu_torch.utils import profiling

logger = logging.getLogger(__name__)


def _pad_etas(etas: np.ndarray, target_cells: int,
              target_loci: Optional[int] = None) -> np.ndarray:
    """Pad the cells (and loci) axes of an etas tensor with a diploid-
    concentrated prior: all-ones rows would make the pad cells' ploidy
    guess zero and NaN the masked loss."""
    P = etas.shape[-1]
    dip = min(2, P - 1)
    if target_loci is not None and etas.shape[1] < target_loci:
        pad = target_loci - etas.shape[1]
        pad_block = np.ones((etas.shape[0], pad, P), etas.dtype)
        pad_block[..., dip] = 100.0
        etas = np.concatenate([etas, pad_block], axis=1)
    if etas.shape[0] < target_cells:
        pad = target_cells - etas.shape[0]
        pad_row = np.ones(etas.shape[1:], etas.dtype)
        pad_row[..., dip] = 100.0
        etas = np.concatenate(
            [etas, np.broadcast_to(pad_row, (pad,) + etas.shape[1:])], axis=0)
    return etas


def _finite(value):
    """float(value), or None when non-finite (strict JSON)."""
    v = float(value)
    return v if np.isfinite(v) else None


@dataclasses.dataclass
class StepOutput:
    fit: FitResult
    spec: PertModelSpec
    fixed: dict
    batch: PertBatch
    wall_time: float


def _retire(out: StepOutput, pi: bool) -> StepOutput:
    """A finished step with the device state that no later step reads
    moved to the host, where the facade still keeps it (``scRT.steps``):
    its Adam moments (saved at the step's end already) and, with
    ``pi``, its pi planes.  At a serving bucket's shape step 1's alone
    are three 872 MB planes sets, held through steps 2 and 3, and a
    batched worker holds several requests on the card at once."""
    def host(tree):
        return {k: v.cpu() for k, v in tree.items()}
    fit = out.fit
    params = dict(fit.params)
    if pi:
        key = pi_param_name(params)
        if key is not None:
            params[key] = params[key].cpu()
    state = fit.opt_state
    if state is not None:
        state = AdamState(count=state.count.cpu(), mu=host(state.mu),
                          nu=host(state.nu))
    return dataclasses.replace(
        out, fit=dataclasses.replace(fit, params=params, opt_state=state))


@dataclasses.dataclass(frozen=True)
class RescueFit:
    """The mirror rescue's sub-fit: the re-fitted cells (indices into the
    step-2 batch, after the cap) and the fit from their mirrored
    initialisation."""
    cells: np.ndarray
    fit: FitResult


@dataclasses.dataclass(frozen=True)
class _PertLossFn:
    spec: PertModelSpec
    # the rank grid of a sharded fit (infer/svi.py reads it to sum the
    # ranks' losses and gradients); None for one rank
    mesh: object = None

    def __call__(self, params, fixed, batch):
        return pert_loss(self.spec, params, fixed, batch, mesh=self.mesh)

    @property
    def packable(self) -> bool:
        """Whether the serving slab may pack this objective's chunks
        (``infer/svi.ChunkCall.signature``): the enumerated steps only.
        Step 1's observed objective is plain PyTorch ops whose (cells,
        loci, P) intermediates, at a bucket's doubled G1 cells, do not
        fit W lanes at once on the card; its chunks run alone."""
        return not self.spec.step1

    def prime(self, fixed, batch) -> None:
        """Fill the batch's fit-constant cache before the serving slab
        stacks it (``infer/svi.dispatch_chunk_slab``)."""
        prime_cache(self.spec, batch, self.mesh)

    def record(self) -> dict:
        """The constructor's arguments, for a program record
        (``infer/svi.py``): the spec's fields.  Only a one-rank loss
        function's programs are kept in a store."""
        return {"spec": dataclasses.asdict(self.spec)}

    @classmethod
    def from_record(cls, kwargs: dict) -> "_PertLossFn":
        return cls(PertModelSpec(**kwargs["spec"]))


class PertInference:
    """Orchestrates the three fits on dense inputs, on ``device`` (the
    GPU unless ``'cpu'`` is passed; see ``device.resolve_device``).

    ``clone_idx_s`` / ``clone_idx_g1`` are dense integer clone
    assignments aligned with the cell axes of ``s_data`` / ``g1_data``.
    ``mesh`` is the rank grid that the config's ``num_shards`` /
    ``loci_shards`` describe (``parallel.mesh.make_mesh``, made here on
    every rank; None: one rank).
    """

    def __init__(self, s_data: PertData, g1_data: PertData,
                 config: PertConfig = PertConfig(),
                 clone_idx_s: Optional[np.ndarray] = None,
                 clone_idx_g1: Optional[np.ndarray] = None,
                 num_clones: int = 0, device=None):
        if config.resume not in ("auto", "force", "off"):
            # validate BEFORE any manifest mutation below: a typo'd
            # resume value must not cost durable resume state
            raise ValueError(
                f"resume must be 'auto', 'force' or 'off', got "
                f"{config.resume!r}")
        self.device = resolve_device(device)
        self.mesh = make_mesh(config.num_shards, config.loci_shards)
        if self.mesh is not None and config.cell_chunk:
            raise ValueError(
                "cell_chunk is a one-rank memory knob; a sharded fit "
                "divides the cells over its ranks instead (JAX "
                "runner._pad's rule)")
        # the run log open on this thread and the installed metrics
        # registry (the facade's), else disabled no-ops; run() puts this
        # runner's own in their place when no facade opened them
        self.run_log = runlog_mod.current()
        self.metrics = metrics_mod.current()
        # device-cost attribution (obs/meter.py): run() hangs the ledger
        # on the run log, where the fit's chunk loop, the PPC and the
        # decode book into it; its summary lands in run_end's `meter`
        # section and the manifest
        meter_scope = {"run": "pert"}
        if config.request_id:
            meter_scope["request"] = str(config.request_id)
        self.meter = meter_mod.CostLedger(scope=meter_scope)
        if config.rho_from_rt_prior and s_data.rt_prior is None:
            raise ValueError(
                "rho_from_rt_prior=True but no RT-prior column was found "
                "in the input (rt_prior_col); provide the column or drop "
                "the flag")
        self.s = s_data
        self.g1 = g1_data
        self.config = config
        self.clone_idx_s = clone_idx_s
        self.clone_idx_g1 = clone_idx_g1
        self.num_clones = num_clones
        self.L = s_data.num_libraries
        # wall seconds per stage (build, prior, fit, ...) of the last
        # run; the facade hands in its own timer
        self.phases = profiling.PhaseTimer()
        # {candidates, accepted[, capped_to]} of the last mirror rescue
        self.mirror_rescue_stats: Optional[dict] = None
        # the rescue's candidate, re-fitted (after the cap) and accepted
        # cell indices (the QC table's rescue columns)
        self._rescue_cells: Optional[dict] = None
        # the last rescue's sub-fit (None unless it re-fitted cells)
        self.rescue_fit: Optional[RescueFit] = None
        # fault-injection plan (utils/faults.py): config/env-gated,
        # deterministic, inert unless a spec is present.  Installed
        # unconditionally — the newest runner's config wins, so a resume
        # run with faults=None cannot inherit a previous run's plan
        faults_mod.install(faults_mod.resolve_plan(config.faults))
        # live run-health heartbeat (obs/heartbeat.py), installed
        # process-wide (newest runner wins); run() writes the terminal
        # state on completion or Exception — a BaseException
        # (preemption) leaves the last heartbeat to go stale, which is
        # how a watcher tells a lost process
        self._heartbeat = None
        hb_dir = heartbeat_mod.resolve_dir(config.heartbeat_dir,
                                           config.checkpoint_dir)
        if hb_dir:
            # every rank publishes health/host_<rank>.json
            hb_rank, hb_count = dist_mod.process_rank_and_count()
            self._heartbeat = heartbeat_mod.RunHeartbeat(
                hb_dir, interval_seconds=config.heartbeat_interval_seconds,
                process_index=hb_rank, process_count=hb_count,
                config_digest=runlog_mod._config_digest(config))
            heartbeat_mod.install(self._heartbeat)
            heartbeat_mod.attach_phase_sink(self.phases)
        # durable run manifest (infer/manifest.py): the resume ledger of
        # the checkpoint directory — identity (config hash + data
        # fingerprint) decides whether existing checkpoints belong to
        # THIS workload; resume='auto' restores only fingerprint-
        # verified state, and a mismatch under 'auto' voids the ledger
        self._manifest = None
        self._resume_ok = False
        self._resume_reason = "checkpointing disabled"
        # steps THIS run has checkpointed: a transient retry may always
        # resume what this very run wrote, even when the directory's
        # prior identity could not be verified
        self._steps_written: set = set()
        if config.checkpoint_dir:
            self._open_manifest()
        if self.mesh is not None:
            # the realized grid: folded into run_start, or a note event
            # when the facade's session is already open
            self.run_log.add_context(mesh={
                "axes": mesh_topology(self.mesh),
                "num_devices": int(self.mesh.size)})

    def _open_manifest(self) -> None:
        """Load the checkpoint directory's manifest, judge its identity
        against this run's (JAX ``PertInference.__init__``), quarantine
        the checkpoints of another workload, and record this attempt."""
        config = self.config
        # everything the fit consumes, not just reads: changed CN
        # states, clone assignments or the RT prior also invalidate old
        # checkpoints (the priors and conditioning they shaped)
        local_fp = manifest_mod.data_fingerprint(
            self.s.reads, self.g1.reads, self.s.states, self.g1.states,
            self.clone_idx_s, self.clone_idx_g1, self.s.rt_prior)
        # each rank digests what it loaded; every rank loads the full
        # frames, so the deduped identity is the one-rank run's
        host_fps = manifest_mod.all_host_fingerprints(local_fp, self.mesh)
        fingerprint = manifest_mod.combined_fingerprint(host_fps)
        rank, _ = dist_mod.process_rank_and_count()
        cfg_hash = runlog_mod._config_digest(config)
        m = manifest_mod.RunManifest.load(config.checkpoint_dir)
        self._resume_ok, self._resume_reason = m.match(
            cfg_hash, fingerprint, host_fingerprint=local_fp,
            process_index=rank)
        # a split verdict would desynchronise the lockstep fit: any
        # rank's refusal refuses everywhere (every rank enters the
        # collective, whatever its own verdict)
        agreed = manifest_mod.consensus_ok(self._resume_ok, self.mesh)
        if self._resume_ok and not agreed:
            self._resume_ok = False
            self._resume_reason = (
                "a peer rank refused the data fingerprint (split per-rank "
                "verdict — resuming on partial agreement would "
                "desynchronise the ranks)")
        had_identity = m.doc.get("data_fingerprint") is not None
        reset = (config.resume == "off"
                 or (had_identity and not self._resume_ok
                     and config.resume != "force"))
        if reset and rank == 0:
            # voiding the ledger must also retire the FILES: once this
            # run's identity lands in the manifest, surviving stale
            # checkpoints would fingerprint-verify for the next run and
            # restore params fitted to other data (rank 0 alone: ranks
            # racing the renames would half-quarantine generations)
            ckpt.quarantine_stale(config.checkpoint_dir)
        m.begin_run(cfg_hash, fingerprint, run_log_path=self.run_log.path,
                    reset_steps=reset, host_fingerprints=host_fps)
        # no rank may load a checkpoint that rank 0 is quarantining
        dist_mod.barrier("pert-manifest/begin_run")
        self._manifest = m
        if had_identity and not self._resume_ok and config.resume == "auto":
            logger.warning(
                "checkpoint dir %s: %s — starting fresh (use "
                "resume='force' to override)", config.checkpoint_dir,
                self._resume_reason)

    # -- batches ----------------------------------------------------------

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(x), dtype=dtype,
                            device=self.device)

    def _gamma_feats(self, data: PertData) -> torch.Tensor:
        return gc_features(self._tensor(data.gammas), self.config.K)

    def _loci_mask(self, data: PertData) -> Optional[torch.Tensor]:
        """(loci,) float mask, or None when every locus is real."""
        if data.loci_mask is None or data.loci_mask.all():
            return None
        return self._tensor(data.loci_mask.astype(np.float32))

    def _pad(self, data: PertData) -> PertData:
        """Pad the cells to a multiple of the cell shards (times
        ``cell_chunk``), the loci to one of the loci shards, and both to
        the shape-bucket targets (``pad_cells_to`` / ``pad_loci_to``)
        (JAX ``_pad``)."""
        mult = (self.config.cell_chunk or 1) * (
            self.mesh.cells if self.mesh is not None else 1)
        loci_mult = self.mesh.loci if self.mesh is not None else 1
        if mult > 1 or self.config.pad_cells_to:
            data = pad_cells(data, mult, minimum=self.config.pad_cells_to)
        if loci_mult > 1 or self.config.pad_loci_to:
            data = pad_loci(data, loci_mult,
                            minimum=self.config.pad_loci_to)
        return data

    def _tile(self, x, dims):
        """This rank's block of a full host array or tensor with
        symbolic ``dims`` (the array itself with one rank)."""
        if x is None or self.mesh is None:
            return x
        return self.mesh.tile(x, dims)

    def _gather(self, x, dims) -> np.ndarray:
        """The full host array of which ``x`` is this rank's block (its
        host copy with one rank)."""
        if self.mesh is None:
            return x.detach().cpu().numpy() if torch.is_tensor(x) \
                else np.asarray(x)
        return self.mesh.gather(x, dims)

    def _global_cells(self, batch: PertBatch) -> int:
        return int(batch.reads.shape[0]) * (
            self.mesh.cells if self.mesh is not None else 1)

    def _batch(self, data: PertData, **fields) -> PertBatch:
        """The device batch of this rank's block of ``data`` (padded,
        full); ``fields`` are full host arrays or tensors of the named
        ``PertBatch`` fields, tiled alike (``layout.batch_dims``)."""
        if self.mesh is not None:
            cells = self.mesh.cells_slice(data.num_cells)
            loci = self.mesh.loci_slice(data.num_loci)
            data = dataclasses.replace(
                data, reads=data.reads[cells, loci],
                states=None if data.states is None
                else data.states[cells, loci],
                libs=data.libs[cells], gammas=data.gammas[loci],
                rt_prior=None if data.rt_prior is None
                else data.rt_prior[loci],
                cell_mask=data.cell_mask[cells],
                loci_mask=None if data.loci_mask is None
                else data.loci_mask[loci])
        tiles = {}
        for name, value in fields.items():
            value = self._tile(value, layout.batch_dims(name))
            tiles[name] = value.to(self.device).contiguous() \
                if torch.is_tensor(value) else self._tensor(value)
        return PertBatch(
            reads=self._tensor(data.reads),
            libs=self._tensor(data.libs, torch.int64),
            gamma_feats=self._gamma_feats(data),
            mask=self._tensor(data.cell_mask.astype(np.float32)),
            loci_mask=self._loci_mask(data),
            **tiles)

    def _eta_fields(self, etas: np.ndarray) -> dict:
        """The CN prior's batch fields, full: on the host for a sharded
        run (the sparse encoding is decided on the whole prior, then
        :meth:`_batch` tiles it), else on the device."""
        return priors.eta_batch_fields(
            etas, allow_sparse=self.config.sparse_etas,
            device="cpu" if self.mesh is not None else self.device)

    def _place_params(self, params: dict) -> dict:
        """Full host (or device) parameters as this rank's blocks on the
        device (JAX ``_place_params``): the seam through which a
        checkpoint, whatever grid wrote it, lands on this run's grid."""
        return {k: self._tile(torch.as_tensor(np.asarray(v))
                              if not torch.is_tensor(v) else v,
                              layout.param_dims(k)).to(self.device)
                .contiguous() for k, v in params.items()}

    def g1_g2_doubled_batch(self) -> Tuple[PertBatch, PertData]:
        """Step-1 batch: every G1 cell appears as G1 (rep=0) and G2 (rep=1)
        (reference: pert_model.py:228-251)."""
        g1 = self._pad(self.g1)
        doubled = dataclasses.replace(
            g1,
            reads=np.concatenate([g1.reads, g1.reads], axis=0),
            libs=np.concatenate([g1.libs, g1.libs]),
            cell_mask=np.concatenate([g1.cell_mask, g1.cell_mask]))
        rep = np.concatenate([np.zeros_like(g1.reads),
                              np.ones_like(g1.reads)], axis=0)
        batch = self._batch(
            doubled, cn_obs=np.concatenate([g1.states, g1.states]),
            rep_obs=rep)
        return batch, g1

    # -- CN priors --------------------------------------------------------

    def build_etas(self) -> np.ndarray:
        """CN prior concentrations for the S cells, per ``cn_prior_method``
        (reference: pert_model.py:668-716)."""
        cfg = self.config
        method = cfg.cn_prior_method
        P = cfg.P
        s = self.s
        num_cells, num_loci = s.reads.shape

        if method == "hmmcopy":
            if s.states is None:
                raise ValueError("hmmcopy prior requires S-phase CN states")
            return priors.cn_prior_from_states(s.states, P, cfg.cn_prior_weight)

        if method == "diploid":
            dip = np.full((num_cells, num_loci), 2.0, np.float32)
            return priors.cn_prior_from_states(dip, P, cfg.cn_prior_weight)

        if method in ("g1_cells", "g1_clones", "g1_composite"):
            clone_profiles = priors.consensus_clone_profiles(
                self.g1.states, self.clone_idx_g1, self.num_clones,
                states=self.g1.states)
            if method == "g1_clones":
                return priors.clone_cn_prior(
                    self.clone_idx_s, clone_profiles, P, cfg.cn_prior_weight)
            if method == "g1_composite":
                return priors.composite_cn_prior(
                    s.reads, self.clone_idx_s, self.g1.reads, self.g1.states,
                    self.clone_idx_g1, clone_profiles, P, J=cfg.J,
                    device=self.device)
            # g1_cells: the single best-correlated G1 cell's states
            corr = pearson_matrix(s.reads, self.g1.reads,
                                  device=self.device).cpu().numpy()
            if self.clone_idx_s is not None:
                same = self.clone_idx_s[:, None] == self.clone_idx_g1[None, :]
                corr = np.where(same, corr, -np.inf)
            best = np.argmax(corr, axis=1)
            return priors.cn_prior_from_states(
                self.g1.states[best], P, cfg.cn_prior_weight)

        return priors.uniform_prior(num_cells, num_loci, P)

    def build_etas_step3(self) -> np.ndarray:
        """Clone-consensus prior for the G1 cells (reference:
        pert_model.py:853-854)."""
        clone_profiles = priors.consensus_clone_profiles(
            self.g1.states, self.clone_idx_g1, self.num_clones,
            states=self.g1.states)
        return priors.clone_cn_prior(
            self.clone_idx_g1, clone_profiles, self.config.P,
            self.config.cn_prior_weight)

    def _t_init(self, data: PertData, etas: np.ndarray,
                num_padded: int) -> np.ndarray:
        """Initial S-phase times from the real (unpadded) cells and loci,
        padded cells at 0.4."""
        t_real, _, _ = guess_times(data.reads, etas,
                                   float(self.config.upsilon),
                                   loci_mask=data.loci_mask,
                                   device=self.device)
        return np.pad(t_real.cpu().numpy(), (0, num_padded - data.num_cells),
                      constant_values=0.4)

    # -- steps ------------------------------------------------------------

    def _controller_active(self, min_iter, max_iter) -> bool:
        """The controller's inert conditions in one place, for the
        in-fit controller and the rescue gate (JAX
        ``_controller_active``): it needs the diagnostics ring
        (``fit_diag_every > 0``) and a budget that is not pinned exact
        (``min_iter < max_iter``)."""
        cfg = self.config
        return bool(cfg.controller and cfg.fit_diag_every
                    and int(min_iter) < int(max_iter))

    def _fit(self, spec, batch, fixed, t_init, max_iter, min_iter,
             step_name) -> StepOutput:
        """One step fit under the recovery ladder (JAX ``_fit``;
        utils/faults.py):

        * **transient** failures retry with bounded exponential backoff,
          and because the chunk loop saved an in-flight checkpoint on
          the way out, each retry RESUMES the fit rather than restarting
          it;
        * **oom** / **hang** abort with the resumable artifact that same
          save left behind, audited by a ``degrade`` event — the next
          ``resume='auto'`` run continues mid-budget;
        * **preemption** (BaseException) propagates untouched after the
          graceful save: the process is going away;
        * **deterministic** errors propagate immediately — retrying a
          real bug only hides it.

        JAX's elastic rung (rebuild a smaller mesh on a host loss or a
        repeated OOM and re-enter) is not ported (ROADMAP A12's rest): a
        ``hostloss`` (in a sharded run, a collective whose peer rank
        died) aborts like an OOM here, on every surviving rank.
        """
        cfg = self.config

        def attempt():
            try:
                return self._fit_once(spec, batch, fixed, t_init,
                                      max_iter, min_iter, step_name)
            except Exception as exc:
                kind = faults_mod.classify_exception(exc)
                if kind in ("oom", "hang", "hostloss"):
                    self.run_log.emit(
                        "degrade", step=step_name,
                        action=("watchdog_abort" if kind == "hang"
                                else "abort_resumable"),
                        error_class=kind,
                        error=f"{type(exc).__name__}: {str(exc)[:300]}",
                        detail=("fit aborted on a non-retryable "
                                f"{kind}; the in-flight checkpoint "
                                "(when checkpointing is enabled) makes "
                                "the next resume='auto' run continue "
                                "mid-budget"))
                raise

        # each retry re-enters _fit_once, whose _load_resumable picks up
        # the in-flight checkpoint — retries RESUME, not restart
        return faults_mod.retry_call(
            attempt, label=f"{step_name}/fit",
            max_attempts=int(cfg.retry_max_attempts),
            base_delay=float(cfg.retry_backoff_seconds))

    def _load_resumable(self, step_name, max_iter, spec, fixed, batch):
        """Resume-mode + manifest-aware checkpoint restore for one step
        (JAX ``_load_resumable``).

        Returns a completed :class:`StepOutput` (restore, no refit), a
        ``(params0, opt_state0, losses_prefix, resume_ctrl)`` tuple for
        a partial fit, or None for a fresh fit.  Every outcome that
        touched a checkpoint emits a ``resume`` event, so the decision
        is reproducible from the artifact alone.
        """
        cfg = self.config
        if cfg.resume == "off" and step_name not in self._steps_written:
            # 'off' ignores PRE-EXISTING state; a transient retry still
            # resumes the checkpoints this very run wrote
            return None
        if cfg.resume == "auto" and not self._resume_ok \
                and step_name not in self._steps_written:
            # only audit a refusal when there was something to refuse
            if any(os.path.exists(os.path.join(cfg.checkpoint_dir, name))
                   for name in (f"pert_{step_name}.npz",
                                f"pert_{step_name}.commit.json")):
                self.run_log.emit(
                    "resume", step=step_name, mode=cfg.resume,
                    action="fresh", fingerprint_verified=False,
                    reason=self._resume_reason)
            return None
        t0 = time.perf_counter()
        try:
            restored = ckpt.load_step(cfg.checkpoint_dir, step_name)
        except ckpt.CheckpointCorrupt as exc:
            # graceful degradation: a corrupt artifact (and no valid
            # retained predecessor) costs a refit, never the run
            self.run_log.emit("degrade", step=step_name,
                              action="checkpoint_discarded",
                              error_class="corrupt",
                              detail=str(exc)[:500])
            logger.warning("%s — refitting %s from scratch", exc,
                           step_name)
            return None
        if restored is None:
            return None
        params_full, losses, extra = restored
        # full host arrays, whatever grid wrote them: this rank's blocks
        params = self._place_params(
            ckpt.restore_params(params_full, "cpu"))
        num_iters = int(extra.get("meta.num_iters", len(losses)))
        converged = bool(extra.get("meta.converged", True))
        nan_abort = bool(extra.get("meta.nan_abort", False))
        resume_ctrl = ckpt.restore_controller_state(extra)
        if resume_ctrl and resume_ctrl.get("best_params") is not None:
            resume_ctrl["best_params"] = self._place_params(
                ckpt.restore_params(resume_ctrl["best_params"], "cpu"))
        # the geometry change of a resume is audited as JAX's is: a
        # checkpoint from another grid or rank count is a resharding one
        saved_topo = extra.get("meta.topology") \
            if isinstance(extra.get("meta.topology"), dict) else None
        cur = dist_mod.process_topology(self.mesh)
        cur_topo = {"mesh_axes": cur["mesh_axes"],
                    "process_count": cur["process_count"]}
        resharded = saved_topo is not None and (
            saved_topo.get("mesh_axes") != cur_topo["mesh_axes"]
            or int(saved_topo.get("process_count", 1))
            != cur_topo["process_count"])
        reshard_fields = dict(
            resharded=bool(resharded),
            from_topology=({"mesh_axes": saved_topo.get("mesh_axes"),
                            "process_count":
                                saved_topo.get("process_count")}
                           if saved_topo is not None else None),
            to_topology=cur_topo)
        # a controller-extended budget survives in the resume state (a
        # fit killed past max_iter but inside its extended budget is
        # still PARTIAL) — but a GROWN config budget wins: resuming with
        # a larger max_iter is the documented budget-growth workflow
        budget = int(max_iter)
        if resume_ctrl:
            budget = max(int(resume_ctrl["budget"]), budget)
            resume_ctrl["budget"] = budget
        completed = bool(converged or nan_abort or num_iters >= budget)
        path = ckpt._step_path(cfg.checkpoint_dir, step_name)
        self.run_log.emit(
            "checkpoint", action="load", step=step_name,
            path=str(cfg.checkpoint_dir), num_iters=num_iters,
            completed=completed,
            seconds=round(time.perf_counter() - t0, 4),
            bytes=os.path.getsize(path) if os.path.exists(path) else None)
        own_write = step_name in self._steps_written
        self.run_log.emit(
            "resume", step=step_name, mode=cfg.resume,
            action="restored" if completed else "resumed",
            from_iter=num_iters,
            fingerprint_verified=bool(self._resume_ok or own_write),
            reason=("checkpoint written by this run (retry resume)"
                    if own_write and not self._resume_ok
                    else self._resume_reason),
            **reshard_fields)
        if completed:
            # completed step: restore, no refit (the rescue gate types
            # budget as an integer, restored fits included)
            fit = FitResult(params=params, losses=np.asarray(losses),
                            num_iters=num_iters, converged=converged,
                            nan_abort=nan_abort,
                            timings={"fit": 0.0, "ms_per_iter": 0.0,
                                     "dispatched": 0},
                            budget=max(budget, num_iters))
            if self._manifest is not None:
                self._manifest.update_step(step_name, "complete",
                                           num_iters=num_iters)
            return StepOutput(fit, spec, fixed, batch, 0.0)
        # partial step: resume from the saved iteration with the Adam
        # moments (and, for controlled fits, the controller's ledger)
        # intact.  The moments' stored dtype is part of that contract: a
        # resume across moment dtypes cannot be bit-exact, so a mismatch
        # refuses loudly instead of degrading
        saved_dt = str(extra.get("meta.opt_moment_dtype", "float32"))
        has_opt = any(k.startswith("opt.") for k in extra)
        if has_opt and saved_dt != cfg.optimizer_state_dtype:
            raise ValueError(
                f"checkpoint for {step_name} in {cfg.checkpoint_dir} "
                f"stores Adam moments as {saved_dt} but this run "
                f"configures optimizer_state_dtype="
                f"{cfg.optimizer_state_dtype!r}: a mid-budget resume "
                "across moment dtypes cannot be bit-exact — rerun with "
                f"optimizer_state_dtype='{saved_dt}', or resume='off' "
                "to refit the step fresh")
        opt_state0 = ckpt.restore_opt_state(extra, params_full, "cpu")
        if opt_state0 is not None:
            opt_state0 = AdamState(
                count=opt_state0.count.to(self.device),
                mu=self._place_params(opt_state0.mu),
                nu=self._place_params(opt_state0.nu))
        losses_prefix = np.asarray(losses)[:num_iters]
        return params, opt_state0, losses_prefix, resume_ctrl

    def _compile(self, step_name: str) -> None:
        """The step's compile phase: the ``compile`` fault site, then (on
        the GPU) the kernel libraries' builds or loads, each reported as
        a ``compile`` event, all under ``watchdog_compile_seconds``.  The
        site fires once per step, as JAX's fires once per step's program
        in a cold process; on the CPU there is nothing to load and no
        phase is recorded."""
        scope = aotcache_mod.current_scope()
        store = scope.store if scope is not None else None

        def load():
            faults_mod.point("compile")
            if self.device.type != "cuda":
                return []
            return [_cuda.load_event(name, store) for name in _cuda.SOURCES]

        deadline = self.config.watchdog_compile_seconds
        label = f"compile:{step_name}"
        if self.device.type != "cuda":
            faults_mod.run_with_deadline(load, deadline, label)
            return
        # build or load the kernel libraries before the fit, so the
        # first chunk neither waits on nvcc nor emits an event; one
        # compile event per library and step, as JAX's per program
        with self.phases.phase(f"{step_name}/compile"):
            for event in faults_mod.run_with_deadline(
                    load, deadline, label, device=self.device):
                self.run_log.emit("compile", **event)

    def _save(self, step_name: str, params, losses, completed: bool,
              **kw) -> str:
        """One checkpoint save of ``step_name`` with its ``checkpoint``
        event (the file's bytes and the save's seconds beside JAX's
        fields)."""
        t0 = time.perf_counter()
        path = ckpt.save_step(self.config.checkpoint_dir, step_name, params,
                              losses, mesh=self.mesh, **kw)
        self._steps_written.add(step_name)
        self.run_log.emit(
            "checkpoint", action="save", step=step_name,
            path=str(self.config.checkpoint_dir),
            num_iters=int(kw["num_iters"]), completed=bool(completed),
            seconds=round(time.perf_counter() - t0, 4),
            bytes=os.path.getsize(path))
        return path

    def _checkpoint_cb(self, step_name: str):
        """The durability sink of the controlled chunk loop: periodic
        in-fit saves (every ``checkpoint_every`` chunks) and the
        emergency save on an escaping exception both land here."""
        def checkpoint_cb(*, params, opt_state, losses, num_iters,
                          state=None, exact=True, coordinated=True):
            extra = ckpt.pack_controller_state(state) if state else None
            path = self._save(step_name, params, losses, False,
                              opt_state=opt_state, num_iters=int(num_iters),
                              converged=False, nan_abort=False, extra=extra,
                              coordinate=coordinated)
            if not exact:
                self.run_log.emit(
                    "degrade", step=step_name, action="inexact_checkpoint",
                    detail=(f"optimizer state was unavailable at the "
                            f"emergency save (a CUDA error left the "
                            f"device state unreadable); a resume restarts "
                            f"the Adam moments at iteration {num_iters}"))
            if self._manifest is not None:
                self._manifest.update_step(
                    step_name, "in_flight", num_iters=int(num_iters),
                    checkpoint=path, exact=bool(exact))
        return checkpoint_cb

    def _fit_once(self, spec, batch, fixed, t_init, max_iter, min_iter,
                  step_name) -> StepOutput:
        cfg = self.config
        params0 = opt_state0 = losses_prefix = resume_ctrl = None
        if cfg.checkpoint_dir:
            loaded = self._load_resumable(step_name, max_iter, spec, fixed,
                                          batch)
            if isinstance(loaded, StepOutput):
                return loaded
            if loaded is not None:
                params0, opt_state0, losses_prefix, resume_ctrl = loaded
        # phase-boundary injection site: a preemption here models the
        # kill-between-steps window
        faults_mod.point(f"{step_name}/start")
        # the device's memory high-water before the step's fit, so the
        # step-end snapshot's change is the step's own
        self.metrics.sample_device_memory()
        if self._manifest is not None:
            self._manifest.update_step(
                step_name, "in_flight",
                num_iters=len(losses_prefix)
                if losses_prefix is not None else 0)
        if params0 is None:
            with self.phases.phase(f"{step_name}/init"):
                params0 = init_params(spec, batch, fixed,
                                      t_init=self._tile(t_init, ("cells",)),
                                      mesh=self.mesh)
        self._compile(step_name)
        if not spec.step1:
            # analytic (cells x loci) planes one iteration moves
            self.metrics.gauge(
                "pert_planes_moved_per_iter",
                labels={"step": step_name}).set(planes_per_iter(
                    spec.P, binary=spec.binary_pi,
                    sparse_etas=spec.sparse_etas,
                    moment_dtype=cfg.optimizer_state_dtype))
        controller = None
        if self._controller_active(min_iter, max_iter):
            controller = ControllerPolicy.from_config(cfg, max_iter)
        # injection site at the fit dispatch itself: a spec can fail a
        # whole step fit on its first attempt
        faults_mod.point(f"{step_name}/fit")
        t0 = time.perf_counter()
        # one profiler trace per step fit (JAX runner.py:1116)
        with self.meter.context(step=step_name,
                                **self._meter_attrs(step_name, batch)), \
                profiling.trace(cfg.profile_dir, label=step_name):
            fit = self._fit_map(spec, params0, fixed, batch, max_iter,
                                min_iter, step_name, opt_state0,
                                losses_prefix, controller, resume_ctrl)
        wall = time.perf_counter() - t0
        self.phases.add(f"{step_name}/fit", fit.timings["fit"])
        num_cells = self._global_cells(batch)
        profiling.log_step_summary(step_name, fit, wall, num_cells)
        self._emit_fit_events(step_name, fit, wall, num_cells,
                              prior_iters=(len(losses_prefix)
                                           if losses_prefix is not None
                                           else 0))
        if cfg.checkpoint_dir:
            completed = bool(fit.converged or fit.nan_abort
                             or fit.num_iters >= (fit.budget
                                                  if fit.budget is not None
                                                  else max_iter))
            with self.phases.phase(f"{step_name}/checkpoint"):
                self._save(step_name, fit.params, fit.losses, completed,
                           opt_state=fit.opt_state, num_iters=fit.num_iters,
                           converged=fit.converged, nan_abort=fit.nan_abort)
            if self._manifest is not None:
                self._manifest.update_step(
                    step_name, "complete" if completed else "in_flight",
                    num_iters=fit.num_iters)
        # phase-boundary injection site: the step's outputs are durably
        # committed — a preemption here must resume at the NEXT step
        faults_mod.point(f"{step_name}/end")
        with self.phases.phase(f"{step_name}/metrics"):
            self.metrics.emit_snapshot(self.run_log, f"{step_name}/end")
        return StepOutput(fit, spec, fixed, batch, wall)

    def _fit_map(self, spec, params0, fixed, batch, max_iter, min_iter,
                 step_name, opt_state0, losses_prefix, controller,
                 resume_ctrl) -> FitResult:
        cfg = self.config
        return fit_map(_PertLossFn(spec, self.mesh), params0, (fixed, batch),
                       max_iter=max_iter, min_iter=min_iter,
                       rel_tol=cfg.rel_tol, learning_rate=cfg.learning_rate,
                       b1=cfg.adam_b1, b2=cfg.adam_b2,
                       opt_state0=opt_state0, losses_prefix=losses_prefix,
                       device=self.device,
                       moment_dtype=cfg.optimizer_state_dtype,
                       diag_every=cfg.fit_diag_every,
                       doctor_thresholds=dict(
                           window=cfg.doctor_window,
                           slope_tol=cfg.doctor_slope_tol,
                           var_tol=cfg.doctor_var_tol,
                           grad_ratio=cfg.doctor_grad_ratio),
                       controller=controller,
                       escalate_dir=cfg.checkpoint_dir,
                       escalate_tag=step_name,
                       checkpoint_every=cfg.checkpoint_every,
                       checkpoint_cb=(self._checkpoint_cb(step_name)
                                      if cfg.checkpoint_dir else None),
                       resume_state=resume_ctrl,
                       chunk_deadline=cfg.watchdog_chunk_seconds)

    def _meter_attrs(self, step_name: str, batch) -> dict:
        """Cost-attribution context of one step's dispatches (JAX
        ``_meter_attrs``): the real (unpadded) cell count, the bucket's
        ``pad_frac`` (the share of the billed time spent on padding
        cells and loci) and the bucket's name."""
        real = self.g1 if step_name == "step3" else self.s
        padded_cells = self._global_cells(batch)
        padded_loci = int(batch.reads.shape[1]) * (
            self.mesh.loci if self.mesh is not None else 1)
        real_cells = min(int(real.num_cells), padded_cells)
        real_loci = min(int(real.num_loci), padded_loci)
        pad_frac = 1.0 - (real_cells * real_loci) \
            / max(padded_cells * padded_loci, 1)
        return {
            "cells": real_cells,
            "pad_frac": round(max(pad_frac, 0.0), 6),
            "bucket": f"c{padded_cells}xl{padded_loci}",
        }

    def _emit_fit_events(self, step_name: str, fit: FitResult, wall: float,
                         num_cells: int, prior_iters: int = 0) -> None:
        """The controller's decisions, ``fit_end``, ``fit_health`` (with
        ``qc``) and, on a poisoned fit, ``nan_abort`` with the loss
        tail, for one completed step fit (JAX ``_emit_fit_events``);
        every value comes from the returned FitResult.  ``prior_iters``
        (iterations restored from a checkpoint) count in ``iters`` but
        not in the rates, whose wall covers the resumed segment only."""
        self._emit_program_events(step_name, fit)
        for decision in fit.decisions:
            self.run_log.emit("control_decision", step=step_name,
                              **decision)
        iters = max(fit.num_iters - prior_iters, 1)
        diag = None
        if fit.diagnostics is not None and len(fit.diagnostics["iter"]):
            # the ring keeps the last samples: a trailing window of the
            # trajectory, whose bounds ride along
            d = fit.diagnostics
            diag = {
                "every": int(d["every"]),
                "samples": int(len(d["iter"])),
                "window_start_iter": int(d["iter"][0]),
                "window_end_iter": int(d["iter"][-1]),
                "grad_norm_first": _finite(d["grad_norm"][0]),
                "grad_norm_last": _finite(d["grad_norm"][-1]),
                "grad_norm_max": _finite(np.max(d["grad_norm"])),
                "param_norm_last": _finite(d["param_norm"][-1]),
            }
        self.run_log.emit(
            "fit_end", step=step_name, iters=int(fit.num_iters),
            resumed_from_iter=(int(prior_iters) if prior_iters else None),
            final_loss=(float(fit.losses[-1])
                        if len(fit.losses) and np.isfinite(fit.losses[-1])
                        else None),
            converged=bool(fit.converged), nan_abort=bool(fit.nan_abort),
            wall_seconds=round(wall, 4),
            iters_per_second=round(iters / max(wall, 1e-9), 2),
            cells_per_second=round(num_cells * iters / max(wall, 1e-9), 1),
            num_cells=num_cells, program_cache=None, diagnostics=diag)
        if self.config.qc and fit.health is not None:
            h = fit.health
            self.run_log.emit(
                "fit_health", step=step_name, verdict=h["verdict"],
                reason=h["reason"],
                drift=_finite(h["drift"]) if h["drift"] is not None
                else None,
                rel_var=_finite(h["rel_var"])
                if h["rel_var"] is not None else None,
                window=int(h.get("window", 0)),
                grad_decay=_finite(h["grad_decay"])
                if h["grad_decay"] is not None else None,
                converged=bool(fit.converged),
                nan_abort=bool(fit.nan_abort))
        if fit.nan_abort:
            tail = [_finite(v) for v in fit.losses[-20:]]
            self.run_log.emit("nan_abort", step=step_name,
                              iters=int(fit.num_iters), loss_tail=tail)

    def _bucket(self) -> Optional[tuple]:
        """The (cells, loci) a serving bucket pads this run to, or None."""
        c, l = self.config.pad_cells_to, self.config.pad_loci_to
        return (int(c), int(l)) if c and l else None

    def _emit_program_events(self, step_name: str, fit: FitResult) -> None:
        """The ``compile`` events of a fit's graph programs (a capture is
        a miss, a program the store held a hit, a fit the store cannot
        serve uncacheable), after the fit: nothing is emitted inside
        one."""
        for event in fit.programs:
            self.run_log.emit("compile", step=step_name, **event)

    def run_step1(self) -> StepOutput:
        iters = self.config.resolved_iters()
        with self.phases.phase("step1/build"):
            batch, _ = self.g1_g2_doubled_batch()
            spec = PertModelSpec(P=self.config.P, K=self.config.K,
                                 L=self.L, tau_mode="beta_default",
                                 step1=True,
                                 cell_chunk=self.config.cell_chunk)
        return self._fit(spec, batch, {}, None, iters["max_iter_step1"],
                         iters["min_iter_step1"], "step1")

    def run_step2(self, step1: StepOutput, etas: np.ndarray) -> StepOutput:
        iters = self.config.resolved_iters()
        t0 = time.perf_counter()
        with torch.no_grad():
            # the sites alone: the constrained log_pi and pi of step 1's
            # 2 x padded-G1-cells planes would be built only to be dropped
            c1 = _sites(step1.spec, step1.fit.params, step1.fixed)
        fixed = {"beta_means": c1["beta_means"],   # pert_model.py:782-787
                 "lamb": c1["lamb"]}               # pert_model.py:801
        cond_rho = bool(self.config.rho_from_rt_prior)
        s = self._pad(self.s)
        t_init = self._t_init(self.s, etas, s.num_cells)
        etas_padded = _pad_etas(etas, s.num_cells, s.num_loci)
        if cond_rho:
            # the reference's unused rho0 branch (pert_model.py:568-570),
            # clamped to the learned path's domain
            fixed["rho"] = torch.clamp(self._tensor(
                self._tile(s.rt_prior, ("loci",))), 0.0, 1.0)
        eta_fields = self._eta_fields(etas_padded)
        batch = self._batch(s, **eta_fields)
        spec = PertModelSpec(
            P=self.config.P, K=self.config.K, L=self.L, tau_mode="param",
            step1=False, cond_beta_means=True, cond_rho=cond_rho,
            fixed_lamb=True, sparse_etas="eta_idx" in eta_fields,
            binary_pi=self.config.binary_pi,
            cell_chunk=self.config.cell_chunk)
        self.phases.add("step2/build", time.perf_counter() - t0)
        out = self._fit(spec, batch, fixed, t_init, iters["max_iter"],
                        iters["min_iter"], "step2")
        self._step2_data = s
        if self.config.mirror_rescue:
            # an active controller runs the rescue only when the gate
            # finds a suspect candidate; an inert one leaves it on
            run_rescue = self._gate_rescue(out, batch) \
                if self._controller_active(iters["min_iter"],
                                           iters["max_iter"]) else True
            if run_rescue:
                with self.phases.phase("step2/rescue"):
                    out = self._mirror_rescue(out, batch)
        else:
            # reference-faithful path: surface the symptom the rescue
            # exists for
            cfg = self.config
            _, cand = self._mirror_candidates(out, batch)
            if cand.size:
                logger.info(
                    "step 2: %d cells fitted at boundary tau (outside "
                    "[%.2f, %.2f]) — if their profiles look fully "
                    "replicated this may be the tau mirror degeneracy; "
                    "consider mirror_rescue=True",
                    cand.size, cfg.mirror_tau_lo, cfg.mirror_tau_hi)
        return out

    def _mirror_candidates(self, out: StepOutput, batch: PertBatch):
        """(tau, candidate indices) on the host: the real cells whose
        fitted tau lies outside [mirror_tau_lo, mirror_tau_hi]; shared by
        the rescue and the no-rescue hint."""
        cfg = self.config
        with torch.no_grad():
            tau = self._gather(to_unit_interval(out.fit.params["tau_raw"]),
                               ("cells",))
        mask = self._gather(batch.mask, ("cells",))
        cand = np.flatnonzero(((tau < cfg.mirror_tau_lo)
                               | (tau > cfg.mirror_tau_hi)) & (mask > 0.5))
        return tau, cand

    def _gate_rescue(self, out: StepOutput, batch: PertBatch) -> bool:
        """The controller's gate of the mirror rescue (JAX
        ``_gate_rescue``): run the sub-fit only when a boundary-tau
        candidate is also suspect -- fitted tau within
        ``controller_rescue_extreme_tau`` of 0 or 1, or (consulted only
        when no candidate is extreme, and only with ``qc``) more than
        ``qc_frac_thresh`` of its bins low-confidence.  Emits one
        ``control_decision`` event (``rescue`` / ``rescue_skip``) with
        the trigger signals; a skip leaves the same statistics as a
        0-accepted pass."""
        cfg = self.config
        tau, cand = self._mirror_candidates(out, batch)
        trigger: dict = {"candidates": int(cand.size)}
        thresholds = {
            "mirror_tau_lo": float(cfg.mirror_tau_lo),
            "mirror_tau_hi": float(cfg.mirror_tau_hi),
            "extreme_tau": float(cfg.controller_rescue_extreme_tau),
            "entropy_thresh": float(cfg.qc_entropy_thresh),
            "frac_thresh": float(cfg.qc_frac_thresh),
        }
        run = False
        if cand.size:
            extremity = np.minimum(tau[cand], 1.0 - tau[cand])
            extreme = extremity < cfg.controller_rescue_extreme_tau
            run = bool(extreme.any())
            trigger.update(
                extreme_tau_count=int(extreme.sum()),
                suspect_count=int(extreme.sum()),
                min_extremity=_finite(extremity.min()))
            if not run and not cfg.qc:
                trigger["qc"] = "off"
            elif not run:
                with self.phases.phase("step2/rescue_gate"), \
                        torch.no_grad(), program_step("step2"):
                    _, frac_low, mean_rep = (
                        self._gather(t, ("cells",))
                        for t in cell_entropy_aggregates(
                            out.spec, out.fit.params, out.fixed, batch,
                            entropy_thresh=cfg.qc_entropy_thresh,
                            mesh=self.mesh))
                high_ent = frac_low[cand] > cfg.qc_frac_thresh
                run = bool(high_ent.any())
                trigger.update(
                    high_entropy_count=int(high_ent.sum()),
                    suspect_count=int(high_ent.sum()),
                    max_frac_low_conf=_finite(frac_low[cand].max()),
                    mean_rep_entropy=_finite(
                        float(np.mean(mean_rep[cand]))))
        self.run_log.emit(
            "control_decision", step="step2",
            action="rescue" if run else "rescue_skip",
            iter=int(out.fit.num_iters),
            budget=int(out.fit.budget if out.fit.budget is not None
                       else out.fit.num_iters),
            trigger=trigger, thresholds=thresholds,
            detail=("mirror rescue gated IN: suspect boundary-tau "
                    "candidates present" if run else
                    "mirror rescue gated OUT: no suspect boundary-tau "
                    "candidates (no wasted refit-and-reject sub-fit)"))
        if not run:
            self.mirror_rescue_stats = {"candidates": int(cand.size),
                                        "accepted": 0}
            self._rescue_cells = {"candidates": cand.copy(),
                                  "accepted": np.zeros(0, cand.dtype)}
            self._emit_rescue_event()
            logger.info("mirror rescue skipped by the controller: %d "
                        "boundary-tau candidate(s), none extreme or "
                        "high-entropy", cand.size)
        return run

    def _mirror_rescue(self, out: StepOutput, batch: PertBatch) -> StepOutput:
        """Post-step-2 mirror-basin rescue (JAX ``runner._mirror_rescue``).

        A nearly fully replicated cell at read rate u is
        likelihood-equivalent to an unreplicated one at ~2u, and the u
        prior's mean tracks the fitted tau, so step 2 can settle in
        either basin.  The boundary-tau candidates are re-fit from the
        mirrored initialisation (tau' = 1 - tau, u re-seeded by its prior
        at tau') with every global site (rho, a, beta_means, lambda)
        conditioned at the step-2 fit, on the candidates' sub-batch
        through the same fused kernels.  Each candidate keeps whichever
        parameter set scores the higher ``per_cell_objective`` (the
        unfused enumeration), both scored under the step-2
        ``beta_stds``; accepted cells are spliced into the step-2
        parameters on ``self.device``.  Per-cell selection makes the pass
        objective-improving.
        """
        cfg = self.config
        tau, cand = self._mirror_candidates(out, batch)
        self.rescue_fit = None
        self.mirror_rescue_stats = {"candidates": int(cand.size),
                                    "accepted": 0}
        self._rescue_cells = {"candidates": cand.copy(),
                              "accepted": np.zeros(0, cand.dtype)}
        if cand.size == 0:
            self._emit_rescue_event()
            return out
        if cand.size > cfg.mirror_max_cells:
            # the most boundary-extreme first (mirrored cells sit at tau
            # ~ 0.005; genuinely early-S cells land higher)
            extremity = np.minimum(tau[cand], 1.0 - tau[cand])
            cand = cand[np.argsort(extremity)[:cfg.mirror_max_cells]]
            logger.info("mirror rescue: capping %d candidates to the %d "
                        "most boundary-extreme (mirror_max_cells)",
                        self.mirror_rescue_stats["candidates"],
                        cfg.mirror_max_cells)
            self.mirror_rescue_stats["capped_to"] = int(cand.size)

        self._rescue_cells["fitted"] = cand.copy()
        params = out.fit.params
        # each cells shard re-fits its own candidates, padded to the
        # largest shard's count with masked copies of its first cell, so
        # every rank's sub-batch has one shape and the sub-fit runs in
        # lockstep (one shard: the candidates themselves, no pad)
        local, width = self._rescue_rows(cand, int(batch.reads.shape[0]))
        rows = np.asarray([c for c, _ in local] + [0] * (width - len(local)),
                          np.int64)
        sub_params, sub_batch = slice_cells(params, batch, rows)
        if width > len(local):
            valid = torch.as_tensor(
                np.arange(width) < len(local), dtype=torch.float32,
                device=self.device)
            sub_batch.mask = sub_batch.mask * valid
        # every global site conditioned: the sub-fit moves only the
        # candidates' per-cell sites, so splicing them back cannot shift
        # the other cells' objective
        # the candidates are not padded to a chunk multiple: the sub-fit
        # runs unchunked (JAX runner.py:1567-1568)
        spec = dataclasses.replace(out.spec, cond_rho=True, cond_a=True,
                                   cell_chunk=None)
        fixed = dict(out.fixed)
        with torch.no_grad():
            if not out.spec.cond_rho:
                fixed["rho"] = to_unit_interval(params["rho_raw"])
            if not out.spec.cond_a:
                fixed["a"] = to_positive(params["a_raw"])
        pi_key = "pi_bin_logits" if out.spec.binary_pi else "pi_logits"
        orig_sub = {k: sub_params[k]
                    for k in ("tau_raw", "u", "betas", pi_key)}
        orig_sub["beta_stds_raw"] = params["beta_stds_raw"]

        t_flip = np.clip(1.0 - tau[[g for _, g in local]], 0.05, 0.95) \
            .astype(np.float32)
        t_flip = np.pad(t_flip, (0, width - len(local)), constant_values=0.5)
        params0 = init_params(spec, sub_batch, fixed, t_init=t_flip,
                              mesh=self.mesh)
        # warm-seed the sites the flip does not mirror, from fresh copies
        # (the acceptance scoring and the splice read the originals
        # after the fit): beta_stds, the width the candidates are scored
        # under, and the incumbent GC coefficients
        params0["beta_stds_raw"] = params["beta_stds_raw"].clone()
        params0["betas"] = sub_params["betas"].clone()
        fit = fit_map(_PertLossFn(spec, self.mesh), params0,
                      (fixed, sub_batch), max_iter=cfg.mirror_max_iter,
                      min_iter=cfg.mirror_min_iter, rel_tol=cfg.rel_tol,
                      learning_rate=cfg.learning_rate, b1=cfg.adam_b1,
                      b2=cfg.adam_b2, device=self.device,
                      moment_dtype=cfg.optimizer_state_dtype)
        self.rescue_fit = RescueFit(cand.copy(), fit)
        self._emit_program_events("rescue", fit)

        # both scored under the step-2 beta_stds (the sub-fit also moves
        # that global param; its drift is discarded)
        rescued = dict(fit.params)
        rescued["beta_stds_raw"] = orig_sub["beta_stds_raw"]
        with torch.no_grad():
            obj_orig = per_cell_objective(spec, orig_sub, fixed, sub_batch,
                                          mesh=self.mesh)
            obj_new = per_cell_objective(spec, rescued, fixed, sub_batch,
                                         mesh=self.mesh)
            # each shard's first len(its candidates) rows, in cand order
            keep_rows = self._rescue_order(cand, int(batch.reads.shape[0]),
                                           width)
            tau_new = self._gather(to_unit_interval(fit.params["tau_raw"]),
                                   ("cells",))[keep_rows]
            accept_all = self._gather(obj_new > obj_orig, ("cells",))
        accept = accept_all[keep_rows]
        self.mirror_rescue_stats["accepted"] = int(accept.sum())
        logger.info("mirror rescue: %d boundary-tau candidates, %d accepted "
                    "(per-cell log-joint improved)", cand.size,
                    int(accept.sum()))
        self._emit_rescue_event((tau_new - tau[cand])[accept])
        if not accept.any():
            return out

        keep = cand[accept]
        self._rescue_cells["accepted"] = keep.copy()
        mine = [(c, i) for i, (c, _) in enumerate(local)
                if accept_all[self._rescue_base(width) + i]]
        if not mine:
            return out
        dst = torch.as_tensor([c for c, _ in mine], device=self.device)
        src = torch.as_tensor([i for _, i in mine], device=self.device)
        new_params = dict(params)
        for key in ("tau_raw", "u", "betas"):
            new_params[key] = params[key].index_copy(
                0, dst, rescued[key].index_select(0, src))
        new_params[pi_key] = params[pi_key].index_copy(
            1, dst, rescued[pi_key].index_select(1, src))
        new_fit = dataclasses.replace(out.fit, params=new_params)
        return dataclasses.replace(out, fit=new_fit)

    def _rescue_rows(self, cand: np.ndarray, local_cells: int):
        """(this shard's candidates as ``(local row, global index)``
        pairs in ``cand`` order, the sub-batch width: the largest
        shard's count)."""
        if self.mesh is None:
            return [(int(c), int(c)) for c in cand], int(cand.size)
        shard = cand // local_cells
        width = int(np.bincount(shard, minlength=self.mesh.cells).max())
        mine = cand[shard == self.mesh.cell_index]
        return [(int(c) % local_cells, int(c)) for c in mine], width

    def _rescue_base(self, width: int) -> int:
        """This shard's first row in the gathered sub-batch."""
        return 0 if self.mesh is None else self.mesh.cell_index * width

    def _rescue_order(self, cand: np.ndarray, local_cells: int,
                      width: int) -> np.ndarray:
        """Rows of the gathered sub-batch (shard-major, ``width`` each)
        in the order of ``cand``."""
        if self.mesh is None:
            return np.arange(cand.size)
        shard = cand // local_cells
        rank_in_shard = np.zeros(cand.size, np.int64)
        for k in range(self.mesh.cells):
            where = np.flatnonzero(shard == k)
            rank_in_shard[where] = np.arange(where.size)
        return shard * width + rank_in_shard

    def _emit_rescue_event(self, tau_deltas=None) -> None:
        """``rescue`` event from ``mirror_rescue_stats`` and the accepted
        cells' tau changes (the first 64)."""
        stats = self.mirror_rescue_stats or {}
        deltas = (np.asarray(tau_deltas, np.float64)
                  if tau_deltas is not None else np.zeros(0))
        self.run_log.emit(
            "rescue", step="step2",
            candidates=int(stats.get("candidates", 0)),
            accepted=int(stats.get("accepted", 0)),
            capped_to=stats.get("capped_to"),
            tau_deltas=[_finite(round(float(d), 4)) for d in deltas[:64]],
            tau_mean_abs_delta=(
                _finite(round(float(np.mean(np.abs(deltas))), 4))
                if deltas.size else None))

    def run_step3(self, step1: StepOutput, step2: StepOutput) -> StepOutput:
        iters = self.config.resolved_iters()
        t0 = time.perf_counter()
        with torch.no_grad():
            c1 = _sites(step1.spec, step1.fit.params, step1.fixed)
            c2 = _sites(step2.spec, step2.fit.params, step2.fixed)
        fixed = {"beta_means": c1["beta_means"], "lamb": c1["lamb"],
                 "rho": c2["rho"], "a": c2["a"]}   # pert_model.py:844-851
        etas2_real = self.build_etas_step3()
        g1 = self._pad(self.g1)
        t_init2 = self._t_init(self.g1, etas2_real, g1.num_cells)
        etas2 = _pad_etas(etas2_real, g1.num_cells, g1.num_loci)
        eta_fields = self._eta_fields(etas2)
        batch = self._batch(g1, **eta_fields)
        spec = PertModelSpec(
            P=self.config.P, K=self.config.K, L=self.L, tau_mode="param",
            step1=False, cond_beta_means=True, cond_rho=True, cond_a=True,
            fixed_lamb=True, sparse_etas="eta_idx" in eta_fields,
            binary_pi=self.config.binary_pi,
            cell_chunk=self.config.cell_chunk)
        self.phases.add("step3/build", time.perf_counter() - t0)
        out = self._fit(spec, batch, fixed, t_init2,
                        iters["max_iter_step3"], iters["min_iter_step3"],
                        "step3")
        self._step3_data = g1
        return out

    def build_cell_qc(self, out: StepOutput, data: PertData,
                      qc_stats: dict) -> pd.DataFrame:
        """Per-cell QC table of a fitted step (JAX ``build_cell_qc``):
        tau, the entropy aggregates that packaging collected
        (``package_step_output``'s ``qc_collect``), the
        posterior-predictive check at the packaged MAP states, the
        mirror rescue's status, and the flags ``high_entropy``,
        ``ppc_outlier``, ``boundary_tau`` and ``non_finite`` with
        ``qc_pass`` their negation.  One row per real cell."""
        cfg = self.config
        n = int(np.sum(data.cell_mask)) if data.cell_mask is not None \
            else data.num_cells
        cell_ids = list(data.cell_ids)[:n]
        ppc_dropped = False
        with self.phases.phase("qc/ppc"):
            try:
                faults_mod.point("qc/ppc")
                ppc_t0 = time.perf_counter()
                bins = ("cells", "loci")
                with program_step("step2"):
                    ppc_dev, ppc_z = (self._gather(t, ("cells",))[:n]
                                      for t in ppc_discrepancy(
                        out.spec, out.fit.params, out.fixed, out.batch,
                        seed=cfg.seed, num_replicates=cfg.qc_ppc_replicates,
                        maps=(self._tile(qc_stats["cn_map"], bins),
                              self._tile(qc_stats["rep_map"], bins)),
                        mesh=self.mesh))
                self.meter.book_exec(
                    kind="ppc", seconds=time.perf_counter() - ppc_t0,
                    ctx={"step": "step2",
                         **self._meter_attrs("step2", out.batch)})
            except Exception as exc:
                if faults_mod.classify_exception(exc) != "oom":
                    raise
                # degradation ladder, QC rung: the PPC is an optional
                # health surface — drop it rather than kill a run whose
                # inference results are already computed and durable
                ppc_dropped = True
                ppc_dev = np.full(n, np.nan, np.float64)
                ppc_z = np.full(n, np.nan, np.float64)
                self.run_log.emit(
                    "degrade", step="step2", action="drop_ppc",
                    error_class="oom",
                    detail=("posterior-predictive check OOMed — PPC "
                            "columns are NaN and the ppc_outlier flag "
                            "is disabled for this run"),
                    error=f"{type(exc).__name__}: {str(exc)[:300]}")
                logger.warning("cell QC: PPC dropped after OOM (%s)", exc)
        with self.phases.phase("qc/package"):
            return self._cell_qc_table(cell_ids, ppc_dev, ppc_z, qc_stats,
                                       ppc_dropped)

    def _cell_qc_table(self, cell_ids, ppc_dev, ppc_z, qc_stats: dict,
                       ppc_dropped: bool = False) -> pd.DataFrame:
        """The QC table of :meth:`build_cell_qc` and its
        ``cell_qc_summary`` event (the flagged cells, the first 64, most
        suspect first).  A dropped PPC (its OOM rung) leaves NaN columns
        that flag no cell ``non_finite``."""
        cfg = self.config
        n = len(cell_ids)
        tau = np.asarray(qc_stats["tau"])[:n]
        mean_ent = np.asarray(qc_stats["mean_cn_entropy"])[:n]
        max_ent = np.asarray(qc_stats["max_cn_entropy"])[:n]
        frac_low = np.asarray(qc_stats["frac_low_conf"])[:n]
        mean_rep = np.asarray(qc_stats["mean_rep_entropy"])[:n]
        rescue_cand = np.zeros(n, bool)
        rescue_acc = np.zeros(n, bool)
        if self._rescue_cells is not None:
            c = self._rescue_cells["candidates"]
            a = self._rescue_cells["accepted"]
            rescue_cand[c[c < n]] = True
            rescue_acc[a[a < n]] = True
        finite = np.isfinite(tau) & np.isfinite(mean_ent)
        if not ppc_dropped:
            finite &= np.isfinite(ppc_z)
        # NaN comparisons are False: a poisoned cell lands only in
        # non_finite, the flag that subsumes the others
        flag_arrays = {
            "high_entropy": frac_low > cfg.qc_frac_thresh,
            "ppc_outlier": ppc_z > cfg.qc_ppc_z,
            "boundary_tau": ((tau < cfg.mirror_tau_lo)
                             | (tau > cfg.mirror_tau_hi)),
            "non_finite": ~finite,
        }
        flags = np.full(n, "", object)
        for name, arr in flag_arrays.items():
            sep = np.where(flags == "", "", ",")
            flags = np.where(arr, flags + sep + name, flags)
        flagged = flags != ""
        order = np.argsort(-(np.nan_to_num(ppc_z, nan=np.inf, posinf=np.inf)
                             + np.nan_to_num(frac_low, nan=1.0)))
        worst = order[flagged[order]][:64]
        self.run_log.emit(
            "cell_qc_summary", step="step2",
            num_cells=int(n), num_flagged=int(flagged.sum()),
            flag_counts={k: int(v.sum())
                         for k, v in flag_arrays.items() if v.any()},
            thresholds={
                "entropy_thresh": float(cfg.qc_entropy_thresh),
                "frac_thresh": float(cfg.qc_frac_thresh),
                "ppc_z": float(cfg.qc_ppc_z),
                "ppc_replicates": int(cfg.qc_ppc_replicates),
            },
            entropy_hist=[int(v) for v in np.histogram(
                mean_ent[np.isfinite(mean_ent)], bins=10,
                range=(0.0, 1.0))[0]],
            mean_cn_entropy_mean=_finite(np.nanmean(mean_ent))
            if n else None,
            ppc_z_max=_finite(np.nanmax(ppc_z))
            if n and np.isfinite(ppc_z).any() else None,
            flagged_cells=[{
                "cell_id": str(cell_ids[i]),
                "reasons": flags[i].split(","),
                "tau": _finite(tau[i]),
                "frac_low_conf": _finite(frac_low[i]),
                "ppc_z": _finite(ppc_z[i]),
            } for i in worst])
        logger.info("cell QC: %d/%d cells flagged (%s)", int(flagged.sum()),
                    n, ", ".join(f"{k}={int(v.sum())}"
                                 for k, v in flag_arrays.items() if v.any())
                    or "all clean")
        return pd.DataFrame({
            "cell_id": cell_ids,
            "model_tau": tau,
            "mean_cn_entropy": mean_ent,
            "max_cn_entropy": max_ent,
            "frac_low_conf": frac_low,
            "mean_rep_entropy": mean_rep,
            "ppc_deviance": ppc_dev,
            "ppc_z": ppc_z,
            "rescue_candidate": rescue_cand,
            "rescue_accepted": rescue_acc,
            "qc_flags": flags,
            "qc_pass": ~flagged,
        })

    def run(self):
        """Run steps 1-3; returns (step1, step2, step3-or-None).

        Under the facade this writes into its open session and
        installed registry.  A runner driven directly creates its own
        run log from ``telemetry_path`` and its own registry here,
        installs the registry for the run and retires it after.  The
        heartbeat (with ``checkpoint_dir`` or ``heartbeat_dir``) closes
        ``done`` on return and ``error`` on an Exception; a
        BaseException (a preemption) leaves it as it was, to go stale."""
        facade_log = runlog_mod.active()
        self.run_log = facade_log \
            or runlog_mod.RunLog.create(self.config.telemetry_path)
        if self._manifest is not None:
            self._manifest.note_run_log(self.run_log.path)
        registry = metrics_mod.current()
        owns_metrics = not registry.enabled
        self.metrics = metrics_mod.MetricsRegistry.create(
            textfile_path=self.config.metrics_textfile) \
            if owns_metrics else registry
        self.run_log.metrics_registry = self.metrics
        metrics_mod.attach_phase_sink(self.phases, registry=self.metrics)
        self.meter.metrics_registry = self.metrics
        self.run_log.meter_ledger = self.meter
        # span tracing: the facade attaches the tracer to the log it
        # owns; a runner driven directly attaches its own.  Phases become
        # spans through the timer's chain, and the chunk loop records
        # fit/chunk spans through the runlog.current() seam
        if self.config.trace_spans and self.run_log.tracer is None:
            spans_mod.attach_tracer(self.run_log,
                                    spans_mod.tracer_for_run(self.config))
        if self.run_log.tracer is not None:
            spans_mod.attach_phase_sink(self.phases, self.run_log.tracer)
        if facade_log is None:
            # the facade stamps the log it owns itself
            if self.config.request_id:
                self.run_log.add_context(
                    request_id=str(self.config.request_id))
            if self.config.slab_width:
                self.run_log.add_context(
                    slab_width=int(self.config.slab_width))
        if owns_metrics:
            metrics_mod.install(self.metrics)
        try:
            # re-entrant: under the facade's open log this is a
            # pass-through and the facade's run_end closes the file.
            # The compiled-program store is the run's (a serving
            # worker's when it shares its directory): its graphs and
            # pools are freed when the run ends, an exception included;
            # the kernel libraries build in compile_cache_dir's directory
            with self.run_log.session(config=self.config, timer=self.phases,
                                      device=self.device), \
                    aotcache_mod.run_scope(
                        self.config.executable_cache_dir,
                        aotcache_mod.program_config_digest(self.config),
                        self._bucket()), \
                    _cuda.build_dir_scope(self.config.compile_cache_dir):
                step1 = _retire(self.run_step1(), pi=True)
                with self.phases.phase("step2/prior"):
                    etas = self.build_etas()
                step2 = _retire(self.run_step2(step1, etas), pi=False)
                step3 = _retire(self.run_step3(step1, step2), pi=False) \
                    if self.config.run_step3 else None
            self.metrics.write_textfile()
            if self._manifest is not None:
                # the durable cost record, for a run without a log
                self._manifest.doc["meter"] = self.meter.summary()
                self._manifest.save()
        except Exception as exc:
            if self._heartbeat is not None:
                self._heartbeat.close("error", error=exc)
            raise
        finally:
            if owns_metrics:
                metrics_mod.uninstall(self.metrics)
            if self._heartbeat is not None:
                heartbeat_mod.uninstall(self._heartbeat)
        if self._heartbeat is not None:
            self._heartbeat.close("done")
        return step1, step2, step3


# ---------------------------------------------------------------------------
# output packaging (pandas parity)
# ---------------------------------------------------------------------------

def _decode_with_degradation(spec, params, fixed, batch, want_entropy: bool,
                             phase_prefix: str, data=None,
                             hmm_self_prob: Optional[float] = None,
                             mesh=None):
    """The packaging decode under the OOM degradation ladder (JAX
    ``_decode_with_degradation``).  ``hmm_self_prob`` selects the
    Viterbi CN decode, its chain restarting at each chromosome start of
    ``data.loci`` (the whole genome's); on a ``mesh`` that shards the
    loci each rank runs the chain over whole rows of its cells
    (``decode_discrete_hmm``'s ``mesh``).

    Returns ``(decoded, ent_planes, want_entropy)``.  On an ``oom`` the
    ladder walks: halve the decode slab (three times — each halving
    halves the live joint tensor), then drop the optional QC entropy
    surfaces, then re-raise — at which point every step's results are
    already in durable checkpoints, so the abort is resumable.  Every
    rung is a ``degrade`` event; other errors propagate from the first
    attempt untouched.  The fault site ``{phase_prefix}/decode`` fires
    on every attempt.
    """
    log = runlog_mod.current()
    num_loci = batch.reads.shape[1]
    auto_chunk = max(1, _DECODE_SLAB_BYTES
                     // max(num_loci * spec.P * 2 * 4, 1))

    def _decode(chunk, entropy):
        faults_mod.point(f"{phase_prefix}/decode")
        if hmm_self_prob is not None:
            chroms = data.loci.get_level_values(0)
            restart = np.r_[1.0, (chroms[1:] != chroms[:-1])
                            .astype(np.float32)]
            out = decode_discrete_hmm(spec, params, fixed, batch, restart,
                                      hmm_self_prob, want_entropy=entropy,
                                      mesh=mesh)
        else:
            # each slab length (a rung of the ladder) is a program of its
            # own key in the run's store
            with program_step(phase_prefix):
                out = decode_discrete(spec, params, fixed, batch,
                                      want_entropy=entropy, cell_chunk=chunk,
                                      mesh=mesh)
        if entropy:
            return out[:3], out[3:]
        return out, None

    # rung 0 is the normal path (the automatic slab); rungs 1-3 halve it.
    # The Viterbi decode has no slab knob, so its ladder goes from the
    # normal attempt straight to dropping the QC surfaces
    if hmm_self_prob is not None:
        ladder = [None]
    else:
        ladder = [None] + [max(1, auto_chunk >> k) for k in (1, 2, 3)]
    last_exc = None
    for rung, chunk in enumerate(ladder):
        try:
            decoded, ent_planes = _decode(chunk, want_entropy)
            return decoded, ent_planes, want_entropy
        except Exception as exc:
            if faults_mod.classify_exception(exc) != "oom":
                raise
            last_exc = exc
            if rung == len(ladder) - 1:
                break
            log.emit(
                "degrade", step=phase_prefix, action="halve_decode_slab",
                detail=(f"decode OOM at slab={chunk or auto_chunk} cells — "
                        f"retrying at {max(1, auto_chunk >> (rung + 1))}"),
                error=f"{type(exc).__name__}: {str(exc)[:300]}")
    if want_entropy:
        # next rung: drop the optional QC surfaces and retry once at
        # the smallest slab
        log.emit(
            "degrade", step=phase_prefix, action="drop_qc_surfaces",
            detail=("decode still OOM at the smallest slab — dropping "
                    "the posterior-entropy planes (model_cn_entropy "
                    "column and the per-cell QC table) for this run"),
            error=f"{type(last_exc).__name__}: {str(last_exc)[:300]}")
        try:
            decoded, ent_planes = _decode(ladder[-1], False)
            return decoded, ent_planes, False
        except Exception as exc:
            if faults_mod.classify_exception(exc) != "oom":
                raise
            last_exc = exc
    log.emit(
        "degrade", step=phase_prefix, action="abort_resumable",
        error_class="oom",
        detail=("decode OOM after the full degradation ladder; step "
                "checkpoints are durable, so the run is resumable"),
        error=f"{type(last_exc).__name__}: {str(last_exc)[:300]}")
    raise last_exc


def package_step_output(
    cn_long: pd.DataFrame,
    data: PertData,
    step: StepOutput,
    lamb: float,
    losses_g: np.ndarray,
    losses_s: np.ndarray,
    cols: ColumnConfig = ColumnConfig(),
    mirror_rescue_stats: Optional[dict] = None,
    qc_collect: Optional[dict] = None,
    qc_entropy_thresh: float = 0.5,
    phase_prefix: str = "s",
    hmm_self_prob: Optional[float] = None,
    mesh=None,
) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Decode the discretes and attach the fitted values to the long-form
    contract (reference: pert_model.py:466-538): model_cn_state,
    model_rep_state, model_p_rep, model_tau, model_u and model_rho
    columns, plus the supplementary table (model_lambda, model_a, loss_g,
    loss_s, and one ``mirror_rescue_<stat>`` row per rescue statistic
    when ``mirror_rescue_stats`` is given).

    ``qc_collect`` (a dict, filled in place) adds the posterior-entropy
    pass: the decode also returns the per-bin entropy planes, the long
    output gains ``model_cn_entropy``, and ``qc_collect`` receives the
    per-cell aggregates (reduced on the device), tau and the MAP planes
    that ``PertInference.build_cell_qc`` reads.

    ``hmm_self_prob`` switches the per-bin argmax for the Viterbi CN
    decode (``models/hmm.py``) with that self-transition probability.

    The decode runs under the OOM ladder (:func:`_decode_with_degradation`,
    fault site ``{phase_prefix}/decode``); when the ladder drops the
    entropy surfaces, ``qc_collect`` receives ``degraded: True`` and
    nothing else, and the QC table is skipped.

    ``mesh``: the step is this rank's block; each rank decodes its own
    and the planes and per-cell values are gathered on the host, so
    every rank returns the same frames."""
    spec, params, fixed, batch = step.spec, step.fit.params, step.fixed, \
        step.batch
    decode_t0 = time.perf_counter()
    decoded, ent_planes, want_entropy = _decode_with_degradation(
        spec, params, fixed, batch, qc_collect is not None, phase_prefix,
        data=data, hmm_self_prob=hmm_self_prob, mesh=mesh)
    if qc_collect is not None and not want_entropy:
        qc_collect["degraded"] = True
        qc_collect = None
    with torch.no_grad():
        c = _sites(spec, params, fixed)
        qc_device = entropy_aggregates_from_planes(
            ent_planes[0], ent_planes[1], batch.effective_loci_mask(),
            qc_entropy_thresh, want_max=True, mesh=mesh) \
            if want_entropy else {}

    def host(t, dims=("cells", "loci")):
        if mesh is None:
            return t.detach().cpu().numpy()
        return mesh.gather(t, dims)

    cn_map, rep_map, p_rep = (host(t) for t in decoded)
    ledger = meter_mod.ledger_of(runlog_mod.current())
    if ledger is not None:
        # the decode runs at the fit's padded shape: its time books with
        # the same bucket attribution (no iteration work units)
        padded = cn_map.shape
        real = (min(int(data.num_cells), padded[0]),
                min(int(data.num_loci), padded[1]))
        ledger.book_exec(
            kind="decode", seconds=time.perf_counter() - decode_t0,
            ctx={"step": f"{phase_prefix}/decode",
                 "bucket": f"c{padded[0]}xl{padded[1]}",
                 "pad_frac": round(max(1.0 - (real[0] * real[1])
                                       / max(padded[0] * padded[1], 1),
                                       0.0), 6)})
    tau, u = (host(c[k], ("cells",)) for k in ("tau", "u"))
    rho, a_c = host(c["rho"], ("loci",)), c["a"].detach().cpu().numpy()

    n = int(np.sum(data.cell_mask)) if data.cell_mask is not None \
        else data.num_cells
    cell_ids = list(data.cell_ids)[:n]
    cn_long = cn_long.copy()
    cn_long[cols.chr_col] = cn_long[cols.chr_col].astype(str)
    per_bin = {"model_cn_state": cn_map[:n], "model_rep_state": rep_map[:n],
               "model_p_rep": p_rep[:n]}
    if want_entropy:
        per_bin["model_cn_entropy"] = host(ent_planes[0])[:n]
        qc_collect.update({k: host(v, ("cells",))
                           for k, v in qc_device.items()})
        qc_collect.update(tau=tau, cn_map=cn_map, rep_map=rep_map)
    out = attach_dense_columns(
        cn_long, cell_ids, data.loci, cols,
        per_bin=per_bin,
        per_cell={"model_tau": tau[:n], "model_u": u[:n]},
        per_locus={"model_rho": rho},
    )
    supp = [
        pd.DataFrame({"param": ["model_lambda"], "level": ["all"],
                      "value": [float(lamb)]}),
        pd.DataFrame({"param": ["model_a"], "level": ["all"],
                      "value": [float(np.asarray(a_c).reshape(-1)[0])]}),
        pd.DataFrame({"param": ["loss_g"] * len(losses_g),
                      "level": np.arange(len(losses_g)),
                      "value": np.asarray(losses_g, np.float64)}),
        pd.DataFrame({"param": ["loss_s"] * len(losses_s),
                      "level": np.arange(len(losses_s)),
                      "value": np.asarray(losses_s, np.float64)}),
    ]
    if mirror_rescue_stats is not None:
        supp.append(pd.DataFrame({
            "param": [f"mirror_rescue_{k}" for k in mirror_rescue_stats],
            "level": ["all"] * len(mirror_rescue_stats),
            "value": [float(v) for v in mirror_rescue_stats.values()],
        }))
    return out, pd.concat(supp, ignore_index=True)
