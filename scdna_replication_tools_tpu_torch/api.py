"""Public pandas-in / pandas-out facade: ``scRT`` (port of ``api.py``).

Same constructor keywords and defaults as the JAX ``scRT`` (reference:
infer_scRT.py:25-105), plus ``device``.  ``infer(level='pert')`` runs the
three-step fit on the GPU (or on ``device='cpu'``) and returns the same
four DataFrames.

The adaptive controller, the model-health QC (``cell_qc()``), the
controller-gated mirror rescue, the run log and the durable runs
(``checkpoint_dir``, ``resume``, ``faults``, the watchdogs and the
heartbeat) run as in the JAX package, at its defaults, so
``scRT(cn_s, cn_g1)`` with no option given runs.  The run log (``telemetry_path``, 'auto' = one schema-v9 JSONL per
run under the repository's ``.pert_runs/``; the written path is
``scRT.run_log_path``) renders with ``tools/pert_report.py``; the run's
metrics registry is ``scRT.metrics_registry`` (``metrics_textfile``
adds its Prometheus textfile).  A caller who sets a JAX option the port
lacks gets ``NotImplementedError`` naming its ROADMAP item; the port
never runs something else in its place.
"""

from __future__ import annotations

import numpy as np
import torch

from scdna_replication_tools_tpu_torch.config import ColumnConfig, PertConfig
from scdna_replication_tools_tpu_torch.data.loader import build_pert_inputs
from scdna_replication_tools_tpu_torch.device import resolve_device
from scdna_replication_tools_tpu_torch.infer.runner import (
    PertInference,
    package_step_output,
)
from scdna_replication_tools_tpu_torch.models.pert import _sites
from scdna_replication_tools_tpu_torch.obs import heartbeat as heartbeat_mod
from scdna_replication_tools_tpu_torch.obs import metrics as metrics_mod
from scdna_replication_tools_tpu_torch.obs import spans as spans_mod
from scdna_replication_tools_tpu_torch.obs.runlog import RunLog
from scdna_replication_tools_tpu_torch.pipeline.assign import assign_s_to_clones
from scdna_replication_tools_tpu_torch.pipeline.consensus import (
    compute_consensus_clone_profiles,
)
from scdna_replication_tools_tpu_torch.utils.profiling import PhaseTimer


def _unported(options: dict) -> None:
    """Raise for the first JAX option left on that the port lacks."""
    checks = [
        ("cell_chunk", options["cell_chunk"] is not None,
         "A9 (encodings and options: cell_chunk)"),
        ("cn_hmm_self_prob", options["cn_hmm_self_prob"] is not None,
         "A9 (encodings and options: the Viterbi decode)"),
        ("num_shards", options["num_shards"] != 1, "A12 (multi-GPU)"),
        ("loci_shards", options["loci_shards"] != 1, "A12 (multi-GPU)"),
        ("executable_cache_dir", options["executable_cache_dir"] is not None,
         "A14 (compiled-program cache)"),
        ("clone_col", options["clone_col"] is None,
         "A10 (clone discovery: pipeline/clustering.py)"),
    ]
    for name, on, item in checks:
        if on:
            raise NotImplementedError(
                f"scRT option {name}={options[name]!r} is not ported to the "
                f"PyTorch package yet (ROADMAP {item}); leave it at its "
                "default or use scdna_replication_tools_tpu")
    if options["fused_adam"] != "auto":
        raise ValueError(f"fused_adam={options['fused_adam']!r}: the port "
                         "has one Adam path, 'auto' (the CUDA kernel on the "
                         "GPU, its plain version on the CPU)")


class scRT:
    """Single-cell replication-timing inference facade.

    Keyword surface and defaults of the JAX ``scRT``; ``device`` selects
    where the fit runs (None = the GPU, raising when there is none).
    ``backend``, ``cuda``, ``elastic_mesh``, ``compile_cache_dir`` and
    ``clustering_*`` only act inside features the port refuses, and are
    accepted and unused (the config hash records the JAX defaults of
    those it hashes: ``config.UNPORTED_FIELDS``).

    Durable runs as in the JAX package: ``checkpoint_dir`` checkpoints
    every step (and every ``checkpoint_every`` chunks inside a
    controlled fit) with a resume ledger beside them, and a live
    heartbeat under ``checkpoint_dir/health/`` (``heartbeat_dir='auto'``);
    a rerun with ``resume='auto'`` restores the completed steps and
    resumes a partial one on the uninterrupted trajectory, also from a
    directory the JAX package wrote.  ``faults`` injects the
    deterministic fault plan of ``utils/faults.py``;
    ``watchdog_compile_seconds`` / ``watchdog_chunk_seconds`` bound a
    step's compile phase and each fit chunk.
    """

    def __init__(self, cn_s, cn_g1, input_col='reads', assign_col='copy',
                 library_col='library_id', ploidy_col='ploidy',
                 cell_col='cell_id', cn_state_col='state', chr_col='chr',
                 start_col='start', gc_col='gc', rv_col='rt_value',
                 rs_col='rt_state', frac_rt_col='frac_rt',
                 clone_col='clone_id', rt_prior_col='mcf7rt',
                 cn_prior_method='g1_composite', col2='rpm_gc_norm',
                 col3='temp_rt', col4='changepoint_segments',
                 col5='binary_thresh', max_iter=2000, min_iter=100,
                 max_iter_step1=None, min_iter_step1=None,
                 max_iter_step3=None, min_iter_step3=None,
                 cn_prior_weight=1e6, learning_rate=0.05, rel_tol=1e-6,
                 cuda=False, seed=0, P=13, K=4, J=5, upsilon=6,
                 run_step3=True, backend='jax', num_shards=1,
                 loci_shards=1, cell_chunk=None, checkpoint_dir=None,
                 resume='auto', checkpoint_every=4, faults=None,
                 watchdog_compile_seconds=None,
                 watchdog_chunk_seconds=None, elastic_mesh=True,
                 pad_cells_to=None, pad_loci_to=None, request_id=None,
                 slab_width=None,
                 trace_spans=False, trace_parent=None,
                 enum_impl='auto', fused_adam='auto',
                 optimizer_state_dtype='float32', cn_hmm_self_prob=None,
                 rho_from_rt_prior=False, mirror_rescue=True,
                 compile_cache_dir='auto', executable_cache_dir=None,
                 telemetry_path='auto',
                 metrics_textfile=None, heartbeat_dir='auto',
                 heartbeat_interval_seconds=15.0, fit_diag_every=25,
                 qc=True, qc_entropy_thresh=0.5, qc_frac_thresh=0.25,
                 qc_ppc_replicates=8, qc_ppc_z=5.0,
                 controller=True, controller_max_extra_iters=None,
                 clustering_method='kmeans', clustering_kwargs=None,
                 device=None):
        _unported(dict(
            fused_adam=fused_adam, cell_chunk=cell_chunk,
            cn_hmm_self_prob=cn_hmm_self_prob, num_shards=num_shards,
            loci_shards=loci_shards,
            executable_cache_dir=executable_cache_dir, clone_col=clone_col))
        self.device = resolve_device(device)
        self.cn_s = cn_s
        self.cn_g1 = cn_g1
        self.clone_col = clone_col
        self.cols = ColumnConfig(
            input_col=input_col, gc_col=gc_col, rt_prior_col=rt_prior_col,
            clone_col=clone_col, cell_col=cell_col, library_col=library_col,
            chr_col=chr_col, start_col=start_col, cn_state_col=cn_state_col,
            assign_col=assign_col, ploidy_col=ploidy_col, rv_col=rv_col,
            rs_col=rs_col, frac_rt_col=frac_rt_col, rpm_gc_norm_col=col2,
            temp_rt_col=col3, seg_col=col4, thresh_col=col5,
        )
        self.config = PertConfig(
            P=P, K=K, J=J, upsilon=upsilon,
            cn_prior_method=cn_prior_method, cn_prior_weight=cn_prior_weight,
            rho_from_rt_prior=rho_from_rt_prior,
            learning_rate=learning_rate, max_iter=max_iter, min_iter=min_iter,
            rel_tol=rel_tol, max_iter_step1=max_iter_step1,
            min_iter_step1=min_iter_step1, max_iter_step3=max_iter_step3,
            min_iter_step3=min_iter_step3, run_step3=run_step3,
            pad_cells_to=pad_cells_to, pad_loci_to=pad_loci_to,
            enum_impl=enum_impl, optimizer_state_dtype=optimizer_state_dtype,
            mirror_rescue=mirror_rescue, seed=seed,
            fit_diag_every=fit_diag_every, qc=qc,
            qc_entropy_thresh=qc_entropy_thresh,
            qc_frac_thresh=qc_frac_thresh,
            qc_ppc_replicates=qc_ppc_replicates, qc_ppc_z=qc_ppc_z,
            controller=controller,
            controller_max_extra_iters=controller_max_extra_iters,
            telemetry_path=telemetry_path, metrics_textfile=metrics_textfile,
            checkpoint_dir=checkpoint_dir, resume=resume,
            checkpoint_every=checkpoint_every, faults=faults,
            watchdog_compile_seconds=watchdog_compile_seconds,
            watchdog_chunk_seconds=watchdog_chunk_seconds,
            heartbeat_dir=heartbeat_dir,
            heartbeat_interval_seconds=heartbeat_interval_seconds,
            request_id=request_id, slab_width=slab_width,
            trace_spans=trace_spans, trace_parent=trace_parent,
        )
        self.clone_profiles = None
        # {candidates, accepted[, capped_to]} of the last mirror rescue
        # (None unless it ran)
        self.mirror_rescue_stats = None
        # the last mirror rescue's sub-fit, ``infer.runner.RescueFit``
        # (re-fitted cells and their FitResult; None unless it ran)
        self.mirror_rescue_fit = None
        # {stage: wall seconds} of the last infer(level='pert'), with
        # "total_accounted"
        self.phase_report = None
        # the last run's metrics registry and the path its run log was
        # written to (None with telemetry off)
        self.metrics_registry = None
        self.run_log_path = None
        # the per-cell model-health table of the last run (qc=True)
        self._cell_qc_df = None

    def infer(self, level: str = 'pert'):
        if level in ('pyro', 'pert', 'jax'):
            self.cn_s, supp_s, cn_g1_out, supp_g1 = self.infer_pert_model()
            return self.cn_s, supp_s, cn_g1_out, supp_g1
        if level in ('cell', 'clone', 'bulk'):
            raise NotImplementedError(
                f"infer(level={level!r}) is not ported to the PyTorch "
                "package yet (ROADMAP A10: the deterministic levels)")
        raise ValueError(f"unknown level {level!r}")

    def _ensure_clones(self, assign_col: str):
        """Consensus clone profiles of the G1 cells, then S-cell clone
        assignment (reference: infer_scRT.py:129-148)."""
        c = self.cols
        self.clone_profiles = compute_consensus_clone_profiles(
            self.cn_g1, assign_col, clone_col=self.clone_col,
            cell_col=c.cell_col, chr_col=c.chr_col, start_col=c.start_col,
            cn_state_col=c.cn_state_col)
        self.cn_s = assign_s_to_clones(
            self.cn_s, self.clone_profiles, col_name=assign_col,
            clone_col=self.clone_col, cell_col=c.cell_col,
            chr_col=c.chr_col, start_col=c.start_col)

    def infer_pert_model(self):
        """The three-step fit (reference: infer_scRT.py:127-168): returns
        (cn_s_out, supp_s_out, cn_g1_out, supp_g1_out); the G1 pair is
        None when ``run_step3=False``.

        The facade owns the telemetry, as in the JAX package: the metrics
        registry is installed before the run-log session opens (so the
        early phases and ``run_start`` count), both ride the facade's
        PhaseTimer, and the session around clone_prep .. package
        guarantees ``run_end``, even on an exception."""
        c = self.cols
        timer = PhaseTimer()
        with timer.phase("telemetry/create"):
            registry = metrics_mod.MetricsRegistry.create(
                textfile_path=self.config.metrics_textfile)
            metrics_mod.install(registry)
            metrics_mod.attach_phase_sink(timer, registry=registry)
            heartbeat_mod.attach_phase_sink(timer)
            self.metrics_registry = registry
            run_log = RunLog.create(self.config.telemetry_path)
        run_log.metrics_registry = registry
        if self.config.trace_spans:
            # the facade owns the log, so it attaches the tracer (the
            # runner defers to one already attached) and points the span
            # phase sink at the timer every phase of the run accumulates
            # into; the session below opens the root 'run' span
            spans_mod.attach_tracer(
                run_log, spans_mod.tracer_for_run(self.config))
            spans_mod.attach_phase_sink(timer, run_log.tracer)
        if self.config.request_id:
            run_log.add_context(request_id=str(self.config.request_id))
        if self.config.slab_width:
            # this run was one lane of a width-K serving slab
            run_log.add_context(slab_width=int(self.config.slab_width))
        self.run_log_path = run_log.path
        with run_log.session(config=self.config, timer=timer,
                             device=self.device):
            with timer.phase("clone_prep"):
                self._ensure_clones(c.assign_col)

            with timer.phase("load"):
                s_data, g1_data = build_pert_inputs(self.cn_s, self.cn_g1, c)
                clone_ids = sorted(
                    self.cn_g1[self.clone_col].astype(str).unique())
                clone_map = {cid: i for i, cid in enumerate(clone_ids)}

                def _clone_idx(cn, cell_ids):
                    per_cell = cn[[c.cell_col, self.clone_col]] \
                        .drop_duplicates(c.cell_col) \
                        .set_index(c.cell_col)[self.clone_col]
                    return np.array([clone_map[str(per_cell[cid])]
                                     for cid in cell_ids], np.int32)

                inference = PertInference(
                    s_data, g1_data, self.config,
                    clone_idx_s=_clone_idx(self.cn_s, s_data.cell_ids),
                    clone_idx_g1=_clone_idx(self.cn_g1, g1_data.cell_ids),
                    num_clones=len(clone_ids), device=self.device)
            # the runner accumulates its phases into the same ledger
            inference.phases = timer
            step1, step2, step3 = inference.run()
            self.mirror_rescue_stats = inference.mirror_rescue_stats
            self.mirror_rescue_fit = inference.rescue_fit

            with timer.phase("package"):
                with torch.no_grad():
                    lamb = float(_sites(step1.spec, step1.fit.params,
                                        step1.fixed)["lamb"].reshape(-1)[0])
                qc_collect = {} if self.config.qc else None
                cn_s_out, supp_s_out = package_step_output(
                    self.cn_s, inference._step2_data, step2, lamb,
                    step1.fit.losses, step2.fit.losses, c,
                    mirror_rescue_stats=inference.mirror_rescue_stats,
                    qc_collect=qc_collect,
                    qc_entropy_thresh=self.config.qc_entropy_thresh,
                    phase_prefix="package_s")
            if qc_collect is not None and not qc_collect.get("degraded"):
                # a 'degraded' marker means the packaging decode's OOM
                # ladder dropped the entropy surfaces: the QC table has
                # no inputs then (the drop is a degrade event)
                self._cell_qc_df = inference.build_cell_qc(
                    step2, inference._step2_data, qc_collect)
            with timer.phase("package"):
                if step3 is not None:
                    cn_g1_out, supp_g1_out = package_step_output(
                        self.cn_g1, inference._step3_data, step3, lamb,
                        step1.fit.losses, step3.fit.losses, c,
                        phase_prefix="package_g1")
                else:
                    cn_g1_out, supp_g1_out = None, None
        self.phase_report = timer.report()
        self.steps = (step1, step2, step3)
        # the textfile's final refresh (a telemetry-off run has no run_end
        # snapshot); the registry then leaves the seam and stays readable
        # as scRT.metrics_registry
        registry.write_textfile()
        metrics_mod.uninstall(registry)
        return cn_s_out, supp_s_out, cn_g1_out, supp_g1_out

    def cell_qc(self):
        """Per-cell model-health QC table of the last PERT run (JAX
        ``scRT.cell_qc``): one row per S-phase cell with ``model_tau``,
        the posterior-entropy aggregates (``mean_cn_entropy``,
        ``max_cn_entropy``, ``frac_low_conf``, ``mean_rep_entropy``),
        the posterior-predictive check (``ppc_deviance``, ``ppc_z``),
        the mirror rescue's status, and ``qc_flags`` (comma-joined:
        ``high_entropy``, ``ppc_outlier``, ``boundary_tau``,
        ``non_finite``) with ``qc_pass`` their negation."""
        if self._cell_qc_df is None:
            raise RuntimeError(
                "cell_qc() needs a completed infer(level='pert') run with "
                "qc=True (the default) - run infer first, or drop qc=False")
        return self._cell_qc_df
