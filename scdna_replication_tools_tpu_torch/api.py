"""Public pandas-in / pandas-out facade: ``scRT`` and ``SPF`` (port of
``api.py``).

Same constructor keywords and defaults as the JAX ``scRT`` (reference:
infer_scRT.py:25-105), plus ``device``.  ``infer(level='pert')`` runs the
three-step fit on the GPU (or on ``device='cpu'``) and returns the same
four DataFrames; ``level='cell'|'clone'|'bulk'`` runs the deterministic
levels (empty frames for the outputs they do not have).  With
``clone_col=None`` the clones are discovered by k-means on the device
(or ``clustering_method='umap_hdbscan'``, host sklearn); ``cell_chunk``
runs the fused kernels per chunk of cells and ``cn_hmm_self_prob``
decodes CN with Viterbi.  ``SPF`` gives the per-clone S-phase fraction
(reference: infer_SPF.py:18-111).

The adaptive controller, the model-health QC (``cell_qc()``), the
controller-gated mirror rescue, the run log and the durable runs
(``checkpoint_dir``, ``resume``, ``faults``, the watchdogs and the
heartbeat) run as in the JAX package, at its defaults, so
``scRT(cn_s, cn_g1)`` with no option given runs.  The run log (``telemetry_path``, 'auto' = one schema-v9 JSONL per
run under the repository's ``.pert_runs/``; the written path is
``scRT.run_log_path``) renders with ``tools/pert_report.py``; the run's
metrics registry is ``scRT.metrics_registry`` (``metrics_textfile``
adds its Prometheus textfile).  ``executable_cache_dir=D`` replays a CUDA
graph per fit iteration on the card, and the graphs of each decode and
PPC slab pass after the fits, captured once per program and kept in the
run's compiled-program store (``infer/aotcache.py``), whose directory
keeps the kernel libraries and the program records for the next
process;
``compile_cache_dir`` is where the libraries build; ``profile_dir=T``
writes a ``torch.profiler`` trace per step fit (and one of the
packaging) into T and the ``pert_xla_scope_seconds`` gauges of their
named ranges into the run's registry.  The port never runs something
else in place of an option it takes.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from scdna_replication_tools_tpu_torch.config import ColumnConfig, PertConfig
from scdna_replication_tools_tpu_torch.data.loader import (
    build_pert_inputs,
    check_frame_columns,
)
from scdna_replication_tools_tpu_torch.device import resolve_device
from scdna_replication_tools_tpu_torch.infer import aotcache
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
from scdna_replication_tools_tpu_torch.pipeline.clustering import (
    discover_clones,
)
from scdna_replication_tools_tpu_torch.pipeline.consensus import (
    compute_consensus_clone_profiles,
)
from scdna_replication_tools_tpu_torch.utils import profiling
from scdna_replication_tools_tpu_torch.utils.profiling import PhaseTimer


def _feed_trace_scope_gauges(profile_dir, registry) -> None:
    """One ``pert_xla_scope_seconds{scope}`` gauge per named range of the
    run's traces (``utils/trace_summary.scope_totals``: device seconds by
    full ``pert/*`` path), so run_end's metrics snapshot carries them
    (JAX ``api._feed_trace_scope_gauges``).  Best-effort: a missing or
    unreadable trace means absent gauges, never a failed run."""
    try:
        from scdna_replication_tools_tpu_torch.utils.trace_summary import (
            scope_totals,
        )

        for scope, seconds in scope_totals(str(profile_dir)).items():
            registry.gauge("pert_xla_scope_seconds",
                           labels={"scope": scope}).set(round(seconds, 6))
    except Exception as exc:  # noqa: BLE001 — metrics enrichment must
        # not take down the run it decorates
        profiling.logger.debug("metrics: trace-scope gauges unavailable "
                               "(%s)", exc)


def _unported(options: dict) -> None:
    """Raise for a JAX option value the port has no path for."""
    if options["fused_adam"] != "auto":
        raise ValueError(f"fused_adam={options['fused_adam']!r}: the port "
                         "has one Adam path, 'auto' (the CUDA kernel on the "
                         "GPU, its plain version on the CPU)")


class scRT:
    """Single-cell replication-timing inference facade.

    Keyword surface and defaults of the JAX ``scRT``; ``device`` selects
    where the fit runs (None = the GPU, raising when there is none).
    ``backend``, ``cuda`` and ``elastic_mesh`` only act inside features
    the port lacks, and are accepted and unused (the config hash records
    the JAX default of the one it hashes: ``config.UNPORTED_FIELDS``).

    The compiled-program store: ``executable_cache_dir=D`` on the card
    captures each fit's iteration into CUDA graphs once per program and
    replays them (bit-equal to the eager run), keeps them for the run
    and frees them when it ends, and keeps the kernel libraries in D,
    where the next process finds them (``compile`` events: ``miss`` for
    a capture, ``hit`` for a graph the store held, ``disk_hit`` for a
    library read from D, ``uncacheable`` for a fit on the CPU or a
    sharded one, which run eagerly).  ``compile_cache_dir`` is the
    libraries' build directory ('auto': the package's ``_build/``; None:
    the process's own).  ``profile_dir=T`` (the port's addition to the
    JAX keywords) writes a ``torch.profiler`` trace of each step fit,
    and one of the packaging, into T.

    Sharded fits: ``num_shards=N, loci_shards=M`` on every rank of an
    initialised process group of N x M ranks
    (``parallel.init_distributed``, e.g. under ``torchrun``); each rank
    loads the full frames, fits its cells slice (and loci tile) and
    returns the same output frames.  ``num_shards`` None or 0 takes every
    rank of the group (one rank, the plain run, without a group); a
    grid of more than one rank without a group raises ``ValueError``.

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
                 profile_dir=None, telemetry_path='auto',
                 metrics_textfile=None, heartbeat_dir='auto',
                 heartbeat_interval_seconds=15.0, fit_diag_every=25,
                 qc=True, qc_entropy_thresh=0.5, qc_frac_thresh=0.25,
                 qc_ppc_replicates=8, qc_ppc_z=5.0,
                 controller=True, controller_max_extra_iters=None,
                 clustering_method='kmeans', clustering_kwargs=None,
                 device=None):
        _unported(dict(fused_adam=fused_adam))
        if clustering_method not in ('kmeans', 'umap_hdbscan'):
            raise ValueError(
                f"clustering_method must be 'kmeans' or 'umap_hdbscan', "
                f"got {clustering_method!r}")
        self.clustering_method = clustering_method
        self.clustering_kwargs = dict(clustering_kwargs or {})
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
            cell_chunk=cell_chunk, cn_hmm_self_prob=cn_hmm_self_prob,
            num_shards=num_shards, loci_shards=loci_shards,
            profile_dir=profile_dir, compile_cache_dir=compile_cache_dir,
            executable_cache_dir=executable_cache_dir,
        )
        # a grid that the process group cannot hold, or one with no
        # group, raises here and never runs as one rank; the runner makes
        # the grid (with its subgroups) on every rank and owns it
        from scdna_replication_tools_tpu_torch.parallel.mesh import grid_shape
        grid_shape(num_shards, loci_shards)
        self.mesh = None  # the last infer(level='pert')'s rank grid
        self.clone_profiles = None
        self.bulk_cn = None
        self.manhattan_df = None
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
        """(cn_s_out, supp_s_out, cn_g1_out, supp_g1_out) of a level
        (reference: infer_scRT.py:108-124); the deterministic levels
        return empty frames for the three they do not produce."""
        supp_s_out = pd.DataFrame({})
        supp_g1_out = pd.DataFrame({})
        cn_g1_out = pd.DataFrame({})
        if level == 'cell':
            self.cn_s = self.infer_cell_level()
        elif level == 'clone':
            self.cn_s = self.infer_clone_level()
        elif level == 'bulk':
            self.cn_s = self.infer_bulk_level()
        elif level in ('pyro', 'pert', 'jax'):
            self.cn_s, supp_s_out, cn_g1_out, supp_g1_out = \
                self.infer_pert_model()
        else:
            raise ValueError(f"unknown level {level!r}")
        return self.cn_s, supp_s_out, cn_g1_out, supp_g1_out

    def _ensure_clones(self, assign_col: str):
        """Clone discovery when ``clone_col`` is None (k-means on the
        device, or umap_hdbscan), consensus clone profiles of the G1
        cells, then S-cell clone assignment (reference:
        infer_scRT.py:129-148)."""
        c = self.cols
        if self.clone_col is None:
            self.cn_g1, self.clone_col = discover_clones(
                self.cn_g1, c.assign_col, cell_col=c.cell_col,
                chr_col=c.chr_col, start_col=c.start_col,
                method=self.clustering_method, device=self.device,
                **self.clustering_kwargs)
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
                self.mesh = inference.mesh
            # the runner accumulates its phases into the same ledger
            inference.phases = timer
            # the run's program store holds the fits' programs and, after
            # them, the decode and PPC programs of the packaging and QC
            with aotcache.run_scope(
                    self.config.executable_cache_dir,
                    aotcache.program_config_digest(self.config),
                    inference._bucket()):
                step1, step2, step3 = inference.run()
                self.mirror_rescue_stats = inference.mirror_rescue_stats
                self.mirror_rescue_fit = inference.rescue_fit

                # the packaging decode and the QC, traced as one block
                with profiling.trace(self.config.profile_dir, label="package"):
                    with timer.phase("package"):
                        with torch.no_grad():
                            lamb = float(_sites(
                                step1.spec, step1.fit.params,
                                step1.fixed)["lamb"].reshape(-1)[0])
                        qc_collect = {} if self.config.qc else None
                        cn_s_out, supp_s_out = package_step_output(
                            self.cn_s, inference._step2_data, step2, lamb,
                            step1.fit.losses, step2.fit.losses, c,
                            mirror_rescue_stats=inference.mirror_rescue_stats,
                            qc_collect=qc_collect,
                            qc_entropy_thresh=self.config.qc_entropy_thresh,
                            phase_prefix="package_s",
                            hmm_self_prob=self.config.cn_hmm_self_prob,
                            mesh=self.mesh)
                    if qc_collect is not None \
                            and not qc_collect.get("degraded"):
                        # a 'degraded' marker means the packaging
                        # decode's OOM ladder dropped the entropy
                        # surfaces: the QC table has no inputs then (the
                        # drop is a degrade event)
                        self._cell_qc_df = inference.build_cell_qc(
                            step2, inference._step2_data, qc_collect)
                    with timer.phase("package"):
                        if step3 is not None:
                            cn_g1_out, supp_g1_out = package_step_output(
                                self.cn_g1, inference._step3_data, step3, lamb,
                                step1.fit.losses, step3.fit.losses, c,
                                phase_prefix="package_g1",
                                hmm_self_prob=self.config.cn_hmm_self_prob,
                                mesh=self.mesh)
                        else:
                            cn_g1_out, supp_g1_out = None, None
            if self.config.profile_dir:
                # the named ranges' device time as registry gauges, so
                # run_end's snapshot carries them (the traces closed with
                # their blocks)
                with timer.phase("metrics/trace_scopes"):
                    _feed_trace_scope_gauges(self.config.profile_dir,
                                             registry)
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

    # -- deterministic levels (reference: infer_scRT.py:171-276) ---------

    def infer_cell_level(self):
        from scdna_replication_tools_tpu_torch.pipeline.deterministic import (
            infer_cell_level,
        )
        cn_s, self.manhattan_df, self.clone_profiles, self.clone_col = \
            infer_cell_level(self.cn_s, self.cn_g1, self.cols,
                             self.clone_col, self.clustering_method,
                             self.clustering_kwargs, device=self.device)
        return cn_s

    def infer_clone_level(self):
        from scdna_replication_tools_tpu_torch.pipeline.deterministic import (
            infer_clone_level,
        )
        cn_s, self.manhattan_df, self.clone_profiles, self.clone_col = \
            infer_clone_level(self.cn_s, self.cn_g1, self.cols,
                              self.clone_col, self.clustering_method,
                              self.clustering_kwargs, device=self.device)
        return cn_s

    def infer_bulk_level(self):
        from scdna_replication_tools_tpu_torch.pipeline.deterministic import (
            infer_bulk_level,
        )
        cn_s, self.manhattan_df = infer_bulk_level(
            self.cn_s, self.cn_g1, self.cols, self.clone_col,
            device=self.device)
        return cn_s

    # -- downstream (reference: infer_scRT.py:279-290) --------------------

    def compute_pseudobulk_rt_profiles(self, output_col='pseudobulk',
                                       time_col='hours'):
        from scdna_replication_tools_tpu_torch.pipeline.pseudobulk import (
            compute_pseudobulk_rt_profiles,
        )
        self.bulk_cn = compute_pseudobulk_rt_profiles(
            self.cn_s, self.cols.rv_col, output_col=output_col,
            time_col=time_col, clone_col=self.clone_col,
            chr_col=self.cols.chr_col, start_col=self.cols.start_col)
        return self.bulk_cn

    def calculate_twidth(self, pseudobulk_col='pseudobulk_hours',
                         tfs_col='time_from_scheduled_rt', per_cell=False,
                         query2=None, curve='sigmoid'):
        from scdna_replication_tools_tpu_torch.pipeline.twidth import (
            calculate_twidth,
            compute_time_from_scheduled_column,
        )
        cn = pd.merge(self.cn_s, self.bulk_cn)
        cn = compute_time_from_scheduled_column(
            cn, pseudobulk_col=pseudobulk_col,
            frac_rt_col=self.cols.frac_rt_col, tfs_col=tfs_col)
        return calculate_twidth(cn, tfs_col=tfs_col, rs_col=self.cols.rs_col,
                                cell_col=self.cols.cell_col,
                                per_cell=per_cell, query2=query2, curve=curve)


class SPF:
    """Per-clone S-phase fraction with bootstrap errors (reference:
    infer_SPF.py:18-111).  With ``clone_col=None`` the G1 cells' clones
    come from k-means on ``device`` (None = the GPU); the bootstrap is
    NumPy's ``multivariate_hypergeometric`` on ``default_rng(seed)``, as
    in the JAX package."""

    def __init__(self, cn_s, cn_g1, input_col='reads', clone_col='clone_id',
                 seed: int = 0, device=None):
        self.cn_s = cn_s
        self.cn_g1 = cn_g1
        self.input_col = input_col
        self.clone_col = clone_col
        self.rng = np.random.default_rng(seed)
        self.device = device

    def infer(self):
        # fail fast with named columns; only cn_g1 needs clone_col
        base = ['cell_id', 'chr', 'start', self.input_col]
        problems = check_frame_columns({
            'cn_s': (self.cn_s, base),
            'cn_g1': (self.cn_g1, base + [self.clone_col]),
        })
        if problems:
            raise ValueError("invalid SPF input: " + "; ".join(problems))

        if self.clone_col is None:
            # max_k=100: kmeans_cluster's own range, as the reference's
            # SPF searches (infer_SPF.py:62-66)
            self.cn_g1, self.clone_col = discover_clones(
                self.cn_g1, self.input_col, max_k=100,
                device=resolve_device(self.device))

        self.clone_profiles = compute_consensus_clone_profiles(
            self.cn_g1, self.input_col, clone_col=self.clone_col)
        self.cn_s = assign_s_to_clones(self.cn_s, self.clone_profiles,
                                       col_name=self.input_col,
                                       clone_col=self.clone_col)
        self.output_df = self.calculate_clone_fractions()
        return self.cn_s, self.output_df

    def calculate_clone_fractions(self, N_subsamples=500,
                                  frac_subsample=0.75) -> pd.DataFrame:
        """Bootstrap SPF per clone (reference: infer_SPF.py:49-111): the
        per-(clone, phase) counts of a 75 % subsample are jointly
        multivariate-hypergeometric, drawn ``N_subsamples`` times at
        once."""
        s_df = self.cn_s[['cell_id', self.clone_col]].drop_duplicates()
        g_df = self.cn_g1[['cell_id', self.clone_col]].drop_duplicates()

        s_counts = s_df[self.clone_col].value_counts().sort_index()
        g_counts = g_df[self.clone_col].value_counts().sort_index()
        clones = sorted(set(s_counts.index) | set(g_counts.index))
        s_n = np.array([s_counts.get(c, 0) for c in clones], np.int64)
        g_n = np.array([g_counts.get(c, 0) for c in clones], np.int64)

        spf = s_n / np.maximum(s_n + g_n, 1)

        category_counts = np.concatenate([s_n, g_n])
        n_total = int(category_counts.sum())
        k = int(round(frac_subsample * n_total))
        draws = self.rng.multivariate_hypergeometric(
            category_counts, k, size=N_subsamples)
        s_draw = draws[:, :len(clones)].astype(np.float64)
        g_draw = draws[:, len(clones):].astype(np.float64)
        fracs = s_draw / np.maximum(s_draw + g_draw, 1.0)
        spf_std = fracs.std(axis=0, ddof=1)

        return pd.DataFrame({
            'clone_id': clones,
            'SPF': spf,
            'SPF_std': spf_std,
            'num_s': s_n,
            'num_g': g_n,
        })
