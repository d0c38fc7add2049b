"""Console entry points of the port (port of ``cli.py``):
``infer_scrt_main``, ``infer_spf_main`` and ``simulator_main``, with the
JAX package's flags and defaults plus ``--device`` (default: the GPU,
raising when there is none; ``cpu`` runs the plain versions).  A flag
for a feature the port lacks raises as ``scRT`` does, naming its
ROADMAP item.

    python -c "from scdna_replication_tools_tpu_torch.cli import \
        infer_scrt_main; infer_scrt_main([...])"
"""

from __future__ import annotations

from argparse import ArgumentParser

import pandas as pd

_CLONE_COL_HELP = ("clone column; pass 'none' to discover clones by "
                   "clustering the G1 cells instead")


def _parse_clone_col(value):
    """CLI sentinel: the string 'none' (any case) means clone discovery."""
    return None if value.lower() == "none" else value


def infer_scrt_main(argv=None):
    p = ArgumentParser(description="Infer scRT profiles with PERT on "
                       "PyTorch/CUDA")
    p.add_argument("s_phase_cells", help="long-form tsv for S-phase cells")
    p.add_argument("g1_phase_cells", help="long-form tsv for G1-phase cells")
    p.add_argument("output", help="S-phase output tsv with scRT columns")
    p.add_argument("supp_output", help="supplementary param/loss tsv")
    p.add_argument("--level", default="pert",
                   choices=["pert", "pyro", "jax", "cell", "clone", "bulk"])
    p.add_argument("--max-iter", type=int, default=2000)
    p.add_argument("--cn-prior-method", default="g1_composite")
    p.add_argument("--clone-col", default="clone_id",
                   help=_CLONE_COL_HELP)
    p.add_argument("--clustering-method", default="kmeans",
                   choices=["kmeans", "umap_hdbscan"],
                   help="clone-discovery algorithm used when "
                        "--clone-col none")
    p.add_argument("--num-shards", type=int, default=1,
                   help="cell shards of a sharded fit (PertConfig."
                        "num_shards): run the command on every rank of a "
                        "process group of that many ranks, e.g. under "
                        "torchrun after parallel.init_distributed; 0 = "
                        "every rank of the group; more than 1 without a "
                        "group raises")
    p.add_argument("--enum-impl", default="auto",
                   choices=["auto", "xla", "pallas", "pallas_interpret",
                            "binary", "binary_xla", "binary_pallas",
                            "binary_interpret"],
                   help="pi encoding (PertConfig.enum_impl): 'auto' = "
                        "categorical, 'binary' = the independent-binary "
                        "CN encoding, both through the CUDA kernels on "
                        "the GPU; the JAX backend-specific values raise")
    p.add_argument("--fused-adam", default="auto",
                   choices=["auto", "off", "xla", "pallas",
                            "pallas_interpret"],
                   help="the pi parameter's Adam update: the port has "
                        "one, 'auto' (the CUDA kernel on the GPU); other "
                        "values raise")
    p.add_argument("--optimizer-state-dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="stored dtype of the pi parameter's Adam m/v "
                        "moments (PertConfig.optimizer_state_dtype); "
                        "bfloat16 halves the dominant optimizer-state "
                        "HBM traffic (arithmetic stays float32; "
                        "mid-budget resume across a dtype change is "
                        "refused)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="write step-boundary + periodic in-fit "
                        "checkpoints (and the resume manifest) to this "
                        "directory (PertConfig.checkpoint_dir)")
    p.add_argument("--resume", default="auto",
                   choices=["auto", "force", "off"],
                   help="resume policy against --checkpoint-dir: 'auto' "
                        "(default) restores completed steps and resumes "
                        "in-flight fits mid-budget when the manifest's "
                        "data fingerprint matches; 'force' skips the "
                        "verification; 'off' starts fresh "
                        "(PertConfig.resume)")
    p.add_argument("--checkpoint-every", type=int, default=4,
                   help="periodic in-fit checkpoint cadence in "
                        "controller chunks (chunk = fit_diag_every "
                        "iterations); 0 keeps only step-boundary "
                        "checkpoints (PertConfig.checkpoint_every)")
    p.add_argument("--faults", default=None,
                   help="deterministic fault-injection spec for chaos "
                        "testing, e.g. 'preempt@step2/chunk#2' or the "
                        "process-scoped 'preempt@step2/chunk#2@proc1' "
                        "(PertConfig.faults; see utils/faults.py)")
    from argparse import BooleanOptionalAction
    p.add_argument("--elastic-mesh", action=BooleanOptionalAction,
                   default=True,
                   help="elastic mesh-shrink rung of the recovery "
                        "ladder: on a lost rank or a repeated OOM in a "
                        "sharded fit with --checkpoint-dir, the surviving "
                        "ranks re-form a group at half the cells extent "
                        "and continue from the last committed generation "
                        "instead of aborting (PertConfig.elastic_mesh; "
                        "each shrink is audited as a 'degrade "
                        "mesh_shrink' event)")
    p.add_argument("--pad-cells-to", type=int, default=None,
                   help="pad the cells axes (S and G1) up to at least "
                        "this many entries with masked pad cells — the "
                        "shape-bucket contract of the serving worker "
                        "(PertConfig.pad_cells_to)")
    p.add_argument("--pad-loci-to", type=int, default=None,
                   help="pad the loci axis up to at least this many "
                        "bins with masked pad loci (the other half of "
                        "the shape-bucket contract; "
                        "PertConfig.pad_loci_to)")
    p.add_argument("--request-id", default=None,
                   help="opaque per-request identity stamped into the "
                        "run log's run_start (serving traffic: "
                        "scdna_replication_tools_tpu_torch.tools."
                        "pert_fleet query/trend --request groups on "
                        "it); excluded from the config hash "
                        "(PertConfig.request_id)")
    p.add_argument("--trace-spans", action=BooleanOptionalAction,
                   default=False,
                   help="causal span tracing (default OFF): phases, fit "
                        "chunks and the run itself become schema-v8 "
                        "span_end events in the run log, exportable as "
                        "a Perfetto timeline with "
                        "scdna_replication_tools_tpu_torch.tools."
                        "pert_trace (PertConfig.trace_spans); "
                        "tracing-off logs "
                        "carry no span bytes")
    p.add_argument("--trace-parent", default=None,
                   help="cross-process trace handoff "
                        "'<trace_id>:<parent_span_id>' — this run's span "
                        "tree stitches under that parent (the serving "
                        "worker sets it per request; "
                        "PertConfig.trace_parent)")
    p.add_argument("--mirror-rescue", action=BooleanOptionalAction,
                   default=True,
                   help="post-step-2 mirror-basin rescue for boundary-tau "
                        "cells (beyond-reference; default ON — "
                        "--no-mirror-rescue restores the reference-faithful "
                        "no-rescue trajectory; PertConfig.mirror_rescue)")
    p.add_argument("--compile-cache", default="auto",
                   help="where the kernel libraries build: 'auto' (the "
                        "package's _build/), a path, or 'none' for a "
                        "directory of this process "
                        "(PertConfig.compile_cache_dir)")
    p.add_argument("--executable-cache", default=None,
                   help="the compiled-program store: each fit iteration "
                        "on the GPU replays a CUDA graph captured once "
                        "per program, and the kernel libraries persist "
                        "in this directory (PertConfig."
                        "executable_cache_dir; default: none)")
    p.add_argument("--profile-dir", default=None,
                   help="write a torch.profiler trace per step fit (and "
                        "one of the packaging) into this directory and "
                        "the pert_xla_scope_seconds gauges into the run's "
                        "metrics (PertConfig.profile_dir)")
    p.add_argument("--telemetry", default="auto",
                   help="structured JSONL run log: 'auto' (default, a "
                        "timestamped file under repo-local .pert_runs/), "
                        "a file/directory path, or 'none' to disable "
                        "(PertConfig.telemetry_path); render with "
                        "python -m scdna_replication_tools_tpu_torch."
                        "tools.pert_report")
    p.add_argument("--metrics-textfile", default=None,
                   help="Prometheus text-exposition export of the run's "
                        "typed metrics registry, rewritten atomically at "
                        "every phase boundary for scrape/node-exporter "
                        "setups (PertConfig.metrics_textfile); the "
                        "metrics_snapshot events in the run log and the "
                        "fleet index (python -m "
                        "scdna_replication_tools_tpu_torch.tools."
                        "pert_fleet) work without it")
    p.add_argument("--heartbeat-dir", default="auto",
                   help="live run-health heartbeats: every process "
                        "atomically writes health/host_<rank>.json for "
                        "scdna_replication_tools_tpu_torch.tools."
                        "pert_watch; 'auto' (default) uses "
                        "<checkpoint-dir>/health when checkpointing is "
                        "on, a path targets a directory, 'none' "
                        "disables (PertConfig.heartbeat_dir)")
    p.add_argument("--heartbeat-interval", type=float, default=15.0,
                   help="seconds between heartbeat writes "
                        "(PertConfig.heartbeat_interval_seconds); the "
                        "watcher derives its freshness ladder from "
                        "this declared cadence")
    p.add_argument("--qc", action=BooleanOptionalAction, default=True,
                   help="model-health QC: posterior-confidence maps, "
                        "convergence doctor, posterior-predictive checks "
                        "and the per-cell QC table/events (default ON; "
                        "--no-qc restores the bare pipeline; "
                        "PertConfig.qc)")
    p.add_argument("--qc-entropy-thresh", type=float, default=0.5,
                   help="normalized CN-posterior entropy above which a "
                        "bin counts as low-confidence "
                        "(PertConfig.qc_entropy_thresh)")
    p.add_argument("--qc-ppc-z", type=float, default=5.0,
                   help="posterior-predictive z-score above which a cell "
                        "is flagged ppc_outlier (PertConfig.qc_ppc_z)")
    p.add_argument("--qc-output", default=None,
                   help="also write the per-cell QC table (scRT.cell_qc()) "
                        "to this tsv")
    p.add_argument("--controller", action=BooleanOptionalAction,
                   default=True,
                   help="adaptive fit controller (default ON): fits run "
                        "as compiled chunks and may early-stop when the "
                        "convergence doctor reads the tail as converged, "
                        "extend plateaued fits, re-seed oscillating ones "
                        "and escalate NaN aborts — every decision is a "
                        "control_decision event in the run log; "
                        "--no-controller restores the fixed-budget "
                        "single-program fits bit-exactly "
                        "(PertConfig.controller)")
    p.add_argument("--controller-max-extra-iters", type=int, default=None,
                   help="cap on the total extra iterations the controller "
                        "may grant one fit beyond its budget (default: "
                        "half the fit's max_iter; "
                        "PertConfig.controller_max_extra_iters)")
    p.add_argument("--device", default=None,
                   help="where the run goes: the GPU by default (raising "
                        "when there is none), or 'cpu'")
    args = p.parse_args(argv)

    from scdna_replication_tools_tpu_torch.api import scRT

    cn_s = pd.read_csv(args.s_phase_cells, sep="\t", dtype={"chr": str})
    cn_g1 = pd.read_csv(args.g1_phase_cells, sep="\t", dtype={"chr": str})

    scrt = scRT(cn_s, cn_g1, clone_col=_parse_clone_col(args.clone_col),
                cn_prior_method=args.cn_prior_method,
                max_iter=args.max_iter, num_shards=args.num_shards,
                enum_impl=args.enum_impl, fused_adam=args.fused_adam,
                optimizer_state_dtype=args.optimizer_state_dtype,
                clustering_method=args.clustering_method,
                checkpoint_dir=args.checkpoint_dir, resume=args.resume,
                checkpoint_every=args.checkpoint_every,
                faults=args.faults,
                elastic_mesh=args.elastic_mesh,
                pad_cells_to=args.pad_cells_to,
                pad_loci_to=args.pad_loci_to,
                request_id=args.request_id,
                trace_spans=args.trace_spans,
                trace_parent=args.trace_parent,
                mirror_rescue=args.mirror_rescue,
                compile_cache_dir=(None if str(args.compile_cache).lower()
                                   == "none" else args.compile_cache),
                executable_cache_dir=args.executable_cache,
                profile_dir=args.profile_dir,
                telemetry_path=args.telemetry,
                metrics_textfile=args.metrics_textfile,
                heartbeat_dir=args.heartbeat_dir,
                heartbeat_interval_seconds=args.heartbeat_interval,
                qc=args.qc, qc_entropy_thresh=args.qc_entropy_thresh,
                qc_ppc_z=args.qc_ppc_z,
                controller=args.controller,
                controller_max_extra_iters=args.controller_max_extra_iters,
                device=args.device)
    out_df, supp_df, _, _ = scrt.infer(level=args.level)

    out_df.to_csv(args.output, sep="\t", index=False)
    supp_df.to_csv(args.supp_output, sep="\t", index=False)
    from scdna_replication_tools_tpu_torch.utils.profiling import logger

    if args.qc_output:
        if scrt._cell_qc_df is not None:
            scrt.cell_qc().to_csv(args.qc_output, sep="\t", index=False)
            logger.info("per-cell QC table written to %s", args.qc_output)
        else:
            logger.warning(
                "--qc-output %s requested but no QC table was produced "
                "(QC runs only with --qc on the pert level); nothing "
                "written", args.qc_output)
    if scrt.run_log_path:
        logger.info("run telemetry written to %s (render with python "
                    "-m scdna_replication_tools_tpu_torch.tools."
                    "pert_report)", scrt.run_log_path)


def infer_spf_main(argv=None):
    p = ArgumentParser(description="Per-clone S-phase fraction")
    p.add_argument("s_phase_cells")
    p.add_argument("g1_phase_cells")
    p.add_argument("output_s", help="S cells with clone assignments")
    p.add_argument("output_spf", help="per-clone SPF table")
    p.add_argument("--input-col", default="reads")
    p.add_argument("--clone-col", default="clone_id",
                   help=_CLONE_COL_HELP)
    p.add_argument("--device", default=None,
                   help="where the run goes: the GPU by default (raising "
                        "when there is none), or 'cpu'")
    args = p.parse_args(argv)

    from scdna_replication_tools_tpu_torch.api import SPF

    cn_s = pd.read_csv(args.s_phase_cells, sep="\t", dtype={"chr": str})
    cn_g1 = pd.read_csv(args.g1_phase_cells, sep="\t", dtype={"chr": str})

    spf = SPF(cn_s, cn_g1, input_col=args.input_col,
              clone_col=_parse_clone_col(args.clone_col),
              device=args.device)
    cn_s, out_df = spf.infer()
    cn_s.to_csv(args.output_s, sep="\t", index=False)
    out_df.to_csv(args.output_spf, sep="\t", index=False)


def simulator_main(argv=None):
    p = ArgumentParser(description="Simulate PERT read-count data")
    p.add_argument("-si", "--df_s", required=True)
    p.add_argument("-gi", "--df_g", required=True)
    p.add_argument("-n", "--num_reads", type=int, required=True)
    p.add_argument("-l", "--lamb", type=float, required=True)
    p.add_argument("-a", "--a", type=float, required=True)
    p.add_argument("-b", "--betas", type=float, nargs="+", required=True)
    p.add_argument("-rt", "--rt_cols", type=str, nargs="+", required=True)
    p.add_argument("-gc", "--gc_col", type=str, default="gc")
    p.add_argument("-c", "--clones", type=str, nargs="+", required=True)
    p.add_argument("-so", "--s_out", required=True)
    p.add_argument("-go", "--g_out", required=True)
    p.add_argument("--device", default=None,
                   help="where the run goes: the GPU by default (raising "
                        "when there is none), or 'cpu'")
    args = p.parse_args(argv)

    from scdna_replication_tools_tpu_torch.models.simulator import (
        pert_simulator,
    )

    df_s = pd.read_csv(args.df_s, sep="\t", dtype={"chr": str})
    df_g = pd.read_csv(args.df_g, sep="\t", dtype={"chr": str})
    df_s["library_id"] = df_s.get("library_id", "SIM")
    df_g["library_id"] = df_g.get("library_id", "SIM")

    df_s, df_g = pert_simulator(
        df_s, df_g, args.num_reads, args.rt_cols, args.clones, args.lamb,
        args.betas, args.a, gc_col=args.gc_col, device=args.device)
    df_s.to_csv(args.s_out, sep="\t", index=False)
    df_g.to_csv(args.g_out, sep="\t", index=False)
