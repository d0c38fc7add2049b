"""pert-serve on PyTorch and CUDA: the CLI of the port's serving worker
(port of ``serve/cli.py``; the worker also takes ``--device``, see
``serve/worker.py``).

    # a worker on a spool directory (drains gracefully on SIGTERM or
    # SIGINT); --max-batch K > 1 turns on continuous batching: up to K
    # same-bucket requests run as concurrent lanes of one slab
    python -m scdna_replication_tools_tpu_torch.serve.cli worker \
        --spool /data/pert_spool --max-batch 4

    # submit a request (prints its id; the worker fits it later)
    python -m scdna_replication_tools_tpu_torch.serve.cli submit \
        --spool /data/pert_spool cn_s.tsv cn_g1.tsv --option max_iter=800

    # one request's state, its result files, or (no id) the live worker
    # surface (status.json) and the queue
    python -m scdna_replication_tools_tpu_torch.serve.cli status \
        --spool /data/pert_spool <request_id>
    python -m scdna_replication_tools_tpu_torch.serve.cli collect \
        --spool /data/pert_spool <request_id>
"""

from __future__ import annotations

import argparse
import json
import sys


def _emit(text, err: bool = False) -> None:
    # CLI entry point: stdout IS the interface (one JSON document / id
    # per command, exactly like bench.py's one-JSON-line contract);
    # routing through the package logger would interleave log
    # formatting into machine-read output
    print(text, file=sys.stderr if err else sys.stdout)


def _parse_option(tokens) -> dict:
    """``KEY=VALUE`` pairs -> options dict; values parse as JSON when
    they can (so ``max_iter=800`` is an int and ``qc=false`` a bool)
    and stay strings otherwise (``clone_col=clone_id``)."""
    options = {}
    for tok in tokens or []:
        if "=" not in tok:
            raise SystemExit(f"pert-serve: --option {tok!r} is not "
                             f"KEY=VALUE")
        key, value = tok.split("=", 1)
        try:
            options[key] = json.loads(value)
        except ValueError:
            options[key] = value
    return options


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m scdna_replication_tools_tpu_torch.serve.cli",
        description="Persistent shape-bucketed PERT inference service "
                    "over a file-queue spool directory")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_worker = sub.add_parser(
        "worker", help="run the worker daemon (resident program cache; "
                       "drains gracefully on SIGTERM/SIGINT)")
    p_worker.add_argument("--spool", required=True,
                          help="spool directory (created if missing)")
    p_worker.add_argument("--cells-buckets", default=None,
                          help="comma-separated ascending cells bucket "
                               "ladder (default: powers of two 8..4096)")
    p_worker.add_argument("--loci-buckets", default=None,
                          help="comma-separated ascending loci bucket "
                               "ladder (default: powers of two "
                               "64..262144)")
    p_worker.add_argument("--poll-interval", type=float, default=0.5)
    p_worker.add_argument("--max-requests", type=int, default=None,
                          help="exit after this many requests "
                               "(CI/bench harnesses)")
    p_worker.add_argument("--exit-when-idle", action="store_true",
                          help="exit when the queue is empty instead "
                               "of polling (CI/bench harnesses)")
    p_worker.add_argument("--telemetry", default=None,
                          help="worker-level RunLog path (default: a "
                               "timestamped worker_*.jsonl in the "
                               "spool root); request_start/request_end "
                               "events land here")
    p_worker.add_argument("--metrics-textfile", default=None,
                          help="atomic Prometheus textfile of the "
                               "worker registry — the resident scrape "
                               "surface (pert_serve_queue_depth, "
                               "pert_serve_requests_total, "
                               "pert_serve_bucket_pad_frac, ...)")
    p_worker.add_argument("--option", action="append", default=[],
                          metavar="KEY=VALUE",
                          help="default scRT option applied to every "
                               "request (tickets override per "
                               "request); repeatable")
    p_worker.add_argument("--max-batch", type=int, default=1,
                          help="continuous-batching width K (default "
                               "1 = strictly serial): run up to K "
                               "same-bucket-rung requests as "
                               "concurrent blocks of one slab sharing "
                               "the resident compiled programs; "
                               "converged blocks retire and refill "
                               "from the spool at once")
    p_worker.add_argument("--executable-cache", default="auto",
                          help="the compiled-program store: 'auto' "
                               "(default) is <spool>/exec_cache, a path "
                               "pins it, 'none' runs without one")
    p_worker.add_argument("--device", default=None,
                          help="where the fits run: the GPU by default "
                               "(raising when there is none), or 'cpu'")
    p_worker.add_argument("--trace-spans", default=True,
                          action=argparse.BooleanOptionalAction,
                          help="causal span tracing per request "
                               "(default ON): queue-wait/admission/"
                               "fit/stream-back spans in the worker "
                               "log + the request log, stitched by the "
                               "ticket's trace id — export a Perfetto "
                               "timeline with "
                               "scdna_replication_tools_tpu_torch."
                               "tools.pert_trace; "
                               "--no-trace-spans mutes it")

    p_submit = sub.add_parser(
        "submit", help="queue one request (returns the request id; "
                       "the fit runs asynchronously in the worker)")
    p_submit.add_argument("--spool", required=True)
    p_submit.add_argument("s_phase_cells",
                          help="long-form tsv for S-phase cells")
    p_submit.add_argument("g1_phase_cells",
                          help="long-form tsv for G1-phase cells")
    p_submit.add_argument("--request-id", default=None)
    p_submit.add_argument("--priority", default="normal",
                          help="SLO priority class (high|normal|low, "
                               "default normal): workers claim by "
                               "class, then oldest deadline, then "
                               "submission order")
    p_submit.add_argument("--deadline-seconds", type=float,
                          default=None,
                          help="soft SLO deadline this many seconds "
                               "from submission; within a priority "
                               "class, oldest deadline is claimed "
                               "first")
    p_submit.add_argument("--option", action="append", default=[],
                          metavar="KEY=VALUE",
                          help="per-request scRT option (whitelist: "
                               "serve/worker.py REQUEST_OPTION_KEYS); "
                               "repeatable")
    p_submit.add_argument("--tenant", default=None,
                          help="advisory tenant/cost-center label for "
                               "the request: device-time attribution in "
                               "the worker's status.json "
                               "(processed.by_tenant) and the "
                               "pert_meter attribution rollup "
                               "(scdna_replication_tools_tpu_torch."
                               "tools.pert_meter).  The "
                               "worker sanitizes it ([A-Za-z0-9._-], "
                               "max 64 chars) before trusting it")

    p_status = sub.add_parser(
        "status", help="show one request's state (or the whole queue)")
    p_status.add_argument("--spool", required=True)
    p_status.add_argument("request_id", nargs="?", default=None)

    p_collect = sub.add_parser(
        "collect", help="print a finished request's result paths")
    p_collect.add_argument("--spool", required=True)
    p_collect.add_argument("request_id")

    args = ap.parse_args(argv)

    from scdna_replication_tools_tpu_torch.serve import (
        BucketSet,
        ServeWorker,
        SpoolQueue,
    )

    queue = SpoolQueue(args.spool)

    if args.cmd == "worker":
        worker = ServeWorker(
            queue,
            buckets=BucketSet.from_specs(args.cells_buckets,
                                         args.loci_buckets),
            telemetry_path=args.telemetry,
            metrics_textfile=args.metrics_textfile,
            poll_interval=args.poll_interval,
            max_requests=args.max_requests,
            exit_when_idle=args.exit_when_idle,
            default_options=_parse_option(args.option),
            trace_spans=args.trace_spans,
            max_batch=args.max_batch,
            executable_cache_dir=args.executable_cache,
            device=args.device)
        stats = worker.run()
        _emit(json.dumps(stats, indent=1))
        return 0

    if args.cmd == "submit":
        deadline = None
        if args.deadline_seconds is not None:
            import time as _time

            deadline = _time.time() + float(args.deadline_seconds)
        rid = queue.submit(args.s_phase_cells, args.g1_phase_cells,
                           options=_parse_option(args.option),
                           request_id=args.request_id,
                           priority=args.priority,
                           deadline_unix=deadline,
                           tenant=args.tenant)
        _emit(rid)
        return 0

    if args.cmd == "status":
        if args.request_id:
            doc = queue.status(args.request_id)
            if doc is None:
                _emit(f"pert-serve: unknown request "
                  f"{args.request_id!r} in {args.spool}", err=True)
                return 1
            _emit(json.dumps(doc, indent=1))
        else:
            # the live worker surface: status.json (atomic heartbeat —
            # in-flight request + its open span stack, queue depth,
            # bucket-residency ledger, recent outcomes) plus the queue
            # listing.  "what is the worker doing right now, and how
            # long has it been stuck there" — worker.age_seconds and
            # the per-span ages answer the second half
            worker_doc = None
            try:
                worker_doc = json.loads(queue.status_path.read_text())
                updated = worker_doc.get("updated_unix")
                if isinstance(updated, (int, float)):
                    import time as _time

                    worker_doc["age_seconds"] = round(
                        max(_time.time() - updated, 0.0), 3)
            except (OSError, ValueError):
                pass  # no worker has ever run on this spool (or the
                # status surface is unreadable): worker=null says so
            _emit(json.dumps({
                "worker": worker_doc,
                "requests": queue.list_requests(),
            }, indent=1))
        return 0

    # collect
    doc = queue.status(args.request_id)
    if doc is None or doc.get("state") not in ("done", "failed"):
        state = doc.get("state") if doc else "unknown"
        _emit(f"pert-serve: request {args.request_id} is {state}, "
              f"not collectable yet", err=True)
        return 1
    results = queue.results_dir(args.request_id)
    _emit(json.dumps({
        "request_id": args.request_id,
        "state": doc.get("state"),
        "status": doc.get("status"),
        "error": doc.get("error"),
        "results_dir": str(results),
        "files": sorted(str(p) for p in results.glob("*")
                        if p.is_file()),
    }, indent=1))
    return 0


def console_main() -> int:
    """The ``pert-serve`` console entry: `status | head`-style piping
    is normal usage, not an error."""
    try:
        return main()
    except BrokenPipeError:
        return 0


if __name__ == "__main__":
    sys.exit(console_main())
