"""Merge run-log span streams into one Chrome/Perfetto timeline (port of
``tools/pert_trace.py``, reading with the port's ``obs/summary`` and
``utils/trace_summary``).

The span layer (``obs/spans.py``, schema v8) records causality (request,
admission, fit chunks, stream-back; phases as spans; per-process
timelines), but each run log is one file.  This tool stitches and
exports them:

    # one timeline from any mix of run logs (a serve spool ingests the
    # worker log and every per-request run log under results/)
    python -m scdna_replication_tools_tpu_torch.tools.pert_trace \\
        export --perfetto --out trace.json --spool /data/pert_spool
    python -m scdna_replication_tools_tpu_torch.tools.pert_trace \\
        export --perfetto --out trace.json \\
        .pert_runs/run_p0.jsonl .pert_runs/run_p1.jsonl

    # trace-event format check
    python -m scdna_replication_tools_tpu_torch.tools.pert_trace \\
        validate trace.json

    # per-request latency decomposition of a serve spool
    python -m scdna_replication_tools_tpu_torch.tools.pert_trace \\
        waterfall --spool /data/pert_spool

Stitching rules:

* spans stamped with the same ``trace_id`` land on the same thread
  lane whichever log they came from: a serve request's worker-side
  spans (queue_wait, admission, stream_back) nest with the request
  run's own span tree, because the ticket carried the trace id across
  the spool, and a sharded run's per-rank logs merge into
  per-``process_index`` rows of one timeline;
* logs without spans (tracing off) still render: their ``phase``
  events become slices anchored at ``run_start.started_unix + t``
  (phase events are emitted at phase exit);
* ``--profile-dir`` reads the ``torch.profiler`` traces that
  ``PertConfig.profile_dir`` writes, through the port's
  ``utils/trace_summary.scope_totals`` (seconds per ``pert/*`` range
  path), as one counter track, ``pert_xla_scope_seconds``: the name of
  the gauge the port's registry publishes from the same totals.

Output is Chrome trace-event JSON (the ``traceEvents`` array format),
loadable by Perfetto (ui.perfetto.dev) and chrome://tracing.  Host code:
it needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional

from scdna_replication_tools_tpu_torch.obs.summary import read_events

# the serve A/B's latency components, in causal order; ``classify``
# maps every span onto one of them
WATERFALL_COMPONENTS = ("queue_wait", "admission", "pad", "compile",
                        "fit", "decode", "stream_back", "other")

# container spans: the envelope of a timeline row, not a leaf cost —
# excluded from waterfall totals (their children ARE the breakdown)
_CONTAINER_SPANS = frozenset({"run", "request"})


def _warn(msg: str) -> None:
    print(f"pert_trace: warning: {msg}", file=sys.stderr)


def classify_span(name: str, attrs: Optional[dict] = None
                  ) -> Optional[str]:
    """Waterfall component of one span; None for spans that must not
    be summed (containers, and ``fit/chunk`` — the chunks decompose the
    fit phase they ride inside, double-counting it).

    Phase-derived spans map by the phase vocabulary: trace/compile →
    ``compile``; the fit (+ rescue sub-fits) → ``fit``; decode, QC and
    packaging → ``decode``; input staging — load, build, init, padding
    and the host→device transfer — → ``pad``; everything else
    (telemetry, checkpoints, metrics export) → ``other``.
    """
    if name in _CONTAINER_SPANS or name == "fit/chunk":
        return None
    if name in ("queue_wait", "admission", "stream_back"):
        return name
    if name.endswith("/trace") or name.endswith("/compile"):
        return "compile"
    if name.endswith("/fit") or "/rescue" in name:
        return "fit"
    if name.endswith("/decode") or name.endswith("/fetch") \
            or name.endswith("/package") or name.startswith("qc/") \
            or name.endswith("/qc_aggregate") \
            or name.startswith("package_"):
        return "decode"
    if name in ("load", "clone_prep", "finalize") \
            or name.endswith("/build") or name.endswith("/init") \
            or name.endswith("/h2d"):
        return "pad"
    return "other"


# ---------------------------------------------------------------------------
# log ingestion
# ---------------------------------------------------------------------------


def discover_logs(paths, spool=None) -> List[pathlib.Path]:
    """Run logs from explicit paths/directories plus a serve spool
    (worker_*.jsonl in the root + every results/*/run.jsonl)."""
    found: List[pathlib.Path] = []
    for p in paths or []:
        p = pathlib.Path(p)
        if p.is_dir():
            found.extend(sorted(p.rglob("*.jsonl")))
        elif p.exists():
            found.append(p)
        else:
            _warn(f"{p}: no such log — skipped")
    if spool:
        spool = pathlib.Path(spool)
        found.extend(sorted(spool.glob("*.jsonl")))
        found.extend(sorted(spool.glob("results/*/run.jsonl")))
    seen, out = set(), []
    for p in found:
        key = str(p.resolve())
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def log_spans(path) -> dict:
    """One log's timeline material: its span_end payloads, the
    synthesized phase slices when it has none, and the run identity
    (trace id, process index, absolute time base)."""
    try:
        events = read_events(path)
    except OSError:
        return {"path": str(path), "spans": [], "phases": [],
                "trace_id": None, "process_index": 0}
    start = next((ev for ev in events
                  if ev.get("event") == "run_start"), {})
    spans = [ev for ev in events if ev.get("event") == "span_end"]
    phases = []
    if not spans:
        # pre-v8 / tracing-off fallback: phase events anchor at
        # started_unix + t (emitted at phase EXIT), so the slice is
        # [end - seconds, end]
        base = start.get("started_unix")
        if isinstance(base, (int, float)):
            for ev in events:
                if ev.get("event") != "phase":
                    continue
                secs = float(ev.get("seconds") or 0.0)
                end = float(base) + float(ev.get("t") or 0.0)
                phases.append({"name": str(ev.get("name")),
                               "start_unix": end - secs,
                               "duration_seconds": secs})
    return {
        "path": str(path),
        "run_name": start.get("run_name"),
        "request_id": start.get("request_id"),
        "trace_id": start.get("trace_id"),
        "process_index": int(start.get("process_index") or 0),
        "spans": spans,
        "phases": phases,
    }


# ---------------------------------------------------------------------------
# Perfetto (Chrome trace-event) export
# ---------------------------------------------------------------------------


def build_trace(logs: List[dict], scope_seconds: Optional[dict] = None
                ) -> dict:
    """Merge ingested logs into one trace-event document.

    pid = process_index (multi-host rows), tid = one lane per trace id
    (span-less logs get a lane of their own), ts normalized to the
    earliest instant across every participant so the stitched timeline
    starts at 0.
    """
    slices = []   # (start_unix, dur_s, name, pid, lane_key, args)
    lanes: dict = {}

    def _lane(key: str) -> int:
        return lanes.setdefault(key, len(lanes) + 1)

    lane_names: dict = {}
    for log in logs:
        default_lane = log.get("trace_id") \
            or f"log:{pathlib.Path(log['path']).name}"
        for ev in log["spans"]:
            lane_key = ev.get("trace_id") or default_lane
            lane = _lane(lane_key)
            lane_names.setdefault(
                lane, log.get("request_id") or lane_key)
            args = {"trace_id": ev.get("trace_id"),
                    "span_id": ev.get("span_id"),
                    "parent_id": ev.get("parent_id"),
                    "log": pathlib.Path(log["path"]).name}
            args.update(ev.get("attrs") or {})
            slices.append((float(ev.get("start_unix") or 0.0),
                           float(ev.get("duration_seconds") or 0.0),
                           str(ev.get("name")),
                           int(ev.get("process_index") or 0),
                           lane, args))
        for ph in log["phases"]:
            lane = _lane(default_lane)
            lane_names.setdefault(
                lane, log.get("request_id") or default_lane)
            slices.append((ph["start_unix"], ph["duration_seconds"],
                           ph["name"], log["process_index"], lane,
                           {"kind": "phase",
                            "log": pathlib.Path(log["path"]).name}))
    if not slices:
        return {"traceEvents": [], "displayTimeUnit": "ms"}

    t0 = min(s[0] for s in slices)
    events = []
    pids = sorted({s[3] for s in slices})
    for pid in pids:
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0,
                       "args": {"name": f"pert process {pid}"}})
    for lane, label in sorted(lane_names.items()):
        for pid in pids:
            events.append({"ph": "M", "name": "thread_name",
                           "pid": pid, "tid": lane,
                           "args": {"name": str(label)}})
    # key on the scalar prefix only: the args dicts are not orderable,
    # and two same-instant same-name spans would otherwise TypeError
    # the whole export
    for start, dur, name, pid, lane, args in sorted(
            slices, key=lambda s: s[:5]):
        events.append({
            "ph": "X", "cat": "pert", "name": name,
            "pid": pid, "tid": lane,
            "ts": round((start - t0) * 1e6, 3),
            "dur": round(max(dur, 0.0) * 1e6, 3),
            "args": args,
        })
    if scope_seconds:
        # the named ranges' device time as ONE counter track: each
        # range is a series of the counter, so device totals render
        # alongside the host spans in the same UI
        events.append({
            "ph": "C", "name": "pert_xla_scope_seconds", "pid": pids[0],
            "ts": 0.0,
            "args": {scope: round(float(secs), 6)
                     for scope, secs in sorted(scope_seconds.items())},
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "metadata": {"kind": "pert_trace",
                     "base_unix": round(t0, 6),
                     "logs": [log["path"] for log in logs]},
    }


def validate_trace(doc) -> List[str]:
    """Trace-event format errors ([] = valid): the shape Perfetto and
    chrome://tracing ingest — a dict with a ``traceEvents`` list (or a
    bare list), every event an object with a ``ph``, complete ``X``
    duration events, well-formed counters and metadata."""
    errors: List[str] = []
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
        if not isinstance(events, list):
            return ["top-level object lacks a traceEvents array"]
    elif isinstance(doc, list):
        events = doc
    else:
        return [f"not a trace-event document: {type(doc).__name__}"]
    for i, ev in enumerate(events):
        where = f"traceEvents[{i}]"
        if not isinstance(ev, dict):
            errors.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if not isinstance(ph, str) or not ph:
            errors.append(f"{where}: missing ph")
            continue
        if ph in ("X", "B", "E", "C", "M") and not isinstance(
                ev.get("name"), str):
            errors.append(f"{where}: {ph!r} event lacks a name")
        if ph == "X":
            for field in ("ts", "dur"):
                if not isinstance(ev.get(field), (int, float)):
                    errors.append(f"{where}: X event lacks numeric "
                                  f"{field}")
            dur = ev.get("dur")
            # guard the comparison on the type: a non-numeric dur was
            # already reported above, and `"abc" < 0` would crash the
            # validator on exactly the malformed input it diagnoses
            if isinstance(dur, (int, float)) and dur < 0:
                errors.append(f"{where}: negative dur")
            for field in ("pid", "tid"):
                if not isinstance(ev.get(field), int):
                    errors.append(f"{where}: X event lacks integer "
                                  f"{field}")
        if ph == "C":
            if not isinstance(ev.get("ts"), (int, float)):
                errors.append(f"{where}: counter lacks numeric ts")
            if not isinstance(ev.get("args"), dict):
                errors.append(f"{where}: counter lacks args")
        if ph == "M" and not isinstance(ev.get("args"), dict):
            errors.append(f"{where}: metadata event lacks args")
    return errors


# ---------------------------------------------------------------------------
# per-request waterfall (the serve A/B's latency decomposition)
# ---------------------------------------------------------------------------


def request_waterfall(worker_log, request_log=None,
                      request_id: Optional[str] = None,
                      worker_spans: Optional[list] = None) -> dict:
    """Where one request's latency went: seconds per
    :data:`WATERFALL_COMPONENTS` bucket, from the worker log's
    request-scoped spans (queue_wait / admission / stream_back) plus
    the request run log's phase spans (pad / compile / fit / decode).
    ``total_seconds`` is the request span's own duration when present.
    Missing material contributes zeros — a waterfall over an untraced
    run is honest about knowing nothing, not an error.

    ``worker_spans`` (pre-parsed ``span_end`` payloads, e.g. pooled
    from EVERY worker log of a multi-worker spool) substitutes for
    re-reading ``worker_log`` — callers decomposing N requests parse
    the worker side once instead of N times."""
    out = {c: 0.0 for c in WATERFALL_COMPONENTS}
    total = None
    slab_occupancy = None
    retired_early = None

    def _consume(spans, only_request: Optional[str]):
        nonlocal total, slab_occupancy, retired_early
        for ev in spans:
            attrs = ev.get("attrs") or {}
            if only_request and attrs.get("request_id") \
                    not in (None, only_request):
                continue
            name = str(ev.get("name"))
            if name == "request" and (not only_request or attrs.get(
                    "request_id") == only_request):
                total = float(ev.get("duration_seconds") or 0.0)
                # batched-serving attribution inputs (the worker's
                # request-span close stamps them when max_batch > 1)
                if attrs.get("slab_avg_occupancy") is not None:
                    slab_occupancy = float(attrs["slab_avg_occupancy"])
                if attrs.get("retired_early") is not None:
                    retired_early = bool(attrs["retired_early"])
                continue
            comp = classify_span(name, attrs)
            if comp is not None:
                out[comp] += float(ev.get("duration_seconds") or 0.0)

    if worker_spans is not None:
        _consume(worker_spans, request_id)
    elif worker_log:
        _consume(log_spans(worker_log)["spans"], request_id)
    if request_log:
        _consume(log_spans(request_log)["spans"], None)
    waterfall = {c: round(v, 4) for c, v in out.items()}
    waterfall["total_seconds"] = round(total, 4) \
        if total is not None else None
    if slab_occupancy is not None:
        # continuous batching: K blocks' fit spans cover the SAME
        # device seconds, so summing raw fit time across a slab
        # double-counts.  fit_attributed divides each request's fit
        # wall by its time-weighted slab occupancy — the per-request
        # share of the shared fit time; summing IT across the slab
        # recovers the device wall once.  Raw ``fit`` stays as-is
        # (it is the request's own latency experience).
        waterfall["slab_avg_occupancy"] = round(slab_occupancy, 4)
        waterfall["fit_attributed"] = round(
            waterfall["fit"] / max(slab_occupancy, 1.0), 4)
        if retired_early is not None:
            waterfall["retired_early"] = retired_early
    return waterfall


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pert_trace",
        description="Stitch RunLog span streams into one Perfetto "
                    "timeline; validate trace-event documents; "
                    "decompose serve-request latency")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_exp = sub.add_parser("export", help="merge run logs into one "
                                          "Chrome/Perfetto trace JSON")
    p_exp.add_argument("logs", nargs="*",
                       help="run-log files or directories to ingest")
    p_exp.add_argument("--spool", default=None,
                       help="pert-serve spool: ingests the worker "
                            "log(s) + every results/*/run.jsonl")
    p_exp.add_argument("--perfetto", action="store_true",
                       help="Chrome trace-event JSON (the only format; "
                            "the flag documents intent)")
    p_exp.add_argument("--profile-dir", default=None,
                       help="torch.profiler trace directory "
                            "(PertConfig.profile_dir): ingests "
                            "utils/trace_summary.scope_totals() "
                            "device seconds per pert/* range as a "
                            "counter track")
    p_exp.add_argument("--out", required=True)

    p_val = sub.add_parser("validate", help="check a trace-event "
                                            "document (nonzero exit "
                                            "on format errors)")
    p_val.add_argument("trace")

    p_wat = sub.add_parser("waterfall",
                           help="per-request latency decomposition "
                                "from a serve spool's logs")
    p_wat.add_argument("--spool", required=True)
    p_wat.add_argument("--request", default=None,
                       help="one request id (default: every request "
                            "with a results/<id>/run.jsonl)")

    args = ap.parse_args(argv)

    if args.cmd == "export":
        paths = discover_logs(args.logs, spool=args.spool)
        if not paths:
            raise SystemExit("pert_trace: no run logs found — pass log "
                             "files/directories or --spool")
        logs = [log_spans(p) for p in paths]
        if not any(log["spans"] or log["phases"] for log in logs):
            _warn("none of the ingested logs carry spans or phases — "
                  "the timeline will be empty (run with tracing on: "
                  "--trace-spans / the serve worker's default)")
        scope_seconds = None
        if args.profile_dir:
            try:
                from scdna_replication_tools_tpu_torch.utils.trace_summary \
                    import scope_totals

                scope_seconds = scope_totals(args.profile_dir) or None
            except Exception as exc:  # noqa: BLE001 — the counter
                # track is an enrichment; a missing/unreadable profile
                # dir must not block the span export
                _warn(f"--profile-dir unreadable ({exc}); exporting "
                      f"without the XLA counter track")
        doc = build_trace(logs, scope_seconds=scope_seconds)
        errors = validate_trace(doc)
        if errors:
            raise SystemExit("pert_trace: internal error — the built "
                             "trace fails its own validation: "
                             + "; ".join(errors[:5]))
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(doc, indent=1) + "\n")
        n = sum(1 for ev in doc["traceEvents"] if ev.get("ph") == "X")
        print(f"pert_trace: {n} span slice(s) from {len(paths)} "
              f"log(s) -> {out} (open in ui.perfetto.dev)")
        return 0

    if args.cmd == "validate":
        try:
            doc = json.loads(pathlib.Path(args.trace).read_text())
        except (OSError, ValueError) as exc:
            raise SystemExit(f"pert_trace: unreadable trace "
                             f"{args.trace} ({exc})")
        errors = validate_trace(doc)
        if errors:
            for err in errors[:20]:
                print(f"pert_trace: {args.trace}: {err}",
                      file=sys.stderr)
            return 1
        events = doc.get("traceEvents", doc)
        n = sum(1 for ev in events
                if isinstance(ev, dict) and ev.get("ph") == "X")
        print(f"pert_trace: {args.trace} is a valid trace-event "
              f"document ({n} duration slices)")
        return 0

    # waterfall
    spool = pathlib.Path(args.spool)
    worker_logs = sorted(spool.glob("*.jsonl"))
    if not worker_logs:
        raise SystemExit(f"pert_trace: no worker log under {spool}")
    request_dirs = sorted(d for d in (spool / "results").glob("*")
                          if (d / "run.jsonl").exists()) \
        if (spool / "results").is_dir() else []
    if args.request:
        request_dirs = [d for d in request_dirs
                        if d.name == args.request]
    # pool the spool-side spans from EVERY worker log, once: multiple
    # workers (or a restarted one) share a spool, and a request's
    # queue_wait/admission spans live in whichever worker served it —
    # reading only the newest log would silently zero the others'
    # components.  The per-request_id filter keeps requests disjoint.
    worker_spans = [span for wl in worker_logs
                    for span in log_spans(wl)["spans"]]
    rows = {}
    for d in request_dirs:
        rows[d.name] = request_waterfall(
            None, d / "run.jsonl", request_id=d.name,
            worker_spans=worker_spans)
    print(json.dumps({"spool": str(spool), "requests": rows},
                     indent=1))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:
        sys.exit(0)
