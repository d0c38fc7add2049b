"""Cross-run fleet index over run logs: trends and regression gates (port
of ``tools/pert_fleet.py``, reading with the port's ``obs/summary`` and
``obs/metrics``).

    M=scdna_replication_tools_tpu_torch.tools.pert_fleet
    python -m $M index   [--roots DIR ...] [--out FILE]
    python -m $M query   [--config-hash H] [--run-name N] [--status S]
                         [--request ID|*] [--since D] [--until D]
                         [--format markdown|json]
    python -m $M trend   [--metric M ...] [--request ID|*] [--out FILE]
                         [--format markdown|json]
    python -m $M regress --baseline FILE [--run LOG]
                         [--tolerance-scale S] [--write-baseline FILE]

Serve traffic rides the same machinery: ``index --roots`` on a serve
spool ingests the worker log and every per-request run log under its
``results/`` tree (ordinary ``*.jsonl`` run logs stamped with a
``request_id``), and ``query`` / ``trend --request`` group on that id
(``--request '*'`` keeps every request-stamped run, a literal id one
request's runs).

* ``index`` ingests every run log under the roots (default: the
  repo-local ``.pert_runs/`` plus ``artifacts/``) into one JSON index:
  per run its identity (config hash, platform, workload shape), status,
  and the flat metric vector of ``obs.summary.flat_metrics``;
* ``query`` filters the index (config hash, date window, run name,
  status) and prints a markdown table;
* ``trend`` renders, per metric, a markdown table and a sparkline
  across runs in time order;
* ``regress`` compares one run (``--run``, or the newest indexed run)
  with a baseline file, applying each metric's relative threshold from
  ``obs/metrics_manifest.json`` through ``obs.metrics.regress_verdict``
  (only movement in the bad direction fails), and exits 1 on any gated
  regression.  ``--tolerance-scale`` widens every threshold;
  ``--write-baseline`` records the run as the new baseline instead.
  Baseline metrics the catalogue does not know are warned about and
  skipped.

JAX and port logs index alike, and a baseline one package wrote judges
the other's runs.  Host code: it needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time
from typing import List, Optional

from scdna_replication_tools_tpu_torch.obs.metrics import (
    manifest_metrics,
    metric_base_name,
    regress_verdict,
)
from scdna_replication_tools_tpu_torch.obs.summary import (
    flat_metrics,
    summarize_run,
)

DEFAULT_ROOTS = (".pert_runs", "artifacts")
DEFAULT_INDEX = ".pert_runs/fleet_index.json"

_SPARK_BARS = "▁▂▃▄▅▆▇█"


def _warn(msg: str) -> None:
    print(f"pert_fleet: warning: {msg}", file=sys.stderr)


# ---------------------------------------------------------------------------
# per-run extraction + the index
# ---------------------------------------------------------------------------


def run_record(path) -> Optional[dict]:
    """One index record for a run-log file; None when unreadable or not
    a run log (no run_start envelope)."""
    path = pathlib.Path(path)
    summary = summarize_run(path)
    if summary is None or summary.get("run_name") is None:
        return None
    fits = summary.get("fits") or []
    cells = [f.get("num_cells") for f in fits
             if isinstance(f.get("num_cells"), int)]
    try:
        mtime = path.stat().st_mtime
    except OSError:
        mtime = None
    # the cost plane (schema v9 run_end.meter): attributed device time
    # and goodput, promoted to top-level record fields so `query
    # --format json` answers "what did this run cost" without a
    # re-parse
    meter = summary.get("meter") or {}
    return {
        "path": str(path),
        "file": path.name,
        "mtime": mtime,
        "run_name": summary.get("run_name"),
        # serve traffic (schema v7): per-request RunLogs under the
        # worker's spool/results tree carry the request id in
        # run_start — `query`/`trend` group on it via --request
        "request_id": summary.get("request_id"),
        "schema_version": summary.get("schema_version"),
        "started_unix": summary.get("started_unix"),
        "config_hash": summary.get("config_hash"),
        "platform": summary.get("platform"),
        "device_kind": summary.get("device_kind"),
        "num_devices": summary.get("num_devices"),
        "status": summary.get("status"),
        "wall_seconds": summary.get("wall_seconds"),
        "device_seconds": meter.get("billed_device_seconds"),
        "goodput": meter.get("goodput_cell_iters_per_device_second"),
        "waste_frac": meter.get("waste_frac"),
        "workload": {
            "num_cells": max(cells) if cells else None,
            "steps": sorted({str(f.get("step")) for f in fits
                             if f.get("step")}),
        },
        "metrics": flat_metrics(summary),
    }


def discover_logs(roots) -> List[pathlib.Path]:
    found: List[pathlib.Path] = []
    for root in roots:
        root = pathlib.Path(root)
        if root.is_file():
            found.append(root)
        elif root.is_dir():
            found.extend(sorted(root.rglob("*.jsonl")))
    # dedupe, keep discovery order
    seen = set()
    out = []
    for p in found:
        key = str(p.resolve())
        if key not in seen:
            seen.add(key)
            out.append(p)
    return out


def build_index(roots) -> dict:
    runs = []
    for path in discover_logs(roots):
        record = run_record(path)
        if record is None:
            _warn(f"{path}: not a readable run log — skipped")
            continue
        runs.append(record)
    runs.sort(key=_run_time)
    return {
        "kind": "pert_fleet_index",
        "generated_unix": round(time.time(), 3),
        "roots": [str(r) for r in roots],
        "num_runs": len(runs),
        "runs": runs,
    }


def _run_time(record: dict) -> float:
    t = record.get("started_unix")
    if isinstance(t, (int, float)):
        return float(t)
    return float(record.get("mtime") or 0.0)


def load_runs(args) -> List[dict]:
    """Runs for query/trend/regress: from ``--index`` when it exists,
    else indexed fresh from the roots."""
    index_path = pathlib.Path(args.index)
    if index_path.is_file():
        try:
            doc = json.loads(index_path.read_text())
            return list(doc.get("runs", []))
        except (OSError, ValueError) as exc:
            _warn(f"unreadable index {index_path} ({exc}); re-indexing")
    return build_index(args.roots)["runs"]


def filter_runs(runs: List[dict], args) -> List[dict]:
    def _date(value):
        return time.mktime(time.strptime(value, "%Y-%m-%d"))

    out = runs
    if getattr(args, "config_hash", None):
        out = [r for r in out if r.get("config_hash") == args.config_hash]
    if getattr(args, "run_name", None):
        out = [r for r in out if r.get("run_name") == args.run_name]
    if getattr(args, "request", None):
        # '*' keeps every run that IS a request (serve traffic only);
        # a literal id keeps that request's runs
        if args.request == "*":
            out = [r for r in out if r.get("request_id")]
        else:
            out = [r for r in out if r.get("request_id") == args.request]
    if getattr(args, "status", None):
        out = [r for r in out if r.get("status") == args.status]
    if getattr(args, "since", None):
        out = [r for r in out if _run_time(r) >= _date(args.since)]
    if getattr(args, "until", None):
        # inclusive day: anything before the NEXT midnight
        out = [r for r in out
               if _run_time(r) < _date(args.until) + 86400.0]
    return sorted(out, key=_run_time)


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _fmt_time(record: dict) -> str:
    t = _run_time(record)
    if not t:
        return "-"
    return time.strftime("%Y-%m-%d %H:%M", time.localtime(t))


def _fmt_val(value) -> str:
    if value is None:
        return "-"
    if isinstance(value, float):
        return f"{value:.4g}"
    return str(value)


def sparkline(values) -> str:
    """Unicode sparkline; non-numeric entries render as '·'."""
    nums = [v for v in values if isinstance(v, (int, float))]
    if not nums:
        return ""
    lo, hi = min(nums), max(nums)
    out = []
    for v in values:
        if not isinstance(v, (int, float)):
            out.append("·")
        elif hi == lo:
            out.append(_SPARK_BARS[3])
        else:
            idx = int((v - lo) / (hi - lo) * (len(_SPARK_BARS) - 1)
                      + 0.5)
            out.append(_SPARK_BARS[idx])
    return "".join(out)


def render_query(runs: List[dict]) -> str:
    lines = ["| run | when | status | platform | config | request | "
             "cells | wall (s) |",
             "|---|---|---|---|---|---|---:|---:|"]
    for r in runs:
        lines.append(
            f"| `{r.get('file')}` | {_fmt_time(r)} | {r.get('status')} "
            f"| {r.get('platform') or '-'} "
            f"| `{r.get('config_hash') or '-'}` "
            f"| {r.get('request_id') or '-'} "
            f"| {_fmt_val((r.get('workload') or {}).get('num_cells'))} "
            f"| {_fmt_val(r.get('wall_seconds'))} |")
    return "\n".join(lines)


def default_trend_metrics() -> List[str]:
    """Gated metrics first (the bench trajectory), in manifest order."""
    return [name for name, spec in manifest_metrics().items()
            if spec.get("regress")]


def trend_document(runs: List[dict], metric_names: List[str]) -> dict:
    """Machine-readable twin of :func:`render_trend` (``trend --format
    json``): per metric, the manifest spec plus the time-ordered value
    series, for scripts that would otherwise re-parse markdown."""
    known = manifest_metrics()
    metrics: dict = {}
    for name in metric_names:
        values = [(r.get("metrics") or {}).get(name) for r in runs]
        if not any(isinstance(v, (int, float)) for v in values):
            continue
        spec = known.get(name, {})
        metrics[name] = {
            "help": spec.get("help"),
            "regress": spec.get("regress"),
            "values": values,
            "runs": [{"file": r.get("file"),
                      "when_unix": _run_time(r) or None,
                      "config_hash": r.get("config_hash"),
                      "value": v}
                     for r, v in zip(runs, values)],
        }
    return {"kind": "pert_fleet_trend", "num_runs": len(runs),
            "metrics": metrics}


def render_trend(runs: List[dict], metric_names: List[str]) -> str:
    lines = [f"# PERT fleet trend — {len(runs)} run(s)", ""]
    if not runs:
        return "\n".join(lines + ["_no indexed runs_", ""])
    known = manifest_metrics()
    for name in metric_names:
        values = [(r.get("metrics") or {}).get(name) for r in runs]
        if not any(isinstance(v, (int, float)) for v in values):
            continue
        spec = known.get(name, {})
        lines.append(f"## `{name}`")
        if spec.get("help"):
            lines.append(f"_{spec['help']}_")
        lines.append("")
        lines.append(f"`{sparkline(values)}`")
        lines.append("")
        lines += ["| run | when | value |", "|---|---|---:|"]
        for r, v in zip(runs, values):
            lines.append(f"| `{r.get('file')}` | {_fmt_time(r)} "
                         f"| {_fmt_val(v)} |")
        lines.append("")
    if len(lines) == 2:
        lines += ["_none of the requested metrics appear in the indexed "
                  "runs_", ""]
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# regress
# ---------------------------------------------------------------------------


# re-exported for callers/tests that think in fleet terms; the one
# implementation lives with the manifest (obs/metrics.py)
_metric_base_name = metric_base_name


def write_baseline(record: dict, out_path) -> dict:
    doc = {
        "kind": "pert_fleet_baseline",
        "created": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "run_log": record.get("file"),
        "platform": record.get("platform"),
        "device_kind": record.get("device_kind"),
        "config_hash": record.get("config_hash"),
        "workload": record.get("workload"),
        # JAX's text, byte for byte: either package's tool writes the
        # same baseline file from the same run
        "note": "pert_fleet regression baseline: HEAD runs are compared "
                "against these metrics with the per-metric relative "
                "thresholds from obs/metrics_manifest.json; refresh "
                "with `python -m tools.pert_fleet regress --run RUN "
                "--write-baseline <this file>`",
        "metrics": record.get("metrics") or {},
    }
    out_path = pathlib.Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(doc, indent=1, sort_keys=False)
                        + "\n")
    return doc


def compare_to_baseline(baseline: dict, record: dict,
                        tolerance_scale: float = 1.0) -> dict:
    """Per-metric comparison of one run against a baseline artifact.

    Returns ``{"rows": [...], "regressions": [...], "warnings": [...]}``
    — a row per baseline metric with the applied threshold and verdict
    from the SHARED judgement ``obs.metrics.regress_verdict`` (the same
    vocabulary ``pert_report --compare`` renders):

    * ``REGRESSED`` — moved in the bad direction past the (scaled,
      direction-capped) threshold; drives the nonzero exit;
    * ``ok`` / ``improved`` — within threshold / moved the good way
      past it;
    * ``incomparable`` — zero baseline moved the bad way: the relative
      delta is infinite, so it is warned about, never hard-gated (a
      warm-cache baseline with 0 compile misses must not wedge CI);
    * ``untracked`` — compared for the record, but the manifest arms no
      regress gate for it;
    * ``missing`` — the run lacks the metric (warned, not failed: a
      degraded run already fails louder elsewhere).
    """
    known = manifest_metrics()
    run_metrics = record.get("metrics") or {}
    rows, regressions, warnings = [], [], []
    for key in sorted((baseline.get("metrics") or {})):
        base_val = baseline["metrics"][key]
        if not isinstance(base_val, (int, float)):
            continue
        spec = known.get(metric_base_name(key))
        if spec is None:
            warnings.append(
                f"baseline metric {key!r} is not in "
                f"obs/metrics_manifest.json — skipped (register it, or "
                f"refresh the baseline)")
            continue
        run_val = run_metrics.get(key)
        if not isinstance(run_val, (int, float)):
            warnings.append(f"run lacks baseline metric {key!r}")
            rows.append({"metric": key, "baseline": base_val,
                         "run": None, "rel_delta": None,
                         "threshold": None, "verdict": "missing"})
            continue
        rel, threshold, verdict = regress_verdict(
            spec, base_val, run_val, tolerance_scale=tolerance_scale)
        if verdict == "incomparable":
            warnings.append(
                f"baseline metric {key!r} is 0 — relative regression "
                f"gating is undefined from a zero base; refresh the "
                f"baseline from a comparable run")
        row = {"metric": key, "baseline": base_val, "run": run_val,
               "rel_delta": rel, "threshold": threshold,
               "direction": (spec.get("regress") or {}).get("direction"),
               "verdict": verdict}
        rows.append(row)
        if verdict == "REGRESSED":
            regressions.append(row)
    return {"rows": rows, "regressions": regressions,
            "warnings": warnings}


def render_regress(baseline: dict, record: dict, result: dict,
                   tolerance_scale: float) -> str:
    lines = [
        "# PERT fleet regression gate",
        "",
        f"- **baseline**: `{baseline.get('run_log')}` "
        f"({baseline.get('created')}, {baseline.get('platform')}, "
        f"config `{baseline.get('config_hash')}`)",
        f"- **run**: `{record.get('file')}` ({_fmt_time(record)}, "
        f"{record.get('platform')}, config "
        f"`{record.get('config_hash')}`)",
        f"- **tolerance scale**: x{tolerance_scale:g}",
        f"- **verdict**: "
        + ("**REGRESSED** — "
           f"{len(result['regressions'])} gated metric(s) over "
           "threshold" if result["regressions"] else "clean"),
        "",
        "| metric | baseline | run | Δ rel | threshold | verdict |",
        "|---|---:|---:|---:|---:|---|",
    ]
    for row in result["rows"]:
        rel = row.get("rel_delta")
        thr = row.get("threshold")
        mark = {"REGRESSED": "⚠ **REGRESSED**"}.get(row["verdict"],
                                                    row["verdict"])
        lines.append(
            f"| `{row['metric']}` | {_fmt_val(row['baseline'])} "
            f"| {_fmt_val(row.get('run'))} "
            f"| {'-' if rel is None or not _finite(rel) else f'{rel:+.1%}'} "
            f"| {'-' if thr is None else f'±{thr:.0%}'} | {mark} |")
    for w in result["warnings"]:
        lines.append(f"- warning: {w}")
    lines.append("")
    return "\n".join(lines)


def _finite(value) -> bool:
    return isinstance(value, (int, float)) \
        and value == value and abs(value) != float("inf")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _add_source_args(ap) -> None:
    ap.add_argument("--roots", nargs="+", default=list(DEFAULT_ROOTS),
                    help="directories (or run-log files) to ingest "
                         "(default: .pert_runs/ + artifacts/)")
    ap.add_argument("--index", default=DEFAULT_INDEX,
                    help="existing index file to read instead of "
                         "re-scanning the roots (built with the 'index' "
                         "subcommand)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="pert_fleet",
        description="Cross-run fleet index over RunLog JSONLs: index, "
                    "query, trend, and the CI regression gate")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_index = sub.add_parser("index", help="ingest run logs into one "
                                           "queryable index file")
    p_index.add_argument("--roots", nargs="+",
                         default=list(DEFAULT_ROOTS))
    p_index.add_argument("--out", default=DEFAULT_INDEX)

    p_query = sub.add_parser("query", help="filter + list indexed runs")
    _add_source_args(p_query)
    p_query.add_argument("--config-hash", default=None)
    p_query.add_argument("--run-name", default=None)
    p_query.add_argument("--status", default=None)
    p_query.add_argument("--request", default=None, metavar="ID",
                         help="keep only serve-request runs: a request "
                              "id, or '*' for every run that carries "
                              "one (per-request RunLogs under a "
                              "pert-serve spool/results tree)")
    p_query.add_argument("--since", default=None, metavar="YYYY-MM-DD")
    p_query.add_argument("--until", default=None, metavar="YYYY-MM-DD")
    p_query.add_argument("--format", default="markdown",
                         choices=("markdown", "json"),
                         help="output format: the markdown table "
                              "(default) or the matching records as "
                              "JSON (machine-readable; the autopilot/"
                              "scripting interface)")
    p_query.add_argument("--json", action="store_true",
                         help="alias for --format json")

    p_trend = sub.add_parser("trend", help="markdown table + sparkline "
                                           "per metric across runs")
    _add_source_args(p_trend)
    p_trend.add_argument("--config-hash", default=None)
    p_trend.add_argument("--run-name", default=None)
    p_trend.add_argument("--status", default=None)
    p_trend.add_argument("--request", default=None, metavar="ID",
                         help="trend serve-request runs only: a "
                              "request id, or '*' for every run that "
                              "carries one")
    p_trend.add_argument("--since", default=None, metavar="YYYY-MM-DD")
    p_trend.add_argument("--until", default=None, metavar="YYYY-MM-DD")
    p_trend.add_argument("--metric", nargs="+", default=None,
                         help="metric names/series keys to trend "
                              "(default: every manifest metric with a "
                              "regress gate)")
    p_trend.add_argument("--format", default="markdown",
                         choices=("markdown", "json"),
                         help="output format: markdown + sparklines "
                              "(default) or a JSON document of "
                              "per-metric value series (machine-"
                              "readable; the autopilot/scripting "
                              "interface)")
    p_trend.add_argument("--out", default=None,
                         help="write the report here instead of stdout")

    p_reg = sub.add_parser(
        "regress",
        help="compare one run against a committed baseline; nonzero "
             "exit on any gated regression")
    _add_source_args(p_reg)
    p_reg.add_argument("--baseline", default=None,
                       help="baseline artifact (e.g. "
                            "artifacts/FLEET_BASELINE_cpu.json); "
                            "required unless --write-baseline")
    p_reg.add_argument("--run", default=None,
                       help="run log to gate (default: the newest "
                            "indexed run)")
    p_reg.add_argument("--tolerance-scale", type=float, default=1.0,
                       help="multiply every manifest threshold by this "
                            "factor (CI compares across machines, where "
                            "same-machine wall thresholds would flake)")
    p_reg.add_argument("--write-baseline", default=None, metavar="FILE",
                       help="record the run as the new baseline instead "
                            "of comparing")
    p_reg.add_argument("--out", default=None,
                       help="write the markdown verdict here too")

    args = ap.parse_args(argv)

    if args.cmd == "index":
        index = build_index(args.roots)
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(index, indent=1) + "\n")
        print(f"pert_fleet: indexed {index['num_runs']} run(s) from "
              f"{', '.join(index['roots'])} -> {out}")
        return 0

    if args.cmd == "query":
        runs = filter_runs(load_runs(args), args)
        if args.json or args.format == "json":
            print(json.dumps(runs, indent=1))
        else:
            print(render_query(runs))
        return 0

    if args.cmd == "trend":
        runs = filter_runs(load_runs(args), args)
        metrics = args.metric or default_trend_metrics()
        if args.format == "json":
            report = json.dumps(trend_document(runs, metrics), indent=1)
        else:
            report = render_trend(runs, metrics)
        if args.out:
            pathlib.Path(args.out).write_text(report + "\n")
        else:
            print(report)
        return 0

    # regress
    if args.run:
        record = run_record(args.run)
        if record is None:
            raise SystemExit(f"pert_fleet: {args.run} is not a readable "
                             f"run log")
    else:
        runs = sorted(load_runs(args), key=_run_time)
        if not runs:
            raise SystemExit("pert_fleet: no indexed runs to gate — "
                             "pass --run or build an index first")
        record = runs[-1]

    if args.write_baseline:
        write_baseline(record, args.write_baseline)
        print(f"pert_fleet: baseline written to {args.write_baseline} "
              f"from {record.get('file')}")
        return 0

    if not args.baseline:
        raise SystemExit("pert_fleet: regress needs --baseline FILE "
                         "(or --write-baseline to record one)")
    try:
        baseline = json.loads(pathlib.Path(args.baseline).read_text())
    except (OSError, ValueError) as exc:
        raise SystemExit(f"pert_fleet: unreadable baseline "
                         f"{args.baseline} ({exc})")
    result = compare_to_baseline(baseline, record,
                                 tolerance_scale=args.tolerance_scale)
    for w in result["warnings"]:
        _warn(w)
    report = render_regress(baseline, record, result,
                            args.tolerance_scale)
    if args.out:
        pathlib.Path(args.out).write_text(report + "\n")
    print(report)
    if result["regressions"]:
        names = ", ".join(r["metric"] for r in result["regressions"])
        print(f"pert_fleet: REGRESSION GATE FAILED: {names}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except BrokenPipeError:  # `pert_fleet trend | head` is normal usage
        sys.exit(0)
