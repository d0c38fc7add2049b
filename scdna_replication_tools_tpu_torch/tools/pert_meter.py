"""Device-cost and goodput reporting over meter ledgers (port of
``tools/pert_meter.py``, reading with the port's ``obs/meter``).

Every run with a run log closes with a ``meter`` section on ``run_end``
(schema v9): attributed device-seconds decomposed into effective work
and named waste (padding, retired_lane, compile, compile_deserialize,
retry_refit, queue_idle), plus goodput in cell-iterations per
device-second.  This tool renders and cross-checks those ledgers:

    # one run (or a results dir / a whole serve spool): the efficiency
    # waterfall, billed -> waste rows -> effective
    python -m scdna_replication_tools_tpu_torch.tools.pert_meter \\
        report RUN.jsonl
    python -m scdna_replication_tools_tpu_torch.tools.pert_meter \\
        report /data/pert_spool

    # tenant accounting over a spool: per-tenant and per-bucket rollups
    # joined from the worker log(s) and every request's own run log,
    # with the conservation invariant checked on each ledger
    python -m scdna_replication_tools_tpu_torch.tools.pert_meter \\
        attribution /data/pert_spool --check

    # two-arm cost comparison (runs, spools or JSON documents with a
    # meter block): device-seconds per request, goodput, waste mix
    python -m scdna_replication_tools_tpu_torch.tools.pert_meter \\
        ab baseline.jsonl candidate.jsonl

``--json`` on every verb emits the machine document instead of markdown
(one JSON object on stdout).  The conservation contract, billed ==
effective + sum(waste) within 1 %, is asserted by ``--check`` (exit 1 on
a violation).  Host code: it needs no GPU.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from scdna_replication_tools_tpu_torch.obs.meter import (
    WASTE_CATEGORIES,
    conservation_gap,
)

_BAR_WIDTH = 30
#: the 1% conservation tolerance the acceptance contract names
CONSERVATION_TOL = 0.01


# ---------------------------------------------------------------------------
# loading: run logs, results dirs, spools, bench artifacts
# ---------------------------------------------------------------------------

def _iter_events(path):
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except ValueError:
                continue  # torn tail line of a live log


def meter_of_run(path):
    """The ``meter`` section of a run log's ``run_end`` (None when the
    run predates schema v9, metered nothing, or never ended)."""
    meter = None
    for ev in _iter_events(path):
        if ev.get("event") == "run_end" and ev.get("meter"):
            meter = ev["meter"]
    return meter


def _request_rows_of_worker_log(path):
    """request_end joins from one serve worker log: id, tenant, bucket,
    status, wall, and the per-request run log path."""
    rows = []
    for ev in _iter_events(path):
        if ev.get("event") != "request_end":
            continue
        bucket = ev.get("bucket") or {}
        rows.append({
            "request_id": ev.get("request_id"),
            "status": ev.get("status"),
            "tenant": ev.get("tenant"),
            "bucket": bucket.get("name") if isinstance(bucket, dict)
            else bucket,
            "wall_seconds": ev.get("wall_seconds"),
            "run_log": ev.get("run_log"),
        })
    return rows


def collect_spool(spool):
    """Everything the spool knows about cost: the worker session
    ledgers (worker_*.jsonl run_end meters) and one row per request
    (request_end facts + that request's own run-log meter)."""
    spool = pathlib.Path(spool)
    workers = []
    requests = []
    for wlog in sorted(spool.glob("worker_*.jsonl")):
        meter = meter_of_run(wlog)
        if meter:
            workers.append({"path": str(wlog), "meter": meter})
        requests.extend(_request_rows_of_worker_log(wlog))
    for row in requests:
        run_log = row.get("run_log")
        if not run_log:
            # refused/admission-failed requests never opened a run log
            rid = row.get("request_id")
            candidate = spool / "results" / str(rid) / "run.jsonl"
            run_log = str(candidate) if candidate.exists() else None
        if run_log and pathlib.Path(run_log).exists():
            row["meter"] = meter_of_run(run_log)
        else:
            row["meter"] = None
    return {"workers": workers, "requests": requests}


def _meter_like(doc):
    """Find a meter dict inside an arbitrary JSON document (a bench
    artifact arm, a manifest, a bare summary)."""
    if not isinstance(doc, dict):
        return None
    if "billed_device_seconds" in doc:
        return doc
    if isinstance(doc.get("meter"), dict):
        return doc["meter"]
    return None


def load_source(path):
    """Resolve one CLI operand into ``{meters, requests, label}``.

    Accepts a run log (.jsonl), a results directory (contains
    run.jsonl), a spool directory (worker_*.jsonl + results/), or a
    JSON document carrying a ``meter`` block (a durable-run manifest,
    a bench artifact arm).
    """
    p = pathlib.Path(path)
    if p.is_dir():
        if (p / "run.jsonl").exists() and not list(
                p.glob("worker_*.jsonl")):
            meter = meter_of_run(p / "run.jsonl")
            return {"label": p.name, "meters": [meter] if meter else [],
                    "requests": []}
        spooled = collect_spool(p)
        meters = [w["meter"] for w in spooled["workers"]]
        meters += [r["meter"] for r in spooled["requests"]
                   if r.get("meter")]
        return {"label": p.name, "meters": meters,
                "requests": spooled["requests"],
                "workers": spooled["workers"]}
    if str(p).endswith(".jsonl"):
        meter = meter_of_run(p)
        return {"label": p.name, "meters": [meter] if meter else [],
                "requests": _request_rows_of_worker_log(p)}
    with open(p) as fh:
        doc = json.load(fh)
    meter = _meter_like(doc)
    return {"label": p.name, "meters": [meter] if meter else [],
            "requests": []}


# ---------------------------------------------------------------------------
# rollups
# ---------------------------------------------------------------------------

def merge_meters(meters):
    """Sum meter summaries/rollup slots into one conserving rollup
    (billed/effective/waste/cell_iters/flops add; rates recompute)."""
    out = {"billed_device_seconds": 0.0,
           "effective_device_seconds": 0.0,
           "waste_seconds": {}, "cell_iters": 0.0, "flops": 0.0,
           "records": 0}
    for m in meters:
        if not m:
            continue
        out["billed_device_seconds"] += float(
            m.get("billed_device_seconds") or 0.0)
        out["effective_device_seconds"] += float(
            m.get("effective_device_seconds") or 0.0)
        for cat, sec in (m.get("waste_seconds") or {}).items():
            out["waste_seconds"][cat] = \
                out["waste_seconds"].get(cat, 0.0) + float(sec)
        out["cell_iters"] += float(m.get("cell_iters") or 0.0)
        out["flops"] += float(m.get("flops") or 0.0)
        out["records"] += int(m.get("records") or 0)
    billed = out["billed_device_seconds"]
    waste = sum(out["waste_seconds"].values())
    out["waste_frac"] = round(waste / billed, 6) if billed > 0 else 0.0
    if billed > 0:
        out["goodput_cell_iters_per_device_second"] = round(
            out["cell_iters"] / billed, 3)
    for key in ("billed_device_seconds", "effective_device_seconds",
                "cell_iters", "flops"):
        out[key] = round(out[key], 6)
    out["waste_seconds"] = {k: round(v, 6) for k, v
                            in sorted(out["waste_seconds"].items())}
    return out


def rollup_by(rows, key):
    """Group request rows by ``key`` (tenant/bucket) and merge their
    meters; rows without the key land under ``"-"``."""
    groups = {}
    for row in rows:
        label = row.get(key) or "-"
        groups.setdefault(label, []).append(row)
    out = {}
    for label, members in sorted(groups.items()):
        merged = merge_meters([r.get("meter") for r in members])
        merged["requests"] = len(members)
        out[label] = merged
    return out


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _fmt(v, fmt="{:.2f}"):
    return "-" if v is None else fmt.format(v)


def render_waterfall(meter, title="Cost & efficiency"):
    """The efficiency waterfall of one meter rollup as markdown lines:
    billed device-seconds at the top, one row per waste category, the
    effective remainder, then goodput + the conservation check.
    Shared by ``pert_meter report`` and ``pert_report``."""
    lines = [f"## {title}", ""]
    if not meter:
        return lines + ["_no meter section (pre-v9 run log, or the "
                        "run metered nothing)_", ""]
    billed = float(meter.get("billed_device_seconds") or 0.0)
    effective = float(meter.get("effective_device_seconds") or 0.0)
    waste = meter.get("waste_seconds") or {}
    denom = billed or 1.0
    lines += ["| component | device-seconds | share | |",
              "|---|---:|---:|---|",
              f"| **billed** | {billed:.2f} | 100.0% | |"]
    for cat in WASTE_CATEGORIES:
        sec = float(waste.get(cat) or 0.0)
        if sec == 0.0:
            continue
        share = sec / denom
        bar = "#" * round(share * _BAR_WIDTH)
        lines.append(f"| waste: `{cat}` | {sec:.2f} | {share:.1%} "
                     f"| `{bar}` |")
    for cat in sorted(set(waste) - set(WASTE_CATEGORIES)):
        # forward-compat: categories this tool predates still render
        sec = float(waste.get(cat) or 0.0)
        lines.append(f"| waste: `{cat}` | {sec:.2f} "
                     f"| {sec / denom:.1%} | |")
    eff_bar = "#" * round((effective / denom) * _BAR_WIDTH)
    lines.append(f"| **effective** | {effective:.2f} "
                 f"| {effective / denom:.1%} | `{eff_bar}` |")
    lines.append("")
    goodput = meter.get("goodput_cell_iters_per_device_second")
    if goodput is not None:
        lines.append(f"- **goodput**: {goodput} cell-iterations per "
                     f"device-second ({_fmt(meter.get('cell_iters'), '{:.0f}')} "
                     f"cell-iters total)")
    if meter.get("flops"):
        lines.append(f"- **program FLOPs dispatched**: "
                     f"{meter['flops']:.3g}")
    gap = conservation_gap(meter)
    verdict = "OK" if gap <= CONSERVATION_TOL else "VIOLATED ⚠"
    lines.append(f"- **conservation** (billed = effective + Σwaste): "
                 f"{verdict} (gap {gap:.2e})")
    lines.append("")
    return lines


def _render_request_table(rows):
    if not rows:
        return []
    lines = ["## Per-request cost", "",
             "| request | tenant | bucket | status | billed dev-s | "
             "goodput | waste frac |",
             "|---|---|---|---|---:|---:|---:|"]
    for row in rows:
        m = row.get("meter") or {}
        lines.append(
            f"| {row.get('request_id')} | {row.get('tenant') or '-'} "
            f"| {row.get('bucket') or '-'} | {row.get('status')} "
            f"| {_fmt(m.get('billed_device_seconds'))} "
            f"| {_fmt(m.get('goodput_cell_iters_per_device_second'), '{:.3g}')} "
            f"| {_fmt(m.get('waste_frac'), '{:.1%}')} |")
    lines.append("")
    return lines


def _render_rollup_table(title, rollup, count_key="requests"):
    lines = [f"## {title}", ""]
    if not rollup:
        return lines + ["_nothing attributed_", ""]
    lines += [f"| label | {count_key} | billed dev-s | effective | "
              "waste frac | goodput |",
              "|---|---:|---:|---:|---:|---:|"]
    for label, m in rollup.items():
        lines.append(
            f"| `{label}` | {m.get(count_key, '-')} "
            f"| {_fmt(m.get('billed_device_seconds'))} "
            f"| {_fmt(m.get('effective_device_seconds'))} "
            f"| {_fmt(m.get('waste_frac'), '{:.1%}')} "
            f"| {_fmt(m.get('goodput_cell_iters_per_device_second'), '{:.3g}')} |")
    lines.append("")
    return lines


# ---------------------------------------------------------------------------
# verbs
# ---------------------------------------------------------------------------

def cmd_report(args):
    source = load_source(args.path)
    total = merge_meters(source["meters"])
    doc = {"source": str(args.path), "meter": total,
           "conservation_gap": conservation_gap(total),
           "conservation_ok":
               conservation_gap(total) <= CONSERVATION_TOL}
    if source.get("requests"):
        doc["requests"] = [
            {k: r.get(k) for k in ("request_id", "tenant", "bucket",
                                   "status", "wall_seconds")}
            | {"meter": r.get("meter")}
            for r in source["requests"]]
    if args.json:
        print(json.dumps(doc, indent=1))
        return 0
    lines = [f"# PERT cost report — `{source['label']}`", ""]
    lines += render_waterfall(total)
    lines += _render_request_table(source.get("requests") or [])
    sys.stdout.write("\n".join(lines) + "\n")
    return _check_exit(args, [total])


def cmd_attribution(args):
    spooled = collect_spool(args.spool)
    request_rows = spooled["requests"]
    worker_meters = [w["meter"] for w in spooled["workers"]]
    request_meters = [r["meter"] for r in request_rows if r.get("meter")]
    total = merge_meters(worker_meters + request_meters)
    by_tenant = rollup_by(request_rows, "tenant")
    by_bucket = rollup_by(request_rows, "bucket")
    ledgers = [m for m in worker_meters + request_meters if m] + [total]
    gaps = [conservation_gap(m) for m in ledgers]
    doc = {
        "spool": str(args.spool),
        "workers": len(spooled["workers"]),
        "requests": len(request_rows),
        "meter": total,
        "by_tenant": by_tenant,
        "by_bucket": by_bucket,
        "conservation_gap_max": max(gaps, default=0.0),
        "conservation_ok": all(g <= CONSERVATION_TOL for g in gaps),
    }
    if args.json:
        print(json.dumps(doc, indent=1))
        return 0 if (doc["conservation_ok"] or not args.check) else 1
    lines = [f"# PERT cost attribution — spool `{args.spool}`", "",
             f"- **workers**: {doc['workers']}, **requests**: "
             f"{doc['requests']}",
             f"- **conservation** (every ledger + the rollup): "
             f"{'OK' if doc['conservation_ok'] else 'VIOLATED ⚠'} "
             f"(max gap {doc['conservation_gap_max']:.2e})",
             ""]
    lines += render_waterfall(total, title="Fleet rollup")
    lines += _render_rollup_table("By tenant", by_tenant)
    lines += _render_rollup_table("By bucket", by_bucket)
    lines += _render_request_table(request_rows)
    sys.stdout.write("\n".join(lines) + "\n")
    return 0 if (doc["conservation_ok"] or not args.check) else 1


def _arm_doc(path):
    source = load_source(path)
    meter = merge_meters(source["meters"])
    n = len([r for r in source.get("requests") or []
             if r.get("status") == "ok"]) or None
    doc = {"source": str(path), "meter": meter, "requests_ok": n}
    billed = meter.get("billed_device_seconds") or 0.0
    if n:
        doc["device_seconds_per_request"] = round(billed / n, 6)
    return doc


def cmd_ab(args):
    a, b = _arm_doc(args.a), _arm_doc(args.b)
    ma, mb = a["meter"], b["meter"]

    def _ratio(x, y):
        if not isinstance(x, (int, float)) \
                or not isinstance(y, (int, float)) or not x:
            return None
        return round(y / x, 4)

    doc = {
        "a": a, "b": b,
        "deltas": {
            "billed_device_seconds_ratio": _ratio(
                ma.get("billed_device_seconds"),
                mb.get("billed_device_seconds")),
            "goodput_ratio": _ratio(
                ma.get("goodput_cell_iters_per_device_second"),
                mb.get("goodput_cell_iters_per_device_second")),
            "device_seconds_per_request_ratio": _ratio(
                a.get("device_seconds_per_request"),
                b.get("device_seconds_per_request")),
            "waste_frac_delta": round(
                (mb.get("waste_frac") or 0.0)
                - (ma.get("waste_frac") or 0.0), 6),
        },
    }
    if args.json:
        print(json.dumps(doc, indent=1))
        return 0
    lines = [f"# PERT cost A/B — A=`{pathlib.Path(str(args.a)).name}` "
             f"vs B=`{pathlib.Path(str(args.b)).name}`", ""]
    rows = [
        ("billed device-seconds", "billed_device_seconds", "{:.2f}"),
        ("effective device-seconds", "effective_device_seconds",
         "{:.2f}"),
        ("waste frac", "waste_frac", "{:.1%}"),
        ("goodput (cell-iters / dev-s)",
         "goodput_cell_iters_per_device_second", "{:.3g}"),
    ]
    lines += ["| metric | A | B | B/A |", "|---|---:|---:|---:|"]
    for label, key, fmt in rows:
        va, vb = ma.get(key), mb.get(key)
        ratio = _ratio(va, vb) if isinstance(va, (int, float)) \
            and isinstance(vb, (int, float)) else None
        lines.append(f"| {label} | {_fmt(va, fmt)} | {_fmt(vb, fmt)} "
                     f"| {_fmt(ratio, '{:.2f}x')} |")
    pa = a.get("device_seconds_per_request")
    pb = b.get("device_seconds_per_request")
    if pa or pb:
        lines.append(f"| device-seconds per ok request "
                     f"| {_fmt(pa)} | {_fmt(pb)} "
                     f"| {_fmt(_ratio(pa, pb), '{:.2f}x')} |")
    lines += ["", "Waste mix (device-seconds):", "",
              "| category | A | B |", "|---|---:|---:|"]
    wa = ma.get("waste_seconds") or {}
    wb = mb.get("waste_seconds") or {}
    for cat in sorted(set(wa) | set(wb)):
        lines.append(f"| `{cat}` | {_fmt(wa.get(cat))} "
                     f"| {_fmt(wb.get(cat))} |")
    lines.append("")
    sys.stdout.write("\n".join(lines) + "\n")
    return 0


def _check_exit(args, meters):
    if not getattr(args, "check", False):
        return 0
    bad = [m for m in meters
           if m and conservation_gap(m) > CONSERVATION_TOL]
    return 1 if bad else 0


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Device-cost / goodput reporting over PERT meter "
                    "ledgers (run logs, serve spools, bench artifacts)")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_report = sub.add_parser(
        "report", help="efficiency waterfall of one run / results dir "
                       "/ spool: billed -> waste -> effective, goodput")
    p_report.add_argument("path")
    p_report.add_argument("--json", action="store_true")
    p_report.add_argument("--check", action="store_true",
                          help="exit 1 if conservation is violated")

    p_attr = sub.add_parser(
        "attribution", help="per-tenant / per-bucket device-time "
                            "rollup over a serve spool, with the "
                            "conservation invariant checked on every "
                            "ledger")
    p_attr.add_argument("spool")
    p_attr.add_argument("--json", action="store_true")
    p_attr.add_argument("--check", action="store_true",
                        help="exit 1 if any ledger (or the rollup) "
                             "violates conservation")

    p_ab = sub.add_parser(
        "ab", help="two-arm cost comparison: device-seconds per "
                   "request, goodput, waste mix")
    p_ab.add_argument("a")
    p_ab.add_argument("b")
    p_ab.add_argument("--json", action="store_true")

    args = ap.parse_args(argv)
    if args.cmd == "report":
        return cmd_report(args)
    if args.cmd == "attribution":
        return cmd_attribution(args)
    return cmd_ab(args)


if __name__ == "__main__":
    sys.exit(main())
