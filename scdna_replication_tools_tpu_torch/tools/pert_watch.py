"""Mission control for a running PERT fit of the port: watch / check /
report (port of ``tools/pert_watch.py``, reading with the port's
``obs/heartbeat.aggregate_health`` and ``obs/alerts``).

The write side is ``obs/heartbeat.py``: every rank of a fit (and the
serving worker) atomically publishes ``health/host_<rank>.json`` in the
durable run directory.  This tool is the read side, one view over all
hosts:

    python -m scdna_replication_tools_tpu_torch.tools.pert_watch \
        watch RUNDIR [--once] [--interval S]
    python -m scdna_replication_tools_tpu_torch.tools.pert_watch \
        check RUNDIR [--rules FILE] [--metrics-textfile OUT.prom]
    python -m scdna_replication_tools_tpu_torch.tools.pert_watch \
        report RUNDIR [--out report.md]

``RUNDIR`` is either the run directory (its ``health/`` subdir is
used) or a ``health/`` directory itself.

* ``watch`` renders per-host progress bars, the freshness ladder
  (fresh/lagging/stale/presumed_lost: a lost host is flagged by
  staleness before the surviving ranks' collective times out), the
  straggler spread, desync state, the ETA projection, and the live
  run-log tail.  Without ``--once`` it polls and re-renders, flagging
  hosts whose sequence number stopped advancing;
* ``check`` evaluates the declarative rule file
  (``obs/alert_rules.json`` by default, see ``obs/alerts.py``), prints
  one verdict JSON document, optionally exports
  ``pert_heartbeat_lag_seconds`` / ``pert_straggler_spread_chunks`` /
  ``pert_run_eta_seconds`` as a Prometheus textfile, and exits non-zero
  when any error-severity rule fires;
* ``report`` emits the markdown "Run health" section.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from scdna_replication_tools_tpu_torch.obs import alerts as alerts_mod
from scdna_replication_tools_tpu_torch.obs import heartbeat as hb_mod
from scdna_replication_tools_tpu_torch.obs.metrics import MetricsRegistry

_BAR_WIDTH = 20
_FRESH_BADGE = {
    "final": "final",
    "fresh": "fresh",
    "lagging": "LAGGING",
    "stale": "STALE",
    "presumed_lost": "PRESUMED-LOST",
}


def resolve_health_dir(path) -> pathlib.Path:
    """RUNDIR or a health dir itself -> the directory holding
    ``host_<rank>.json`` files."""
    root = pathlib.Path(path)
    if any(root.glob("host_*.json")):
        return root
    return root / "health"


def _bar(iteration, budget) -> str:
    if not budget or iteration is None:
        return "-" * _BAR_WIDTH
    frac = min(max(int(iteration) / max(int(budget), 1), 0.0), 1.0)
    done = round(frac * _BAR_WIDTH)
    return "#" * done + "-" * (_BAR_WIDTH - done)


def _fmt_eta(v) -> str:
    if v is None:
        return "-"
    v = float(v)
    if v >= 3600:
        return f"{v / 3600:.1f}h"
    if v >= 60:
        return f"{v / 60:.1f}m"
    return f"{v:.0f}s"


def _host_line(h: dict) -> str:
    doc = h["doc"]
    it, budget = doc.get("iteration"), doc.get("budget")
    ms = doc.get("ms_per_iter_ewma")
    span = (doc.get("last_span") or {}).get("name") or "-"
    trail = doc.get("trail") or []
    return (f"  host{h['rank']:<3} {str(doc.get('state')):<8} "
            f"{str(doc.get('step') or '-'):<10} "
            f"c{str(doc.get('chunk') if doc.get('chunk') is not None else '-'):<4} "
            f"[{_bar(it, budget)}] "
            f"{it if it is not None else '-'}/{budget if budget else '-'} "
            f"{f'{ms:.1f}ms/it' if ms else '-':<10} "
            f"eta {_fmt_eta(doc.get('eta_seconds')):<7} "
            f"{_FRESH_BADGE.get(h['freshness'], h['freshness']):<13} "
            f"(lag {h['age_seconds']:.1f}s seq {h['seq']}) "
            f"span {span}"
            + (f"  trail {trail[-1]}" if trail else ""))


def runlog_tail(run_dir, limit: int = 5) -> list:
    """Last ``limit`` events of the freshest RunLog JSONL near the
    health dir (the run dir itself and its parent are searched)."""
    root = pathlib.Path(run_dir)
    candidates = []
    for base in (root, root.parent):
        try:
            candidates += [p for p in base.glob("*.jsonl")
                           if p.is_file()]
        except OSError:
            pass
    if not candidates:
        return []
    newest = max(candidates, key=lambda p: p.stat().st_mtime)
    try:
        lines = newest.read_text().splitlines()[-limit:]
    except OSError:
        return []
    out = []
    for line in lines:
        try:
            ev = json.loads(line)
        except ValueError:
            continue
        if isinstance(ev, dict) and ev.get("event"):
            out.append(ev)
    return out


def render_view(health_dir, aggregate: dict, verdicts: list,
                stalled=(), tail=()) -> str:
    lines = [f"PERT run health — {health_dir}",
             f"  hosts {aggregate['hosts_seen']}"
             f"/{aggregate['process_count'] or '?'}"
             f"  states {aggregate['states'] or '-'}"
             f"  steps {', '.join(aggregate['steps']) or '-'}"
             + ("  ** DESYNC **" if aggregate["desync"] else "")]
    for h in aggregate["hosts"]:
        mark = "  << seq stalled" if h["rank"] in stalled else ""
        lines.append(_host_line(h) + mark)
    if aggregate["missing_ranks"]:
        lines.append(f"  MISSING ranks (never wrote a heartbeat): "
                     f"{aggregate['missing_ranks']}")
    spread_c = aggregate["straggler_spread_chunks"]
    spread_i = aggregate["straggler_spread_iters"]
    lines.append(
        f"  spread {spread_c if spread_c is not None else '-'} chunks / "
        f"{spread_i if spread_i is not None else '-'} iters"
        f"  worst {aggregate['worst_freshness'] or '-'}"
        f"  max-lag {aggregate['max_lag_seconds']:.1f}s"
        f"  ETA {_fmt_eta(aggregate['eta_seconds'])}")
    fired = [v for v in verdicts if v["fired"]]
    if fired:
        lines.append("  alerts:")
        for v in fired:
            lines.append(f"    [{v['severity'].upper()}] {v['name']}: "
                         f"{v['detail']}")
    else:
        lines.append("  alerts: none firing")
    if tail:
        lines.append("  runlog tail: "
                     + " | ".join(str(ev.get("event")) for ev in tail))
    return "\n".join(lines)


def render_health_markdown(aggregate: dict, verdicts: list) -> list:
    """The markdown "Run health" section."""
    lines = ["## Run health", ""]
    if not aggregate["hosts"]:
        lines += ["_no heartbeats found (heartbeats off, or the run "
                  "predates them)_", ""]
        return lines
    lines += ["| host | state | step | chunk | iter/budget | ms/iter "
              "| eta | freshness | lag (s) | seq |",
              "|---|---|---|---:|---:|---:|---:|---|---:|---:|"]
    for h in aggregate["hosts"]:
        doc = h["doc"]
        ms = doc.get("ms_per_iter_ewma")
        it, budget = doc.get("iteration"), doc.get("budget")
        lines.append(
            f"| {h['rank']} | {doc.get('state')} "
            f"| {doc.get('step') or '-'} "
            f"| {doc.get('chunk') if doc.get('chunk') is not None else '-'} "
            f"| {it if it is not None else '-'}"
            f"/{budget if budget else '-'} "
            f"| {f'{ms:.1f}' if ms else '-'} "
            f"| {_fmt_eta(doc.get('eta_seconds'))} "
            f"| {h['freshness']} | {h['age_seconds']:.1f} "
            f"| {h['seq']} |")
    lines.append("")
    spread_c = aggregate["straggler_spread_chunks"]
    lines.append(
        f"- **straggler spread**: "
        f"{spread_c if spread_c is not None else '-'} chunks "
        f"({aggregate['straggler_spread_iters'] if aggregate['straggler_spread_iters'] is not None else '-'} iters)")
    lines.append(f"- **desync**: "
                 f"{'YES — ' + ', '.join(aggregate['steps']) if aggregate['desync'] else 'no'}")
    if aggregate["missing_ranks"]:
        lines.append(f"- **missing ranks**: "
                     f"{aggregate['missing_ranks']}")
    lines.append(f"- **ETA**: {_fmt_eta(aggregate['eta_seconds'])}")
    fired = [v for v in verdicts if v["fired"]]
    if fired:
        lines.append("- **alerts firing**:")
        for v in fired:
            lines.append(f"  - [{v['severity']}] `{v['name']}` — "
                         f"{v['detail']}")
    else:
        lines.append("- **alerts**: none firing")
    lines.append("")
    return lines


def _aggregate_and_verdicts(health_dir, rules_path=None):
    aggregate = hb_mod.aggregate_health(health_dir)
    rules = alerts_mod.load_rules(rules_path)
    return aggregate, alerts_mod.evaluate(rules, aggregate)


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def cmd_watch(args) -> int:
    health_dir = resolve_health_dir(args.run_dir)
    last_seq = {}
    while True:
        aggregate, verdicts = _aggregate_and_verdicts(
            health_dir, args.rules)
        stalled = {h["rank"] for h in aggregate["hosts"]
                   if h["freshness"] not in ("final", "fresh")
                   and last_seq.get(h["rank"]) == h["seq"]}
        last_seq = {h["rank"]: h["seq"] for h in aggregate["hosts"]}
        tail = runlog_tail(health_dir) if not args.no_runlog else []
        print(render_view(health_dir, aggregate, verdicts,
                          stalled=stalled, tail=tail))
        if args.once:
            return 0
        print("-" * 78)
        sys.stdout.flush()
        time.sleep(args.interval)


def cmd_check(args) -> int:
    health_dir = resolve_health_dir(args.run_dir)
    aggregate, verdicts = _aggregate_and_verdicts(
        health_dir, args.rules)
    failing = alerts_mod.failing(verdicts)

    registry = MetricsRegistry(textfile_path=args.metrics_textfile)
    registry.gauge("pert_heartbeat_lag_seconds").set(
        float(aggregate["max_lag_seconds"]))
    spread = aggregate["straggler_spread_chunks"]
    registry.gauge("pert_straggler_spread_chunks").set(
        float(spread if spread is not None else 0))
    # a finished (or not-yet-projecting) run has no ETA; emit 0 so the
    # scrape series exists for every check, not only mid-fit ones
    eta = aggregate["eta_seconds"]
    registry.gauge("pert_run_eta_seconds").set(
        float(eta if eta is not None else 0.0))
    if args.metrics_textfile:
        registry.write_textfile()

    doc = {
        "kind": "pert_watch_check",
        "health_dir": str(health_dir),
        "ok": not failing,
        "failing": [v["name"] for v in failing],
        "verdicts": verdicts,
        "aggregate": {k: v for k, v in aggregate.items()
                      if k != "hosts"},
    }
    print(json.dumps(doc, indent=1, sort_keys=True))
    if failing:
        names = ", ".join(v["name"] for v in failing)
        print(f"pert_watch check: FAIL ({names})", file=sys.stderr)
        return 1
    return 0


def cmd_report(args) -> int:
    health_dir = resolve_health_dir(args.run_dir)
    aggregate, verdicts = _aggregate_and_verdicts(
        health_dir, args.rules)
    text = "\n".join(render_health_markdown(aggregate, verdicts))
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    else:
        sys.stdout.write(text + "\n")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Aggregate per-host heartbeats into one "
                    "mission-control view")
    sub = ap.add_subparsers(dest="cmd", required=True)

    w = sub.add_parser("watch", help="render the live view")
    w.add_argument("run_dir", help="run dir (or its health/ dir)")
    w.add_argument("--once", action="store_true",
                   help="render one frame and exit")
    w.add_argument("--interval", type=float, default=2.0,
                   help="poll interval in loop mode (seconds)")
    w.add_argument("--rules", default=None,
                   help="alert rule file (default: checked-in)")
    w.add_argument("--no-runlog", action="store_true",
                   help="skip the RunLog tail")
    w.set_defaults(fn=cmd_watch)

    c = sub.add_parser("check", help="evaluate alert rules; exit "
                                     "non-zero when an error rule fires")
    c.add_argument("run_dir")
    c.add_argument("--rules", default=None)
    c.add_argument("--metrics-textfile", default=None,
                   help="export the watch gauges here (Prometheus "
                        "textfile format)")
    c.set_defaults(fn=cmd_check)

    r = sub.add_parser("report", help="markdown 'Run health' section")
    r.add_argument("run_dir")
    r.add_argument("--rules", default=None)
    r.add_argument("--out", default=None)
    r.set_defaults(fn=cmd_report)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
