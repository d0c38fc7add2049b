"""Render a run log (JSONL) as a markdown run report, or diff two runs
(port of ``tools/pert_report.py``, reading with the port's
``obs/{summary,metrics,alerts,heartbeat}``).

Every run with a run log (``PertConfig.telemetry_path``, default 'auto')
leaves one JSONL file, and this tool turns it into the tables a
performance or model-health investigation starts from: run health, the
phase waterfall, the cost waterfall, the span waterfall, the per-step
fit table, model health (the convergence doctor's verdicts, flagged-cell
QC, the entropy histogram), the controller's decisions, resilience,
metrics, compiled programs and the mirror rescue:

    python -m scdna_replication_tools_tpu_torch.tools.pert_report \\
        RUN.jsonl [--out report.md] [--health-dir DIR]
    python -m scdna_replication_tools_tpu_torch.tools.pert_report \\
        --compare A.jsonl B.jsonl

``--compare`` aligns two runs phase by phase and fit by fit (a cold and
a warm store, a before/after of an optimisation) and reports the deltas,
with each metric judged by ``obs.metrics.regress_verdict``, the
judgement of ``pert_fleet regress``.  It renders JAX and port logs
alike.  Host code: it needs no GPU.
"""

from __future__ import annotations

import argparse
import pathlib
import sys

from scdna_replication_tools_tpu_torch.obs.metrics import (
    manifest_metrics,
    metric_base_name,
    regress_verdict,
)
from scdna_replication_tools_tpu_torch.obs.summary import (
    flat_metrics,
    summarize_run,
)

_BAR_WIDTH = 30


def _fmt_seconds(v) -> str:
    return "-" if v is None else f"{v:.2f}s"


def _fmt_bytes(v) -> str:
    if v is None:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(v) < 1024 or unit == "GiB":
            return f"{v:.1f} {unit}" if unit != "B" else f"{int(v)} B"
        v /= 1024
    return f"{v:.1f} GiB"


def _header(summary: dict) -> list:
    lines = [f"# PERT run report — `{pathlib.Path(summary['path']).name}`",
             ""]
    status = summary.get("status")
    badge = {"ok": "OK", "error": "ERROR", "incomplete": "INCOMPLETE "
             "(no run_end — killed run?)"}.get(status, status)
    lines.append(f"- **status**: {badge}")
    if summary.get("error"):
        err = summary["error"]
        lines.append(f"- **error**: `{err.get('type')}`: "
                     f"{err.get('message')}")
    if summary.get("wall_seconds") is not None:
        lines.append(f"- **wall**: {summary['wall_seconds']:.2f}s "
                     f"(phases account for {summary['phase_total']:.2f}s)")
    plat = summary.get("platform")
    if plat:
        lines.append(f"- **device**: {summary.get('num_devices')}x "
                     f"{summary.get('device_kind')} ({plat}), "
                     f"jax {summary.get('jax_version')}")
    if summary.get("config_hash"):
        lines.append(f"- **config hash**: `{summary['config_hash']}`")
    lines.append(f"- **events**: {summary.get('num_events')}")
    lines.append("")
    return lines


def _phase_waterfall(phases: dict) -> list:
    if not phases:
        return ["## Phase waterfall", "", "_no phase events_", ""]
    total = sum(phases.values()) or 1.0
    lines = ["## Phase waterfall", "",
             "| phase | seconds | share | |",
             "|---|---:|---:|---|"]
    for name, secs in sorted(phases.items(), key=lambda kv: -kv[1]):
        share = secs / total
        bar = "#" * round(share * _BAR_WIDTH)
        lines.append(f"| `{name}` | {secs:.2f} | {share:.1%} | `{bar}` |")
    lines.append(f"| **total accounted** | **{total:.2f}** | | |")
    lines.append("")
    return lines


def _fit_table(fits: list) -> list:
    lines = ["## SVI fits", ""]
    if not fits:
        return lines + ["_no fit_end events_", ""]
    lines += ["| step | iters | final loss | converged | nan | wall | "
              "iters/s | program cache | grad-norm (sampled window) |",
              "|---|---:|---:|---|---|---:|---:|---|---|"]
    for fit in fits:
        diag = fit.get("diagnostics") or {}
        gn = "-"
        if diag.get("samples"):
            # the ring buffer keeps a trailing window; label each value
            # with its iteration so a wrapped ring cannot be misread as
            # the fit's first/overall gradient norms
            lo = diag.get("window_start_iter")
            hi = diag.get("window_end_iter")
            at = (lambda i: f"@i{i}" if i is not None else "")
            # norms are null in the JSONL when non-finite (RFC 8259 has
            # no NaN) — exactly the diverged fits this table post-mortems
            num = (lambda k: "nan" if diag.get(k) is None
                   else f"{diag[k]:.3g}")
            gn = (f"{num('grad_norm_first')}{at(lo)} → "
                  f"{num('grad_norm_last')}{at(hi)} "
                  f"(win max {num('grad_norm_max')})")
        loss = fit.get("final_loss")
        # .get defaults don't fire for keys PRESENT with value None
        # (summary.py materializes optional fields that way)
        opt = (lambda k: "-" if fit.get(k) is None else fit[k])
        lines.append(
            f"| {fit.get('step')} | {fit.get('iters')} "
            f"| {'-' if loss is None else f'{loss:.6g}'} "
            f"| {fit.get('converged')} | {fit.get('nan_abort')} "
            f"| {_fmt_seconds(fit.get('wall_seconds'))} "
            f"| {opt('iters_per_second')} "
            f"| {opt('program_cache')} | {gn} |")
    lines.append("")
    return lines


def _compile_section(comp: dict) -> list:
    lines = ["## Compiled programs", ""]
    if not comp.get("programs"):
        return lines + ["_no compile events_", ""]
    hit_rate = comp.get("hit_rate")
    lines += [
        f"- **programs resolved**: {comp['programs']} "
        f"({comp['cache_hits']} hits / {comp['cache_misses']} misses"
        + (f", hit rate {hit_rate:.0%}" if hit_rate is not None else "")
        + ")",
        f"- **trace**: {comp['trace_seconds']:.2f}s, "
        f"**compile**: {comp['compile_seconds']:.2f}s",
        f"- **memory high-water (largest program)**: "
        f"{_fmt_bytes(comp.get('peak_bytes_max'))}",
        "",
    ]
    return lines


def _model_health_section(fit_health: list, cell_qc: list) -> list:
    """Convergence-doctor verdicts + per-cell QC aggregates (schema v2
    ``fit_health`` / ``cell_qc_summary`` events)."""
    lines = ["## Model health", ""]
    if not fit_health and not cell_qc:
        return lines + ["_no model-health events (QC disabled or a "
                        "pre-v2 run log)_", ""]
    if fit_health:
        lines += ["| step | verdict | drift | rel var | grad decay | "
                  "reason |",
                  "|---|---|---:|---:|---:|---|"]
        num = (lambda v: "-" if v is None else f"{v:.3g}")
        for ev in fit_health:
            verdict = ev.get("verdict") or "?"
            mark = "" if verdict == "converged" else " ⚠"
            lines.append(
                f"| {ev.get('step')} | **{verdict}**{mark} "
                f"| {num(ev.get('drift'))} | {num(ev.get('rel_var'))} "
                f"| {num(ev.get('grad_decay'))} "
                f"| {ev.get('reason') or '-'} |")
        lines.append("")
    for ev in cell_qc:
        n = ev.get("num_cells") or 0
        flagged = ev.get("num_flagged") or 0
        pct = f" ({flagged / n:.1%})" if n else ""
        counts = ev.get("flag_counts") or {}
        detail = ", ".join(f"{k}: {v}" for k, v in counts.items())
        lines.append(f"- **cell QC ({ev.get('step')})**: {n} cells, "
                     f"{flagged} flagged{pct}"
                     + (f" — {detail}" if detail else ""))
        if ev.get("mean_cn_entropy_mean") is not None:
            lines.append(f"- **mean CN-posterior entropy**: "
                         f"{ev['mean_cn_entropy_mean']:.4f}"
                         + (f", max PPC z: {ev['ppc_z_max']:.2f}"
                            if ev.get("ppc_z_max") is not None else ""))
        hist = ev.get("entropy_hist") or []
        if hist and max(hist):
            lines += ["", "  per-cell mean CN entropy histogram "
                          "(bins of 0.1 over [0, 1]):", "  ```"]
            peak = max(hist)
            for i, count in enumerate(hist):
                bar = "#" * round(count / peak * _BAR_WIDTH)
                lines.append(f"  {i / 10:.1f}-{(i + 1) / 10:.1f} "
                             f"{bar} {count}")
            lines.append("  ```")
        flagged_cells = ev.get("flagged_cells") or []
        if flagged_cells:
            lines += ["", "| flagged cell | reasons | tau | frac "
                          "low-conf | PPC z |",
                      "|---|---|---:|---:|---:|"]
            num = (lambda v, fmt="{:.3f}": "-" if v is None
                   else fmt.format(v))
            for cell in flagged_cells[:10]:
                lines.append(
                    f"| `{cell.get('cell_id')}` "
                    f"| {', '.join(cell.get('reasons') or [])} "
                    f"| {num(cell.get('tau'))} "
                    f"| {num(cell.get('frac_low_conf'))} "
                    f"| {num(cell.get('ppc_z'), '{:.2f}')} |")
            if len(flagged_cells) > 10:
                lines.append(f"| _… {len(flagged_cells) - 10} more in "
                             f"the event_ | | | | |")
        lines.append("")
    return lines


def _decision_trail_section(control: list, agg: dict) -> list:
    """The adaptive fit controller's audit trail (schema v3
    ``control_decision`` events): what the controller saw, what it did,
    and the iteration ledger — the section that makes adaptive fits
    reproducible from the artifact alone."""
    lines = ["## Decision trail", ""]
    if not control:
        return lines + ["_no control_decision events (controller off, "
                        "inert, or a pre-v3 run log)_", ""]
    saved = agg.get("iters_saved", 0)
    granted = agg.get("iters_granted", 0)
    actions = agg.get("actions") or {}
    lines += [
        f"- **decisions**: {len(control)} ("
        + ", ".join(f"{k}: {v}" for k, v in actions.items()) + ")",
        f"- **iterations reclaimed (early stops)**: {saved}",
        f"- **iterations granted (extensions)**: {granted}",
        "",
        "| step | iter | action | verdict | drift | rel var | "
        "grad decay | saved/granted | detail |",
        "|---|---:|---|---|---:|---:|---:|---:|---|",
    ]
    num = (lambda v: "-" if v is None else f"{v:.3g}")
    for d in control:
        trig = d.get("trigger") or {}
        ledger = "-"
        if d.get("iters_saved") is not None:
            ledger = f"-{d['iters_saved']}"
        elif d.get("iters_granted") is not None:
            ledger = f"+{d['iters_granted']}"
        detail = d.get("detail") or d.get("outcome") or ""
        reason = trig.get("reason") or ""
        lines.append(
            f"| {d.get('step')} | {d.get('iter')} "
            f"| **{d.get('action')}** "
            f"| {trig.get('verdict') or '-'} "
            f"| {num(trig.get('drift'))} | {num(trig.get('rel_var'))} "
            f"| {num(trig.get('grad_decay'))} | {ledger} "
            f"| {detail or reason} |")
    lines.append("")
    return lines


def _resilience_section(res: dict, schema_version) -> list:
    """The durability trail (schema v4 ``fault_injected`` / ``retry`` /
    ``degrade`` / ``resume`` events + checkpoint traffic): what went
    wrong, what the recovery ladder did about it, and how the run's
    state survived — the audit a chaos test or a post-mortem reads
    first.  Placeholder on pre-v4 logs."""
    lines = ["## Resilience", ""]
    res = res or {}
    events = (res.get("faults") or []) + (res.get("retries") or []) \
        + (res.get("degrades") or []) + (res.get("resumes") or [])
    if not events and not res.get("checkpoint_saves"):
        if schema_version is not None and schema_version < 4:
            return lines + ["_pre-v4 run log: no durability events in "
                            "this schema version_", ""]
        return lines + ["_clean run: no faults injected, no retries, "
                        "no degradations, no resumes_", ""]
    lines.append(f"- **checkpoints**: {res.get('checkpoint_saves', 0)} "
                 f"saved, {res.get('checkpoint_loads', 0)} loaded")
    for ev in res.get("resumes") or []:
        verified = ("fingerprint verified"
                    if ev.get("fingerprint_verified")
                    else "fingerprint NOT verified")
        frm = (f" from iteration {ev['from_iter']}"
               if ev.get("from_iter") is not None else "")
        lines.append(f"- **resume ({ev.get('step')})**: "
                     f"{ev.get('action')}{frm} (mode "
                     f"{ev.get('mode')}, {verified})")
    for ev in res.get("faults") or []:
        lines.append(f"- **fault injected**: `{ev.get('kind')}` at "
                     f"`{ev.get('site')}` (hit {ev.get('hit')})")
    for ev in res.get("retries") or []:
        lines.append(f"- **retry**: `{ev.get('label')}` attempt "
                     f"{ev.get('attempt')}/{ev.get('max_attempts')} "
                     f"after {ev.get('delay_seconds')}s — "
                     f"{ev.get('error') or ev.get('error_class')}")
    for ev in res.get("degrades") or []:
        lines.append(f"- **degrade ({ev.get('step') or '-'})**: "
                     f"`{ev.get('action')}` — {ev.get('detail') or ''}")
    lines.append("")
    return lines


def _spans_section(summary: dict) -> list:
    """"Where the time went" (schema v8 ``span_end`` events): the span
    rollup as a component waterfall — queue-wait / admission / pad /
    compile / fit / decode / stream-back — plus the raw per-name
    table, and a per-request latency table on serve worker logs.
    Placeholder on tracing-off / pre-v8 logs."""
    lines = ["## Where the time went (spans)", ""]
    spans = summary.get("spans") or {}
    by_name = spans.get("by_name") or {}
    if not by_name:
        version = summary.get("schema_version")
        if version is not None and version < 8:
            return lines + ["_pre-v8 run log: no span events in this "
                            "schema version_", ""]
        return lines + ["_no span_end events (tracing off — enable "
                        "with --trace-spans / PertConfig.trace_spans; "
                        "the serve worker traces by default)_", ""]
    from scdna_replication_tools_tpu_torch.tools.pert_trace import (
        WATERFALL_COMPONENTS,
        classify_span,
    )

    components = {c: 0.0 for c in WATERFALL_COMPONENTS}
    for name, slot in by_name.items():
        comp = classify_span(name)
        if comp is not None:
            components[comp] += float(slot.get("seconds") or 0.0)
    total = sum(components.values()) or 1.0
    lines += ["| component | seconds | share | |",
              "|---|---:|---:|---|"]
    for comp in WATERFALL_COMPONENTS:
        secs = components[comp]
        if secs == 0.0:
            continue
        share = secs / total
        bar = "#" * round(share * _BAR_WIDTH)
        lines.append(f"| {comp} | {secs:.2f} | {share:.1%} | `{bar}` |")
    lines.append(f"| **total (leaf spans)** | **{total:.2f}** | | |")
    lines += ["", "| span | count | seconds |", "|---|---:|---:|"]
    for name, slot in sorted(by_name.items(),
                             key=lambda kv: -kv[1]["seconds"]):
        lines.append(f"| `{name}` | {slot['count']} "
                     f"| {slot['seconds']:.2f} |")
    requests = summary.get("requests") or []
    if requests:
        # JAX's text, byte for byte (the report renders a log alike in
        # both packages): this package's command is
        # ``python -m scdna_replication_tools_tpu_torch.tools.pert_trace``
        lines += ["", "per-request latency (serve mode; pad/compile/"
                      "fit/decode live in each request's own run log — "
                      "`python -m tools.pert_trace waterfall`):", "",
                  "| request | status | queue wait | wall |",
                  "|---|---|---:|---:|"]
        for req in requests:
            qw = req.get("queue_wait_seconds")
            lines.append(
                f"| {req.get('request_id')} | {req.get('status')} "
                f"| {'-' if qw is None else f'{qw:.2f}s'} "
                f"| {_fmt_seconds(req.get('wall_seconds'))} |")
    lines.append("")
    return lines


def _fmt_metric_value(entry: dict) -> str:
    if entry.get("type") == "histogram":
        return (f"count={entry.get('count')} sum={entry.get('sum')} "
                f"buckets={entry.get('buckets')}")
    v = entry.get("value")
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _metrics_section(metrics_info: dict, schema_version) -> list:
    """The typed-metrics export (schema v5 ``metrics_snapshot`` events):
    the final registry snapshot plus the per-phase device-memory
    high-water trail.  Placeholder on pre-v5 logs."""
    lines = ["## Metrics", ""]
    metrics_info = metrics_info or {}
    final = metrics_info.get("final")
    if not final:
        if schema_version is not None and schema_version < 5:
            return lines + ["_pre-v5 run log: no metrics_snapshot "
                            "events in this schema version_", ""]
        return lines + ["_no metrics_snapshot events (no metrics "
                        "registry was active)_", ""]
    lines.append(f"- **snapshots**: {metrics_info.get('snapshots', 0)} "
                 f"(the table below is the final, run_end snapshot; "
                 f"wall-clock metrics live in the Prometheus textfile "
                 f"— see obs/metrics_manifest.json)")
    lines += ["", "| metric | type | value |", "|---|---|---|"]
    for key in sorted(final):
        entry = final[key]
        if not isinstance(entry, dict):
            continue
        lines.append(f"| `{key}` | {entry.get('type')} "
                     f"| {_fmt_metric_value(entry)} |")
    hbm = metrics_info.get("hbm_by_phase") or {}
    if hbm:
        lines += ["", "per-phase device HBM high-water "
                      "(max over local devices):", "",
                  "| phase boundary | HBM high-water |", "|---|---:|"]
        for phase, peak in hbm.items():
            lines.append(f"| `{phase}` | {_fmt_bytes(peak)} |")
    lines.append("")
    return lines


def _rescue_section(rescues: list) -> list:
    lines = ["## Mirror rescue", ""]
    if not rescues:
        return lines + ["_no rescue events (mirror_rescue off or "
                        "no step 2)_", ""]
    for ev in rescues:
        cand = ev.get("candidates", 0)
        acc = ev.get("accepted", 0)
        line = (f"- {ev.get('step')}: {cand} boundary-tau candidate(s), "
                f"{acc} accepted")
        if ev.get("capped_to") is not None:
            line += f" (capped to {ev['capped_to']})"
        if ev.get("tau_mean_abs_delta") is not None:
            line += f"; mean |Δtau| {ev['tau_mean_abs_delta']:.3f}"
        lines.append(line)
    lines.append("")
    return lines


def _nan_section(aborts: list) -> list:
    if not aborts:
        return []
    lines = ["## NaN aborts", ""]
    for ev in aborts:
        tail = ev.get("loss_tail", [])
        shown = ", ".join("NaN" if v is None else f"{v:.6g}"
                          for v in tail[-8:])
        lines.append(f"- **{ev.get('step')}** aborted at iteration "
                     f"{ev.get('iters')}; loss tail: {shown}")
    lines.append("")
    return lines


def _run_health_section(path, health_dir=None) -> list:
    """Live-run health rendered from the heartbeat plane (``health/``
    next to the run log, or an explicit ``--health-dir``): per-host
    heartbeat summary, straggler spread, alert verdicts — the same
    renderer ``pert_watch report`` uses.  Placeholder when no
    heartbeats exist (pre-watch runs, heartbeats off)."""
    from scdna_replication_tools_tpu_torch.obs import alerts as alerts_mod
    from scdna_replication_tools_tpu_torch.obs import heartbeat as hb_mod
    from scdna_replication_tools_tpu_torch.tools.pert_watch import (
        render_health_markdown,
    )

    if health_dir is None:
        health_dir = pathlib.Path(str(path)).resolve().parent / "health"
    aggregate = hb_mod.aggregate_health(health_dir)
    try:
        verdicts = alerts_mod.evaluate(alerts_mod.load_rules(),
                                       aggregate)
    except alerts_mod.AlertRuleError:
        verdicts = []
    return render_health_markdown(aggregate, verdicts)


def _meter_section(summary: dict) -> list:
    """The cost/goodput waterfall (schema v9 ``run_end.meter``):
    billed device-seconds -> named waste -> effective, plus goodput
    and the conservation check — the same renderer ``pert_meter
    report`` uses.  Placeholder on pre-v9 / unmetered logs."""
    from scdna_replication_tools_tpu_torch.tools.pert_meter import (
        render_waterfall,
    )

    return render_waterfall(summary.get("meter"))


def render_report(path, health_dir=None) -> str:
    summary = summarize_run(path)
    if summary is None:
        raise SystemExit(f"pert_report: no readable events in {path}")
    lines = _header(summary)
    lines += _run_health_section(path, health_dir)
    lines += _phase_waterfall(summary["phases"])
    lines += _meter_section(summary)
    lines += _spans_section(summary)
    lines += _fit_table(summary["fits"])
    lines += _model_health_section(summary.get("fit_health", []),
                                   summary.get("cell_qc", []))
    lines += _decision_trail_section(summary.get("control_decisions", []),
                                     summary.get("controller", {}))
    lines += _resilience_section(summary.get("resilience", {}),
                                 summary.get("schema_version"))
    lines += _metrics_section(summary.get("metrics", {}),
                              summary.get("schema_version"))
    lines += _compile_section(summary["compile"])
    lines += _rescue_section(summary["rescues"])
    lines += _nan_section(summary["nan_aborts"])
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# --compare
# ---------------------------------------------------------------------------

def _delta(a, b) -> str:
    if a is None or b is None:
        return "-"
    d = b - a
    pct = f" ({d / a:+.0%})" if a else ""
    return f"{d:+.2f}{pct}"


def render_compare(path_a, path_b) -> str:
    sa, sb = summarize_run(path_a), summarize_run(path_b)
    for p, s in ((path_a, sa), (path_b, sb)):
        if s is None:
            raise SystemExit(f"pert_report: no readable events in {p}")
    name_a = pathlib.Path(str(path_a)).name
    name_b = pathlib.Path(str(path_b)).name
    lines = [f"# PERT run comparison — A=`{name_a}` vs B=`{name_b}`", "",
             f"- **A**: status {sa['status']}, wall "
             f"{_fmt_seconds(sa.get('wall_seconds'))}, "
             f"{sa.get('num_devices')}x {sa.get('device_kind')}",
             f"- **B**: status {sb['status']}, wall "
             f"{_fmt_seconds(sb.get('wall_seconds'))}, "
             f"{sb.get('num_devices')}x {sb.get('device_kind')}"]
    ha, hb = sa.get("config_hash"), sb.get("config_hash")
    if ha and hb:
        note = "identical" if ha == hb else f"DIFFER (`{ha}` vs `{hb}`)"
        lines.append(f"- **configs**: {note}")
    wa, wb = sa.get("wall_seconds"), sb.get("wall_seconds")
    if wa and wb:
        lines.append(f"- **wall delta (B - A)**: {_delta(wa, wb)}")
    lines.append("")

    lines += ["## Phases (B - A)", "",
              "| phase | A (s) | B (s) | delta |",
              "|---|---:|---:|---:|"]
    names = sorted(set(sa["phases"]) | set(sb["phases"]),
                   key=lambda n: -(max(sa["phases"].get(n, 0.0),
                                       sb["phases"].get(n, 0.0))))
    for name in names:
        va = sa["phases"].get(name)
        vb = sb["phases"].get(name)
        lines.append(f"| `{name}` "
                     f"| {'-' if va is None else f'{va:.2f}'} "
                     f"| {'-' if vb is None else f'{vb:.2f}'} "
                     f"| {_delta(va, vb)} |")
    lines.append(f"| **total** | {sa['phase_total']:.2f} "
                 f"| {sb['phase_total']:.2f} "
                 f"| {_delta(sa['phase_total'], sb['phase_total'])} |")
    lines.append("")

    lines += ["## Fits (B - A)", "",
              "| step | A iters | B iters | A wall | B wall | wall delta "
              "| A final loss | B final loss |",
              "|---|---:|---:|---:|---:|---:|---:|---:|"]
    fits_a = {f.get("step"): f for f in sa["fits"]}
    fits_b = {f.get("step"): f for f in sb["fits"]}
    for step in sorted(set(fits_a) | set(fits_b), key=str):
        fa, fb = fits_a.get(step, {}), fits_b.get(step, {})
        la, lb = fa.get("final_loss"), fb.get("final_loss")
        lines.append(
            f"| {step} | {fa.get('iters', '-')} | {fb.get('iters', '-')} "
            f"| {_fmt_seconds(fa.get('wall_seconds'))} "
            f"| {_fmt_seconds(fb.get('wall_seconds'))} "
            f"| {_delta(fa.get('wall_seconds'), fb.get('wall_seconds'))} "
            f"| {'-' if la is None else f'{la:.6g}'} "
            f"| {'-' if lb is None else f'{lb:.6g}'} |")
    lines.append("")

    ca, cb = sa["compile"], sb["compile"]
    lines += [
        "## Compile (B - A)", "",
        f"- **A**: {ca['cache_hits']}/{ca['programs']} hits, trace+compile "
        f"{ca['trace_seconds'] + ca['compile_seconds']:.2f}s, peak "
        f"{_fmt_bytes(ca.get('peak_bytes_max'))}",
        f"- **B**: {cb['cache_hits']}/{cb['programs']} hits, trace+compile "
        f"{cb['trace_seconds'] + cb['compile_seconds']:.2f}s, peak "
        f"{_fmt_bytes(cb.get('peak_bytes_max'))}",
        f"- **trace+compile delta**: "
        f"{_delta(ca['trace_seconds'] + ca['compile_seconds'], cb['trace_seconds'] + cb['compile_seconds'])}",
        "",
    ]
    lines += _metrics_compare_section(sa, sb)
    return "\n".join(lines)


def _metrics_compare_section(sa: dict, sb: dict) -> list:
    """Per-metric deltas between two runs with the manifest's regression
    thresholds applied — literally the same judgement as ``pert_fleet
    regress`` (the shared ``obs.metrics.regress_verdict``), inline in a
    run diff.  Uses the shared flat metric vector (final
    metrics_snapshot + event-derived values), so pre-v5 logs still diff
    on their derived metrics."""
    ma, mb = flat_metrics(sa), flat_metrics(sb)
    if not ma and not mb:
        return ["## Metrics (B - A)", "", "_no metrics in either run_",
                ""]
    known = manifest_metrics()
    lines = ["## Metrics (B - A)", "",
             "| metric | A | B | Δ rel | threshold | verdict |",
             "|---|---:|---:|---:|---:|---|"]
    presentation = {"REGRESSED": "⚠ **over threshold**",
                    "untracked": "-"}
    for key in sorted(set(ma) | set(mb)):
        va, vb = ma.get(key), mb.get(key)
        rel = thr = None
        verdict = "-"
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            rel, thr, verdict = regress_verdict(
                known.get(metric_base_name(key)), va, vb)
            verdict = presentation.get(verdict, verdict)
        num = (lambda v: "-" if v is None
               else (f"{v:.6g}" if isinstance(v, float) else str(v)))
        rel_txt = "-" if rel is None or rel != rel \
            or abs(rel) == float("inf") else f"{rel:+.1%}"
        lines.append(
            f"| `{key}` | {num(va)} | {num(vb)} "
            f"| {rel_txt} "
            f"| {'-' if thr is None else f'±{thr:.0%}'} | {verdict} |")
    lines.append("")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Render a RunLog JSONL as markdown, or diff two runs")
    ap.add_argument("run", nargs="?", help="run log (.jsonl) to render")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"),
                    help="diff two run logs (e.g. a cold/warm "
                         "compile-cache pair) instead of rendering one")
    ap.add_argument("--out", default=None,
                    help="write the markdown here instead of stdout")
    ap.add_argument("--health-dir", default=None,
                    help="heartbeat health/ directory for the 'Run "
                         "health' section (default: health/ next to "
                         "the run log; placeholder when absent)")
    args = ap.parse_args(argv)

    if args.compare:
        report = render_compare(*args.compare)
    elif args.run:
        report = render_report(args.run, health_dir=args.health_dir)
    else:
        ap.print_usage(sys.stderr)
        raise SystemExit("pert_report: give a run log or --compare A B")

    if args.out:
        with open(args.out, "w") as fh:
            fh.write(report + "\n")
    else:
        sys.stdout.write(report + "\n")


if __name__ == "__main__":
    main()
