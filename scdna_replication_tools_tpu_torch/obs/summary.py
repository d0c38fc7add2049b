"""Aggregation of a run log's events into a compact summary dict.

Port of ``obs/summary.py``, copied whole.

Shared by the package's ``tools/pert_report`` (markdown rendering +
``--compare``) and ``tools/pert_fleet`` (the index and the regression
gate).  Pure stdlib: the tools read a run log without a GPU.
"""

from __future__ import annotations

import json
import pathlib
from typing import List, Optional


def read_events(path) -> List[dict]:
    """Parse a JSONL run log; skips blank/corrupt lines (a killed run
    may leave a truncated final line — the readable prefix still
    summarises)."""
    events = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            events.append(json.loads(line))
        except ValueError:
            continue
    return events


def _of(events: List[dict], kind: str) -> List[dict]:
    return [ev for ev in events if ev.get("event") == kind]


def _snapshot_hbm_max(snapshot: dict) -> Optional[int]:
    """Max per-device HBM high-water gauge inside one metrics_snapshot
    payload; None when the backend lacks memory_stats (e.g. CPU)."""
    peaks = [entry.get("value") for key, entry in (snapshot or {}).items()
             if key.startswith("pert_device_hbm_peak_bytes")
             and isinstance(entry, dict)
             and isinstance(entry.get("value"), (int, float))]
    return int(max(peaks)) if peaks else None


def flatten_snapshot(snapshot: dict) -> dict:
    """One metrics_snapshot payload -> flat ``{series_key: scalar}``.

    Counters/gauges contribute their value under the series key;
    histograms contribute ``<key>_count`` (the observation count — the
    scalar that trends; the bucket vector stays in the event).
    """
    flat: dict = {}
    for key, entry in (snapshot or {}).items():
        if not isinstance(entry, dict):
            continue
        if entry.get("type") == "histogram":
            if entry.get("count") is not None:
                flat[f"{key}_count"] = entry["count"]
        elif entry.get("value") is not None:
            flat[key] = entry["value"]
    return flat


def derived_metrics(summary: dict) -> dict:
    """Manifest metrics computed from STANDARD RunLog events (the
    ``source: derived:runlog`` entries in obs/metrics_manifest.json).

    This is what lets the fleet index trend pre-v5 logs — wall, fit
    wall, throughput, compile totals and the HBM high-water all predate
    the registry — and it doubles as the home of the wall-clock
    quantities the byte-stable snapshots deliberately exclude.
    """
    out: dict = {}
    if summary.get("wall_seconds") is not None:
        out["pert_wall_seconds"] = round(float(summary["wall_seconds"]), 4)
    fits = summary.get("fits") or []
    fit_wall = sum(float(f.get("wall_seconds") or 0.0) for f in fits)
    fit_iters = sum(int(f.get("iters") or 0) for f in fits)
    if fits:
        out["pert_fit_wall_seconds"] = round(fit_wall, 4)
        out["pert_fit_iters_total"] = fit_iters
        if fit_wall > 0:
            out["pert_iters_per_second"] = round(fit_iters / fit_wall, 2)
        if fit_iters > 0:
            out["pert_fit_ms_per_iter"] = round(
                1000.0 * fit_wall / fit_iters, 3)
    phases = summary.get("phases") or {}
    if phases:
        fitlike = sum(v for k, v in phases.items()
                      if k.endswith("/fit") or k.endswith("/rescue"))
        out["pert_non_fit_wall_seconds"] = round(
            sum(phases.values()) - fitlike, 4)
    comp = summary.get("compile") or {}
    if comp.get("programs"):
        out["pert_trace_compile_seconds"] = round(
            float(comp.get("trace_seconds") or 0.0)
            + float(comp.get("compile_seconds") or 0.0), 4)
        out["pert_compile_cache_hits_total"] = comp.get("cache_hits", 0)
        out["pert_compile_cache_misses_total"] = comp.get("cache_misses",
                                                          0)
        if comp.get("disk_hits"):
            out["pert_aot_disk_hits_total"] = comp["disk_hits"]
    if comp.get("peak_bytes_max") is not None:
        out["pert_peak_hbm_bytes"] = comp["peak_bytes_max"]
    # the cost plane (schema v9): run_end's meter section makes the
    # autopilot objective — device-seconds and goodput — a queryable
    # per-run metric even when the registry snapshot predates the
    # gauges (derived:runlog, like the wall-clock rows above)
    meter = summary.get("meter") or {}
    if meter.get("billed_device_seconds") is not None:
        out["pert_device_seconds_total"] = round(
            float(meter["billed_device_seconds"]), 4)
    if meter.get("goodput_cell_iters_per_device_second") is not None:
        out["pert_goodput_cell_iters_per_device_second"] = round(
            float(meter["goodput_cell_iters_per_device_second"]), 3)
    return out


def flat_metrics(summary: dict) -> dict:
    """The queryable per-run metric vector: event-derived metrics
    overlaid with the final metrics_snapshot (registry values win where
    both exist — they are the same quantity, measured at the source).
    The shared extraction of ``tools/pert_fleet`` and
    ``tools/pert_report --compare``.
    """
    metrics_info = summary.get("metrics") or {}
    return {**derived_metrics(summary),
            **flatten_snapshot(metrics_info.get("final") or {})}


def summarize_events(events: List[dict]) -> dict:
    """Aggregate one run's events; every section is None/empty-safe so a
    partial (crashed) log still summarises."""
    start = next(iter(_of(events, "run_start")), {})
    end = next(iter(_of(events, "run_end")), None)

    # phase ledger: streamed increments accumulate per name (the same
    # semantics as PhaseTimer.add); run_end's final report — when
    # present — is authoritative and identical up to rounding
    phases: dict = {}
    for ev in _of(events, "phase"):
        name = ev.get("name", "?")
        phases[name] = phases.get(name, 0.0) + float(ev.get("seconds", 0.0))
    if end and isinstance(end.get("phases"), dict):
        phases = {k: v for k, v in end["phases"].items()
                  if k != "total_accounted"}

    compiles = _of(events, "compile")
    cache_hits = sum(1 for ev in compiles if ev.get("cache") == "hit")
    cache_misses = sum(1 for ev in compiles if ev.get("cache") == "miss")
    disk_hits = sum(1 for ev in compiles if ev.get("cache") == "disk_hit")
    peak_bytes = [ev["peak_bytes"] for ev in compiles
                  if isinstance(ev.get("peak_bytes"), (int, float))]

    # model health (schema v2): per-step convergence verdicts + the cell
    # QC aggregates.  Both default empty on pre-v2 logs — every consumer
    # (pert_report's "Model health" section) renders a placeholder then.
    fit_health = [{
        "step": ev.get("step"),
        "verdict": ev.get("verdict"),
        "reason": ev.get("reason"),
        "drift": ev.get("drift"),
        "rel_var": ev.get("rel_var"),
        "window": ev.get("window"),
        "grad_decay": ev.get("grad_decay"),
    } for ev in _of(events, "fit_health")]

    # the adaptive controller's audit trail (schema v3): one entry per
    # decision, plus the aggregate an A/B reader wants first — how many
    # iterations the controller reclaimed vs granted
    control = [{
        "step": ev.get("step"),
        "action": ev.get("action"),
        "iter": ev.get("iter"),
        "budget": ev.get("budget"),
        "trigger": ev.get("trigger"),
        "iters_saved": ev.get("iters_saved"),
        "iters_granted": ev.get("iters_granted"),
        "outcome": ev.get("outcome"),
        "detail": ev.get("detail"),
    } for ev in _of(events, "control_decision")]

    fits = [{
        "step": ev.get("step"),
        "iters": ev.get("iters"),
        "final_loss": ev.get("final_loss"),
        "converged": ev.get("converged"),
        "nan_abort": ev.get("nan_abort"),
        "wall_seconds": ev.get("wall_seconds"),
        "iters_per_second": ev.get("iters_per_second"),
        "num_cells": ev.get("num_cells"),
        "program_cache": ev.get("program_cache"),
        "diagnostics": ev.get("diagnostics"),
    } for ev in _of(events, "fit_end")]

    # the typed-metrics export (schema v5): snapshot count, the FINAL
    # (run_end) snapshot payload, and the per-phase HBM high-water trail
    # — all None/empty on pre-v5 logs, so every consumer (pert_report's
    # "Metrics" section, the fleet index) renders a placeholder then
    snaps = _of(events, "metrics_snapshot")
    hbm_by_phase = {}
    for ev in snaps:
        peak = _snapshot_hbm_max(ev.get("metrics") or {})
        if peak is not None:
            hbm_by_phase[str(ev.get("phase"))] = peak

    # causal spans (schema v8): per-name rollup of every span_end — the
    # "where the time went" table — plus the raw span list for timeline
    # consumers (tools/pert_trace exports from the events directly;
    # the summary keeps the rollup so reports need no second parse).
    # Both empty on pre-v8 / tracing-off logs.
    span_events = _of(events, "span_end")
    spans_by_name: dict = {}
    for ev in span_events:
        name = str(ev.get("name"))
        slot = spans_by_name.setdefault(name,
                                        {"count": 0, "seconds": 0.0})
        slot["count"] += 1
        slot["seconds"] = round(
            slot["seconds"] + float(ev.get("duration_seconds") or 0.0), 6)
    trace_ids = sorted({str(ev.get("trace_id")) for ev in span_events
                        if ev.get("trace_id")})

    # queue-wait (the queue-crossing span, surfaced on request_start):
    # joined onto the request_end rows below by request id
    queue_wait_by_request = {
        ev.get("request_id"): ev.get("queue_wait_seconds")
        for ev in _of(events, "request_start")
        if ev.get("queue_wait_seconds") is not None}

    return {
        "run_name": start.get("run_name"),
        # serve traffic (schema v7): per-request RunLogs carry the
        # request id in run_start; a worker-level log instead carries
        # the request lifecycle events below.  Both None/empty on
        # non-serve logs.
        "request_id": start.get("request_id"),
        "schema_version": start.get("schema_version"),
        "started_unix": start.get("started_unix"),
        "config_hash": start.get("config_hash"),
        "platform": start.get("platform"),
        "device_kind": start.get("device_kind"),
        "num_devices": start.get("num_devices"),
        "jax_version": start.get("jax_version"),
        "status": end.get("status") if end else "incomplete",
        "error": end.get("error") if end else None,
        "wall_seconds": end.get("wall_seconds") if end else None,
        "num_events": len(events),
        "phases": phases,
        "phase_total": round(sum(phases.values()), 4),
        "fits": fits,
        "compile": {
            "programs": len(compiles),
            "cache_hits": cache_hits,
            "cache_misses": cache_misses,
            # persistent AOT executable store (infer/aotcache.py):
            # programs deserialized from disk instead of compiled —
            # like a hit, they paid no XLA invocation
            "disk_hits": disk_hits,
            # over cacheable resolutions only: 'uncacheable' events
            # (unhashable loss closures) are neither hits nor misses
            # and would understate the rates.  Two distinct arms —
            # hit_rate counts true IN-PROCESS hits (free), no_xla_rate
            # adds disk hits (no XLA ran, but each paid its
            # deserialize wall — restart cost the meter books as
            # `compile_deserialize`, which a single rate used to hide)
            "hit_rate": (round(
                cache_hits
                / (cache_hits + disk_hits + cache_misses), 4)
                if cache_hits + disk_hits + cache_misses else None),
            "no_xla_rate": (round(
                (cache_hits + disk_hits)
                / (cache_hits + disk_hits + cache_misses), 4)
                if cache_hits + disk_hits + cache_misses else None),
            "trace_seconds": round(sum(
                float(ev.get("trace_seconds", 0.0)) for ev in compiles), 4),
            "compile_seconds": round(sum(
                float(ev.get("compile_seconds", 0.0))
                for ev in compiles), 4),
            "deserialize_seconds": round(sum(
                float(ev.get("deserialize_seconds", 0.0))
                for ev in compiles), 4),
            "peak_bytes_max": max(peak_bytes) if peak_bytes else None,
        },
        "fit_health": fit_health,
        "cell_qc": _of(events, "cell_qc_summary"),
        "control_decisions": control,
        "controller": {
            "decisions": len(control),
            "iters_saved": sum(int(d["iters_saved"] or 0)
                               for d in control),
            "iters_granted": sum(int(d["iters_granted"] or 0)
                                 for d in control),
            "actions": {a: sum(1 for d in control if d["action"] == a)
                        for a in sorted({d["action"] for d in control
                                         if d["action"]})},
        },
        "metrics": {
            "snapshots": len(snaps),
            "final": (snaps[-1].get("metrics") or None) if snaps else None,
            "hbm_by_phase": hbm_by_phase,
        },
        "requests": [{
            "request_id": ev.get("request_id"),
            "tenant": ev.get("tenant"),
            "status": ev.get("status"),
            "wall_seconds": ev.get("wall_seconds"),
            "queue_wait_seconds":
                queue_wait_by_request.get(ev.get("request_id")),
            "bucket": ev.get("bucket"),
            "compile_cache": ev.get("compile_cache"),
            "error_class": ev.get("error_class"),
        } for ev in _of(events, "request_end")],
        # the cost/goodput plane (schema v9, obs/meter.py): run_end's
        # attributed device-seconds + waste decomposition; None on
        # pre-v9 / unmetered logs
        "meter": end.get("meter") if end else None,
        # causal spans (schema v8, tracing-on runs only): rollup by
        # span name + the trace ids present; empty otherwise
        "spans": {
            "count": len(span_events),
            "by_name": spans_by_name,
            "trace_ids": trace_ids,
        },
        "trace_id": start.get("trace_id"),
        "rescues": _of(events, "rescue"),
        "nan_aborts": _of(events, "nan_abort"),
        "checkpoints": _of(events, "checkpoint"),
        # the durability trail (schema v4): fault injections, transient
        # retries, degradation-ladder rungs and resume decisions.  All
        # empty on pre-v4 logs — the report renders a placeholder then.
        "resilience": {
            "faults": _of(events, "fault_injected"),
            "retries": _of(events, "retry"),
            "degrades": _of(events, "degrade"),
            "resumes": _of(events, "resume"),
            "checkpoint_saves": sum(
                1 for ev in _of(events, "checkpoint")
                if ev.get("action") == "save"),
            "checkpoint_loads": sum(
                1 for ev in _of(events, "checkpoint")
                if ev.get("action") == "load"),
        },
    }


def summarize_run(path) -> Optional[dict]:
    """Summary dict for a run-log file; None when unreadable/empty."""
    try:
        events = read_events(path)
    except OSError:
        return None
    if not events:
        return None
    out = summarize_events(events)
    out["path"] = str(path)
    return out
