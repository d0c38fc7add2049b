"""Deterministic typed metrics registry: counters, gauges, fixed-bucket
histograms (port of ``obs/metrics.py``).

The run log (``obs/runlog.py``) records *what happened* as an event
stream; this registry turns the same signals into quantities a run can
be trended by.  It is exported two ways:

* a ``metrics_snapshot`` run-log event at phase boundaries plus a final
  one at ``run_end``, carrying only the metrics the catalogue marks
  ``stable`` (byte-identical across same-seed reruns);
* an optional Prometheus text-exposition file
  (``PertConfig.metrics_textfile``), written atomically on every
  snapshot.

Every metric name, type, label set and histogram bucket edge is pinned
by the port's copy of the catalogue (``obs/metrics_manifest.json``,
byte-identical to the JAX package's); an unknown name warns once and
still records.  The active registry is a thread-local seam
(:func:`install` / :func:`current`): the run log's emit hook and the
PhaseTimer sink resolve it at call time and no-op against the null
registry when no run is active.  Recording never raises.

Taken from the JAX module: the registry, its event mapping for the
events the port emits (``compile``, ``fit_end``, ``control_decision``,
``rescue``, ``nan_abort`` and the durable runs' ``fault_injected``,
``retry``, ``degrade``, ``resume`` and ``checkpoint``), the snapshot and
exposition exports, and the seams.  Device memory is read from ``torch.cuda.memory_stats``
(current and peak allocated bytes) under the catalogue's HBM names.
Left for the items that own them: the mesh-shrink counter (A12), the
event mappings of the serving events (A13) and the regression verdict of
the fleet tools.
"""

from __future__ import annotations

import functools
import json
import math
import os
import pathlib
import threading
from typing import Dict, List, Optional, Tuple

from scdna_replication_tools_tpu_torch.utils.fileio import atomic_write_bytes
from scdna_replication_tools_tpu_torch.utils.profiling import logger

_MANIFEST_PATH = pathlib.Path(__file__).parent / "metrics_manifest.json"

# bucket edges for histograms the manifest does not declare (unknown
# metrics still record; their snapshots are as stable as these edges)
_DEFAULT_BUCKETS = (0.01, 0.1, 1.0, 10.0, 60.0, 600.0)


@functools.lru_cache(maxsize=1)
def load_manifest() -> dict:
    """The checked-in metric catalogue; {} when unreadable (the registry
    then treats every name as unknown — a warning, never a crash)."""
    try:
        return json.loads(_MANIFEST_PATH.read_text())
    except (OSError, ValueError):
        return {}


def manifest_metrics() -> dict:
    """``name -> spec`` dict from the manifest ({} when unreadable)."""
    return load_manifest().get("metrics", {})


def metric_base_name(series_key: str) -> str:
    """Manifest name of a flat series key: strip labels and the
    histogram ``_count`` suffix."""
    name = series_key.split("{", 1)[0]
    if name.endswith("_count") and name[:-6] in manifest_metrics():
        return name[:-6]
    return name


def _labels_key(labels: Optional[dict]) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return ()
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _series_name(name: str, lk: Tuple[Tuple[str, str], ...]) -> str:
    """Canonical flat series key: ``name`` or ``name{k="v",...}`` with
    label keys sorted — the same string in snapshots, the fleet index
    and the Prometheus exposition, so every consumer joins on it."""
    if not lk:
        return name
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in lk)
    return f"{name}{{{inner}}}"


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", r"\\").replace('"', r'\"')
            .replace("\n", r"\n"))


def _round6(value: float):
    """Snapshot/exposition float policy: 6 decimals, ints stay ints —
    repr drift (0.30000000000000004) must not break byte-stability."""
    if isinstance(value, bool):
        return int(value)
    if isinstance(value, int):
        return value
    v = round(float(value), 6)
    return int(v) if v == int(v) and abs(v) < 1e15 else v


# one lock for every series mutation in the process: read-modify-write
# on a counter must not lose updates from another thread.
_MUTATE_LOCK = threading.Lock()


class _Series:
    """One (name, labels) series: the handle ``counter()``/``gauge()``/
    ``histogram()`` return."""

    __slots__ = ("kind", "value", "buckets", "counts", "sum", "count")

    def __init__(self, kind: str, buckets=None):
        self.kind = kind
        self.value = 0 if kind == "counter" else None
        if kind == "histogram":
            self.buckets = tuple(float(b) for b in (buckets
                                                    or _DEFAULT_BUCKETS))
            self.counts = [0] * (len(self.buckets) + 1)  # +1 = +Inf
            self.sum = 0.0
            self.count = 0

    def inc(self, amount=1) -> None:
        with _MUTATE_LOCK:
            self.value = (self.value or 0) + amount

    def set(self, value) -> None:
        self.value = value

    def set_max(self, value) -> None:
        with _MUTATE_LOCK:
            if self.value is None or value > self.value:
                self.value = value

    def observe(self, value) -> None:
        value = float(value)
        if math.isnan(value):
            return
        with _MUTATE_LOCK:
            self.sum += value
            self.count += 1
            for i, edge in enumerate(self.buckets):
                if value <= edge:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1


class _NullSeries:
    """Swallows every mutation — what the null registry hands out."""

    value = None

    def inc(self, amount=1) -> None:
        pass

    def set(self, value) -> None:
        pass

    def set_max(self, value) -> None:
        pass

    def observe(self, value) -> None:
        pass


_NULL_SERIES = _NullSeries()


class MetricsRegistry:
    """Per-run metrics registry (see module docstring).

    Deterministic by construction: no timestamps, no randomness;
    snapshot ordering is sorted series keys; floats are rounded to a
    fixed precision.  ``textfile_path`` (optional) is where
    :meth:`write_textfile` lands the Prometheus exposition.
    """

    enabled = True

    def __init__(self, textfile_path: Optional[str] = None):
        self.textfile_path = str(textfile_path) if textfile_path else None
        self._series: Dict[Tuple[str, tuple], _Series] = {}
        self._warned: set = set()
        self._manifest = manifest_metrics()

    @classmethod
    def create(cls, textfile_path: Optional[str] = None
               ) -> "MetricsRegistry":
        return cls(textfile_path=textfile_path)

    # -- series access ----------------------------------------------------

    def _get(self, name: str, kind: str, labels: Optional[dict]):
        spec = self._manifest.get(name)
        if spec is None:
            if name not in self._warned:
                self._warned.add(name)
                logger.warning(
                    "metrics: %r is not in obs/metrics_manifest.json — "
                    "recording anyway, but register it (name, type, "
                    "labels, buckets) so snapshots know about it", name)
        elif spec.get("type") != kind and name not in self._warned:
            self._warned.add(name)
            logger.warning(
                "metrics: %r is declared %r in the manifest but used as "
                "%r at a call site", name, spec.get("type"), kind)
        key = (name, _labels_key(labels))
        series = self._series.get(key)
        if series is None:
            with _MUTATE_LOCK:
                series = self._series.get(key)
                if series is None:
                    buckets = (spec or {}).get("buckets")
                    series = _Series(kind, buckets=buckets)
                    self._series[key] = series
        return series

    def counter(self, name: str, labels: Optional[dict] = None) -> _Series:
        return self._get(name, "counter", labels)

    def gauge(self, name: str, labels: Optional[dict] = None) -> _Series:
        return self._get(name, "gauge", labels)

    def histogram(self, name: str, labels: Optional[dict] = None
                  ) -> _Series:
        return self._get(name, "histogram", labels)

    def observe(self, name: str, value, labels: Optional[dict] = None
                ) -> None:
        """Histogram shorthand: ``observe(name, v)``."""
        self.histogram(name, labels=labels).observe(value)

    def observe_phase(self, name: str, seconds: float) -> None:
        """The PhaseTimer ``on_add`` sink target (see
        :func:`attach_phase_sink`)."""
        try:
            self.counter("pert_phase_seconds_total",
                         labels={"phase": name}).inc(float(seconds))
        except Exception:  # noqa: BLE001 — the sink rides inside
            # PhaseTimer.add on every phase exit; a malformed seconds
            # value must cost nothing (the timer still records the phase)
            pass

    # -- instrumentation seams -------------------------------------------

    def record_event(self, event: str, payload: dict) -> None:
        """RunLog emit hook: map the event stream onto the catalogue.

        Runs BEFORE the log's enable/session gating, so a telemetry-off
        run still counts — metrics do not depend on the JSONL existing.
        Never raises.
        """
        try:
            self._record_event(event, payload)
        except Exception as exc:  # noqa: BLE001 — a malformed payload
            # must not break the emit path it rides on
            logger.debug("metrics: record_event(%s) failed: %s", event,
                         exc)

    def _record_event(self, event: str, payload: dict) -> None:
        self.counter("pert_runlog_events_total").inc()
        if event == "compile":
            # the port's compile is the nvcc build of a kernel source
            # (ops/_cuda.py): a miss ran nvcc, a disk hit loaded a
            # library built before, a hit found it loaded already
            cache = payload.get("cache")
            if cache == "hit":
                self.counter("pert_compile_cache_hits_total").inc()
            elif cache == "disk_hit":
                self.counter("pert_aot_disk_hits_total").inc()
                if payload.get("deserialize_seconds") is not None:
                    self.observe("pert_aot_deserialize_seconds",
                                 payload["deserialize_seconds"])
            else:
                self.counter("pert_compile_cache_misses_total").inc()
                if payload.get("compile_seconds") is not None:
                    self.observe("pert_compile_seconds",
                                 payload["compile_seconds"])
        elif event == "fit_end":
            step = str(payload.get("step"))
            seg = int(payload.get("iters") or 0) \
                - int(payload.get("resumed_from_iter") or 0)
            seg = max(seg, 0)
            self.counter("pert_fit_iters_total",
                         labels={"step": step}).inc(seg)
            self.observe("pert_fit_iters", seg)
            if payload.get("wall_seconds") is not None:
                self.gauge("pert_fit_wall_seconds",
                           labels={"step": step}).set(
                    float(payload["wall_seconds"]))
            if payload.get("iters_per_second") is not None:
                self.gauge("pert_fit_iters_per_second",
                           labels={"step": step}).set(
                    float(payload["iters_per_second"]))
            if payload.get("wall_seconds") is not None and seg > 0:
                self.gauge("pert_fit_ms_per_iter",
                           labels={"step": step}).set(
                    1000.0 * float(payload["wall_seconds"]) / seg)
        elif event == "control_decision":
            action = payload.get("action")
            if action:
                self.counter("pert_controller_actions_total",
                             labels={"action": str(action)}).inc()
            if payload.get("iters_saved"):
                self.counter("pert_controller_iters_saved_total").inc(
                    int(payload["iters_saved"]))
            if payload.get("iters_granted"):
                self.counter("pert_controller_iters_granted_total").inc(
                    int(payload["iters_granted"]))
        elif event == "fault_injected":
            self.counter("pert_faults_injected_total",
                         labels={"kind": str(payload.get("kind"))}).inc()
        elif event == "retry":
            self.counter("pert_retries_total").inc()
        elif event == "degrade":
            self.counter("pert_degrades_total",
                         labels={"action": str(payload.get("action"))}
                         ).inc()
        elif event == "resume":
            if payload.get("resharded"):
                self.counter("pert_resume_reshard_total").inc()
        elif event == "checkpoint":
            if payload.get("action") == "save":
                self.counter("pert_checkpoint_saves_total").inc()
            elif payload.get("action") == "load":
                self.counter("pert_checkpoint_loads_total").inc()
        elif event == "rescue":
            self.counter("pert_rescue_candidates_total").inc(
                int(payload.get("candidates") or 0))
            self.counter("pert_rescue_accepted_total").inc(
                int(payload.get("accepted") or 0))
        elif event == "nan_abort":
            self.counter("pert_nan_aborts_total").inc()

    def sample_device_memory(self) -> None:
        """Per-device memory gauges from ``torch.cuda.memory_stats``
        (current and peak allocated bytes) of every CUDA device this
        process has initialised; records nothing on a CPU run, as the
        JAX registry records nothing where a backend has no stats."""
        try:
            import torch

            if not (torch.cuda.is_available()
                    and torch.cuda.is_initialized()):
                return
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                if not stats:
                    continue
                label = {"device": str(i)}
                peak = stats.get("allocated_bytes.all.peak")
                if peak is not None:
                    self.gauge("pert_device_hbm_peak_bytes",
                               labels=label).set_max(int(peak))
                in_use = stats.get("allocated_bytes.all.current")
                if in_use is not None:
                    self.gauge("pert_device_hbm_bytes_in_use",
                               labels=label).set(int(in_use))
        except Exception as exc:  # noqa: BLE001 — a failed sample leaves
            # the gauges unset; the run it measures goes on
            logger.debug("metrics: device memory sample failed: %s", exc)

    # -- export -----------------------------------------------------------

    def _sorted_series(self) -> List[Tuple[str, str, _Series]]:
        out = []
        for (name, lk), series in self._series.items():
            out.append((_series_name(name, lk), name, series))
        return sorted(out, key=lambda t: t[0])

    def snapshot(self, stable_only: bool = True) -> dict:
        """``{series_key: payload}`` in sorted-key order.

        ``stable_only`` (the ``metrics_snapshot`` event default) keeps
        only metrics the manifest marks ``stable`` — the quantities that
        are byte-identical across same-seed reruns — plus metrics whose
        manifest entry sets ``"snapshot": "always"`` (opt-in diagnostic
        surfaces).  Unknown metrics count as unstable (nothing
        vouches for them).  Counter/gauge payloads are ``{"type",
        "value"}``; histograms carry per-bin ``buckets`` counts
        (manifest edges + overflow), ``count`` and ``sum``.
        """
        snap: dict = {}
        for key, name, series in self._sorted_series():
            spec = self._manifest.get(name) or {}
            if stable_only and not (spec.get("stable", False)
                                    or spec.get("snapshot") == "always"):
                continue
            if series.kind == "histogram":
                snap[key] = {"type": "histogram",
                             "buckets": list(series.counts),
                             "count": int(series.count),
                             "sum": _round6(series.sum)}
            else:
                if series.value is None:
                    continue
                snap[key] = {"type": series.kind,
                             "value": _round6(series.value)}
        return snap

    def to_prometheus_text(self) -> str:
        """The full registry (stable + wall-clock metrics) in Prometheus
        text exposition format, one HELP/TYPE block per metric name."""
        by_name: Dict[str, List[Tuple[tuple, _Series]]] = {}
        for (name, lk), series in self._series.items():
            by_name.setdefault(name, []).append((lk, series))
        lines: List[str] = []
        for name in sorted(by_name):
            spec = self._manifest.get(name, {})
            help_text = str(spec.get("help", "")).replace("\\", r"\\") \
                .replace("\n", r"\n")
            kind = by_name[name][0][1].kind
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} {kind}")
            for lk, series in sorted(by_name[name], key=lambda t: t[0]):
                if series.kind == "histogram":
                    cum = 0
                    for edge, count in zip(series.buckets, series.counts):
                        cum += count
                        lbl = lk + (("le", f"{edge:g}"),)
                        lines.append(f"{_series_name(name + '_bucket', lbl)}"
                                     f" {cum}")
                    cum += series.counts[-1]
                    lbl = lk + (("le", "+Inf"),)
                    lines.append(f"{_series_name(name + '_bucket', lbl)} "
                                 f"{cum}")
                    lines.append(f"{_series_name(name + '_sum', lk)} "
                                 f"{_round6(series.sum)}")
                    lines.append(f"{_series_name(name + '_count', lk)} "
                                 f"{series.count}")
                elif series.value is not None:
                    lines.append(f"{_series_name(name, lk)} "
                                 f"{_round6(series.value)}")
        return "\n".join(lines) + "\n"

    def write_textfile(self, path: Optional[str] = None) -> Optional[str]:
        """Atomically write the Prometheus exposition to ``path`` (or
        the registry's configured ``textfile_path``).

        Write-temp + ``os.replace`` in the destination directory, so a
        concurrent scraper never reads a torn file — the node-exporter
        textfile-collector contract.  Never raises; returns the path
        written or None.
        """
        path = path or self.textfile_path
        if not path:
            return None
        try:
            path = os.path.abspath(path)
            atomic_write_bytes(path, self.to_prometheus_text().encode())
            return path
        except OSError as exc:
            if "textfile" not in self._warned:
                self._warned.add("textfile")
                logger.warning("metrics: cannot write textfile %s (%s)",
                               path, exc)
            return None

    def emit_snapshot(self, run_log, phase: str) -> None:
        """One phase-boundary export: sample device memory, emit the
        ``metrics_snapshot`` event (stable metrics only — the event must
        be byte-stable across same-seed reruns), refresh the textfile.
        Never raises."""
        try:
            self.sample_device_memory()
            run_log.emit("metrics_snapshot", phase=str(phase),
                         metrics=self.snapshot())
            self.write_textfile()
        except Exception as exc:  # noqa: BLE001 — the export is
            # best-effort by contract; the run it measures must proceed
            logger.debug("metrics: snapshot at %s failed: %s", phase, exc)


class _NullRegistry:
    """Accepts every call as a no-op — :func:`current` outside a run."""

    enabled = False
    textfile_path = None

    def counter(self, name, labels=None):
        return _NULL_SERIES

    gauge = counter
    histogram = counter

    def observe(self, name, value, labels=None):
        pass

    def observe_phase(self, name, seconds):
        pass

    def record_event(self, event, payload):
        pass

    def sample_device_memory(self):
        pass

    def snapshot(self, stable_only=True):
        return {}

    def to_prometheus_text(self):
        return ""

    def write_textfile(self, path=None):
        return None

    def emit_snapshot(self, run_log, phase):
        pass


_NULL = _NullRegistry()

# the active-registry seam is THREAD-LOCAL, like the RunLog stack: an
# install scopes the installing thread only.
_TLS = threading.local()


def install(registry: Optional[MetricsRegistry]) -> None:
    """Install (or clear, with None) this THREAD's active registry.

    A seam on purpose, like :func:`obs.runlog.current`: the
    instrumented layers (the RunLog emit hook, the PhaseTimer sink)
    have no config plumbing.  The newest run's registry wins.
    """
    _TLS.active = registry


def uninstall(registry) -> None:
    """Clear the active registry — but only if it is still ``registry``
    (a newer run's install must not be clobbered by an older run's
    cleanup)."""
    if getattr(_TLS, "active", None) is registry:
        _TLS.active = None


def current():
    """This thread's active registry, or the null no-op instance."""
    active = getattr(_TLS, "active", None)
    return active if active is not None else _NULL


def attach_phase_sink(timer, registry: Optional[MetricsRegistry] = None
                      ) -> None:
    """Attach (or re-scope) THE metrics sink of a PhaseTimer.

    ``registry`` pins the sink to ONE registry: the timer feeds that
    run's registry whatever the seam points at when the phase closes.
    Without it the sink resolves
    :func:`current` at call time (so it can be attached before any
    registry exists).  The sink forwards to whatever ``on_add`` was
    already installed — co-existing with the RunLog's session sink
    regardless of attach order.

    ONE metrics sink per timer, wherever it sits in the chain: the
    sink reads its registry from a mutable cell, and a re-attach
    (same or different registry) re-scopes that cell IN PLACE instead
    of stacking a second sink, which would double-feed two registries.
    """
    existing = getattr(timer, "_pert_metrics_sink_fn", None)
    if existing is not None:
        existing._pert_registry_cell[0] = registry
        return
    prev = getattr(timer, "on_add", None)
    cell = [registry]

    def _sink(name, seconds):
        reg = cell[0] if cell[0] is not None else current()
        reg.observe_phase(name, seconds)
        if prev is not None:
            prev(name, seconds)

    _sink._pert_metrics_sink = True
    _sink._pert_registry_cell = cell
    timer._pert_metrics_sink_fn = _sink
    timer.on_add = _sink
