"""Phase timing and the package logger (port of ``utils/profiling.py``).

Taken: :class:`PhaseTimer` with its ``on_add`` sink chain, ``logger``,
:func:`stable_user`, :func:`probe_writable_dir` and
:func:`log_step_summary`.  Left out: the JAX package's persistent XLA
compilation cache (``resolve_compile_cache_dir`` /
``enable_persistent_compile_cache``; the port caches its nvcc builds in
``ops/_cuda.py``) and ``trace`` (``jax.profiler``; ROADMAP A11b).
"""

from __future__ import annotations

import contextlib
import logging
import os
import pathlib
import time

logger = logging.getLogger("scdna_replication_tools_tpu_torch")


class PhaseTimer:
    """Flat accumulator of named wall-clock phases.

    Phases accumulate (re-entering a name adds to it) and stay FLAT:
    callers keep phases non-overlapping so ``report()``'s total is the
    sum of accounted wall time.  Overlapping ``phase()`` contexts would
    double-count, so the timer warns once per instance when it sees one.

    ``on_add`` (optional callable ``(name, seconds)``) observes every
    accumulation: the run log streams ``phase`` events through it
    (``obs/runlog.py``) and the metrics registry counts phase seconds
    (``obs.metrics.attach_phase_sink``).  Sinks CHAIN: each wraps
    whatever was installed before it.
    """

    def __init__(self):
        self.phases: dict = {}
        self.on_add = None
        self._depth = 0
        self._overlap_warned = False

    @contextlib.contextmanager
    def phase(self, name: str):
        if self._depth > 0 and not self._overlap_warned:
            self._overlap_warned = True
            logger.warning(
                "PhaseTimer: phase(%r) entered while another phase is "
                "still open — overlapping phases double-count wall; keep "
                "phases flat (further overlaps will not be re-reported)",
                name)
        self._depth += 1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._depth -= 1
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.phases[name] = self.phases.get(name, 0.0) + float(seconds)
        if self.on_add is not None:
            self.on_add(name, float(seconds))

    def total(self) -> float:
        return float(sum(self.phases.values()))

    def report(self, ndigits: int = 4) -> dict:
        """JSON-ready ``{phase: seconds}`` dict plus the accounted total."""
        out = {k: round(v, ndigits) for k, v in sorted(self.phases.items())}
        out["total_accounted"] = round(self.total(), ndigits)
        return out


def stable_user() -> str:
    """Per-user discriminator for shared-host tmp paths, stable across
    runs (never the pid)."""
    import getpass

    try:
        return getpass.getuser()
    except (KeyError, OSError):
        return os.environ.get("USER") or "user"


def probe_writable_dir(path) -> bool:
    """mkdir -p + write-probe; True when ``path`` is usable.  Never
    raises: callers fall back (or disable) instead of aborting a run
    over an unwritable observability location."""
    try:
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        probe = path / ".write_probe"
        probe.touch()
        probe.unlink()
        return True
    except OSError:
        return False


def log_step_summary(step_name: str, fit, wall_time: float,
                     num_cells: int) -> None:
    """One INFO line per step fit: wall time, iterations, throughput and
    the stop flags."""
    iters = max(fit.num_iters, 1)
    logger.info(
        "%s: %d iters in %.2fs (%.1f iters/s, %.0f cells/s), "
        "final loss %.6g, converged=%s nan_abort=%s",
        step_name, fit.num_iters, wall_time, iters / max(wall_time, 1e-9),
        num_cells * iters / max(wall_time, 1e-9),
        float(fit.losses[-1]) if len(fit.losses) else float("nan"),
        fit.converged, fit.nan_abort)
