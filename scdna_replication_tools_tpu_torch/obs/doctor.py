"""Convergence doctor: classify an SVI fit's loss tail + gradient health.

Port of ``obs/doctor.py``, copied whole (pure stdlib).

The fit loop (infer/svi.py) stops on exactly two signals — the
reference's relative-tolerance window test or a NaN loss — and everything
else looks identical in the telemetry: a fit that oscillated around a
bad optimum, plateaued at a saddle, or burned its whole iteration budget
still mid-descent all report ``converged=False`` and nothing more.  This
module turns the loss trajectory (plus the diagnostics ring
buffer's sampled gradient norms) into a structured verdict:

* ``converged``   — the tail is flat and quiet (and, when gradient
  samples exist, the gradient norm has decayed);
* ``plateaued``   — the loss is flat but the optimiser is not at rest
  (gradient norm never decayed), or the fit was still descending when
  the iteration budget ran out — either way, more/better optimisation
  would change the answer;
* ``oscillating`` — the detrended tail variance is large relative to the
  fit's total improvement: the optimiser is bouncing, not settling
  (classic too-high-learning-rate signature);
* ``diverging``   — the loss is rising over the tail window, or went
  non-finite (NaN abort);
* ``unknown``     — too few samples to say anything.

All statistics are RELATIVE to the fit's total improvement
``|loss[0] - loss[-1]|`` — the same normalisation the reference's
convergence window uses (reference: pert_model.py:748-758) — so the
thresholds are scale-free across cohort sizes.  Pure stdlib (the inputs
are <=a few thousand floats, host-side, post-fit): the obs package stays
importable by the report tools without jax.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

DEFAULT_WINDOW = 16       # tail samples the classifier looks at
DEFAULT_SLOPE_TOL = 1e-4  # |relative drift across the window| below this = flat
DEFAULT_VAR_TOL = 1e-3    # relative detrended std above this = oscillating
DEFAULT_GRAD_RATIO = 0.1  # grad_last/grad_first below this = decayed

# the absolute floor of classifiable tails: a line fit through <= 2
# points is exact by construction (and sxx zero-divides at n=1), so any
# tail shorter than this is ``unknown`` regardless of the caller's
# stricter ``min_samples`` demand (the adaptive controller asks for a
# FULL window before acting — see obs/controller.py)
MIN_TAIL_SAMPLES = 3

VERDICTS = ("converged", "plateaued", "oscillating", "diverging", "unknown")


def tail_stats(losses: Sequence[float],
               window: int = DEFAULT_WINDOW,
               min_samples: int = MIN_TAIL_SAMPLES) -> Optional[dict]:
    """Least-squares statistics of the last ``window`` loss samples.

    Returns ``{finite, drift, rel_var, scale, n}`` where ``drift`` is the
    fitted linear change ACROSS the window divided by the fit's total
    improvement and ``rel_var`` the detrended residual std on the same
    scale; None when fewer than ``min_samples`` exist (nothing to fit —
    the floor is :data:`MIN_TAIL_SAMPLES` regardless of the argument).
    Non-finite tails short-circuit to ``finite=False`` — the numbers
    would be meaningless and the verdict is already decided.

    Short/partial tails are a first-class input here: the adaptive
    controller calls this on IN-FLIGHT trajectories (0, 1, ... samples),
    so every length down to the empty tail must return None rather than
    index out of range or divide by zero.
    """
    vals = [float(v) for v in losses]
    tail = vals[-int(window):] if window > 0 else vals
    n = len(tail)
    if n < max(int(min_samples), MIN_TAIL_SAMPLES):
        # fewer samples than the caller trusts (and never fewer than 3:
        # a line fit through <=2 points is exact by construction — and
        # sxx would zero-divide at n=1)
        return None
    if not all(math.isfinite(v) for v in tail):
        return {"finite": False, "drift": None, "rel_var": None,
                "scale": None, "n": n}
    # scale: the fit's TOTAL improvement, the reference's own convergence
    # normaliser — a flat-from-the-start trajectory falls back to the
    # loss MAGNITUDE, so zero improvement cannot zero-divide and float
    # ripple on a constant trajectory reads as ~1e-7-relative (quiet),
    # not amplified into a spurious drift
    scale = abs(vals[0] - vals[-1])
    mean = sum(tail) / n
    if scale <= 0.0:
        scale = max(abs(mean), 1e-12)
    xm = (n - 1) / 2.0
    sxx = sum((i - xm) ** 2 for i in range(n))
    sxy = sum((i - xm) * (y - mean) for i, y in enumerate(tail))
    slope = sxy / sxx
    resid = [y - (mean + slope * (i - xm)) for i, y in enumerate(tail)]
    resid_std = math.sqrt(sum(r * r for r in resid) / n)
    return {
        "finite": True,
        "drift": slope * (n - 1) / scale,
        "rel_var": resid_std / scale,
        "scale": scale,
        "n": n,
    }


def classify_loss_tail(losses: Sequence[float],
                       window: int = DEFAULT_WINDOW,
                       slope_tol: float = DEFAULT_SLOPE_TOL,
                       var_tol: float = DEFAULT_VAR_TOL,
                       min_samples: int = MIN_TAIL_SAMPLES):
    """(verdict, stats) from the loss trajectory alone.

    A flat-and-quiet tail classifies ``converged`` here;
    :func:`diagnose_fit` may demote it to ``plateaued`` when gradient
    samples show the optimiser never came to rest.  ``min_samples``
    raises the evidence bar: fewer tail samples than that returns
    ``unknown`` (the controller demands a FULL window before acting on
    a partial, in-flight trajectory).
    """
    stats = tail_stats(losses, window=window, min_samples=min_samples)
    if stats is None:
        return "unknown", None
    if not stats["finite"]:
        return "diverging", stats
    # oscillation when the noise DOMINATES the trend — tested BEFORE the
    # drift sign, because a pure alternation fits a small least-squares
    # slope whose sign depends only on window parity and must not read
    # as divergence.  A steeply descending tail with small residual
    # ripple is a budget problem (below), not a learning-rate problem.
    if stats["rel_var"] > var_tol and stats["rel_var"] >= abs(stats["drift"]):
        return "oscillating", stats
    if stats["drift"] > slope_tol:
        return "diverging", stats
    if stats["drift"] < -slope_tol:
        # still descending at the stop: the budget ended the fit, not the
        # objective — "plateaued" in the sense that the trajectory was
        # cut off before settling
        return "plateaued", stats
    # anything left has |drift| <= slope_tol and noise below the
    # oscillation rule above: flat and quiet
    return "converged", stats


def diagnose_fit(losses: Sequence[float],
                 converged: bool = False,
                 nan_abort: bool = False,
                 grad_norm_first: Optional[float] = None,
                 grad_norm_last: Optional[float] = None,
                 window: int = DEFAULT_WINDOW,
                 slope_tol: float = DEFAULT_SLOPE_TOL,
                 var_tol: float = DEFAULT_VAR_TOL,
                 grad_ratio: float = DEFAULT_GRAD_RATIO,
                 min_samples: int = MIN_TAIL_SAMPLES) -> dict:
    """Full fit-health verdict: loss-tail class + gradient-norm health.

    ``converged``/``nan_abort`` are the fit loop's own flags;
    ``grad_norm_first``/``grad_norm_last`` come from the diagnostics ring
    buffer when sampling was enabled (None otherwise).  Returns a dict
    with ``verdict`` (one of :data:`VERDICTS`), a human ``reason``, the
    tail statistics, and ``grad_decay`` = last/first gradient norm.

    Safe on partial, in-flight tails: any trajectory shorter than
    ``min_samples`` (including the empty one) reads ``unknown`` — the
    adaptive controller calls this between fit chunks and passes its
    full window length here so it never acts on thin evidence.
    """
    grad_decay = None
    if grad_norm_first and grad_norm_last is not None \
            and math.isfinite(grad_norm_first) \
            and math.isfinite(grad_norm_last) and grad_norm_first > 0:
        grad_decay = grad_norm_last / grad_norm_first

    verdict, stats = classify_loss_tail(losses, window=window,
                                        slope_tol=slope_tol,
                                        var_tol=var_tol,
                                        min_samples=min_samples)
    out = {
        "verdict": verdict,
        "reason": "",
        "drift": None if stats is None else stats["drift"],
        "rel_var": None if stats is None else stats["rel_var"],
        "window": 0 if stats is None else stats["n"],
        "grad_decay": grad_decay,
    }
    if nan_abort or (stats is not None and not stats["finite"]):
        out["verdict"] = "diverging"
        out["reason"] = ("loss went non-finite (NaN abort) — see the "
                         "nan_abort event's loss tail")
        return out
    if verdict == "unknown":
        out["reason"] = "too few loss samples to classify"
        return out
    if verdict == "diverging":
        out["reason"] = "loss rising over the tail window"
        return out
    if verdict == "oscillating":
        out["reason"] = ("loss oscillating: detrended tail variance "
                         "exceeds var_tol — consider a lower learning "
                         "rate")
        return out
    if verdict == "plateaued":
        out["reason"] = ("loss still descending when the iteration "
                         "budget ran out — raise max_iter")
        return out
    # flat & quiet: converged unless the gradient norm says otherwise
    if converged:
        out["reason"] = "relative-tolerance convergence criterion fired"
        return out
    if grad_decay is not None and grad_decay > grad_ratio:
        out["verdict"] = "plateaued"
        out["reason"] = (f"loss flat but the gradient norm has not "
                         f"decayed (last/first = {grad_decay:.3g} > "
                         f"{grad_ratio:g}) — stalled optimisation or "
                         f"saddle")
        return out
    out["reason"] = "loss tail flat and quiet"
    return out
