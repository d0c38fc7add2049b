"""Adaptive fit controller: the policy that closes observability -> control.

Port of ``obs/controller.py``, copied whole: pure stdlib (the signals
arrive as host floats), so it carries no device code.  The fit reads
its flight recorder -- the loss history and the diagnostics ring buffer
of ``infer/svi.py`` -- once per chunk of iterations, and between chunks
hands those signals to :func:`evaluate`, which maps them to one of the
adaptive actions:

* ``early_stop`` -- the doctor reads the partial tail as ``converged``
  (flat, quiet, gradient at rest), OR the best loss has stagnated: its
  improvement over the last ``stop_patience`` iterations fell below
  ``stop_ftol`` of the fit's total improvement.  Stop now and reclaim
  the remaining budget (the strict reference rel-tol criterion almost
  never fires inside the fixed budgets; the stagnation rule is the
  spike-robust form, because on PERT's noisy tails the gradient never
  fully decays and transient loss spikes would poison a pure
  tail-flatness test);
* ``extend``     -- the budget ran out while the doctor reads
  ``plateaued`` (still descending, or flat with an undecayed gradient
  norm): grant more iterations, up to ``max_extra_iters`` total;
* ``reseed``     -- ``oscillating``/``diverging`` on two CONSECUTIVE
  evaluations (a transient loss spike poisons one doctor window and is
  gone by the next chunk; re-seeding is for instability that persists):
  perturb from the best-loss checkpoint and restart the optimiser
  state;
* ``escalate``   -- a NaN-poisoned chunk: retry once from the best state
  at a reduced learning rate, then abort.

Two further actions are decided at the step level (``infer/runner.py``)
with the same event vocabulary: ``rescue`` / ``rescue_skip`` gate the
post-step-2 mirror rescue on boundary-tau + high-entropy QC signals
instead of running it unconditionally.

Every decision is a plain dict, recorded on ``FitResult.decisions`` and
emitted as a ``control_decision`` event through the runner's run log:
same seed + same config produce the same decision sequence.  The
mechanism that applies decisions to device state lives in
``infer/svi.py``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

from scdna_replication_tools_tpu_torch.obs import doctor as _doctor

# the event vocabulary of control_decision.action — MUST match the enum
# in the JAX package's run-log schema (obs/runlog_schema.json)
ACTIONS = ("early_stop", "extend", "reseed", "escalate",
           "rescue", "rescue_skip")


@dataclasses.dataclass(frozen=True)
class ControllerPolicy:
    """Knobs of the in-fit decision policy (from ``PertConfig``).

    ``max_extra_iters`` bounds the TOTAL extension a fit can be granted
    beyond its configured budget; ``extend_step`` is the grant per
    decision (the controller re-evaluates at the new exhaustion point).
    ``stop_patience``/``stop_ftol`` drive the best-loss stagnation stop:
    early-stop once the best loss improved by less than ``stop_ftol`` of
    the fit's total improvement over the last ``stop_patience``
    iterations (``stop_patience=0`` disables the rule, leaving only the
    doctor's tail-flatness trigger).
    ``window``/``slope_tol``/``var_tol``/``grad_ratio`` are the
    convergence-doctor thresholds (``PertConfig.doctor_*``) — the
    controller acts only when a FULL window of loss samples exists, so
    thin early evidence reads ``unknown`` and triggers nothing.
    """

    max_extra_iters: int = 0
    extend_step: int = 50
    max_reseeds: int = 1
    reseed_scale: float = 0.02
    nan_lr_factor: float = 0.1
    max_nan_retries: int = 1
    seed: int = 0
    stop_patience: int = 50
    stop_ftol: float = 3e-3
    window: int = _doctor.DEFAULT_WINDOW
    slope_tol: float = _doctor.DEFAULT_SLOPE_TOL
    var_tol: float = _doctor.DEFAULT_VAR_TOL
    grad_ratio: float = _doctor.DEFAULT_GRAD_RATIO

    @classmethod
    def from_config(cls, cfg, max_iter: int) -> "ControllerPolicy":
        """Policy for one fit from a ``PertConfig``.

        ``controller_max_extra_iters=None`` resolves to half the fit's
        own budget, so the extension headroom scales with the workload
        the way the step-1/3 budgets scale with step 2's.
        """
        extra = cfg.controller_max_extra_iters
        if extra is None:
            extra = int(max_iter) // 2
        return cls(
            max_extra_iters=int(extra),
            extend_step=int(cfg.controller_extend_step),
            max_reseeds=int(cfg.controller_max_reseeds),
            reseed_scale=float(cfg.controller_reseed_scale),
            nan_lr_factor=float(cfg.controller_nan_lr_factor),
            seed=int(cfg.seed),
            stop_patience=int(cfg.controller_stop_patience),
            stop_ftol=float(cfg.controller_stop_ftol),
            window=int(cfg.doctor_window),
            slope_tol=float(cfg.doctor_slope_tol),
            var_tol=float(cfg.doctor_var_tol),
            grad_ratio=float(cfg.doctor_grad_ratio),
        )

    def thresholds(self) -> dict:
        """The threshold set every decision event carries — an auditor
        must be able to re-derive the verdict from the artifact alone."""
        return {
            "window": self.window,
            "slope_tol": self.slope_tol,
            "var_tol": self.var_tol,
            "grad_ratio": self.grad_ratio,
            "stop_patience": self.stop_patience,
            "stop_ftol": self.stop_ftol,
            "max_extra_iters": self.max_extra_iters,
            "extend_step": self.extend_step,
            "max_reseeds": self.max_reseeds,
            "nan_lr_factor": self.nan_lr_factor,
        }


def _round(value, nd: int = 6):
    """Stable float rounding for the decision events (byte-identical
    re-runs must serialize identically; non-finite → None for JSON)."""
    if value is None:
        return None
    value = float(value)
    if value != value or value in (float("inf"), float("-inf")):
        return None
    return round(value, nd)


def _stagnation(policy: ControllerPolicy,
                losses: Sequence[float],
                start: int = 0) -> Optional[dict]:
    """Best-loss stagnation signal, or None while still improving.

    The doctor's tail-flatness ``converged`` almost never fires on
    PERT's noisy trajectories (the gradient sits at a noise floor and
    transient loss spikes poison any flatness test), so the stop
    trigger that actually reclaims budget is the classic spike-robust
    form: the BEST loss seen — a monotone series, immune to spikes —
    improved by less than ``stop_ftol`` of the fit's total improvement
    over the last ``stop_patience`` iterations.

    ``start`` anchors the horizon: a reseed (or NaN retry) begins a new
    trajectory regime at iteration ``start``, and measuring stagnation
    across that boundary would cancel the restart one evaluation later
    — the pre-restart global best is usually still unbeaten, which
    reads as zero improvement regardless of how fast the new
    trajectory is descending.  The restarted segment gets a full
    ``stop_patience`` of runway on its own terms.
    """
    patience = int(policy.stop_patience)
    losses = losses[int(start):]
    if patience <= 0 or len(losses) <= patience:
        return None
    vals = [float(v) for v in losses]
    if not all(math.isfinite(v) for v in vals):
        return None  # the NaN escalation path owns poisoned tails
    best_now = min(vals)
    best_before = min(vals[:-patience])
    total = vals[0] - best_now
    if total <= 0:
        return None  # never improved at all — not convergence
    rel_improvement = (best_before - best_now) / total
    if rel_improvement >= policy.stop_ftol:
        return None
    return {
        "verdict": "converged",
        "reason": (f"best loss stagnant: improved "
                   f"{rel_improvement:.2e} (rel) over the last "
                   f"{patience} iters, below stop_ftol"
                   f"={policy.stop_ftol:g}"),
        "best_loss": _round(best_now),
        "rel_improvement": _round(rel_improvement, 9),
        "patience": patience,
    }


def _trigger(report: dict, loss_last) -> dict:
    """The signal snapshot a decision was made on."""
    return {
        "verdict": report["verdict"],
        "reason": report["reason"],
        "drift": _round(report.get("drift")),
        "rel_var": _round(report.get("rel_var")),
        "grad_decay": _round(report.get("grad_decay")),
        "window": int(report.get("window") or 0),
        "loss": _round(loss_last),
    }


def evaluate(policy: ControllerPolicy, *,
             losses: Sequence[float],
             it: int,
             budget: int,
             min_iter: int,
             grad_norm_first: Optional[float] = None,
             grad_norm_last: Optional[float] = None,
             nan: bool = False,
             exhausted: bool = False,
             reseeds_done: int = 0,
             extra_granted: int = 0,
             nan_retries_done: int = 0,
             prev_verdict: Optional[str] = None,
             stagnation_start: int = 0):
    """One ``(decision, verdict)`` from the flight-recorder signals.

    Called by the chunked fit loop (``infer/svi.py``) after every
    chunk (``exhausted=False``, mid-fit) and once more when the budget
    runs out without the stop criterion firing (``exhausted=True``).
    ``losses`` is the host-visible partial trajectory ``losses[:it]``;
    the gradient norms come from the diagnostics ring-buffer tail.
    ``decision`` is None when no action is warranted; ``verdict`` is
    the doctor's read of the partial tail either way — the fit loop
    feeds it back as ``prev_verdict`` on the next evaluation, which is
    how the re-seed PERSISTENCE gate sees across chunks.
    ``stagnation_start`` is the iteration the current trajectory regime
    began at (0, or the last reseed / NaN-retry restart) — the
    stagnation stop measures only within the current regime, giving a
    restart its full ``stop_patience`` of runway (see
    :func:`_stagnation`).

    Deterministic and side-effect free: the same signals always produce
    the same decision dict, which the caller emits verbatim as a
    ``control_decision`` event.
    """
    if nan:
        # NaN escalation path: policy here, mechanism (the LR-reduced
        # retry) in the fit loop.  outcome='abort' is still a
        # logged decision — the artifact must show the controller SAW
        # the poisoned fit and chose to stop retrying.
        retry = nan_retries_done < policy.max_nan_retries
        return {
            "action": "escalate",
            "iter": int(it),
            "budget": int(budget),
            "trigger": {"verdict": "diverging",
                        "reason": "loss went non-finite (NaN) in the "
                                  "last chunk",
                        "nan": True},
            "thresholds": policy.thresholds(),
            "outcome": "retry" if retry else "abort",
            "detail": ("retry from the best checkpoint at "
                       f"lr x {policy.nan_lr_factor:g}" if retry else
                       "NaN retry budget exhausted — aborting with the "
                       "checkpointed artifact"),
        }, "diverging"

    # evidence bar: never act before the reference's own min_iter, and
    # never on less than a full doctor window of samples
    if it < max(int(min_iter), 1) or len(losses) < policy.window:
        return None, None

    report = _doctor.diagnose_fit(
        losses, converged=False, nan_abort=False,
        grad_norm_first=grad_norm_first, grad_norm_last=grad_norm_last,
        window=policy.window, slope_tol=policy.slope_tol,
        var_tol=policy.var_tol, grad_ratio=policy.grad_ratio,
        min_samples=policy.window)
    verdict = report["verdict"]
    loss_last = losses[-1] if len(losses) else None
    unstable = verdict in ("oscillating", "diverging")
    stagnant = _stagnation(policy, losses, start=stagnation_start)

    if not exhausted:
        if verdict == "converged":
            return {
                "action": "early_stop",
                "iter": int(it),
                "budget": int(budget),
                "trigger": _trigger(report, loss_last),
                "thresholds": policy.thresholds(),
                "iters_saved": int(budget - it),
            }, verdict
        if unstable:
            # PERSISTENCE gate: a transient loss spike poisons ONE
            # doctor window (the window is shorter than a chunk, so it
            # slides past by the next evaluation); re-seeding is for
            # instability that survives two consecutive reads.  The
            # stop triggers also hold off while the window is unstable
            # — worst case that defers a stop by one chunk.
            if prev_verdict in ("oscillating", "diverging") \
                    and reseeds_done < policy.max_reseeds:
                return {
                    "action": "reseed",
                    "iter": int(it),
                    "budget": int(budget),
                    "trigger": _trigger(report, loss_last),
                    "thresholds": policy.thresholds(),
                    "detail": (f"{verdict} on two consecutive "
                               f"evaluations: perturb from the "
                               f"best-loss checkpoint (scale "
                               f"{policy.reseed_scale:g}, reseed "
                               f"{reseeds_done + 1}/"
                               f"{policy.max_reseeds}) and reset the "
                               f"optimiser state"),
                }, verdict
            return None, verdict
        if stagnant is not None:
            trigger = _trigger(report, loss_last)
            trigger.update(stagnant)
            return {
                "action": "early_stop",
                "iter": int(it),
                "budget": int(budget),
                "trigger": trigger,
                "thresholds": policy.thresholds(),
                "iters_saved": int(budget - it),
            }, verdict
        return None, verdict

    # budget exhausted without the stop criterion: extend only when the
    # doctor says more optimisation would change the answer — still
    # descending or gradient-stalled (plateaued), and the best loss
    # genuinely moved within the stagnation horizon (a stagnant best
    # means the remaining descent is churn, not progress)
    if verdict == "plateaued" and stagnant is None:
        grant = min(policy.extend_step,
                    policy.max_extra_iters - extra_granted)
        if grant > 0:
            return {
                "action": "extend",
                "iter": int(it),
                "budget": int(budget),
                "trigger": _trigger(report, loss_last),
                "thresholds": policy.thresholds(),
                "iters_granted": int(grant),
            }, verdict
    return None, verdict


def decide(policy: ControllerPolicy, **signals) -> Optional[dict]:
    """The decision half of :func:`evaluate` (same signals): returns
    the ``control_decision`` payload or None.  Convenience for callers
    and tests that do not thread the verdict chain."""
    decision, _ = evaluate(policy, **signals)
    return decision
