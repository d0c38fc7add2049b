"""Fixed-budget MAP-SVI loop (port of ``infer/svi.py``'s ``fit_map``).

The per-iteration semantics are those of the JAX ``_fit_loop``
(reference: pert_model.py:748-758):

* value and gradient of the loss, then the Adam update, applied BEFORE
  the convergence test (the NaN iteration's update lands too);
* the loss history in a float32 buffer of ``max_iter`` zeros;
* convergence once ``i >= min_iter`` and
  ``(max - min)(losses[i-w:i]) / |losses[0] - losses[i]| < rel_tol``
  with ``w = min(9, max_iter)`` (``_window_stat``);
* a NaN loss aborts the fit.

The JAX loop runs on device in one ``lax.while_loop``; here it is a
Python loop that reads the loss once per iteration, one host sync per
iteration, which keeps the exact stop semantics.  Adam is optax's
(lr 0.05, betas 0.8/0.99 by default): the pi parameter through the fused
kernel (``ops/adam_kernel.adam_update``), with its moments stored in
``moment_dtype`` (float32 or bfloat16), every other leaf through the same
math as plain ops with float32 moments.  lr and the bias corrections stay
on device.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from scdna_replication_tools_tpu_torch.device import resolve_device
from scdna_replication_tools_tpu_torch.ops.adam_kernel import (
    adam_scalars,
    adam_update,
    adam_update_plain,
    moment_torch_dtype,
)


def pi_param_name(params: dict) -> Optional[str]:
    """The (planes, cells, loci) pi parameter's key: 'pi_bin_logits' under
    the binary encoding, 'pi_logits' under the categorical one, None for
    parameter dicts that carry neither."""
    for name in ("pi_bin_logits", "pi_logits"):
        if name in params:
            return name
    return None


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: step count (int32, on device) and the
    first / second moments, keyed like the parameters."""

    count: torch.Tensor
    mu: dict
    nu: dict


@dataclasses.dataclass
class FitResult:
    params: dict            # fitted unconstrained params (device tensors)
    losses: np.ndarray      # (num_iters,) float32 per-iteration losses
    num_iters: int
    converged: bool
    nan_abort: bool
    opt_state: Optional[AdamState] = None
    timings: dict = dataclasses.field(default_factory=dict)


def make_opt_state(params: dict, moment_dtype: str = "float32") -> AdamState:
    """Fresh Adam state for ``params``: zero moments, count 0; the pi
    parameter's moments in ``moment_dtype``, the rest float32."""
    device = next(iter(params.values())).device
    pi = pi_param_name(params)
    dt = {pi: moment_torch_dtype(moment_dtype)}

    def zeros():
        return {k: torch.zeros_like(v, dtype=dt.get(k, torch.float32))
                for k, v in params.items()}
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                     mu=zeros(), nu=zeros())


def _adam_apply(params: dict, grads: dict, state: AdamState, lr: float,
                b1: float, b2: float, moment_dtype: str):
    """One Adam step of every leaf; the pi parameter takes the fused
    kernel with ``moment_dtype`` moments, the rest the same math as plain
    ops."""
    count = state.count + 1
    scal = adam_scalars(lr, count, b1, b2)
    pi = pi_param_name(params)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        args = (p, grads[k], state.mu[k], state.nu[k], scal, b1, b2)
        new_p[k], new_m[k], new_v[k] = (
            adam_update(*args, moment_dtype) if k == pi
            else adam_update_plain(*args))
    return new_p, AdamState(count=count, mu=new_m, nu=new_v)


def _window_stat(losses: np.ndarray, i: int, win: int) -> np.float32:
    """max - min over losses[i-win:i]; the start clamps to [0, n - win]
    as lax.dynamic_slice does (unwritten tail values are zeros)."""
    start = min(max(i - win, 0), len(losses) - win)
    window = losses[start:start + win]
    return np.float32(window.max() - window.min())


def fit_map(loss_fn: Callable, params0: dict, loss_args: tuple = (),
            max_iter: int = 2000, min_iter: int = 100, rel_tol: float = 1e-6,
            learning_rate: float = 0.05, b1: float = 0.8, b2: float = 0.99,
            opt_state0: Optional[AdamState] = None,
            device=None, moment_dtype: str = "float32") -> FitResult:
    """Fit ``params`` by MAP ascent of ``-loss_fn`` with the reference's
    stop semantics, for at most ``max_iter`` iterations.

    ``loss_fn(params, *loss_args) -> scalar tensor``.  ``params0`` (a
    dict of float32 tensors, not modified) is copied to ``device`` (see
    ``device.resolve_device``: the GPU unless ``'cpu'`` is passed), where
    ``loss_args`` must already lie; ``opt_state0`` continues from a
    previous Adam state.
    """
    dev = resolve_device(device)
    params = {k: v.detach().to(dev).clone() for k, v in params0.items()}
    state = opt_state0 if opt_state0 is not None \
        else make_opt_state(params, moment_dtype)
    losses = np.zeros((max_iter,), np.float32)
    win = min(9, max_iter)
    tol = np.float32(rel_tol)
    converged = is_nan = False
    n = 0
    t0 = time.perf_counter()
    while n < max_iter:
        leaves = {k: v.requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, *loss_args)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(leaves[k]))
                 for k, g in zip(leaves, grads)}
        with torch.no_grad():
            params, state = _adam_apply(
                {k: v.detach() for k, v in leaves.items()}, grads, state,
                learning_rate, b1, b2, moment_dtype)
        # the one host sync of the iteration
        loss_v = np.float32(loss.detach().item())
        losses[n] = loss_v
        is_nan = bool(np.isnan(loss_v))
        with np.errstate(divide="ignore", invalid="ignore"):
            denom = np.float32(abs(losses[0] - loss_v))
            loss_diff = np.float32(_window_stat(losses, n, win) / denom)
        converged = n >= min_iter and bool(loss_diff < tol)
        n += 1
        if is_nan or converged:
            break
    if params and next(iter(params.values())).is_cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return FitResult(
        params={k: v.detach() for k, v in params.items()},
        losses=losses[:n].copy(),
        num_iters=n,
        converged=converged,
        nan_abort=is_nan,
        opt_state=state,
        timings={"fit": wall, "ms_per_iter": 1e3 * wall / max(n, 1)},
    )
