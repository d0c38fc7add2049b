"""Bijective constraint transforms for MAP optimisation.

Port of ``ops/transforms.py``: every parameter lives in unconstrained
space for Adam and is mapped to its constrained value inside the loss.
Inputs may be Python numbers or tensors; numbers become float32 tensors
on ``device``.
"""

from __future__ import annotations

import torch


def _f32(y, device=None) -> torch.Tensor:
    return torch.as_tensor(y, dtype=torch.float32, device=device)


def softplus(x):
    # log(1 + exp(x)) as logaddexp(x, 0), the jax.nn.softplus form
    return torch.logaddexp(x, torch.zeros_like(x))


def inv_softplus(y):
    # log(exp(y) - 1), numerically stable for large y
    return y + torch.log(-torch.expm1(-y))


def to_positive(x):
    return softplus(x)


def from_positive(y, device=None):
    return inv_softplus(_f32(y, device))


def to_unit_interval(x):
    return torch.sigmoid(x)


def from_unit_interval(y, device=None):
    y = torch.clamp(_f32(y, device), 1e-6, 1.0 - 1e-6)
    return torch.log(y) - torch.log1p(-y)


def to_interval(x, lo, hi):
    return lo + (hi - lo) * torch.sigmoid(x)


def from_interval(y, lo, hi, device=None):
    return from_unit_interval((_f32(y, device) - lo) / (hi - lo))
