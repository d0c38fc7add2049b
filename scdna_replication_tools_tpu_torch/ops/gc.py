"""GC-bias features (port of ``ops/gc.py``; reference:
pert_model.py:460-463): powers in descending order, as the reference
stores them, so the per-library prior stds logspace(1 -> 10^-K) line up.
"""

from __future__ import annotations

import torch


def gc_features(gammas: torch.Tensor, K: int) -> torch.Tensor:
    """(num_loci,) GC fractions -> (num_loci, K+1) features, powers K..0."""
    powers = torch.arange(K, -1, -1, dtype=gammas.dtype, device=gammas.device)
    return gammas[:, None] ** powers[None, :]


def gc_rate(betas: torch.Tensor, features: torch.Tensor) -> torch.Tensor:
    """omega[n, i] = exp(sum_k betas[n, k] * features[i, k]): one
    (cells, K+1) x (K+1, loci) float32 product (reference:
    pert_model.py:632-633)."""
    return torch.exp(betas @ features.T)
