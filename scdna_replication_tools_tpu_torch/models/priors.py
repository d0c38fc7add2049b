"""CN-prior (eta) concentration builders (port of ``models/priors.py``).

Host NumPy, (cells, loci, P) cells-major like the JAX module; the one
product in here, the S x G1 Pearson matrix of the composite prior, runs
on ``device``.  :func:`composite_cn_prior` is the default step-2 prior
and stays dense; the state-derived priors sparsify to the one-hot
(eta_idx, eta_w) planes the sparse kernel reads.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from scdna_replication_tools_tpu_torch.ops.stats import mode_int, pearson_matrix


def one_hot_states(states: np.ndarray, P: int) -> np.ndarray:
    """(cells, loci) integer states -> (cells, loci, P) one-hot float32."""
    s = np.clip(states.astype(np.int64), 0, P - 1)
    return np.eye(P, dtype=np.float32)[s]


def sparsify_etas(etas: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Detect the one-hot Dirichlet structure and compact it.

    Returns float32 (cells, loci) planes ``(eta_idx, eta_w)`` with
    ``etas[c, l, :] = 1`` except ``etas[c, l, idx] = 1 + w`` (``w = 0``
    for uniform bins), or None when the structure does not hold (the
    composite prior spreads weight over J+1 states).
    """
    if etas.ndim != 3:
        return None
    nonunit = etas != 1.0
    if (etas < 1.0).any() or (nonunit.sum(axis=-1) > 1).any():
        return None
    idx = np.argmax(etas, axis=-1)
    w = np.take_along_axis(etas, idx[..., None], axis=-1)[..., 0] - 1.0
    return idx.astype(np.float32), w.astype(np.float32)


def eta_batch_fields(etas: np.ndarray, allow_sparse: bool = True,
                     device=None) -> dict:
    """``PertBatch`` kwargs for a CN prior on ``device``:
    ``{eta_idx, eta_w}`` when the prior sparsifies and ``allow_sparse``,
    else ``{etas}``.  Pair with
    ``PertModelSpec(sparse_etas="eta_idx" in fields)``."""
    if allow_sparse:
        sp = sparsify_etas(np.asarray(etas))
        if sp is not None:
            return {"eta_idx": torch.as_tensor(sp[0], device=device),
                    "eta_w": torch.as_tensor(sp[1], device=device)}
    return {"etas": torch.as_tensor(np.asarray(etas, np.float32),
                                    device=device)}


def cn_prior_from_states(states: np.ndarray, P: int, weight: float) -> np.ndarray:
    """etas = ones, with ``weight`` at each bin's given state
    (reference: pert_model.py:272-282)."""
    oh = one_hot_states(states, P)
    return 1.0 + (weight - 1.0) * oh


def uniform_prior(num_cells: int, num_loci: int, P: int) -> np.ndarray:
    """Uniform fallback etas = 1/P (reference: pert_model.py:713-716)."""
    return np.full((num_cells, num_loci, P), 1.0 / P, np.float32)


def cell_ploidies(states: np.ndarray) -> np.ndarray:
    """Per-cell ploidy = modal CN state."""
    return np.array([mode_int(row) for row in states], dtype=np.float32)


def majority_ploidy_mask(ploidies: np.ndarray, clone_idx: np.ndarray
                         ) -> np.ndarray:
    """Keep only cells whose ploidy is the majority ploidy of their clone."""
    keep = np.zeros(len(ploidies), dtype=bool)
    for c in np.unique(clone_idx):
        in_clone = clone_idx == c
        vals, counts = np.unique(ploidies[in_clone], return_counts=True)
        keep_ploidy = vals[np.argmax(counts)]
        keep |= in_clone & (ploidies == keep_ploidy)
    return keep


def consensus_clone_profiles(
    values: np.ndarray,
    clone_idx: np.ndarray,
    num_clones: int,
    states: Optional[np.ndarray] = None,
    aggfunc=np.median,
) -> np.ndarray:
    """(num_clones, loci) per-clone aggregate (median) profile, with the
    majority-ploidy cell filter when ``states`` is given."""
    if states is not None:
        keep = majority_ploidy_mask(cell_ploidies(states), clone_idx)
    else:
        keep = np.ones(len(clone_idx), dtype=bool)
    out = np.zeros((num_clones, values.shape[1]), np.float32)
    for c in range(num_clones):
        sel = keep & (clone_idx == c)
        if not sel.any():          # fall back to all cells of the clone
            sel = clone_idx == c
        out[c] = aggfunc(values[sel], axis=0)
    return out


def clone_cn_prior(
    clone_idx: np.ndarray,
    clone_cn_profiles: np.ndarray,
    P: int,
    weight: float,
) -> np.ndarray:
    """Per-cell etas from the int-truncated consensus profile of the
    cell's clone (reference: pert_model.py:285-296)."""
    profiles = clone_cn_profiles.astype(np.int64).astype(np.float32)
    states = profiles[clone_idx]
    return cn_prior_from_states(states, P, weight)


def composite_cn_prior(
    s_assign: np.ndarray,
    s_clone_idx: np.ndarray,
    g1_assign: np.ndarray,
    g1_states: np.ndarray,
    g1_clone_idx: np.ndarray,
    clone_cn_profiles: np.ndarray,
    P: int,
    J: int = 5,
    weight: float = 1e5,
    device=None,
) -> np.ndarray:
    """Composite clone + top-J-matching-G1-cell prior (reference:
    pert_model.py:299-361): each S cell adds ``weight*J*2`` at its
    clone's consensus state and ``weight*(J-j)`` at the state of its
    j-th best-correlated same-clone, majority-ploidy G1 cell; J is
    clamped to the smallest (filtered) clone."""
    num_cells, num_loci = s_assign.shape

    sizes = np.bincount(g1_clone_idx, minlength=clone_cn_profiles.shape[0])
    sizes = sizes[sizes > 0]
    J = int(min(J, sizes.min()))

    keep = majority_ploidy_mask(cell_ploidies(g1_states), g1_clone_idx)
    filt_sizes = np.array([
        max(int(((g1_clone_idx == c) & keep).sum()), 1)
        for c in np.unique(g1_clone_idx)
    ])
    J = int(min(J, filt_sizes.min()))

    corr = pearson_matrix(s_assign, g1_assign, device=device).cpu().numpy()
    same_clone = s_clone_idx[:, None] == g1_clone_idx[None, :]
    valid = same_clone & keep[None, :]
    corr = np.where(valid, corr, -np.inf)

    order = np.argsort(-corr, axis=1)[:, :J]                 # (S, J)

    etas = np.ones((num_cells, num_loci, P), np.float32)
    profiles = clone_cn_profiles.astype(np.int64).astype(np.float32)
    clone_states = profiles[s_clone_idx]
    etas += (weight * J * 2.0) * one_hot_states(clone_states, P)

    g1_state_int = np.clip(g1_states.astype(np.int64), 0, P - 1)
    for j in range(J):
        sel_states = g1_state_int[order[:, j]]
        etas += (weight * (J - j)) * one_hot_states(sel_states, P)

    return etas
