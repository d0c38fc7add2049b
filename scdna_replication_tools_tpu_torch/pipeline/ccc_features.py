"""Cell-cycle-classifier features (port of the JAX package's
``pipeline/ccc_features.py``).

Mirrors ``compute_ccc_features`` (reference: compute_ccc_features.py:18-186):
per-cell MADN, 1-vs-2-component GMM likelihood-ratio bimodality statistic,
breakpoint counts (clone-corrected), and read-count-corrected MADN.
The per-cell sklearn GMM fits are replaced by one float32 2-GMM EM of
every cell at once on ``device`` (``ops.stats.gmm2_em``; ``None`` is the
GPU, ``'cpu'`` the CPU); the per-cell fill of missing loci, the MADN,
the 1-component likelihood, the breakpoints and the ``lstsq``
corrections stay float64 host NumPy, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd
import torch

from scdna_replication_tools_tpu_torch.device import resolve_device
from scdna_replication_tools_tpu_torch.ops.stats import (
    gmm2_em,
    gmm2_log_likelihood,
)
from scdna_replication_tools_tpu_torch.pipeline.phase import breakpoints


def _normal_log_likelihood(x: np.ndarray) -> np.ndarray:
    """Mean per-point log-likelihood of each row under a single Gaussian
    (the 1-component GMM of reference: compute_ccc_features.py:23-24)."""
    mu = np.mean(x, axis=1, keepdims=True)
    var = np.var(x, axis=1, keepdims=True) + 1e-12
    lp = -0.5 * (x - mu) ** 2 / var - 0.5 * np.log(2 * np.pi * var)
    return np.mean(lp, axis=1)


def calculate_features(cn: pd.DataFrame, cell_col='cell_id',
                       rpm_norm_col='rpm_clone_norm', madn_col='madn',
                       lrs_col='lrs', bk_col='breakpoints',
                       cn_col='state', device=None) -> pd.DataFrame:
    """Per-cell LRS (bimodality) + MADN
    (reference: compute_ccc_features.py:18-40), batched: the 2-GMM of
    every cell in one EM on ``device``."""
    cn = cn.copy()
    mat = cn.pivot_table(index=cell_col, columns=['chr', 'start'],
                         values=rpm_norm_col, dropna=False, observed=True)
    vals = mat.to_numpy(np.float64)
    # per-cell fill for ragged loci
    if not np.isfinite(vals).all():
        med = np.nanmedian(vals, axis=1, keepdims=True)
        vals = np.where(np.isfinite(vals), vals, med)

    x = torch.as_tensor(vals.astype(np.float32),
                        device=resolve_device(device))
    with torch.no_grad():
        mu, var, w = gmm2_em(x)
        ll2 = gmm2_log_likelihood(x, mu, var, w).cpu().numpy()
    ll1 = _normal_log_likelihood(vals)
    lrs = -2.0 * (ll1 - ll2)

    madn = np.nanmedian(np.abs(np.diff(vals, axis=1)), axis=1)

    per_cell = pd.DataFrame({cell_col: mat.index, madn_col: madn,
                             lrs_col: lrs})
    cn = pd.merge(cn, per_cell)

    if bk_col not in cn.columns:
        cn = calculate_breakpoints(cn, cell_col=cell_col, cn_col=cn_col,
                                   bk_col=bk_col)
    return cn


def calculate_breakpoints(cn: pd.DataFrame, cell_col='cell_id',
                          cn_col='state', bk_col='breakpoints'
                          ) -> pd.DataFrame:
    """Per-cell breakpoint counts, summed within chromosomes
    (reference: compute_ccc_features.py:43-56)."""
    cn = cn.copy()
    counts = {}
    for cell_id, cell_cn in cn.groupby(cell_col, observed=True):
        total = 0
        for _, chrom_cn in cell_cn.groupby('chr', observed=True):
            total += breakpoints(chrom_cn[cn_col].to_numpy())
        counts[cell_id] = total
    cn[bk_col] = cn[cell_col].map(counts)
    return cn


def correct_breakpoints(cell_features: pd.DataFrame, bk_col='breakpoints',
                        clone_col='clone_id',
                        output_col='corrected_breakpoints') -> pd.DataFrame:
    """Center breakpoint counts within each clone
    (reference: compute_ccc_features.py:59-67)."""
    cell_features = cell_features.copy()
    means = cell_features.groupby(clone_col, observed=True)[bk_col] \
        .transform('mean')
    cell_features[output_col] = cell_features[bk_col] - means
    return cell_features


def correct_madn(cell_features: pd.DataFrame, madn_col='madn',
                 num_reads_col='total_mapped_reads_hmmcopy',
                 output_col='corrected_madn') -> pd.DataFrame:
    """Regress MADN on total reads and keep the residual
    (reference: compute_ccc_features.py:70-79), via lstsq."""
    cell_features = cell_features.copy()
    x = cell_features[num_reads_col].to_numpy(np.float64)
    y = cell_features[madn_col].to_numpy(np.float64)
    A = np.stack([x, np.ones_like(x)], axis=1)
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    cell_features[output_col] = y - A @ coef
    return cell_features


def compute_clone_normalization(cn: pd.DataFrame, rpm_col='rpm',
                                rpm_norm_col='rpm_clone_norm',
                                clone_col='clone_id', cell_col='cell_id'
                                ) -> pd.DataFrame:
    """Normalise read depth by the clone mean profile
    (reference: compute_ccc_features.py:82-100)."""
    pieces = []
    for _, chunk in cn.groupby(clone_col, observed=True):
        mat = chunk.pivot_table(values=rpm_col, index=['chr', 'start'],
                                columns=cell_col, observed=True)
        mat = mat.interpolate(method='linear', axis=0)
        norm = mat.divide(mat.mean(axis=1), axis=0)
        pieces.append(norm.reset_index().melt(
            id_vars=['chr', 'start'], value_name=rpm_norm_col))
    merged = pd.concat(pieces, ignore_index=True)
    # drop loci missing in any cell (reference: :94-97)
    wide = merged.pivot_table(values=rpm_norm_col, index=['chr', 'start'],
                              columns=cell_col, observed=True).dropna(axis=0)
    long = wide.reset_index().melt(id_vars=['chr', 'start'],
                                   value_name=rpm_norm_col)
    return pd.merge(cn, long)


def compute_read_count(cn: pd.DataFrame, input_col='reads',
                       output_col='total_mapped_reads_hmmcopy'
                       ) -> pd.DataFrame:
    cn = cn.copy()
    cn[output_col] = cn.groupby('cell_id', observed=True)[input_col] \
        .transform('sum')
    return cn


def compute_cell_frac(cn: pd.DataFrame, frac_rt_col='cell_frac_rep',
                      rep_state_col='model_rep_state') -> pd.DataFrame:
    """reference: compute_ccc_features.py:121-131."""
    cn = cn.copy()
    cn[frac_rt_col] = cn.groupby('cell_id', observed=True)[rep_state_col] \
        .transform('mean')
    cn['extreme_cell_frac'] = (cn[frac_rt_col] > 0.95) | \
        (cn[frac_rt_col] < 0.05)
    return cn


def compute_ccc_features(cn: pd.DataFrame, cell_col='cell_id',
                         rpm_col='rpm', cn_col='state',
                         clone_col='clone_id', madn_col='madn',
                         lrs_col='lrs',
                         num_reads_col='total_mapped_reads_hmmcopy',
                         bk_col='breakpoints', device=None
                         ) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Full feature computation (reference: compute_ccc_features.py:134-186).

    Returns (cn with features merged, per-cell feature frame).  The
    2-GMM runs on ``device`` (``None``: the GPU; raises without one).
    """
    device = resolve_device(device)
    rpm_norm_col = f'{rpm_col}_clone_norm'
    cn = compute_clone_normalization(cn, rpm_col=rpm_col,
                                     rpm_norm_col=rpm_norm_col,
                                     clone_col=clone_col, cell_col=cell_col)
    cn = calculate_features(cn, rpm_norm_col=rpm_norm_col,
                            madn_col=madn_col, lrs_col=lrs_col,
                            cell_col=cell_col, bk_col=bk_col, cn_col=cn_col,
                            device=device)
    if num_reads_col not in cn.columns:
        cn = compute_read_count(cn, input_col=rpm_col,
                                output_col=num_reads_col)

    cell_features = cn[[cell_col, clone_col, madn_col, lrs_col,
                        num_reads_col, bk_col]].drop_duplicates()
    cell_features = correct_madn(cell_features, madn_col=madn_col,
                                 num_reads_col=num_reads_col,
                                 output_col=f'corrected_{madn_col}')
    cell_features = correct_breakpoints(cell_features, bk_col=bk_col,
                                        clone_col=clone_col,
                                        output_col=f'corrected_{bk_col}')
    cn_out = pd.merge(cn, cell_features)
    return cn_out, cell_features
