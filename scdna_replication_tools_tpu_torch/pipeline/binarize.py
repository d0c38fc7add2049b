"""Binarise continuous RT profiles (Dileep & Gilbert style; port of
``pipeline/binarize.py``).

pandas facade over the batched :func:`..ops.stats.manhattan_binarize`,
which runs on ``device`` (None = the GPU).  Mirrors ``binarize_profiles``
(reference: binarize_rt_profiles.py:22-121): per-cell 2-GMM levels with
skew-based percentile fallback, then a 100-threshold Manhattan-distance
scan over linspace(-3, 3) — but all cells are processed in one batched
call instead of a Python loop with per-cell sklearn fits.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd
import torch

from scdna_replication_tools_tpu_torch.device import resolve_device
from scdna_replication_tools_tpu_torch.ops.stats import manhattan_binarize


def binarize_profiles(cn: pd.DataFrame, input_col: str,
                      rs_col='rt_state', frac_rt_col='frac_rt',
                      thresh_col='binary_thresh', cell_col='cell_id',
                      MEAN_GAP_THRESH=0.7, EARLY_S_SKEW_THRESH=0.2,
                      LATE_S_SKEW_THRESH=-0.2, device=None
                      ) -> Tuple[pd.DataFrame, pd.DataFrame]:
    """Returns (cn with rt_state/frac_rt/binary_thresh/GMM columns added,
    manhattan_df of all scanned thresholds)."""
    cn = cn.copy()
    has_chr = "chr" in cn.columns
    if has_chr:
        cn["chr"] = cn["chr"].astype(str)
        mat = cn.pivot_table(index=cell_col, columns=["chr", "start"],
                             values=input_col, dropna=False, observed=True)
    else:
        mat = cn.pivot_table(index=cell_col, columns="start",
                             values=input_col, dropna=False, observed=True)

    vals = mat.to_numpy(np.float32)
    nan_mask = ~np.isfinite(vals)
    if nan_mask.any():
        # fill missing loci with the per-cell median; filled bins are
        # dropped again on melt (the reference drops NaNs upstream)
        med = np.nanmedian(vals, axis=1, keepdims=True)
        vals = np.where(nan_mask, med, vals)

    out = manhattan_binarize(
        torch.as_tensor(np.array(vals, np.float32),
                        device=resolve_device(device)),
        mean_gap_thresh=MEAN_GAP_THRESH,
        early_s_skew_thresh=EARLY_S_SKEW_THRESH,
        late_s_skew_thresh=LATE_S_SKEW_THRESH,
        scale_input=False,
        thresh_from_binaries=False,
    )
    rt_state, frac_rt, best_t, dists = (
        t.cpu().numpy() for t in (out[0], out[1], out[2], out[4]))
    mu, var, w = (t.cpu().numpy() for t in out[3])
    rt_state = np.asarray(rt_state, np.float64)
    rt_state[nan_mask] = np.nan

    def _melt(arr, name):
        df = pd.DataFrame(np.asarray(arr), index=mat.index,
                          columns=mat.columns)
        return df.T.melt(ignore_index=False, value_name=name).reset_index()

    melted = _melt(rt_state, rs_col).dropna()
    if has_chr:
        melted["chr"] = melted["chr"].astype(str)
    cn = pd.merge(cn, melted)

    per_cell = pd.DataFrame({
        cell_col: mat.index,
        frac_rt_col: np.asarray(frac_rt),
        thresh_col: np.asarray(best_t),
        "mean_0": np.asarray(mu)[:, 0],
        "mean_1": np.asarray(mu)[:, 1],
        "covariance_0": np.asarray(var)[:, 0],
        "covariance_1": np.asarray(var)[:, 1],
    })
    cn = pd.merge(cn, per_cell)

    threshs = np.linspace(-3.0, 3.0, 100)
    manhattan_df = pd.DataFrame({
        "thresh": np.tile(threshs, len(mat.index)),
        "manhattan_dist": np.asarray(dists).reshape(-1),
        cell_col: np.repeat(mat.index.to_numpy(), 100),
        "best_thresh": np.repeat(np.asarray(best_t), 100),
    })
    return cn, manhattan_df
