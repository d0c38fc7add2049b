"""Post-PERT cell-cycle phase calling (port, a host pandas/NumPy copy, of
the JAX package's ``pipeline/phase.py``).

Mirrors ``predict_cycle_phase`` (reference: predict_cycle_phase.py:23-117):
per-cell replicated fraction + quality features (ACF, breakpoints,
fraction CN=0) split cells into S / G1-2 / LQ.  The per-cell loops become
groupby aggregations over the long frame.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import pandas as pd

from scdna_replication_tools_tpu_torch.ops.stats import autocorrelation_mean


def autocorr(data, min_lag=10, max_lag=50) -> float:
    """Mean ACF over lags [min_lag, max_lag]
    (reference: predict_cycle_phase.py:23-25)."""
    return autocorrelation_mean(np.asarray(data), min_lag, max_lag)


def breakpoints(data) -> int:
    """Number of adjacent-bin value changes
    (reference: predict_cycle_phase.py:28-30)."""
    return int(np.sum(np.diff(np.asarray(data)) != 0))


def compute_cell_frac(cn: pd.DataFrame, frac_rt_col='cell_frac_rep',
                      rep_state_col='model_rep_state') -> pd.DataFrame:
    cn = cn.copy()
    fracs = cn.groupby('cell_id', observed=True)[rep_state_col] \
        .transform('mean')
    cn[frac_rt_col] = fracs
    return cn


def remove_nonreplicating_cells(cn: pd.DataFrame,
                                frac_rt_col='cell_frac_rep', thresh=0.05):
    """Split cells by extreme replicated fraction
    (reference: predict_cycle_phase.py:42-51)."""
    assert thresh < 0.5
    good_cells = cn.loc[(cn[frac_rt_col] > thresh)
                        & (cn[frac_rt_col] < (1 - thresh))].cell_id.unique()
    cn_good = cn[cn['cell_id'].isin(good_cells)].reset_index(drop=True)
    cn_bad = cn[~cn['cell_id'].isin(good_cells)].reset_index(drop=True)
    return cn_good, cn_bad


def compute_quality_features(cn: pd.DataFrame,
                             rep_state_col='model_rep_state',
                             cn_state_col='model_cn_state',
                             rpm_col='rpm') -> pd.DataFrame:
    """Per-cell ACF/breakpoint/CN0 features
    (reference: predict_cycle_phase.py:54-85)."""
    metrics = []
    for cell_id, cell_cn in cn.groupby('cell_id', observed=True):
        metrics.append({
            'cell_id': cell_id,
            'rpm_auto': autocorr(cell_cn[rpm_col].to_numpy()),
            'rep_auto': autocorr(cell_cn[rep_state_col].to_numpy()),
            'cn_bk': breakpoints(cell_cn[cn_state_col].to_numpy()),
            'rep_bk': breakpoints(cell_cn[rep_state_col].to_numpy()),
            'frac_cn0': float((cell_cn[cn_state_col] == 0).mean()),
        })
    metrics = pd.DataFrame(metrics)
    metrics['rpm_auto_norm'] = metrics['rpm_auto'] - metrics['rpm_auto'].mean()
    metrics['rep_auto_norm'] = metrics['rep_auto'] - metrics['rep_auto'].mean()
    return pd.merge(cn, metrics)


def remove_low_quality_cells(cn: pd.DataFrame, rep_auto_thresh=0.2,
                             frac_cn0_thresh=0.05):
    """reference: predict_cycle_phase.py:88-96."""
    low = cn.loc[(cn['rep_auto'] > rep_auto_thresh)
                 | (cn['frac_cn0'] > frac_cn0_thresh)].cell_id.unique()
    cn_good = cn[~cn['cell_id'].isin(low)].reset_index(drop=True)
    cn_bad = cn[cn['cell_id'].isin(low)].reset_index(drop=True)
    return cn_good, cn_bad


def predict_cycle_phase(cn: pd.DataFrame, frac_rt_col='cell_frac_rep',
                        rep_state_col='model_rep_state',
                        cn_state_col='model_cn_state', rpm_col='rpm'
                        ) -> Tuple[pd.DataFrame, pd.DataFrame, pd.DataFrame]:
    """Returns (cn_s, cn_g, cn_lq) with PERT_phase labels
    (reference: predict_cycle_phase.py:99-117)."""
    cn = compute_cell_frac(cn, frac_rt_col=frac_rt_col,
                           rep_state_col=rep_state_col)
    cn = compute_quality_features(cn, rep_state_col=rep_state_col,
                                  cn_state_col=cn_state_col, rpm_col=rpm_col)
    cn_s_lq, cn_g = remove_nonreplicating_cells(cn, frac_rt_col=frac_rt_col)
    cn_s, cn_lq = remove_low_quality_cells(cn_s_lq)

    cn_s = cn_s.copy()
    cn_g = cn_g.copy()
    cn_lq = cn_lq.copy()
    cn_s['PERT_phase'] = 'S'
    cn_g['PERT_phase'] = 'G1/2'
    cn_lq['PERT_phase'] = 'LQ'
    return cn_s, cn_g, cn_lq
