"""T-width: replication-timing heterogeneity metric (port, a host copy,
of ``pipeline/twidth.py``; its two plot functions import matplotlib
inside them, as the JAX package's do).

Mirrors ``calculate_twidth`` (reference: calculate_twidth.py:23-200): the
time window over which loci go from 25% to 75% replicated, via a sigmoid
(or linear) fit of percent-replicated vs time-from-scheduled-replication.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
from scipy.optimize import curve_fit


def compute_time_from_scheduled_column(cn: pd.DataFrame,
                                       pseudobulk_col='pseudobulk_hours',
                                       frac_rt_col='frac_rt',
                                       tfs_col='time_from_scheduled_rt'
                                       ) -> pd.DataFrame:
    """tfs = bulk hours - frac_rt * 10 (reference:
    calculate_twidth.py:23-34)."""
    cn = cn.copy()
    cn[tfs_col] = cn[pseudobulk_col] - (cn[frac_rt_col] * 10.0)
    return cn


def calc_pct_replicated_per_time_bin(cn: pd.DataFrame,
                                     tfs_col='time_from_scheduled_rt',
                                     rs_col='rt_state', per_cell=False,
                                     query2: Optional[str] = None,
                                     cell_col='cell_id'):
    """Percent replicated per time-from-scheduled interval
    (reference: calculate_twidth.py:37-71; 201 bin edges over [-10, 10])."""
    if query2:
        cn = cn.query(query2)
    intervals = np.linspace(-10, 10, 201)
    time_bins, pct_reps = [], []
    idx = np.digitize(cn[tfs_col].to_numpy(), intervals) - 1
    cn = cn.assign(_tbin=idx)
    cn = cn[(idx >= 0) & (idx < 200)]
    group_cols = ["_tbin", cell_col] if per_cell else ["_tbin"]
    grouped = cn.groupby(group_cols, observed=True)[rs_col].mean()
    for key, pct in grouped.items():
        tbin = key[0] if per_cell else key
        time_bins.append(intervals[int(tbin)])
        pct_reps.append(float(pct))
    return time_bins, pct_reps


def sigmoid(x, x0, k, b):
    return 1.0 / (1.0 + np.exp(-k * (x - x0))) + b


def inv_sigmoid(y, x0, k, b):
    temp = (1.0 / (y - b)) - 1.0
    return (np.log(temp) / -k) + x0


def fit_sigmoid(xdata, ydata):
    p0 = [np.median(xdata), 1.0, 0.0]
    popt, pcov = curve_fit(sigmoid, xdata, ydata, p0, method="dogbox")
    return popt, pcov


def calc_t_width(popt, low=0.25, high=0.75):
    right_time = inv_sigmoid(low, *popt)
    left_time = inv_sigmoid(high, *popt)
    return right_time - left_time, left_time, right_time


def linear(x, m, b):
    return m * np.asarray(x) + b


def inv_linear(y, m, b):
    return (y - b) / m


def fit_linear(xdata, ydata):
    popt, pcov = curve_fit(linear, xdata, ydata, [-1.0, -1.0])
    return popt, pcov


def calc_linear_t_width(popt, low=0.25, high=0.75):
    right_time = inv_linear(low, *popt)
    left_time = inv_linear(high, *popt)
    return right_time - left_time, left_time, right_time


def calculate_twidth(cn: pd.DataFrame, tfs_col='time_from_scheduled_rt',
                     rs_col='rt_state', per_cell=False,
                     query2: Optional[str] = None, curve='sigmoid',
                     cell_col='cell_id'):
    """Returns (t_width, right_time, left_time, popt, time_bins, pct_reps)
    (reference: calculate_twidth.py:142-170)."""
    time_bins, pct_reps = calc_pct_replicated_per_time_bin(
        cn, tfs_col=tfs_col, rs_col=rs_col, per_cell=per_cell,
        query2=query2, cell_col=cell_col)
    if curve == 'sigmoid':
        popt, _ = fit_sigmoid(time_bins, pct_reps)
        t_width, right_time, left_time = calc_t_width(popt)
    elif curve == 'linear':
        popt, _ = fit_linear(time_bins, pct_reps)
        t_width, right_time, left_time = calc_linear_t_width(popt)
    else:
        raise ValueError(f"unknown curve {curve!r}")
    return t_width, right_time, left_time, popt, time_bins, pct_reps


def plot_cell_variability(xdata, ydata, popt=None, left_time=None,
                          right_time=None, t_width=None, alpha=1,
                          title='Cell-to-cell variability', curve='sigmoid',
                          ax=None):
    """Scatter + fitted curve + T-width guides
    (reference: calculate_twidth.py:117-139)."""
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(1, 1, figsize=(6, 6))
    ax.scatter(xdata, ydata, label='data', alpha=alpha)
    if popt is not None:
        x = np.linspace(-10, 10, 1000)
        y = sigmoid(x, *popt) if curve == 'sigmoid' else linear(x, *popt)
        ax.plot(x, y, color='r', label='fit')
        ax.axhline(y=0.75, color='k', linestyle='--')
        ax.axhline(y=0.25, color='k', linestyle='--')
        ax.axvline(x=left_time, color='k', linestyle='--')
        ax.axvline(x=right_time, color='k', linestyle='--',
                   label=f'T_width={round(t_width, 3)}')
    ax.set_xlabel('time from scheduled replication (h)')
    ax.set_ylabel('% replicated')
    ax.set_title(title)
    ax.legend(loc='best')
    return ax


def compute_and_plot_twidth(cn, tfs_col='time_from_scheduled_rt',
                            rs_col='rt_state', per_cell=False, query2=None,
                            cell_col='cell_id', alpha=1,
                            title='Cell-to-cell variability',
                            curve='sigmoid', ax=None):
    t_width, right_time, left_time, popt, time_bins, pct_reps = \
        calculate_twidth(cn, tfs_col=tfs_col, rs_col=rs_col,
                         per_cell=per_cell, query2=query2, curve=curve,
                         cell_col=cell_col)
    ax = plot_cell_variability(time_bins, pct_reps, popt, left_time,
                               right_time, t_width, alpha=alpha,
                               title=title, curve=curve, ax=ax)
    return ax, t_width
