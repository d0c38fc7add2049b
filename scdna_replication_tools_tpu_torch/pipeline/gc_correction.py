"""Bulk G1 GC-bias correction via LOWESS (port of
``pipeline/gc_correction.py``; reference: bulk_gc_correction.py:21-74).

Per library, a LOWESS curve of G1 reads-per-million against GC content
is fit and every bin's rpm (S and G1) is divided by the curve at its GC.

:func:`lowess` is the JAX package's estimator (Cleveland's tricube
local linear regression over the nearest ``ceil(frac * n)`` points,
with ``it`` robustifying passes), evaluated once per distinct x value
instead of once per point.  Every G1 cell shares the loci's GC vector,
so the n points hold few distinct x values; the fit at x0 depends only
on x0 and the robustness weights, and points tied at the window's edge
get tricube weight 0, so the estimator is unchanged.  The per-value
fits run in float64 torch on the device, as sums over the distinct
values of each value's robustness-weighted counts; the passes' fitted
values are gathered back to the points for the next weights.  A window
of zero width and one whose weights all vanish take the JAX package's
own branches (host NumPy on that window), which depend on how ties are
broken.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from scdna_replication_tools_tpu_torch.device import resolve_device

# distinct evaluation points per block of the (points, values) distance
# matrices
_BLOCK = 1024


def _fit_at_host(x, y, delta, r, x0) -> float:
    """The JAX package's ``_fit_at``, for the windows its tie-dependent
    branches cover."""
    d = np.abs(x - x0)
    idx = np.argpartition(d, r - 1)[:r]
    dmax = d[idx].max()
    if dmax <= 0:
        return float(np.average(y[idx], weights=delta[idx] + 1e-12))
    w = (1.0 - (d[idx] / dmax) ** 3) ** 3
    w = np.clip(w, 0, None) * delta[idx]
    sw = w.sum()
    if sw <= 0:
        return float(y[idx].mean())
    xw = x[idx]
    xm = np.dot(w, xw) / sw
    ym = np.dot(w, y[idx]) / sw
    sxx = np.dot(w, (xw - xm) ** 2)
    if sxx <= 1e-12:
        return float(ym)
    b = np.dot(w, (xw - xm) * (y[idx] - ym)) / sxx
    return float(ym + b * (x0 - xm))


def _fit_at_values(xu, counts, dsum, dysum, r, x0) -> tuple:
    """Local linear fits at the points ``x0`` (E,) from the distinct x
    values ``xu`` (G,) with their point counts and robustness-weighted
    sums of 1 and y.  Returns (fits (E,), host_fallback (E,) bool)."""
    d = torch.abs(xu[None, :] - x0[:, None])                  # (E, G)
    d_sorted, order = torch.sort(d, dim=1)
    reach = torch.cumsum(counts[order], dim=1)
    kth = torch.searchsorted(reach, torch.full(
        (x0.shape[0], 1), float(r), dtype=reach.dtype, device=d.device))
    dmax = torch.gather(d_sorted, 1, kth)                     # (E, 1)
    tric = torch.clamp((1.0 - (d / torch.where(dmax > 0, dmax, 1.0)) ** 3)
                       ** 3, min=0.0)
    w = tric * dsum[None, :]
    sw = w.sum(dim=1)
    safe_sw = torch.where(sw > 0, sw, 1.0)
    xm = (w @ xu) / safe_sw
    ym = (tric @ dysum) / safe_sw
    dx = xu[None, :] - xm[:, None]
    sxx = torch.sum(w * dx * dx, dim=1)
    sxy = torch.sum(tric * dx * (dysum[None, :] - ym[:, None]
                                 * dsum[None, :]), dim=1)
    b = sxy / torch.where(sxx > 1e-12, sxx, 1.0)
    fit = torch.where(sxx <= 1e-12, ym, ym + b * (x0 - xm))
    return fit, (dmax[:, 0] <= 0) | (sw <= 0)


def lowess(y: np.ndarray, x: np.ndarray, xvals: np.ndarray,
           frac: float = 2.0 / 3.0, it: int = 3, device=None) -> np.ndarray:
    """LOWESS fit of y ~ x evaluated at ``xvals`` (the statsmodels
    defaults: tricube weights over the nearest ``ceil(frac * n)`` points,
    ``it`` robustifying passes with bisquare weights on the residuals),
    on ``device`` (None = the GPU) in float64."""
    dev = resolve_device(device)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    xvals = np.asarray(xvals, np.float64)
    n = len(x)
    order = np.argsort(x)
    x, y = x[order], y[order]
    r = max(int(np.ceil(frac * n)), 2)

    xu_np, inv_np, counts_np = np.unique(x, return_inverse=True,
                                         return_counts=True)
    f64 = dict(dtype=torch.float64, device=dev)
    xu = torch.as_tensor(xu_np, **f64)
    counts = torch.as_tensor(counts_np, **f64)
    inv = torch.as_tensor(inv_np, dtype=torch.int64, device=dev)
    y_t = torch.as_tensor(y, **f64)

    def curve(delta: torch.Tensor, x0_np: np.ndarray) -> torch.Tensor:
        dsum = torch.zeros_like(xu).index_add_(0, inv, delta)
        dysum = torch.zeros_like(xu).index_add_(0, inv, delta * y_t)
        x0 = torch.as_tensor(x0_np, **f64)
        parts, fallback = [], []
        for i in range(0, len(x0_np), _BLOCK):
            fit, fb = _fit_at_values(xu, counts, dsum, dysum, r,
                                     x0[i:i + _BLOCK])
            parts.append(fit)
            fallback.append(fb)
        fits = torch.cat(parts) if parts else x0
        fb = torch.cat(fallback).cpu().numpy() if fallback else []
        if np.any(fb):
            delta_np = delta.cpu().numpy()
            fits = fits.clone()
            for j in np.flatnonzero(fb):
                fits[j] = _fit_at_host(x, y, delta_np, r, x0_np[j])
        return fits

    delta = torch.ones(n, **f64)
    fitted_at_x = y_t.clone()
    for iteration in range(it + 1):
        if iteration > 0:
            resid = y_t - fitted_at_x
            s = _median(torch.abs(resid))
            if float(s) <= 0:
                break
            u = torch.clamp(resid / (6.0 * s), -1.0, 1.0)
            delta = (1.0 - u * u) ** 2
        if iteration < it:
            fitted_at_x = curve(delta, xu_np)[inv]
        else:
            return curve(delta, xvals).cpu().numpy()
    return curve(delta, xvals).cpu().numpy()


def _median(v: torch.Tensor) -> torch.Tensor:
    """np.median of a vector: of an even length, the mean of the two
    middle values (``torch.median`` returns the lower one)."""
    s = torch.sort(v).values
    m = v.shape[0] // 2
    return s[m] if v.shape[0] % 2 else (s[m - 1] + s[m]) / 2.0


def compute_reads_per_million(cn: pd.DataFrame, input_col='reads',
                              rpm_col='rpm', cell_col='cell_id'
                              ) -> pd.DataFrame:
    """Per-cell reads-per-million (reference: bulk_gc_correction.py:21-26)."""
    cn = cn.copy()
    totals = cn.groupby(cell_col, observed=True)[input_col].transform("sum")
    cn[rpm_col] = cn[input_col] / totals * 1e6
    return cn


def bulk_g1_gc_correction(cn_s: pd.DataFrame, cn_g1: pd.DataFrame,
                          input_col='reads', library_col='library_id',
                          output_col='rpm_gc_norm', gc_col='gc',
                          cell_col='cell_id', device=None):
    """GC-correct S and G1 rpm by the per-library G1 LOWESS curve;
    returns (cn_s, cn_g1) with ``output_col`` added (reference:
    bulk_gc_correction.py:34-74).  The curve runs on ``device``."""
    rpm_col = 'rpm'
    cn_s = compute_reads_per_million(cn_s, input_col, rpm_col, cell_col)
    cn_g1 = compute_reads_per_million(cn_g1, input_col, rpm_col, cell_col)

    cn_s[output_col] = np.nan
    cn_g1[output_col] = np.nan

    for lib_id, s_chunk in cn_s.groupby(library_col, observed=True):
        g1_chunk = cn_g1[cn_g1[library_col] == lib_id]
        gc_vec = np.sort(s_chunk[gc_col].unique())
        pred = lowess(g1_chunk[rpm_col].to_numpy(),
                      g1_chunk[gc_col].to_numpy(), gc_vec, device=device)
        curve = pd.Series(pred, index=gc_vec)
        cn_s.loc[s_chunk.index, output_col] = (
            s_chunk[rpm_col].to_numpy()
            / curve.reindex(s_chunk[gc_col]).to_numpy())
        cn_g1.loc[g1_chunk.index, output_col] = (
            g1_chunk[rpm_col].to_numpy()
            / curve.reindex(g1_chunk[gc_col]).to_numpy())

    return cn_s, cn_g1
