"""Batched statistics for the prior and the S-phase time guess.

Port of ``ops/stats.py``: :func:`pearson_matrix` (one float32 matmul on
standardised rows), :func:`masked_pearson_matrix` (NumPy, copied),
:func:`guess_times` with the 2-GMM EM and Manhattan binarisation it
runs on every cell at once (the binarisation also serves the
deterministic levels, ``pipeline/binarize.py``), the 2-GMM's per-row
log-likelihood (the cell-cycle features, ``pipeline/ccc_features.py``),
and the host helpers :func:`autocorrelation_mean` (phase calling) and
:func:`mode_int`.
The tensor functions take NumPy arrays or tensors and run on ``device``
(default: the input's device, the CPU for NumPy).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _as_f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _standardize_rows(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    mu = torch.mean(x, dim=1, keepdim=True)
    sd = torch.std(x, dim=1, keepdim=True, correction=0)
    return (x - mu) / (sd + eps)


def pearson_matrix(a, b, device=None) -> torch.Tensor:
    """Pearson correlation between every row of ``a`` (A, L) and every
    row of ``b`` (B, L) -> (A, B), as one matmul on standardised rows."""
    az = _standardize_rows(_as_f32(a, device))
    bz = _standardize_rows(_as_f32(b, device))
    return az @ bz.T / az.shape[1]


def masked_pearson_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """NaN-aware Pearson matrix between rows of ``a`` (A, L) and ``b``
    (B, L): each pair uses only the loci observed in both rows
    (reference: assign_s_to_clones.py:30-44), in float64 NumPy."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    ma = np.isfinite(a).astype(np.float64)
    mb = np.isfinite(b).astype(np.float64)
    a0 = np.where(ma > 0, a, 0.0)
    b0 = np.where(mb > 0, b, 0.0)

    n = ma @ mb.T
    sx = a0 @ mb.T
    sy = ma @ b0.T
    sxx = (a0 * a0) @ mb.T
    syy = ma @ (b0 * b0).T
    sxy = a0 @ b0.T

    cov = n * sxy - sx * sy
    var_x = n * sxx - sx * sx
    var_y = n * syy - sy * sy
    denom = np.sqrt(np.clip(var_x, 0, None) * np.clip(var_y, 0, None))
    with np.errstate(invalid="ignore", divide="ignore"):
        r = cov / denom
    return np.where(denom > 0, r, np.nan)


def skew(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """scipy.stats.skew with bias=True."""
    mu = torch.mean(x, dim=dim, keepdim=True)
    m2 = torch.mean((x - mu) ** 2, dim=dim)
    m3 = torch.mean((x - mu) ** 3, dim=dim)
    return m3 / torch.clamp(m2, min=1e-30) ** 1.5


def _row_percentiles(x: torch.Tensor, pcts) -> list:
    """Per-row linear-interpolation percentiles, the jnp.percentile
    formula (low * (1 - w) + high * w at q * (n - 1)); one sort serves
    every requested percentile."""
    xs = torch.sort(x, dim=1).values
    n = xs.shape[1]
    out = []
    for pct in pcts:
        q = torch.tensor(pct, dtype=torch.float32) / 100.0 * (n - 1)
        lo, hi = torch.floor(q), torch.ceil(q)
        w_hi = q - lo
        lo_i = int(min(max(lo.item(), 0), n - 1))
        hi_i = int(min(max(hi.item(), 0), n - 1))
        out.append(xs[:, lo_i] * (1.0 - w_hi).to(x.device)
                   + xs[:, hi_i] * w_hi.to(x.device))
    return out


def gmm2_em(x: torch.Tensor, num_iters: int = 60, eps: float = 1e-6
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """2-component 1-D Gaussian mixture per row of ``x`` (cells, loci):
    split at the 25th/75th percentiles, then a fixed number of EM
    iterations.  Returns (means, variances, weights), each (cells, 2)."""
    lo, hi = _row_percentiles(x, (25.0, 75.0))
    mu = torch.stack([lo, hi], dim=1)
    var = torch.var(x, dim=1, keepdim=True, correction=0) \
        * torch.ones((1, 2), dtype=x.dtype, device=x.device) + eps
    w = torch.full(mu.shape, 0.5, dtype=x.dtype, device=x.device)
    for _ in range(num_iters):
        diff = x[:, :, None] - mu[:, None, :]
        log_p = (
            -0.5 * diff * diff / var[:, None, :]
            - 0.5 * torch.log(2.0 * np.pi * var[:, None, :])
            + torch.log(w[:, None, :] + eps)
        )
        r = torch.softmax(log_p, dim=2)
        nk = torch.sum(r, dim=1) + eps
        mu = torch.sum(r * x[:, :, None], dim=1) / nk
        diff = x[:, :, None] - mu[:, None, :]
        var = torch.sum(r * diff * diff, dim=1) / nk + eps
        w = nk / x.shape[1]
    return mu, var, w


def gmm2_log_likelihood(x: torch.Tensor, mu: torch.Tensor,
                        var: torch.Tensor, w: torch.Tensor,
                        eps: float = 1e-6) -> torch.Tensor:
    """Mean per-point log-likelihood of each row of ``x`` (cells, loci)
    under its 2-GMM (``mu``, ``var``, ``w``: (cells, 2), as
    :func:`gmm2_em` returns them) -> (cells,)."""
    diff = x[:, :, None] - mu[:, None, :]
    log_p = (
        -0.5 * diff * diff / var[:, None, :]
        - 0.5 * torch.log(2.0 * np.pi * var[:, None, :])
        + torch.log(w[:, None, :] + eps)
    )
    return torch.mean(torch.logsumexp(log_p, dim=2), dim=1)


def linspace_f32(start: float, stop: float, num: int,
                 device=None) -> torch.Tensor:
    """float32 ``jnp.linspace(start, stop, num)`` as XLA computes it on
    the CPU: ``start * (1 - i r) + i (stop r)`` with r = 1 / (num - 1)
    folded to a float32 constant and the last product fused into the
    add; the last entry is ``stop``.  ``torch.linspace`` differs from it
    in the last bit of about half the entries."""
    f32, f64 = np.float32, np.float64
    i = np.arange(num - 1, dtype=f32)
    r = f32(1.0) / f32(num - 1)
    head = (f32(start) * (f32(1.0) - i * r)).astype(f32)
    fused = (i.astype(f64) * f64(f32(stop) * r) + head.astype(f64))
    out = np.append(fused.astype(f32), f32(stop))
    return torch.as_tensor(out, device=device)


def manhattan_binarize(x: torch.Tensor, num_thresh: int = 100,
                       mean_gap_thresh: float = 0.7,
                       early_s_skew_thresh: float = 0.2,
                       late_s_skew_thresh: float = -0.2,
                       scale_input: bool = True,
                       thresh_from_binaries: bool = True):
    """Binarise each cell's profile at the Manhattan-optimal threshold
    (reference: pert_model.py:364-423, binarize_rt_profiles.py:44-117):
    2-GMM means set the binary levels (skew-dependent percentiles when
    the means are closer than ``mean_gap_thresh``), and ``num_thresh``
    thresholds are scanned for the least L1 distance between the
    profile and its binarisation: linspace(b0, b1) per cell when
    ``thresh_from_binaries``, else linspace(-3, 3).  ``scale_input``
    standardises each row first.

    Returns (rt_state (cells, loci) int32, frac_rt (cells,),
    best_thresh (cells,), (means, vars, weights), dists (cells,
    num_thresh)).
    """
    x = x.to(torch.float32)
    if scale_input:
        x = _standardize_rows(x)
    mu, var, w = gmm2_em(x)
    mean_lo = torch.min(mu, dim=1).values
    mean_hi = torch.max(mu, dim=1).values
    mean_gap = mean_hi - mean_lo

    cell_skew = skew(x, dim=1)
    p5, p25, p50, p75, p95 = _row_percentiles(
        x, (5.0, 25.0, 50.0, 75.0, 95.0))
    early = cell_skew > early_s_skew_thresh
    late = cell_skew < late_s_skew_thresh
    fb_b0 = torch.where(early, p50, torch.where(late, p5, p25))
    fb_b1 = torch.where(early, p95, torch.where(late, p50, p75))

    close = mean_gap < mean_gap_thresh
    b0 = torch.where(close, fb_b0, mean_lo)
    b1 = torch.where(close, fb_b1, mean_hi)

    if thresh_from_binaries:
        frac = linspace_f32(0.0, 1.0, num_thresh, device=x.device)
        threshs = b0[:, None] + (b1 - b0)[:, None] * frac[None, :]
    else:
        threshs = linspace_f32(-3.0, 3.0, num_thresh, device=x.device) \
            [None, :].expand(x.shape[0], num_thresh)

    best_dist = torch.full((x.shape[0],), float("inf"), dtype=torch.float32,
                           device=x.device)
    best_t = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    dists = []
    for j in range(num_thresh):
        t = threshs[:, j]
        bin_x = torch.where(x > t[:, None], b1[:, None], b0[:, None])
        dist = torch.sum(torch.abs(x - bin_x), dim=1)
        better = dist < best_dist
        best_dist = torch.where(better, dist, best_dist)
        best_t = torch.where(better, t, best_t)
        dists.append(dist)

    rt_state = (x > best_t[:, None]).to(torch.int32)
    frac_rt = torch.mean(rt_state.to(torch.float32), dim=1)
    return rt_state, frac_rt, best_t, (mu, var, w), torch.stack(dists, 1)


def guess_times(reads, etas, upsilon: float = 6.0, loci_mask=None,
                device=None):
    """Initial guess of each cell's time in S-phase (reference:
    pert_model.py:426-457): reads normalised by the CN-prior argmax state
    (0.5 where the prior says homozygous deletion), Manhattan-binarised;
    the replicated fraction seeds ``t_init`` and a Beta(alpha,
    upsilon - alpha) prior.  ``loci_mask`` drops padded loci first."""
    reads = _as_f32(reads, device)
    etas = torch.as_tensor(etas, device=reads.device)
    if loci_mask is not None:
        keep = np.asarray(loci_mask).astype(bool)
        if not keep.all():
            idx = torch.as_tensor(np.flatnonzero(keep), device=reads.device)
            reads = reads[:, idx]
            etas = etas[:, idx]
    cn_states = torch.argmax(etas, dim=-1).to(torch.float32)
    denom = torch.where(cn_states > 0.0, cn_states,
                        torch.full_like(cn_states, 0.5))
    _, frac_rt, _, _, _ = manhattan_binarize(reads / denom)
    t_init = frac_rt
    t_alpha = t_init * upsilon
    t_beta = upsilon - t_alpha
    return t_init, t_alpha, t_beta


def autocorrelation_mean(x: np.ndarray, min_lag: int = 10,
                         max_lag: int = 50) -> float:
    """Mean of the ACF over lags [min_lag, max_lag], in float64 NumPy.

    Replaces ``statsmodels.tsa.acf`` in ``autocorr``
    (reference: predict_cycle_phase.py:23-25): ACF computed with the
    standard biased estimator (denominator n, lag-0 variance); a series
    of no more than ``max_lag`` points stops at lag n - 1, and a
    constant one has ACF 0 past lag 0.
    """
    x = np.asarray(x, np.float64)
    n = x.size
    x = x - x.mean()
    denom = np.dot(x, x)
    if denom == 0 or n <= max_lag:
        max_lag = min(max_lag, n - 1)
    acf = np.empty(max_lag + 1)
    acf[0] = 1.0
    for k in range(1, max_lag + 1):
        acf[k] = np.dot(x[:-k], x[k:]) / denom if denom > 0 else 0.0
    return float(np.mean(acf[min_lag - 1:]))


def mode_int(values: np.ndarray) -> float:
    """Most frequent value (ties -> smallest), as scipy.stats.mode."""
    vals, counts = np.unique(np.asarray(values), return_counts=True)
    return float(vals[np.argmax(counts)])
