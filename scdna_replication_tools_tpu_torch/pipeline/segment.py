"""Least-squares changepoint detection (port of ``pipeline/segment.py``;
the reference's ruptures.KernelCPD(kernel='linear', min_size=2),
normalize_by_cell.py:45-46, 73-74).

For the linear kernel the search minimises the within-segment sum of
squared deviations from the segment mean; for 1 or 2 breakpoints it is
solved exactly from prefix sums.  :func:`find_breakpoints` is the NumPy
search (the oracle); :func:`find_breakpoints_batch` runs every row on
the threaded host C++ library ``csrc/segment.cpp``, built at first use
(``ops/_cuda.library``).  A failed build raises: the exact
2-breakpoint sweep is O(n^2) per cell, so the per-row NumPy search would
take hours at a thousand cells of 5451 loci.
"""

from __future__ import annotations

import ctypes
import os
from typing import List

import numpy as np

from scdna_replication_tools_tpu_torch.ops import _cuda


def _segment_cost_table(y: np.ndarray):
    """cost(i, j) = sum of squared deviations of y[i:j] from its mean,
    from prefix sums."""
    s1 = np.concatenate([[0.0], np.cumsum(y)])
    s2 = np.concatenate([[0.0], np.cumsum(y * y)])

    def cost(i, j):
        n = j - i
        tot = s1[j] - s1[i]
        return (s2[j] - s2[i]) - tot * tot / np.maximum(n, 1)

    return cost


def find_breakpoints(y: np.ndarray, n_bkps: int, min_size: int = 2
                     ) -> List[int]:
    """Optimal breakpoints, as ruptures' ``predict`` returns them: the
    sorted segment ends, without 0 and with len(y)."""
    y = np.asarray(y, np.float64)
    n = len(y)
    cost = _segment_cost_table(y)

    if n_bkps == 1:
        ks = np.arange(min_size, n - min_size + 1)
        if len(ks) == 0:
            return [n]
        costs = cost(0, ks) + cost(ks, n)
        k = int(ks[np.argmin(costs)])
        return [k, n]

    if n_bkps == 2:
        best = (np.inf, None)
        a_vals = np.arange(min_size, n - 2 * min_size + 1)
        if len(a_vals) == 0:
            return [n]
        left = cost(0, a_vals)
        for idx, a in enumerate(a_vals):
            b_vals = np.arange(a + min_size, n - min_size + 1)
            if len(b_vals) == 0:
                continue
            tot = left[idx] + cost(a, b_vals) + cost(b_vals, n)
            j = int(np.argmin(tot))
            if tot[j] < best[0]:
                best = (tot[j], (int(a), int(b_vals[j])))
        if best[1] is None:
            return [n]
        a, b = best[1]
        return [a, b, n]

    raise NotImplementedError("only 1 or 2 breakpoints are supported")


def find_breakpoints_batch(Y: np.ndarray, n_bkps: int, min_size: int = 2,
                           row_len: np.ndarray = None) -> np.ndarray:
    """Exact breakpoints of every row of ``Y`` on the host library: the
    search of :func:`find_breakpoints`, row for row and tie for tie.

    ``row_len[i]`` (optional) restricts row i to its leading entries.
    Returns (rows, 2) int64: [a, b] for 2 breakpoints, [k, -1] for 1,
    and [-1, -1] where a row is too short to split.
    """
    Y = np.ascontiguousarray(Y, np.float64)
    n_rows, n_loci = Y.shape
    if row_len is None:
        row_len = np.full(n_rows, n_loci, np.int64)
    row_len = np.ascontiguousarray(row_len, np.int64)
    if row_len.shape != (n_rows,) or row_len.min(initial=0) < 0 \
            or row_len.max(initial=0) > n_loci:
        raise ValueError(f"row_len must hold {n_rows} lengths in "
                         f"[0, {n_loci}]")
    lib = _cuda.library("segment")
    out = np.full((n_rows, 2), -1, np.int64)
    lib.batch_bkps_f64(
        Y.ctypes.data_as(_cuda._F64P), row_len.ctypes.data_as(_cuda._I64P),
        ctypes.c_int64(n_rows), ctypes.c_int64(n_loci),
        ctypes.c_int32(n_bkps), ctypes.c_int32(min_size),
        out.ctypes.data_as(_cuda._I64P),
        ctypes.c_int32(max(1, min(16, os.cpu_count() or 1))))
    return out
