"""Long-form <-> dense marshalling on the native library (port of the
JAX package's ``native/pivot.py``).

``scatter_pivot`` replaces the pandas ``pivot_table`` walk of the
reference's ``process_input_data`` (reference: pert_model.py:143-146):
keys are factorised once and values scattered straight into the dense
(cells x loci) matrix by the multithreaded C++ kernel of
``csrc/pivot.cpp`` (built at first use by ``ops/_cuda.library``).
Semantics: one row per (cell, locus) key; with duplicate keys the last
row wins (the loader routes duplicates to ``pivot_table`` upstream).

``use_native``: ``None`` or ``True`` take the library, and a failed
build raises (the JAX package falls back to NumPy when it finds no
toolchain; ROADMAP C); ``False`` takes the NumPy scatter, which gives the
same matrix bit for bit.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from scdna_replication_tools_tpu_torch.ops import _cuda


def _threads() -> int:
    return max(1, min(16, os.cpu_count() or 1))


def _check_keys(cell_codes, locus_codes, n_cells, n_loci, n_values):
    """Every key inside the (n_cells, n_loci) matrix, one per value: the
    library writes and reads through the codes unchecked."""
    if len(cell_codes) != len(locus_codes) or len(cell_codes) != n_values:
        raise ValueError(f"{len(cell_codes)} cell codes, {len(locus_codes)} "
                         f"locus codes and {n_values} values must be as many")
    for name, codes, n in (("cell", cell_codes, n_cells),
                           ("locus", locus_codes, n_loci)):
        if len(codes) and (codes.min() < 0 or codes.max() >= n):
            raise ValueError(f"{name} codes must lie in [0, {n})")


def scatter_pivot(cell_codes: np.ndarray, locus_codes: np.ndarray,
                  values: np.ndarray, n_cells: int, n_loci: int,
                  use_native: Optional[bool] = None) -> np.ndarray:
    """Dense (n_cells, n_loci) float32 matrix, NaN where no key appeared."""
    out = np.full((n_cells, n_loci), np.nan, np.float32)
    cell_codes = np.ascontiguousarray(cell_codes, np.int32)
    locus_codes = np.ascontiguousarray(locus_codes, np.int32)
    values = np.ascontiguousarray(values, np.float64)
    _check_keys(cell_codes, locus_codes, n_cells, n_loci, len(values))
    if use_native is False:
        out[cell_codes, locus_codes] = values
        return out
    _cuda.library("pivot").scatter_pivot_f32(
        cell_codes.ctypes.data_as(_cuda._I32P),
        locus_codes.ctypes.data_as(_cuda._I32P),
        values.ctypes.data_as(_cuda._F64P),
        ctypes.c_int64(len(values)),
        out.ctypes.data_as(_cuda._F32P),
        ctypes.c_int64(n_loci),
        ctypes.c_int32(_threads()),
    )
    return out


def gather_melt(mat: np.ndarray, cell_codes: np.ndarray,
                locus_codes: np.ndarray,
                use_native: Optional[bool] = None) -> np.ndarray:
    """Values of ``mat`` at each (cell, locus) key -- dense back to long."""
    mat = np.ascontiguousarray(mat, np.float32)
    cell_codes = np.ascontiguousarray(cell_codes, np.int32)
    locus_codes = np.ascontiguousarray(locus_codes, np.int32)
    _check_keys(cell_codes, locus_codes, *mat.shape, len(cell_codes))
    if use_native is False:
        return mat[cell_codes, locus_codes]
    out = np.empty(len(cell_codes), np.float32)
    _cuda.library("pivot").gather_melt_f32(
        mat.ctypes.data_as(_cuda._F32P),
        cell_codes.ctypes.data_as(_cuda._I32P),
        locus_codes.ctypes.data_as(_cuda._I32P),
        ctypes.c_int64(len(cell_codes)),
        ctypes.c_int64(mat.shape[1]),
        out.ctypes.data_as(_cuda._F32P),
        ctypes.c_int32(_threads()),
    )
    return out
