"""Assign S-phase cells to clones by profile correlation (port, a pandas
and NumPy copy, of ``pipeline/assign.py``; reference:
assign_s_to_clones.py:18-79)."""

from __future__ import annotations

import numpy as np
import pandas as pd

from scdna_replication_tools_tpu_torch.ops.stats import masked_pearson_matrix


def assign_s_to_clones(
    s_phase_cells: pd.DataFrame,
    clone_df: pd.DataFrame,
    col_name: str = "reads",
    clone_col: str = "clone_id",
    cell_col: str = "cell_id",
    chr_col: str = "chr",
    start_col: str = "start",
) -> pd.DataFrame:
    """Add ``clone_col`` to ``s_phase_cells`` from the best-matching
    clone of the (loci x clones) consensus frame ``clone_df``."""
    s_phase_cells = s_phase_cells.copy()
    s_phase_cells[chr_col] = s_phase_cells[chr_col].astype(str)

    clone_idx_cols = [chr_col, start_col]
    if set(clone_idx_cols).issubset(clone_df.columns):
        clone_df = clone_df.set_index(clone_idx_cols)

    cell_mat = s_phase_cells.pivot_table(
        index=cell_col, columns=clone_idx_cols, values=col_name,
        dropna=False, observed=True)

    key = pd.MultiIndex.from_arrays([
        cell_mat.columns.get_level_values(0).astype(str),
        cell_mat.columns.get_level_values(1),
    ])
    clone_key = pd.MultiIndex.from_arrays([
        clone_df.index.get_level_values(0).astype(str),
        clone_df.index.get_level_values(1),
    ])
    clone_mat = clone_df.copy()
    clone_mat.index = clone_key
    clone_mat = clone_mat.reindex(key)

    vals = np.array(cell_mat.to_numpy(np.float64))
    vals[~np.isfinite(vals)] = np.nan
    clone_vals = clone_mat.to_numpy(np.float64).T
    corr = masked_pearson_matrix(vals, clone_vals)

    # zero-variance profiles make Pearson undefined; fall back to the
    # negative mean squared distance for those pairs
    if np.isnan(corr).any():
        a0 = np.nan_to_num(vals)
        d2 = (
            np.sum(a0 * a0, axis=1)[:, None]
            - 2.0 * a0 @ np.nan_to_num(clone_vals).T
            + np.sum(np.nan_to_num(clone_vals) ** 2, axis=1)[None, :]
        )
        corr = np.where(np.isnan(corr), -2.0 - d2 / (1.0 + np.abs(d2).max()),
                        corr)
    best = np.argmax(corr, axis=1)
    assignment = pd.Series(
        np.asarray(clone_df.columns)[best], index=cell_mat.index)

    s_phase_cells[clone_col] = s_phase_cells[cell_col].map(assignment)
    return s_phase_cells
