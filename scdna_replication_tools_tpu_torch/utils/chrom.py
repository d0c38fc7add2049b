"""Genome ordering for long-form scWGS DataFrames.

Port (a copy: no JAX involved) of ``utils/chrom.py``'s ordering:
chromosomes 1..22 then X then Y (reference: pert_model.py:194-203).
"""

from __future__ import annotations

import numpy as np
import pandas as pd

CHR_ORDER = [str(i + 1) for i in range(22)] + ["X", "Y"]


def as_chr_categorical(series: pd.Series) -> pd.Series:
    """Cast a chromosome column to the canonical ordered categorical."""
    s = series.astype(str).astype("category")
    return s.cat.set_categories(CHR_ORDER, ordered=True)


def as_chr_categorical_array(values) -> pd.Categorical:
    """Array-level twin of :func:`as_chr_categorical` (non-canonical
    contigs become NaN)."""
    cat = pd.Categorical(np.asarray(values).astype(str))
    return cat.set_categories(CHR_ORDER, ordered=True)


def sort_by_cell_and_loci(cn: pd.DataFrame, cell_col: str = "cell_id",
                          chr_col: str = "chr", start_col: str = "start"
                          ) -> pd.DataFrame:
    """Sort a long-form frame so each cell follows genomic order
    (reference: pert_model.py:194-203)."""
    cn = cn.copy()
    cn[chr_col] = as_chr_categorical(cn[chr_col])
    return cn.sort_values(by=[cell_col, chr_col, start_col], kind="mergesort")
