"""Genome ordering for long-form scWGS DataFrames.

Port (a copy: no JAX involved) of ``utils/chrom.py``'s ordering:
chromosomes 1..22 then X then Y (reference: pert_model.py:194-203).
"""

from __future__ import annotations

import pandas as pd

CHR_ORDER = [str(i + 1) for i in range(22)] + ["X", "Y"]


def as_chr_categorical(series: pd.Series) -> pd.Series:
    """Cast a chromosome column to the canonical ordered categorical."""
    s = series.astype(str).astype("category")
    return s.cat.set_categories(CHR_ORDER, ordered=True)
