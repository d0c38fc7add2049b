"""Consensus per-clone pseudobulk profiles (port, a pandas copy, of
``pipeline/consensus.py``; reference:
compute_consensus_clone_profiles.py:17-88)."""

from __future__ import annotations

import numpy as np
import pandas as pd

from scdna_replication_tools_tpu_torch.ops.stats import mode_int


def add_cell_ploidies(
    cn: pd.DataFrame,
    cell_col: str = "cell_id",
    cn_state_col: str = "state",
    ploidy_col: str = "ploidy",
) -> pd.DataFrame:
    """Ploidy = modal CN state per cell."""
    ploidies = cn.groupby(cell_col, observed=True)[cn_state_col] \
        .agg(lambda s: mode_int(s.to_numpy()))
    cn = cn.copy()
    cn[ploidy_col] = cn[cell_col].map(ploidies)
    return cn


def filter_ploidies(
    cn: pd.DataFrame,
    clone_col: str = "clone_id",
    ploidy_col: str = "ploidy",
) -> pd.DataFrame:
    """Keep each clone's majority-ploidy cells."""
    pieces = []
    for _, group in cn.groupby(clone_col, observed=True):
        keep = group.groupby(ploidy_col, observed=True).size().idxmax()
        pieces.append(group[group[ploidy_col] == keep])
    return pd.concat(pieces, ignore_index=True)


def compute_consensus_clone_profiles(
    cn: pd.DataFrame,
    col_name: str,
    clone_col: str = "clone_id",
    cell_col: str = "cell_id",
    chr_col: str = "chr",
    start_col: str = "start",
    cn_state_col: str = "state",
    ploidy_col: str = "ploidy",
    aggfunc=np.median,
) -> pd.DataFrame:
    """(loci x clones) consensus profile frame for ``col_name``, dropping
    'None' clones and filtering to majority ploidy when ``cn_state_col``
    is present."""
    cn = cn[cn[clone_col] != "None"].copy()

    if cn_state_col is not None and cn_state_col in cn.columns:
        cn = add_cell_ploidies(cn, cell_col=cell_col,
                               cn_state_col=cn_state_col,
                               ploidy_col=ploidy_col)
        cn = filter_ploidies(cn, clone_col=clone_col, ploidy_col=ploidy_col)

    return cn.pivot_table(
        index=[chr_col, start_col], columns=clone_col, values=col_name,
        aggfunc=aggfunc, observed=True,
    )
