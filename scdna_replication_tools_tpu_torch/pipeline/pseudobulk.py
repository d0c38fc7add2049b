"""Population- and clone-level pseudobulk replication-timing profiles
(port, a host pandas copy, of ``pipeline/pseudobulk.py``).

Mirrors ``compute_pseudobulk_rt_profiles``
(reference: compute_pseudobulk_rt_profiles.py:16-69): per-locus means of a
replication column, rescaled to 0-10 "hours" with the latest loci largest.
The reference's per-locus Python loop (:18-24) is one groupby mean.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def calc_population_rt(cn: pd.DataFrame, input_col: str, output_col: str,
                       time_col='rt_hours', chr_col='chr',
                       start_col='start') -> pd.DataFrame:
    pop = (cn.groupby([chr_col, start_col], observed=True)[input_col]
           .mean().rename(output_col).reset_index())

    # hours: invert so latest loci (smallest mean) get the largest value,
    # normalised to [0, 10] (reference:
    # compute_pseudobulk_rt_profiles.py:28-36)
    a = pop[output_col].to_numpy(np.float64)
    a = -(a - a.max())
    amax = a.max()
    pop[time_col] = (a / amax * 10.0) if amax > 0 else 0.0
    return pop


def compute_pseudobulk_rt_profiles(cn: pd.DataFrame, input_col: str,
                                   output_col='pseudobulk',
                                   time_col='hours', clone_col='clone_id',
                                   chr_col='chr', start_col='start'
                                   ) -> pd.DataFrame:
    bulk = calc_population_rt(
        cn, input_col, f"{output_col}_{input_col}",
        time_col=f"{output_col}_{time_col}", chr_col=chr_col,
        start_col=start_col)

    if clone_col is not None and clone_col in cn.columns:
        for clone_id, clone_cn in cn.groupby(clone_col, observed=True):
            oc = f"{output_col}_clone{clone_id}_{input_col}"
            tc = f"{output_col}_clone{clone_id}_{time_col}"
            clone_bulk = calc_population_rt(
                clone_cn, input_col, oc, time_col=tc, chr_col=chr_col,
                start_col=start_col)
            bulk = pd.merge(bulk, clone_bulk[[chr_col, start_col, oc, tc]])
    return bulk
