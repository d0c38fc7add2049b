"""Deterministic (non-probabilistic) scRT inference levels (port of
``pipeline/deterministic.py``): k-means clone discovery, the LOWESS
curve and the binarisation run on ``device`` (None = the GPU), the rest
is host pandas.

The pre-PERT heuristic pipeline, mirroring the reference's
``scRT.infer_cell_level`` / ``infer_clone_level`` / ``infer_bulk_level``
(reference: infer_scRT.py:171-276): clustering -> clone assignment -> GC
correction -> normalisation (per-cell / per-clone / pseudobulk) ->
Manhattan binarisation.  These double as baselines for the PERT model.
"""

from __future__ import annotations

from typing import Optional


from scdna_replication_tools_tpu_torch.config import ColumnConfig
from scdna_replication_tools_tpu_torch.pipeline.assign import (
    assign_s_to_clones,
)
from scdna_replication_tools_tpu_torch.pipeline.binarize import (
    binarize_profiles,
)
from scdna_replication_tools_tpu_torch.pipeline.clustering import (
    discover_clones,
)
from scdna_replication_tools_tpu_torch.pipeline.consensus import (
    compute_consensus_clone_profiles,
)
from scdna_replication_tools_tpu_torch.pipeline.gc_correction import (
    bulk_g1_gc_correction,
)
from scdna_replication_tools_tpu_torch.pipeline.normalize import (
    normalize_by_cell,
    normalize_by_clone,
)


def _cluster_if_needed(cn_s, cn_g1, cols: ColumnConfig,
                       clone_col: Optional[str],
                       clustering_method: str = 'kmeans',
                       clustering_kwargs: Optional[dict] = None,
                       device=None):
    if clone_col is None:
        cn_g1, clone_col = discover_clones(
            cn_g1, cols.assign_col, cell_col=cols.cell_col,
            chr_col=cols.chr_col, start_col=cols.start_col,
            method=clustering_method, device=device,
            **(clustering_kwargs or {}))
    return cn_s, cn_g1, clone_col


def infer_cell_level(cn_s, cn_g1, cols: ColumnConfig,
                     clone_col: Optional[str],
                     clustering_method: str = 'kmeans',
                     clustering_kwargs: Optional[dict] = None,
                     device=None):
    """reference: infer_scRT.py:171-204."""
    cn_s, cn_g1, clone_col = _cluster_if_needed(
        cn_s, cn_g1, cols, clone_col, clustering_method, clustering_kwargs,
        device)

    clone_profiles = compute_consensus_clone_profiles(
        cn_g1, cols.assign_col, clone_col=clone_col, cell_col=cols.cell_col,
        chr_col=cols.chr_col, start_col=cols.start_col,
        cn_state_col=cols.cn_state_col)

    cn_s = assign_s_to_clones(cn_s, clone_profiles, col_name=cols.assign_col,
                              clone_col=clone_col, cell_col=cols.cell_col,
                              chr_col=cols.chr_col, start_col=cols.start_col)

    cn_s, cn_g1 = bulk_g1_gc_correction(
        cn_s, cn_g1, input_col=cols.input_col, gc_col=cols.gc_col,
        cell_col=cols.cell_col, library_col=cols.library_col,
        output_col=cols.rpm_gc_norm_col, device=device)

    cn_s = normalize_by_cell(
        cn_s, cn_g1, input_col=cols.rpm_gc_norm_col, clone_col=clone_col,
        temp_col=cols.temp_rt_col, output_col=cols.rv_col,
        seg_col=cols.seg_col, cell_col=cols.cell_col, chr_col=cols.chr_col,
        start_col=cols.start_col, cn_state_col=cols.cn_state_col,
        ploidy_col=cols.ploidy_col)

    cn_s, manhattan_df = binarize_profiles(
        cn_s, cols.rv_col, rs_col=cols.rs_col, frac_rt_col=cols.frac_rt_col,
        thresh_col=cols.thresh_col, cell_col=cols.cell_col, device=device)

    return cn_s, manhattan_df, clone_profiles, clone_col


def infer_clone_level(cn_s, cn_g1, cols: ColumnConfig,
                      clone_col: Optional[str],
                      clustering_method: str = 'kmeans',
                      clustering_kwargs: Optional[dict] = None,
                      device=None):
    """reference: infer_scRT.py:207-242."""
    cn_s, cn_g1, clone_col = _cluster_if_needed(
        cn_s, cn_g1, cols, clone_col, clustering_method, clustering_kwargs,
        device)

    clone_profiles = compute_consensus_clone_profiles(
        cn_g1, cols.assign_col, clone_col=clone_col, cell_col=cols.cell_col,
        chr_col=cols.chr_col, start_col=cols.start_col,
        cn_state_col=cols.cn_state_col)

    cn_s = assign_s_to_clones(cn_s, clone_profiles, col_name=cols.input_col,
                              clone_col=clone_col, cell_col=cols.cell_col,
                              chr_col=cols.chr_col, start_col=cols.start_col)

    cn_s, cn_g1 = bulk_g1_gc_correction(
        cn_s, cn_g1, input_col=cols.input_col, gc_col=cols.gc_col,
        cell_col=cols.cell_col, library_col=cols.library_col,
        output_col=cols.rpm_gc_norm_col, device=device)

    profiles_gc_norm = compute_consensus_clone_profiles(
        cn_g1, cols.rpm_gc_norm_col, clone_col=clone_col,
        cell_col=cols.cell_col, chr_col=cols.chr_col,
        start_col=cols.start_col, cn_state_col=cols.cn_state_col)

    cn_s = normalize_by_clone(
        cn_s, profiles_gc_norm, input_col=cols.rpm_gc_norm_col,
        clone_col=clone_col, output_col=cols.rv_col, cell_col=cols.cell_col,
        chr_col=cols.chr_col, start_col=cols.start_col,
        cn_state_col=cols.cn_state_col, ploidy_col=cols.ploidy_col)

    cn_s, manhattan_df = binarize_profiles(
        cn_s, cols.rv_col, rs_col=cols.rs_col, frac_rt_col=cols.frac_rt_col,
        thresh_col=cols.thresh_col, cell_col=cols.cell_col, device=device)

    return cn_s, manhattan_df, profiles_gc_norm, clone_col


def infer_bulk_level(cn_s, cn_g1, cols: ColumnConfig,
                     clone_col: Optional[str], device=None):
    """reference: infer_scRT.py:245-276 — one dummy pseudobulk clone."""
    dummy = f'dummy_{clone_col}'
    cn_s = cn_s.copy()
    cn_g1 = cn_g1.copy()
    cn_s[dummy] = '1'
    cn_g1[dummy] = '1'

    bulk_profile = compute_consensus_clone_profiles(
        cn_g1, cols.input_col, clone_col=dummy, cell_col=cols.cell_col,
        chr_col=cols.chr_col, start_col=cols.start_col, cn_state_col=None)

    cn_s = normalize_by_clone(
        cn_s, bulk_profile, input_col=cols.input_col, clone_col=dummy,
        output_col=cols.rv_col, cell_col=cols.cell_col,
        chr_col=cols.chr_col, start_col=cols.start_col,
        cn_state_col=cols.cn_state_col, ploidy_col=cols.ploidy_col)

    cn_s, manhattan_df = binarize_profiles(
        cn_s, cols.rv_col, rs_col=cols.rs_col, frac_rt_col=cols.frac_rt_col,
        thresh_col=cols.thresh_col, cell_col=cols.cell_col, device=device)

    cn_s = cn_s.drop(columns=[dummy])
    return cn_s, manhattan_df
