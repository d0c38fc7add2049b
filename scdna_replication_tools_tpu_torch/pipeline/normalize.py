"""S-phase profile normalisation against G1 references (port, a host
pandas copy, of ``pipeline/normalize.py``; its changepoint sweeps run
on the port's host library, ``pipeline/segment.py``).

Covers the reference modules ``normalize_by_cell.py`` and
``normalize_by_clone.py``:

* :func:`normalize_by_cell` — each S cell is matched to its best-Pearson
  G1 cell within the clone and normalised by that cell's CN states, then
  cell-specific CNAs are removed via changepoint scanning
  (reference: normalize_by_cell.py:216-267).  The per-cell Pearson loops
  (:148-180) collapse into one masked (S x G1) correlation matrix.
* :func:`normalize_by_clone` — each S cell is divided by its clone's
  consensus profile (reference: normalize_by_clone.py:51-77).
* :func:`remove_cell_specific_CNAs` — iterative 2-breakpoint interior scan
  plus 1-breakpoint chr1/chrX edge scan with median-ratio and t-test gates
  (reference: normalize_by_cell.py:35-145).  Note: the reference computes
  its background as ``Y[~temp_indices]`` where ``temp_indices`` is an
  *integer* array — bitwise-not indexing that selects a MIRRORED slice
  from the far end of the genome, not the complement.  That quirk is
  reproduced here deliberately: it is load-bearing.  Measured on
  replication-bearing profiles, comparing a candidate region against its
  mirrored counterpart (instead of the full complement) weakens the CNA
  gate exactly enough that smooth replication blocks survive, while true
  whole-arm CNAs still trip it; "fixing" the background to the intended
  complement flattens most of the RT signal (median-of-ratio gates are
  meaningless on the zero-centered scaled profile) and drops cell-level
  rep-state accuracy to chance.  Shipped behaviour beats intent.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import pandas as pd
from scipy.stats import ttest_ind

from scdna_replication_tools_tpu_torch.ops.stats import masked_pearson_matrix
from scdna_replication_tools_tpu_torch.pipeline.consensus import (
    add_cell_ploidies,
)
from scdna_replication_tools_tpu_torch.pipeline.segment import (
    find_breakpoints,
    find_breakpoints_batch,
)
from scdna_replication_tools_tpu_torch.utils.chrom import sort_by_cell_and_loci


def scale(x: np.ndarray) -> np.ndarray:
    """Center/scale like sklearn.preprocessing.scale (population std)."""
    x = np.asarray(x, np.float64)
    sd = x.std()
    return (x - x.mean()) / (sd if sd > 0 else 1.0)


def _interior_gate(y: np.ndarray, chroms: np.ndarray, a: int, b: int):
    """CNA acceptance gate for an interior [a, b) segment.

    Reference: normalize_by_cell.py:47-62.  Returns (accept, median_ratio).
    The background is the reference's ``Y[~np.arange(a, b)]`` — a MIRRORED
    slice from the far end of the genome, not the complement; see the
    module docstring for why that quirk is load-bearing and kept verbatim.
    """
    region = y[a:b]
    background = y[~np.arange(a, b)]
    if len(region) == 0 or len(background) == 0:
        return False, 1.0
    median_ratio = np.median(region) / np.median(background)
    _, pval = ttest_ind(region, background)
    same_chr = chroms[a] == chroms[b - 1]
    ok = (median_ratio > 1.1 or median_ratio < 0.9) and pval < 0.05 \
        and same_chr
    return ok, median_ratio


def _edge_gate(y: np.ndarray, chroms: np.ndarray, ind: int):
    """Edge-segment gate: losses at the chr1 start, gains at the chrX end.

    Reference: normalize_by_cell.py:71-104.  Returns
    (accept, slice-or-None, median_ratio).
    """
    if ind <= 0 or ind >= len(y):
        return False, None, 1.0
    left_chr = chroms[ind]
    right_chr = chroms[ind - 1]
    if right_chr == "1":
        sl = slice(0, ind)
    elif left_chr == "X":
        sl = slice(ind, len(y))
    else:
        return False, None, 1.0
    region = y[sl]
    # same mirrored-background semantics (normalize_by_cell.py:90)
    background = y[~np.arange(sl.start, sl.stop)]
    if len(region) == 0 or len(background) == 0:
        return False, None, 1.0
    median_ratio = np.median(region) / np.median(background)
    _, pval = ttest_ind(region, background)
    ok = ((median_ratio > 1.1 and left_chr == "X")
          or (median_ratio < 0.9 and right_chr == "1")) and pval < 0.05
    return ok, sl, median_ratio


def identify_changepoint_segs(y: np.ndarray, chroms: np.ndarray,
                              max_rounds: Optional[int] = None):
    """Iteratively nominate and flatten CNA segments in one profile.

    Mirrors ``identify_changepoint_segs``
    (reference: normalize_by_cell.py:35-113): interior 2-breakpoint scan
    until no significant region, then chr1-start / chrX-end 1-breakpoint
    scan (losses on chr1, gains on chrX only, :96-100).

    ``max_rounds=None`` (default) loops until the gate fails, exactly like
    the reference's unbounded ``while True`` loops (normalize_by_cell.py:44,
    :72); pass an int to bound each phase for adversarial inputs.
    """
    y = np.asarray(y, np.float64).copy()
    chroms = np.asarray(chroms).astype(str)
    chng = np.zeros(len(y))
    j = 1

    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        rounds += 1
        bkps = find_breakpoints(y, n_bkps=2)
        if len(bkps) < 3:
            break
        a, b = bkps[0], bkps[1]
        ok, median_ratio = _interior_gate(y, chroms, a, b)
        if not ok:
            break
        chng[a:b] = j
        j += 1
        y[a:b] /= median_ratio

    rounds = 0
    while max_rounds is None or rounds < max_rounds:
        rounds += 1
        bkps = find_breakpoints(y, n_bkps=1)
        ind = bkps[0]
        ok, sl, median_ratio = _edge_gate(y, chroms, ind)
        if not ok:
            break
        chng[sl] = j
        j += 1
        y[sl] /= median_ratio

    return y, chng


def _trim_tails(x: np.ndarray) -> np.ndarray:
    """Clamp the distribution tails before the changepoint search
    (reference: normalize_by_cell.py:122-128)."""
    x2 = np.where(scale(x) < 4, x, np.percentile(x, 95))
    return np.where(scale(x2) > -4, x2, np.percentile(x2, 5))


def _scale_segments(y: np.ndarray, chng: np.ndarray) -> np.ndarray:
    """Scale within each nominated segment, then overall
    (reference: normalize_by_cell.py:137-143)."""
    scaled = np.empty_like(y)
    for seg in np.unique(chng):
        sel = chng == seg
        scaled[sel] = scale(y[sel])
    return scale(scaled)


def remove_cell_specific_CNAs(cell_cn: pd.DataFrame, input_col='copy_norm',
                              output_col='rt_value',
                              seg_col='changepoint_segments',
                              cell_col='cell_id', chr_col='chr',
                              start_col='start') -> pd.DataFrame:
    """Per-cell CNA removal + per-segment scaling
    (reference: normalize_by_cell.py:116-145)."""
    cell_cn = sort_by_cell_and_loci(cell_cn, cell_col=cell_col,
                                    chr_col=chr_col, start_col=start_col)
    x = cell_cn[input_col].to_numpy(np.float64)

    y, chng = identify_changepoint_segs(
        _trim_tails(x), cell_cn[chr_col].to_numpy())

    cell_cn = cell_cn.copy()
    cell_cn[seg_col] = chng
    cell_cn[output_col] = _scale_segments(y, chng)
    return cell_cn


def remove_cell_specific_CNAs_batch(Y: np.ndarray, row_len: np.ndarray,
                                    chrom_rows: list,
                                    max_rounds: Optional[int] = None):
    """Batched equivalent of per-cell :func:`remove_cell_specific_CNAs`.

    Runs the trim → iterative-flatten → per-segment-scale sequence of
    the reference (normalize_by_cell.py:116-145) for EVERY cell at once.
    All cells advance through the flattening rounds in lock step; each
    round makes ONE :func:`find_breakpoints_batch` call over the still-
    active cells, which lands on the threaded C++ kernel
    (csrc/segment.cpp) — the exact 2-breakpoint search is O(n^2) per
    cell and is the 10k-cell scalability cliff when done per cell in
    Python.  The per-cell gate arithmetic (medians, t-test, flatten) is
    O(n) and intentionally reuses the exact same NumPy calls as the
    single-profile path so the two engines agree bit-for-bit.

    Args:
      Y: (cells, max_len) float64; row i holds the cell's genome-ordered
        profile in its leading ``row_len[i]`` entries.  Modified freely
        (pass a copy if the caller needs the input preserved).
      row_len: (cells,) int array of valid prefix lengths.
      chrom_rows: per-cell str arrays of chromosome labels (len row_len[i]).
      max_rounds: optional per-phase round bound; None = run each phase
        until its gate fails, like the reference's unbounded loops.

    Returns (rt, chng): two (cells, max_len) float64 arrays with the same
    ragged layout — the scaled RT profile and the segment labels.
    """
    Y = np.ascontiguousarray(Y, np.float64)
    n_rows, max_len = Y.shape
    row_len = np.asarray(row_len, np.int64)
    chng = np.zeros_like(Y)
    j_counter = np.ones(n_rows, np.int64)

    ys = Y  # flattened in place, round by round
    for i in range(n_rows):
        n = int(row_len[i])
        if n > 0:  # empty rows stay empty (np.percentile raises on [])
            ys[i, :n] = _trim_tails(ys[i, :n])

    # phase 1: interior 2-breakpoint rounds (reference :44-68)
    # inactive rows are masked by zeroing their row_len (the kernel
    # early-returns -1 for them) rather than fancy-indexing a submatrix,
    # which would copy the full active slab every round
    active = row_len > 0
    rounds = 0
    while active.any() and (max_rounds is None or rounds < max_rounds):
        rounds += 1
        bk = find_breakpoints_batch(ys, n_bkps=2,
                                    row_len=np.where(active, row_len, 0))
        for i in np.nonzero(active)[0]:
            a, b = int(bk[i, 0]), int(bk[i, 1])
            if a < 0:  # row too short for an admissible split
                active[i] = False
                continue
            n = int(row_len[i])
            y = ys[i, :n]
            ok, median_ratio = _interior_gate(y, chrom_rows[i], a, b)
            if not ok:
                active[i] = False
                continue
            chng[i, a:b] = j_counter[i]
            j_counter[i] += 1
            y[a:b] /= median_ratio

    # phase 2: chr1-start / chrX-end 1-breakpoint rounds (reference :72-104)
    active = row_len > 0
    rounds = 0
    while active.any() and (max_rounds is None or rounds < max_rounds):
        rounds += 1
        bk = find_breakpoints_batch(ys, n_bkps=1,
                                    row_len=np.where(active, row_len, 0))
        for i in np.nonzero(active)[0]:
            ind = int(bk[i, 0])
            n = int(row_len[i])
            if ind < 0:
                active[i] = False
                continue
            y = ys[i, :n]
            ok, sl, median_ratio = _edge_gate(y, chrom_rows[i], ind)
            if not ok:
                active[i] = False
                continue
            chng[i, sl] = j_counter[i]
            j_counter[i] += 1
            y[sl] /= median_ratio

    rt = np.zeros_like(Y)
    for i in range(n_rows):
        n = int(row_len[i])
        if n > 0:
            rt[i, :n] = _scale_segments(ys[i, :n], chng[i, :n])
    return rt, chng


def _pivot(cn: pd.DataFrame, value_col, cell_col, chr_col, start_col):
    cn = cn.copy()
    cn[chr_col] = cn[chr_col].astype(str)
    return cn.pivot_table(index=cell_col, columns=[chr_col, start_col],
                          values=value_col, dropna=False, observed=True)


def normalize_by_cell(cn_s: pd.DataFrame, cn_g1: pd.DataFrame,
                      input_col='rpm_gc_norm', clone_col='clone_id',
                      cell_col='cell_id', temp_col='temp_rt',
                      output_col='rt_value',
                      seg_col='changepoint_segments', chr_col='chr',
                      start_col='start', cn_state_col='state',
                      ploidy_col='ploidy', engine='batch') -> pd.DataFrame:
    """Match each S cell to its best G1 cell and normalise
    (reference: normalize_by_cell.py:216-267).

    ``engine='batch'`` (default) runs the changepoint flattening for all
    S cells in lock step through :func:`remove_cell_specific_CNAs_batch`,
    landing the O(n^2) breakpoint sweeps on the threaded C++ kernel;
    ``engine='loop'`` is the per-cell reference-shaped path kept as the
    parity oracle.  The two produce bit-identical output.
    """
    if engine not in ("batch", "loop"):
        raise ValueError(f"unknown engine {engine!r}")
    cn_s = cn_s.dropna().copy()
    cn_g1 = cn_g1.dropna().copy()

    cn_s = add_cell_ploidies(cn_s, cell_col, cn_state_col, ploidy_col)
    cn_g1 = add_cell_ploidies(cn_g1, cell_col, cn_state_col, ploidy_col)

    s_mat = _pivot(cn_s, input_col, cell_col, chr_col, start_col)
    g1_mat = _pivot(cn_g1, input_col, cell_col, chr_col, start_col)
    g1_mat = g1_mat.reindex(columns=s_mat.columns)
    g1_state_mat = _pivot(cn_g1, cn_state_col, cell_col, chr_col, start_col)
    g1_state_mat = g1_state_mat.reindex(columns=s_mat.columns)

    corr = masked_pearson_matrix(s_mat.to_numpy(np.float64),
                                 g1_mat.to_numpy(np.float64))

    # restrict matches to the S cell's clone when both frames carry clones
    if clone_col in cn_s.columns and clone_col in cn_g1.columns:
        s_clones = cn_s[[cell_col, clone_col]].drop_duplicates(cell_col) \
            .set_index(cell_col)[clone_col].reindex(s_mat.index).astype(str)
        g1_clones = cn_g1[[cell_col, clone_col]].drop_duplicates(cell_col) \
            .set_index(cell_col)[clone_col].reindex(g1_mat.index).astype(str)
        same = s_clones.to_numpy()[:, None] == g1_clones.to_numpy()[None, :]
        corr = np.where(same, corr, -np.inf)
    corr = np.nan_to_num(corr, nan=-np.inf)
    best = np.argmax(corr, axis=1)

    s_ploidy = cn_s[[cell_col, ploidy_col]].drop_duplicates(cell_col) \
        .set_index(cell_col)[ploidy_col].reindex(s_mat.index).to_numpy()
    g1_ploidy = cn_g1[[cell_col, ploidy_col]].drop_duplicates(cell_col) \
        .set_index(cell_col)[ploidy_col].reindex(g1_mat.index).to_numpy()

    chr_vals = s_mat.columns.get_level_values(0).astype(str)
    start_vals = s_mat.columns.get_level_values(1)
    eps = np.finfo(float).eps

    if engine == "loop":
        out = []
        for i, s_cell in enumerate(s_mat.index):
            g1_idx = best[i]
            g1_cell = g1_mat.index[g1_idx]
            s_vals = s_mat.iloc[i].to_numpy(np.float64)
            g1_states = g1_state_mat.iloc[g1_idx].to_numpy(np.float64)
            # (s * ploidy_g1) / (state_g1 * ploidy_s)
            # (reference: normalize_by_cell.py:205-206)
            norm = (s_vals * g1_ploidy[g1_idx]) / \
                (g1_states * s_ploidy[i] + eps)
            valid = np.isfinite(norm)
            df = pd.DataFrame({
                chr_col: chr_vals[valid],
                start_col: np.asarray(start_vals)[valid],
                cell_col: s_cell,
                temp_col: scale(norm[valid]),          # :209
                "G1_match_cell_id": g1_cell,
                "G1_match_pearsonr": corr[i, g1_idx],
            })
            df = remove_cell_specific_CNAs(
                df, input_col=temp_col, output_col=output_col,
                seg_col=seg_col, cell_col=cell_col,
                chr_col=chr_col, start_col=start_col)
            out.append(df)
        out = pd.concat(out, ignore_index=True)
        return pd.merge(out, cn_s)

    # engine == 'batch': one genome-order permutation of the shared pivot
    # columns, one padded (cells, loci) matrix, one batched CNA pass.
    from scdna_replication_tools_tpu_torch.utils.chrom import (
        CHR_ORDER,
        as_chr_categorical_array,
    )

    cat = as_chr_categorical_array(chr_vals)
    codes = cat.codes.astype(np.int64)
    codes = np.where(codes < 0, len(CHR_ORDER), codes)  # unknown chr last
    perm = np.lexsort((np.asarray(start_vals), codes))
    # the loop engine sees chromosome labels AFTER the categorical cast
    # (sort_by_cell_and_loci), where non-canonical contigs become NaN and
    # then the literal string 'nan' in the gate comparisons — reproduce
    # that exactly so both engines gate and merge identically
    # (np.asarray, not .to_numpy(): Categorical.astype(str) returns a
    # plain ndarray on pandas >= 2.1, a pandas array before)
    chr_sorted = np.asarray(cat.take(perm).astype(str), dtype=object)
    start_sorted = np.asarray(start_vals)[perm]

    n_cells, n_cols = s_mat.shape
    s_arr = s_mat.to_numpy(np.float64)
    g1_state_arr = g1_state_mat.to_numpy(np.float64)
    norm_all = (s_arr * g1_ploidy[best][:, None]) / \
        (g1_state_arr[best] * s_ploidy[:, None] + eps)
    valid_all = np.isfinite(norm_all)

    Y = np.zeros((n_cells, n_cols))
    row_len = np.zeros(n_cells, np.int64)
    chrom_rows, start_rows, temp_rows = [], [], []
    full = np.empty(n_cols)
    for i in range(n_cells):
        valid = valid_all[i]
        # scale in pivot-column order first — identical op order to the
        # loop engine, whose df is built pre-sort (:209)
        full.fill(np.nan)
        full[valid] = scale(norm_all[i][valid])
        v_sorted = valid[perm]
        row = full[perm][v_sorted]
        n = row.size
        Y[i, :n] = row
        row_len[i] = n
        temp_rows.append(row)
        chrom_rows.append(chr_sorted[v_sorted])
        start_rows.append(start_sorted[v_sorted])

    rt, chng = remove_cell_specific_CNAs_batch(Y, row_len, chrom_rows)

    out = pd.DataFrame({
        chr_col: as_chr_categorical_array(np.concatenate(chrom_rows)),
        start_col: np.concatenate(start_rows),
        cell_col: np.repeat(s_mat.index.to_numpy(), row_len),
        temp_col: np.concatenate(temp_rows),
        "G1_match_cell_id": np.repeat(g1_mat.index.to_numpy()[best],
                                      row_len),
        "G1_match_pearsonr": np.repeat(corr[np.arange(n_cells), best],
                                       row_len),
        seg_col: np.concatenate(
            [chng[i, :row_len[i]] for i in range(n_cells)]),
        output_col: np.concatenate(
            [rt[i, :row_len[i]] for i in range(n_cells)]),
    })
    return pd.merge(out, cn_s)


def normalize_by_clone(cn_s: pd.DataFrame, clone_profiles: pd.DataFrame,
                       input_col='rpm_gc_norm', clone_col='clone_id',
                       cell_col='cell_id', output_col='rt_value',
                       chr_col='chr', start_col='start',
                       cn_state_col='state', ploidy_col='ploidy'
                       ) -> pd.DataFrame:
    """Divide every S cell by its clone's consensus profile
    (reference: normalize_by_clone.py:51-77).

    The JAX package merges cell by cell (``cell_clone_norm``); here
    one gather of the profile values at each row's locus and clone
    gives the same frame: JAX's column order, the rows of loci the
    profiles hold, cells in sorted order and each cell's loci sorted by
    (chr, start)."""
    cn_s = cn_s.dropna().copy()
    clone_profiles = clone_profiles.dropna()
    if not isinstance(clone_profiles.index, pd.MultiIndex):
        clone_profiles = clone_profiles.set_index([chr_col, start_col])
    # align chromosome dtype with the long frame
    clone_profiles = clone_profiles.copy()
    clone_profiles.index = pd.MultiIndex.from_arrays(
        [clone_profiles.index.get_level_values(0).astype(str),
         clone_profiles.index.get_level_values(1)],
        names=[chr_col, start_col])
    cn_s[chr_col] = cn_s[chr_col].astype(str)

    if cn_state_col in cn_s.columns:
        cn_s = add_cell_ploidies(cn_s, cell_col, cn_state_col, ploidy_col)

    # each cell's clone is its first row's, as the per-cell merge reads it
    clone_of = cn_s.groupby(cell_col, observed=True)[clone_col] \
        .transform("first")
    col_pos = {c: i for i, c in enumerate(clone_profiles.columns)}
    missing = set(pd.unique(clone_of)) - set(col_pos)
    if missing:
        raise KeyError(f"{sorted(map(str, missing))} not in the clone "
                       "profiles' columns")
    out = cn_s.set_index([chr_col, start_col]).reset_index()
    locus = clone_profiles.index.get_indexer(
        pd.MultiIndex.from_arrays([out[chr_col], out[start_col]]))
    keep = locus >= 0
    out = out[keep].copy()
    prof = pd.Series(clone_profiles.to_numpy()[
        locus[keep], clone_of.map(col_pos).to_numpy()[keep]],
        index=out.index)
    out[output_col] = out[input_col] / (prof + np.finfo(float).eps)
    return out.sort_values([cell_col, chr_col, start_col],
                           kind="mergesort").reset_index(drop=True)
