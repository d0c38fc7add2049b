"""Host-side data pipeline: long-form pandas <-> dense (cells, loci) arrays.

Port of ``data/loader.py`` (itself the replacement for
``pert_infer_scRT.process_input_data``, reference: pert_model.py:133-191).
Arrays are (cells, loci) NumPy; the runner moves them to the device.
The pivot scatters on the threaded C++ library of ``native/pivot.py``,
as the JAX package's does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import pandas as pd

from scdna_replication_tools_tpu_torch.config import ColumnConfig
from scdna_replication_tools_tpu_torch.utils.chrom import as_chr_categorical


@dataclasses.dataclass
class PertData:
    """Dense per-phase model inputs plus the metadata to map back to pandas.

    ``reads``/``states`` are (num_cells, num_loci) float32; ``libs`` is
    (num_cells,) int32 of library indices; ``gammas`` (num_loci,) float32
    GC content; ``rt_prior`` optional (num_loci,) float32 scaled to
    [0, 1]; ``cell_mask`` marks real (non-pad) cells.
    """

    reads: np.ndarray
    states: Optional[np.ndarray]
    libs: np.ndarray
    gammas: np.ndarray
    rt_prior: Optional[np.ndarray]
    cell_ids: List
    loci: pd.MultiIndex          # MultiIndex of (chr, start)
    library_ids: List            # index -> library id string
    cell_mask: np.ndarray        # (num_cells,) bool
    loci_mask: Optional[np.ndarray] = None   # (num_loci,) bool; None = all real

    @property
    def num_cells(self) -> int:
        return self.reads.shape[0]

    @property
    def num_loci(self) -> int:
        return self.reads.shape[1]

    @property
    def num_libraries(self) -> int:
        return len(self.library_ids)


def pivot_matrix(
    cn: pd.DataFrame,
    value_col: str,
    cols: ColumnConfig = ColumnConfig(),
    use_native: Optional[bool] = None,
) -> pd.DataFrame:
    """Pivot a long-form frame to a (cell x locus) matrix in genome order.

    Keys are factorised once and the values scattered into the dense
    matrix by the native library (``native/pivot.scatter_pivot``; a
    failed build raises, ``use_native=False`` takes the NumPy scatter,
    bit for bit the same matrix).  Duplicate (cell, locus) keys fall back
    to ``pivot_table``, whose mean-aggregation the scatter cannot
    reproduce.
    """
    from scdna_replication_tools_tpu_torch.native.pivot import scatter_pivot

    cn = cn[cn[value_col].notna()
            & cn[cols.cell_col].notna()
            & cn[cols.start_col].notna()]
    if cn[cols.start_col].dtype != np.int64:
        starts_num = pd.to_numeric(cn[cols.start_col]).to_numpy()
        starts_i64 = starts_num.astype(np.int64)
        if not np.array_equal(starts_i64.astype(starts_num.dtype),
                              starts_num):
            raise ValueError(
                f"column {cols.start_col!r} has non-integral values; "
                "bin starts must be integral genomic coordinates")
        cn = cn.assign(**{cols.start_col: starts_i64})
    chr_cat = as_chr_categorical(cn[cols.chr_col])
    known = chr_cat.cat.codes.to_numpy() >= 0
    if not known.all():
        cn = cn[known]
        chr_cat = chr_cat[known]

    def _sorted_factorize(values):
        codes, uniques = pd.factorize(values)
        uniques = np.asarray(uniques)
        order = np.argsort(uniques, kind="stable")
        rank = np.empty(len(uniques), np.int64)
        rank[order] = np.arange(len(uniques))
        return uniques[order], rank[codes]

    cell_ids, cell_codes = _sorted_factorize(cn[cols.cell_col].to_numpy())
    starts = cn[cols.start_col].to_numpy(np.int64)
    # genome-ordered locus key: chr categorical code in the high bits
    locus_key = chr_cat.cat.codes.to_numpy(np.int64) << 42 | starts
    key_vals, locus_codes = _sorted_factorize(locus_key)

    pair_key = cell_codes * len(key_vals) + locus_codes
    if len(pd.unique(pair_key)) != len(pair_key):
        mat = cn.assign(**{cols.chr_col: chr_cat}).pivot_table(
            index=cols.cell_col,
            columns=[cols.chr_col, cols.start_col],
            values=value_col,
            observed=True,
        )
        return mat.sort_index(axis=1).astype(np.float32)

    dense = scatter_pivot(cell_codes, locus_codes,
                          cn[value_col].to_numpy(np.float64),
                          len(cell_ids), len(key_vals),
                          use_native=use_native)

    chr_categories = chr_cat.cat.categories
    loci = pd.MultiIndex.from_arrays(
        [pd.Categorical.from_codes((key_vals >> 42).astype(np.int32),
                                   categories=chr_categories),
         key_vals & ((1 << 42) - 1)],
        names=[cols.chr_col, cols.start_col])
    return pd.DataFrame(dense, index=pd.Index(cell_ids, name=cols.cell_col),
                        columns=loci)


def _library_index(
    cn_s: pd.DataFrame, cn_g1: pd.DataFrame, cols: ColumnConfig
) -> Tuple[pd.Series, pd.Series, List]:
    """Library ids -> dense integers shared across both phases
    (reference: pert_model.py:206-225)."""
    libs_s = cn_s[[cols.cell_col, cols.library_col]].drop_duplicates(cols.cell_col)
    libs_g1 = cn_g1[[cols.cell_col, cols.library_col]].drop_duplicates(cols.cell_col)
    all_ids = list(pd.concat([libs_s, libs_g1])[cols.library_col].unique())
    mapping = {lib: i for i, lib in enumerate(all_ids)}
    s = libs_s.set_index(cols.cell_col)[cols.library_col].map(mapping)
    g1 = libs_g1.set_index(cols.cell_col)[cols.library_col].map(mapping)
    return s, g1, all_ids


def _per_locus_profile(
    cn: pd.DataFrame, value_col: str, loci: pd.MultiIndex, cols: ColumnConfig
) -> Optional[np.ndarray]:
    """One value per locus (GC content / RT prior), aligned to ``loci``."""
    if value_col is None or value_col not in cn.columns:
        return None
    prof = (
        cn[[cols.chr_col, cols.start_col, value_col]]
        .drop_duplicates([cols.chr_col, cols.start_col])
        .dropna()
    )
    prof[cols.chr_col] = prof[cols.chr_col].astype(str)
    prof = prof.set_index([cols.chr_col, cols.start_col])[value_col]
    key = pd.MultiIndex.from_arrays(
        [loci.get_level_values(0).astype(str), loci.get_level_values(1)]
    )
    aligned = prof.reindex(key)
    if aligned.isna().any():
        missing = int(aligned.isna().sum())
        raise ValueError(
            f"column {value_col!r} is missing for {missing} loci shared by the "
            "read-count pivots"
        )
    return aligned.to_numpy(dtype=np.float32)


def check_frame_columns(frames) -> List[str]:
    """Problem strings for ``{name: (frame, needed_columns)}``."""
    problems = []
    for name, (frame, needed) in frames.items():
        if frame is None or len(frame) == 0:
            problems.append(f"{name} is empty")
            continue
        missing = [c for c in needed if c is not None
                   and c not in frame.columns]
        if missing:
            problems.append(f"{name} is missing column(s) {missing}")
    return problems


def validate_input_frames(
    cn_s: pd.DataFrame, cn_g1: pd.DataFrame, cols: ColumnConfig
) -> None:
    """Fail fast, with named columns, on malformed input frames."""
    required = {
        "cn_s": (cn_s, [cols.cell_col, cols.chr_col, cols.start_col,
                        cols.input_col, cols.library_col, cols.gc_col]),
        "cn_g1": (cn_g1, [cols.cell_col, cols.chr_col, cols.start_col,
                          cols.input_col, cols.library_col,
                          cols.cn_state_col]),
    }
    problems = check_frame_columns(required)
    if problems:
        contract, seen = [], set()
        for _, needed in required.values():
            for c in needed:
                if c is not None and c not in seen:
                    seen.add(c)
                    contract.append(c)
        raise ValueError(
            "invalid PERT input: " + "; ".join(problems)
            + f" (long-form contract: {', '.join(contract)} — see README)")


def build_pert_inputs(
    cn_s: pd.DataFrame,
    cn_g1: pd.DataFrame,
    cols: ColumnConfig = ColumnConfig(),
) -> Tuple[PertData, PertData]:
    """Dense model inputs for the S and G1/2 populations: genome-ordered
    pivots over the loci fully observed in every pivot, a shared library
    index, per-locus GC and optional RT-prior profiles."""
    validate_input_frames(cn_s, cn_g1, cols)
    s_reads = pivot_matrix(cn_s, cols.input_col, cols)
    g1_reads = pivot_matrix(cn_g1, cols.input_col, cols)
    g1_states = pivot_matrix(cn_g1, cols.cn_state_col, cols)

    has_s_states = cols.cn_state_col in cn_s.columns
    s_states = pivot_matrix(cn_s, cols.cn_state_col, cols) if has_s_states else None

    loci = s_reads.dropna(axis=1).columns
    loci = loci.intersection(g1_reads.dropna(axis=1).columns)
    loci = loci.intersection(g1_states.dropna(axis=1).columns)
    if s_states is not None:
        loci = loci.intersection(s_states.dropna(axis=1).columns)
    loci = loci.sortlevel([0, 1])[0]
    if len(loci) == 0:
        raise ValueError(
            "no locus is fully observed in every pivot (S reads, G1 reads, "
            "G1 states" + (", S states" if s_states is not None else "")
            + ") — check that both frames cover the same (chr, start) bins "
            "and that chromosome labels use the canonical 1..22,X,Y naming")

    s_reads = s_reads[loci]
    g1_reads = g1_reads[loci]
    g1_states = g1_states[loci]
    if s_states is not None:
        s_states = s_states[loci]

    libs_s, libs_g1, library_ids = _library_index(cn_s, cn_g1, cols)

    gammas = _per_locus_profile(cn_s, cols.gc_col, loci, cols)
    if gammas is None:
        raise ValueError("gc_col must name a GC-content column; the PERT "
                         f"model requires GC features (got gc_col="
                         f"{cols.gc_col!r})")

    rt_prior = _per_locus_profile(cn_s, cols.rt_prior_col, loci, cols)
    if rt_prior is not None:
        # early RT ~ 1, late RT ~ 0 (reference: pert_model.py:254-257)
        rt_prior = rt_prior / rt_prior.max()

    def _to_f32_int(mat: pd.DataFrame) -> np.ndarray:
        # int64 truncation before float32 (reference: pert_model.py:161-166)
        return mat.to_numpy().astype(np.int64).astype(np.float32)

    def _make(reads_df, states_df, libs) -> PertData:
        cell_ids = list(reads_df.index)
        return PertData(
            reads=_to_f32_int(reads_df),
            states=None if states_df is None else _to_f32_int(states_df),
            libs=libs.reindex(cell_ids).to_numpy(dtype=np.int32),
            gammas=gammas,
            rt_prior=rt_prior,
            cell_ids=cell_ids,
            loci=loci,
            library_ids=library_ids,
            cell_mask=np.ones(len(cell_ids), dtype=bool),
            loci_mask=np.ones(len(loci), dtype=bool),
        )

    return _make(s_reads, s_states, libs_s), _make(g1_reads, g1_states, libs_g1)


def attach_dense_columns(
    cn_long: pd.DataFrame,
    cell_ids,
    loci: pd.MultiIndex,
    cols: ColumnConfig = ColumnConfig(),
    per_bin: Optional[dict] = None,
    per_cell: Optional[dict] = None,
    per_locus: Optional[dict] = None,
) -> pd.DataFrame:
    """Array-native unpivot: attach dense model outputs to a long frame.

    Each long row is mapped to its (cell, locus) dense codes; rows whose
    cell or locus is absent from the dense axes are dropped (inner-join
    semantics, left order kept), and every output column is one NumPy
    gather.  ``per_bin`` maps column name -> (cells, loci) array,
    ``per_cell`` -> (cells,), ``per_locus`` -> (loci,).
    """
    cell_codes = pd.Categorical(cn_long[cols.cell_col],
                                categories=cell_ids).codes
    loci_key = pd.MultiIndex.from_arrays(
        [loci.get_level_values(0).astype(str), loci.get_level_values(1)])
    row_key = pd.MultiIndex.from_arrays(
        [cn_long[cols.chr_col].astype(str),
         cn_long[cols.start_col].to_numpy()])
    locus_codes = loci_key.get_indexer(row_key)

    keep = (cell_codes >= 0) & (locus_codes >= 0)
    out = cn_long[keep].reset_index(drop=True)
    cc = np.asarray(cell_codes)[keep]
    lc = locus_codes[keep]
    for name, mat in (per_bin or {}).items():
        out[name] = np.asarray(mat)[cc, lc]
    for name, vec in (per_cell or {}).items():
        out[name] = np.asarray(vec)[cc]
    for name, vec in (per_locus or {}).items():
        out[name] = np.asarray(vec)[lc]
    return out


def pad_cells(data: PertData, multiple: int = 1,
              minimum: Optional[int] = None) -> PertData:
    """Pad the cells axis to a multiple of ``multiple`` (and at least
    ``minimum``) with masked cells; padded cells carry
    ``cell_mask=False`` and add zero to every masked reduction."""
    n = data.num_cells
    target = max(n, int(minimum or 0))
    target = ((target + multiple - 1) // multiple) * multiple
    if target == n:
        return data
    pad = target - n

    def _pad_mat(x):
        if x is None:
            return None
        return np.concatenate([x, np.ones((pad, x.shape[1]), x.dtype)], axis=0)

    return dataclasses.replace(
        data,
        reads=_pad_mat(data.reads),
        states=_pad_mat(data.states),
        libs=np.concatenate([data.libs, np.zeros(pad, data.libs.dtype)]),
        cell_ids=list(data.cell_ids) + [f"__pad_{i}__" for i in range(pad)],
        cell_mask=np.concatenate([data.cell_mask, np.zeros(pad, dtype=bool)]),
    )


def pad_loci(data: PertData, multiple: int = 1,
             minimum: Optional[int] = None) -> PertData:
    """Pad the loci axis to a multiple of ``multiple`` (and at least
    ``minimum``) with masked loci: chr '__PAD__' index entries, neutral
    GC (0.45) and mid-range RT prior (0.5)."""
    n = data.num_loci
    target = max(n, int(minimum or 0))
    target = ((target + multiple - 1) // multiple) * multiple
    if target == n:
        return data
    pad = target - n

    def _pad_mat(x):
        if x is None:
            return None
        return np.concatenate([x, np.ones((x.shape[0], pad), x.dtype)], axis=1)

    def _pad_vec(x, value):
        if x is None:
            return None
        return np.concatenate([x, np.full(pad, value, x.dtype)])

    chrs = list(data.loci.get_level_values(0).astype(str)) + ["__PAD__"] * pad
    starts = list(data.loci.get_level_values(1)) + list(range(pad))
    loci = pd.MultiIndex.from_arrays([chrs, starts],
                                     names=data.loci.names)
    loci_mask = data.loci_mask if data.loci_mask is not None \
        else np.ones(n, dtype=bool)
    return dataclasses.replace(
        data,
        reads=_pad_mat(data.reads),
        states=_pad_mat(data.states),
        gammas=_pad_vec(data.gammas, 0.45),
        rt_prior=_pad_vec(data.rt_prior, 0.5),
        loci=loci,
        loci_mask=np.concatenate([loci_mask, np.zeros(pad, dtype=bool)]),
    )
