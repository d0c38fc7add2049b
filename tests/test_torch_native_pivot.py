"""The port's native pivot (``native/pivot.py`` on the host library
``csrc/pivot.cpp``, built here by the host's ``c++`` through the port's
one build path, ``ops/_cuda.library``) and the loader's ``pivot_matrix``
on it, against the JAX package's.

JAX's five cases (tests/test_native_pivot.py) run against the port;
``pivot_matrix`` gives JAX's frame (values, NaN positions, index and
columns) and, through the library and with ``use_native=False``, the
same matrix bit for bit; a failed build raises instead of falling back
to NumPy (the JAX package falls back); keys outside the matrix are
refused on both routes before the library writes through them.
"""

import numpy as np
import pandas as pd
import pytest

from scdna_replication_tools_tpu.data import loader as jloader
from scdna_replication_tools_tpu.native import pivot as jpivot
from scdna_replication_tools_tpu_torch.config import ColumnConfig
from scdna_replication_tools_tpu_torch.data.loader import pivot_matrix
from scdna_replication_tools_tpu_torch.native import pivot as tpivot
from scdna_replication_tools_tpu_torch.native.pivot import (
    gather_melt,
    scatter_pivot,
)
from scdna_replication_tools_tpu_torch.ops import _cuda
from scdna_replication_tools_tpu_torch.utils.chrom import as_chr_categorical


def _long_frame(num_cells=7, num_loci=50, seed=0, shuffle=True):
    rng = np.random.default_rng(seed)
    cells = [f"c{i:03d}" for i in range(num_cells)]
    rows = []
    for c in cells:
        rows.append(pd.DataFrame({
            "cell_id": c,
            "chr": ["1"] * (num_loci // 2) + ["X"] * (num_loci - num_loci // 2),
            "start": np.r_[np.arange(num_loci // 2),
                           np.arange(num_loci - num_loci // 2)] * 500_000,
            "reads": rng.poisson(40, num_loci).astype(float),
        }))
    df = pd.concat(rows, ignore_index=True)
    if shuffle:
        df = df.sample(frac=1.0, random_state=1).reset_index(drop=True)
    return df


def _keys(seed=2, n_cells=11, n_loci=37, n=300):
    rng = np.random.default_rng(seed)
    cc = rng.integers(0, n_cells, n).astype(np.int32)
    lc = rng.integers(0, n_loci, n).astype(np.int32)
    _, keep = np.unique(cc.astype(np.int64) * n_loci + lc, return_index=True)
    return cc[keep], lc[keep], rng.normal(0, 10, len(keep)), n_cells, n_loci


# ---------------------------------------------------------------------------
# JAX's five cases, on the port
# ---------------------------------------------------------------------------


def test_scatter_pivot_matches_numpy_fallback():
    cc, lc, vals, n_cells, n_loci = _keys()
    a = scatter_pivot(cc, lc, vals, n_cells, n_loci, use_native=False)
    b = scatter_pivot(cc, lc, vals, n_cells, n_loci)
    np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b))

    got = gather_melt(np.nan_to_num(a), cc, lc)
    np.testing.assert_allclose(got, vals.astype(np.float32))


def test_native_library_builds_here():
    """The host compiler is here, so the library builds and binds both
    entry points."""
    lib = _cuda.library("pivot")
    assert lib.scatter_pivot_f32 is not None and lib.gather_melt_f32
    assert _cuda.BUILD_INFO["pivot"]["path"].endswith(".so")


def test_pivot_matrix_matches_pandas_pivot_table():
    df = _long_frame()
    got = pivot_matrix(df, "reads", ColumnConfig())
    ref_df = df.copy()
    ref_df["chr"] = as_chr_categorical(ref_df["chr"])
    want = ref_df.pivot_table(index="cell_id", columns=["chr", "start"],
                              values="reads", observed=True).sort_index(axis=1)
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy())
    assert list(got.index) == list(want.index)
    assert [tuple(map(str, t)) for t in got.columns] == \
        [tuple(map(str, t)) for t in want.columns]


def test_pivot_matrix_drops_unknown_chromosomes():
    df = _long_frame(num_cells=3, num_loci=10)
    weird = df.iloc[:5].copy()
    weird["chr"] = "chrUn_gl000220"
    got = pivot_matrix(pd.concat([df, weird], ignore_index=True), "reads")
    want = pivot_matrix(df, "reads")
    np.testing.assert_allclose(got.to_numpy(), want.to_numpy())


def test_pivot_matrix_duplicate_keys_fall_back_to_mean():
    df = _long_frame(num_cells=2, num_loci=6, shuffle=False)
    dup = df.iloc[[0]].copy()
    dup["reads"] = df.iloc[0]["reads"] + 10.0
    got = pivot_matrix(pd.concat([df, dup], ignore_index=True), "reads")
    assert got.iloc[0, 0] == df.iloc[0]["reads"] + 5.0  # pivot_table mean


# ---------------------------------------------------------------------------
# against JAX's, and bit for bit against the NumPy scatter
# ---------------------------------------------------------------------------


def _ragged_frame():
    """Cells missing loci (NaN in the matrix), a NaN value, float starts
    and a third chromosome, shuffled."""
    df = _long_frame(num_cells=9, num_loci=64, seed=3)
    df = df.drop(index=df.index[::13]).reset_index(drop=True)
    df.loc[5, "reads"] = np.nan
    extra = _long_frame(num_cells=4, num_loci=8, seed=4, shuffle=False)
    extra["chr"] = "2"
    df = pd.concat([df, extra], ignore_index=True)
    df["start"] = df["start"].astype(float)
    return df.sample(frac=1.0, random_state=5).reset_index(drop=True)


@pytest.mark.parametrize("make", [_long_frame, _ragged_frame],
                         ids=["complete", "ragged"])
def test_pivot_matrix_equals_jax(make):
    df = make()
    got = pivot_matrix(df, "reads")
    want = jloader.pivot_matrix(df, "reads")
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    plain = pivot_matrix(df, "reads", use_native=False)
    pd.testing.assert_frame_equal(plain, got, check_exact=True)
    assert got.to_numpy().tobytes() == plain.to_numpy().tobytes()
    if make is _ragged_frame:
        assert np.isnan(got.to_numpy()).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_and_gather_equal_jax_bit_for_bit(seed):
    cc, lc, vals, n_cells, n_loci = _keys(seed=seed, n_cells=300,
                                          n_loci=400, n=100_000)
    assert len(cc) > 1 << 16          # the threaded path
    got = scatter_pivot(cc, lc, vals, n_cells, n_loci)
    want = jpivot.scatter_pivot(cc, lc, vals, n_cells, n_loci)
    assert got.tobytes() == want.tobytes()
    assert got.tobytes() == scatter_pivot(cc, lc, vals, n_cells, n_loci,
                                          use_native=False).tobytes()
    filled = np.nan_to_num(got)
    back = gather_melt(filled, cc, lc)
    assert back.tobytes() == jpivot.gather_melt(filled, cc, lc).tobytes()
    assert back.tobytes() == gather_melt(filled, cc, lc,
                                         use_native=False).tobytes()


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No compiler, no library: the pivot raises with the compiler's
    output instead of falling back to the NumPy scatter."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(_cuda._LIBS, "pivot", raising=False)
    monkeypatch.delitem(_cuda.BUILD_INFO, "pivot", raising=False)
    monkeypatch.setattr(_cuda, "_compiler", lambda name: "false")
    cc, lc, vals, n_cells, n_loci = _keys()
    with pytest.raises(RuntimeError, match="pivot.cpp"):
        tpivot.scatter_pivot(cc, lc, vals, n_cells, n_loci)
    with pytest.raises(RuntimeError, match="pivot.cpp"):
        pivot_matrix(_long_frame(num_cells=2, num_loci=4), "reads")
    assert "pivot" not in _cuda._LIBS
    # the NumPy scatter needs no library
    assert scatter_pivot(cc, lc, vals, n_cells, n_loci,
                         use_native=False).shape == (n_cells, n_loci)


@pytest.mark.parametrize("use_native", [None, False])
@pytest.mark.parametrize("bad", ["cell_high", "locus_negative", "lengths"])
def test_keys_outside_the_matrix_are_refused(use_native, bad):
    """The library writes through the codes unchecked, so both routes
    refuse a key outside the matrix (or codes and values of other
    lengths) before the call."""
    cc, lc, vals, n_cells, n_loci = _keys()
    mat = np.zeros((n_cells, n_loci), np.float32)
    if bad == "cell_high":
        cc = cc.copy()
        cc[3] = n_cells
    elif bad == "locus_negative":
        lc = lc.copy()
        lc[-1] = -1
    else:
        vals = vals[:-1]
    with pytest.raises(ValueError, match="codes"):
        scatter_pivot(cc, lc, vals, n_cells, n_loci, use_native=use_native)
    if bad != "lengths":
        with pytest.raises(ValueError, match="codes"):
            gather_melt(mat, cc, lc, use_native=use_native)
