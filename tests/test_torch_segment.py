"""The port's changepoint search (``pipeline/segment.py`` and the host
library ``csrc/segment.cpp``) against the JAX package's, and the
batched CNA removal of ``pipeline/normalize.py`` built on it.

The library is the JAX package's C++ source, built at first use by the
host compiler; its breakpoints equal the NumPy search's row for row and
tie for tie, and a failed build raises (no Python fallback).
"""

import numpy as np
import pytest

from scdna_replication_tools_tpu.pipeline import normalize as jnorm
from scdna_replication_tools_tpu.pipeline import segment as jseg
from scdna_replication_tools_tpu_torch.ops import _cuda
from scdna_replication_tools_tpu_torch.pipeline import normalize as tnorm
from scdna_replication_tools_tpu_torch.pipeline import segment as tseg


def _profiles(seed=0, rows=12, n=240):
    rng = np.random.default_rng(seed)
    Y = rng.normal(size=(rows, n))
    Y[:, 60:140] += 1.5
    Y[min(2, rows - 1), 100:] -= 3.0
    Y[min(3, rows - 1)] = 1.0                     # every split ties
    return Y


@pytest.mark.parametrize("n_bkps", [1, 2])
def test_find_breakpoints_matches_jax(n_bkps):
    for y in _profiles(rows=5):
        assert tseg.find_breakpoints(y, n_bkps) == \
            jseg.find_breakpoints(y, n_bkps)
    for n in (0, 1, 3, 4, 5):
        y = np.arange(n, dtype=float)
        assert tseg.find_breakpoints(y, n_bkps) == \
            jseg.find_breakpoints(y, n_bkps)


@pytest.mark.parametrize("n_bkps", [1, 2])
def test_batch_equals_the_oracle_and_jax(n_bkps):
    Y = _profiles(seed=1)
    row_len = np.array([240, 240, 240, 240, 200, 57, 6, 5, 4, 3, 0, 240])
    got = tseg.find_breakpoints_batch(Y, n_bkps, row_len=row_len)
    np.testing.assert_array_equal(
        got, jseg.find_breakpoints_batch(Y, n_bkps, row_len=row_len))
    for i, n in enumerate(row_len):
        ref = tseg.find_breakpoints(Y[i, :n], n_bkps)
        want = [-1, -1] if len(ref) == 1 else ref[:-1] + [-1] * (3 - len(ref))
        assert list(got[i]) == want, (i, got[i], ref)


def test_cna_removal_batch_matches_jax():
    rng = np.random.default_rng(2)
    rows, n = 6, 300
    Y = rng.normal(size=(rows, n))
    Y[:, 100:160] *= 1.6
    chroms = [np.repeat(["1", "2", "X"], 100)] * rows
    row_len = np.array([300, 300, 250, 300, 120, 300])
    jrt, jch = jnorm.remove_cell_specific_CNAs_batch(Y.copy(), row_len,
                                                     chroms)
    trt, tch = tnorm.remove_cell_specific_CNAs_batch(Y.copy(), row_len,
                                                     chroms)
    np.testing.assert_array_equal(tch, jch)
    np.testing.assert_array_equal(trt, jrt)


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No compiler, no library: the search raises with the compiler's
    output instead of falling back to the per-row NumPy search."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(_cuda._LIBS, "segment", raising=False)
    monkeypatch.delitem(_cuda.BUILD_INFO, "segment", raising=False)
    monkeypatch.setattr(_cuda, "_compiler", lambda name: "false")
    with pytest.raises(RuntimeError, match="segment.cpp"):
        tseg.find_breakpoints_batch(_profiles(rows=4), 2)
    assert "segment" not in _cuda._LIBS


def test_library_builds_once_under_the_lock(tmp_path, monkeypatch):
    """A fresh build directory gets one library, named by the hash of
    the source and the flags, with the compiler's log beside it and no
    temporary file left."""
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    monkeypatch.delitem(_cuda._LIBS, "segment", raising=False)
    monkeypatch.delitem(_cuda.BUILD_INFO, "segment", raising=False)
    lib = _cuda.library("segment")
    assert _cuda.library("segment") is lib
    files = sorted(p.name for p in (tmp_path / "build").iterdir())
    assert len(files) == 2 and files[1] == _cuda._target("segment").name \
        and files[0] == _cuda._target("segment").with_suffix(".log").name, \
        files
    assert _cuda.BUILD_INFO["segment"]["cache"] == "miss"


@pytest.mark.parametrize("row_len", [[5, 241], [-1, 3], [3]])
def test_row_lengths_are_checked_before_the_call(row_len):
    with pytest.raises(ValueError, match="row_len"):
        tseg.find_breakpoints_batch(_profiles(rows=2), 2,
                                    row_len=np.array(row_len))
