"""The port's cell-cycle-classifier features (``pipeline/ccc_features.py``)
and its ``ops/stats.gmm2_log_likelihood`` against the JAX package's.

Tolerances:

* ``gmm2_log_likelihood`` (float32, the same mixture on the same rows):
  1e-5 relative, of max(1, |ll|): ll is a mean of per-point log-densities
  of size ~1 and crosses zero (a row near 0.003 read 7.7e-8 apart);
* ``madn``, ``breakpoints``, ``corrected_madn`` and
  ``corrected_breakpoints`` (float64 host NumPy and pandas in both): 1e-9;
* ``lrs`` = -2 (ll1 - ll2), with ll2 the mean float32 log-likelihood of
  each cell under its 2-GMM fit by 60 float32 EM iterations, and ll1 the
  float64 one-Gaussian term: 1e-5 of max(1, |lrs|), i.e. absolute below
  1.  Set from the float32 EM on the CPU: against the same features with
  a float64 EM the port's float32 lrs differ by at most 3.8e-7 (30 cells
  x 400 loci) and 2.5e-7 (300 x 2000), against JAX's by 4.3e-7 and
  4.6e-7 -- a few float32 ulps of ll2 (|ll2| ~ 1-2), while lrs itself
  runs from 2e-4 to 0.15, so a bound relative to lrs alone would hold
  ulps of ll2 against a number a thousand times smaller.
  ``chip_smoke.py`` holds the card's lrs to the CPU's with the same bound.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from scdna_replication_tools_tpu.ops import stats as jstats
from scdna_replication_tools_tpu.pipeline import ccc_features as jccc
from scdna_replication_tools_tpu_torch.ops import stats as tstats
from scdna_replication_tools_tpu_torch.pipeline import ccc_features as tccc

from test_torch_model import one_torch_thread  # noqa: F401

TOL_LRS = 1e-5
TOL_EXACT = 1e-9
EXACT_COLS = ("madn", "breakpoints", "corrected_madn",
              "corrected_breakpoints")


def ccc_frame(cells=30, loci=400, clones=3, seed=0, missing=True):
    """A long-form frame of ``clones`` clones with their own CN gains,
    private losses, replication at a per-cell fraction along a smooth
    timing profile, Poisson reads and their rpm; with ``missing``, cell 4
    lacks one locus (the per-cell fill of calculate_features runs)."""
    rng = np.random.default_rng(seed)
    chrom = np.where(np.arange(loci) < loci // 2, "1", "2")
    start = np.r_[np.arange(loci // 2), np.arange(loci - loci // 2)] \
        * 500_000
    rt = np.sin(np.arange(loci) / 25.0)
    rows = []
    for i in range(cells):
        k = i % clones
        cn = np.full(loci, 2)
        cn[k * 40:k * 40 + 60] = 3
        cn[rng.integers(0, loci - 30):][:rng.integers(5, 30)] = 1
        frac = rng.uniform(0, 1)
        rep = (rng.uniform(size=loci)
               < 1 / (1 + np.exp(-6 * (frac - 0.5 + 0.5 * rt)))).astype(int)
        rows.append(pd.DataFrame({
            "cell_id": f"cell{i:03d}", "chr": chrom, "start": start,
            "clone_id": f"C{k}", "state": cn,
            "reads": rng.poisson(40 * cn * (1 + rep)).astype(float),
            "model_rep_state": rep}))
    df = pd.concat(rows, ignore_index=True)
    df["rpm"] = df["reads"] / df.groupby("cell_id")["reads"] \
        .transform("sum") * 1e6
    if missing:
        df = df.drop(index=df.index[(df.cell_id == "cell004")
                                    & (df.start == 10 * 500_000)
                                    & (df.chr == "1")])
    return df.reset_index(drop=True)


def lrs_err(got, want) -> float:
    """max |got - want| / max(1, |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_gmm2_log_likelihood_equals_jax(seed):
    rng = np.random.default_rng(seed)
    x = np.where(rng.random((24, 300)) < rng.uniform(0.1, 0.9, (24, 1)),
                 rng.normal(0.8, 0.1, (24, 300)),
                 rng.normal(1.3, 0.2, (24, 300))).astype(np.float32)
    mu, var, w = (np.array(a) for a in jstats.gmm2_em(x))
    want = np.asarray(jstats.gmm2_log_likelihood(x, mu, var, w))
    got = tstats.gmm2_log_likelihood(*(torch.as_tensor(a) for a in
                                       (x, mu, var, w))).numpy()
    assert got.dtype == np.float32 and got.shape == (24,)
    assert lrs_err(got, want) <= 1e-5
    # on the port's own EM fit too
    tmu, tvar, tw = tstats.gmm2_em(torch.as_tensor(x))
    assert lrs_err(tstats.gmm2_log_likelihood(torch.as_tensor(x), tmu,
                                              tvar, tw), want) <= 1e-5


@pytest.mark.parametrize("missing", [True, False],
                         ids=["missing_locus", "complete"])
def test_compute_ccc_features_equals_jax(missing):
    df = ccc_frame(missing=missing)
    cn_out, feats = tccc.compute_ccc_features(df.copy(), device="cpu")
    j_out, j_feats = jccc.compute_ccc_features(df.copy())
    assert list(feats.columns) == list(j_feats.columns)
    assert list(cn_out.columns) == list(j_out.columns)
    assert len(cn_out) == len(j_out) and len(feats) == 30
    pd.testing.assert_frame_equal(
        feats.drop(columns=["lrs"]), j_feats.drop(columns=["lrs"]),
        check_exact=False, rtol=TOL_EXACT, atol=TOL_EXACT)
    for col in EXACT_COLS:
        np.testing.assert_allclose(feats[col], j_feats[col],
                                   rtol=TOL_EXACT, atol=TOL_EXACT)
    assert lrs_err(feats["lrs"], j_feats["lrs"]) <= TOL_LRS
    assert (feats["lrs"] > 0).all()
    pd.testing.assert_frame_equal(
        cn_out.drop(columns=["lrs"]), j_out.drop(columns=["lrs"]),
        check_exact=False, rtol=TOL_EXACT, atol=TOL_EXACT)
    assert lrs_err(cn_out["lrs"], j_out["lrs"]) <= TOL_LRS


def test_the_fill_of_a_missing_locus_runs():
    """The cell without a locus gets that locus filled with its own
    median: its MADN is that of its row with the gap filled so."""
    df = ccc_frame()
    norm = tccc.compute_clone_normalization(df.copy(), rpm_col="rpm",
                                            rpm_norm_col="n")
    pd.testing.assert_frame_equal(
        norm, jccc.compute_clone_normalization(df.copy(), rpm_col="rpm",
                                               rpm_norm_col="n"))
    feats = tccc.calculate_features(norm, rpm_norm_col="n", device="cpu")
    mat = norm.pivot_table(index="cell_id", columns=["chr", "start"],
                           values="n", dropna=False, observed=True)
    assert mat.loc["cell004"].isna().sum() == 1
    assert mat.drop(index="cell004").notna().all().all()
    row = mat.loc["cell004"].to_numpy()
    filled = np.where(np.isfinite(row), row, np.nanmedian(row))
    madn = feats.loc[feats.cell_id == "cell004", "madn"].iloc[0]
    assert madn == np.nanmedian(np.abs(np.diff(filled)))


def test_feature_steps_equal_jax():
    df = ccc_frame(seed=4)
    bk = tccc.calculate_breakpoints(df)
    pd.testing.assert_frame_equal(bk, jccc.calculate_breakpoints(df))
    reads = tccc.compute_read_count(df)
    pd.testing.assert_frame_equal(reads, jccc.compute_read_count(df))
    frac = tccc.compute_cell_frac(df)
    pd.testing.assert_frame_equal(frac, jccc.compute_cell_frac(df))
    feats = reads[["cell_id", "clone_id", "total_mapped_reads_hmmcopy"]] \
        .drop_duplicates().reset_index(drop=True)
    feats["madn"] = np.linspace(0.1, 0.3, len(feats))
    feats["breakpoints"] = np.arange(len(feats)) % 7
    pd.testing.assert_frame_equal(tccc.correct_madn(feats),
                                  jccc.correct_madn(feats),
                                  check_exact=False, rtol=TOL_EXACT)
    pd.testing.assert_frame_equal(tccc.correct_breakpoints(feats),
                                  jccc.correct_breakpoints(feats))


def test_the_gmm_needs_a_device_or_the_gpu(monkeypatch):
    """device=None is the GPU: without one the call raises before any
    work; 'cpu' runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tccc.compute_ccc_features(ccc_frame(cells=6, loci=60))
    _, feats = tccc.compute_ccc_features(ccc_frame(cells=6, loci=60),
                                         device="cpu")
    assert len(feats) == 6
