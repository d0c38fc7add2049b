"""The port's phase calling (``pipeline/phase.py``) and its
``ops/stats.autocorrelation_mean`` against the JAX package's.

Both are host float64 NumPy and pandas: the ACF means agree within 1e-12
(absolute and relative), and ``predict_cycle_phase``'s three frames are
equal (``assert_frame_equal``, exact) on JAX's own input of
tests/test_pipeline.py and on a seeded frame of 24 cells x 300 loci with
mixed replicated fractions, CN-0 runs and a cell missing a locus.
"""

import numpy as np
import pandas as pd
import pytest

from scdna_replication_tools_tpu.ops import stats as jstats
from scdna_replication_tools_tpu.pipeline import phase as jphase
from scdna_replication_tools_tpu_torch.ops import stats as tstats
from scdna_replication_tools_tpu_torch.pipeline import phase as tphase

from test_pipeline import _phase_input


def _series():
    rng = np.random.default_rng(7)
    walk = np.cumsum(rng.normal(size=400))
    return {
        "normal_200": rng.normal(size=200),
        "walk_400": walk,
        "binary_300": (rng.random(300) < 0.4).astype(float),
        "poisson_51": rng.poisson(30, 51).astype(float),
        "constant_120": np.full(120, 3.0),          # denominator 0
        "n_equals_max_lag_50": rng.normal(size=50),  # stops at lag 49
        "short_30": rng.normal(size=30),             # stops at lag 29
        "constant_40": np.full(40, 2.0),
    }


@pytest.mark.parametrize("name", sorted(_series()))
@pytest.mark.parametrize("lags", [(10, 50), (1, 5), (3, 20)])
def test_autocorrelation_mean_equals_jax(name, lags):
    x = _series()[name]
    got = tstats.autocorrelation_mean(x, *lags)
    want = jstats.autocorrelation_mean(x, *lags)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert tphase.autocorr(x, *lags) == got
    assert tphase.autocorr(x, *lags) == jphase.autocorr(x, *lags)


@pytest.mark.parametrize("name", sorted(_series()))
def test_breakpoints_equal_jax(name):
    x = np.round(_series()[name])
    assert tphase.breakpoints(x) == jphase.breakpoints(x)


def _mixed_input(cells=24, loci=300, seed=11):
    """Cells across the replicated-fraction range (below 0.05, mid-S,
    above 0.95), some with CN-0 runs, some with autocorrelated
    replication, and one cell missing a locus."""
    rng = np.random.default_rng(seed)
    fracs = np.r_[0.0, 0.02, 0.97, 1.0, rng.uniform(0.1, 0.9, cells - 4)]
    rows = []
    for i, frac in enumerate(fracs):
        if i % 3 == 0:      # autocorrelated: replicated in one block
            rep = (np.arange(loci) < frac * loci).astype(float)
        else:
            rep = (rng.random(loci) < frac).astype(float)
        cn = np.full(loci, 2)
        if i % 5 == 1:      # a run of CN 0
            s0 = rng.integers(0, loci - 40)
            cn[s0:s0 + rng.integers(5, 40)] = 0
        cn[rng.integers(0, loci - 20):][:10] = 3
        rows.append(pd.DataFrame({
            "cell_id": f"cell{i:02d}",
            "chr": np.where(np.arange(loci) < loci // 2, "1", "2"),
            "start": (np.arange(loci) % (loci // 2)) * 500_000,
            "model_rep_state": rep,
            "model_cn_state": cn,
            "rpm": rng.poisson(50 * (1 + rep) * np.maximum(cn, 0.2))
            .astype(float),
        }))
    df = pd.concat(rows, ignore_index=True)
    drop = df.index[(df.cell_id == "cell07") & (df.start == 17 * 500_000)
                    & (df.chr == "1")]
    return df.drop(index=drop).reset_index(drop=True)


@pytest.mark.parametrize("make", [_phase_input, _mixed_input],
                         ids=["jax_phase_input", "mixed_24x300"])
def test_predict_cycle_phase_frames_equal_jax(make):
    cn = make()
    got = tphase.predict_cycle_phase(cn.copy())
    want = jphase.predict_cycle_phase(cn.copy())
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w, check_exact=True)
    labels = pd.concat(got).groupby("cell_id")["PERT_phase"].first()
    assert len(labels) == cn["cell_id"].nunique()
    if make is _mixed_input:
        # every class is reached: the extremes are G1/2, the CN-0 and
        # block-replicated cells LQ, the rest S
        assert set(labels) == {"S", "G1/2", "LQ"}
        assert labels["cell00"] == labels["cell03"] == "G1/2"


def test_predict_cycle_phase_steps_equal_jax():
    cn = _mixed_input(seed=3)
    frac = tphase.compute_cell_frac(cn)
    pd.testing.assert_frame_equal(frac, jphase.compute_cell_frac(cn))
    feats = tphase.compute_quality_features(frac)
    pd.testing.assert_frame_equal(
        feats, jphase.compute_quality_features(frac), check_exact=True)
    for a, b in zip(tphase.remove_nonreplicating_cells(frac, thresh=0.1),
                    jphase.remove_nonreplicating_cells(frac, thresh=0.1)):
        pd.testing.assert_frame_equal(a, b)
    for a, b in zip(tphase.remove_low_quality_cells(feats, 0.1, 0.01),
                    jphase.remove_low_quality_cells(feats, 0.1, 0.01)):
        pd.testing.assert_frame_equal(a, b)
