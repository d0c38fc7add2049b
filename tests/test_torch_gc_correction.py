"""The port's LOWESS and bulk G1 GC correction
(``pipeline/gc_correction.py``) against the JAX package's.

The port evaluates the fit once per distinct x value (the same
estimator); the curves are held to 1e-12 relative of JAX's per-point
evaluation, including ties of x, robustness passes that stop early
(zero median residual) and windows of zero width.
"""

import numpy as np
import pandas as pd
import pytest

from scdna_replication_tools_tpu.pipeline import gc_correction as jgc
from scdna_replication_tools_tpu_torch.pipeline import gc_correction as tgc

from test_torch_model import one_torch_thread  # noqa: F401

REL = 1e-12


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.mark.parametrize("cells,loci,seed", [(6, 300, 0), (1, 500, 1),
                                             (9, 80, 2)])
def test_lowess_matches_jax(cells, loci, seed):
    rng = np.random.default_rng(seed)
    gc = np.round(rng.uniform(0.3, 0.6, loci), 3)     # ties across loci
    x = np.tile(gc, cells)
    y = 180 * (1 + 0.8 * (x - 0.45)) + rng.normal(0, 12, x.size)
    xvals = np.sort(np.r_[np.unique(gc), 0.31234, 0.5999])
    ref = jgc.lowess(y, x, xvals)
    got = tgc.lowess(y, x, xvals, device="cpu")
    assert _rel(got, ref) <= REL


def test_lowess_zero_residual_stops_early():
    """A perfectly linear y: the first robustness pass finds a zero
    median residual and stops, as JAX's does."""
    x = np.tile(np.linspace(0.3, 0.6, 50), 3)
    y = 2.0 * x + 1.0
    xv = np.linspace(0.3, 0.6, 7)
    assert _rel(tgc.lowess(y, x, xv, device="cpu"), jgc.lowess(y, x, xv)) \
        <= REL


def test_lowess_zero_width_window_takes_jax_branch():
    """One x value holds more than frac of the points: the window at it
    has zero width and the JAX package's weighted-mean branch answers."""
    rng = np.random.default_rng(3)
    x = np.r_[np.full(80, 0.4), rng.uniform(0.3, 0.6, 20)]
    y = rng.normal(100, 5, x.size)
    xv = np.array([0.4, 0.35, 0.55])
    assert _rel(tgc.lowess(y, x, xv, device="cpu"), jgc.lowess(y, x, xv)) \
        <= REL


def _frames(seed=4, cells=5, loci=200, libs=("L1", "L2")):
    rng = np.random.default_rng(seed)
    gc = rng.uniform(0.3, 0.6, loci)
    rows = []
    for phase in ("s", "g"):
        for c in range(cells):
            lib = libs[c % len(libs)]
            rows.append(pd.DataFrame({
                "cell_id": f"{phase}{c}", "chr": "1",
                "start": np.arange(loci) * 500_000, "gc": gc,
                "library_id": lib,
                "reads": rng.poisson(100 * (1 + gc)).astype(float)}))
    df = pd.concat(rows, ignore_index=True)
    return (df[df.cell_id.str.startswith("s")].reset_index(drop=True),
            df[df.cell_id.str.startswith("g")].reset_index(drop=True))


def test_bulk_g1_gc_correction_matches_jax():
    cn_s, cn_g1 = _frames()
    js, jg = jgc.bulk_g1_gc_correction(cn_s, cn_g1)
    ts, tg = tgc.bulk_g1_gc_correction(cn_s, cn_g1, device="cpu")
    for j, t in ((js, ts), (jg, tg)):
        assert list(t.columns) == list(j.columns)
        pd.testing.assert_frame_equal(t.drop(columns=["rpm_gc_norm"]),
                                      j.drop(columns=["rpm_gc_norm"]))
        assert _rel(t["rpm_gc_norm"].to_numpy(),
                    j["rpm_gc_norm"].to_numpy()) <= REL


def test_reads_per_million_matches_jax():
    cn_s, _ = _frames(seed=5)
    pd.testing.assert_frame_equal(tgc.compute_reads_per_million(cn_s),
                                  jgc.compute_reads_per_million(cn_s))
