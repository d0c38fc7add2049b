"""Genome-wide example bin table (the bundled-data-asset equivalent; port,
a copy, of the JAX package's ``data/example_bins.py``, table for table).

The reference bundles ``notebooks/mcfrt.csv`` — hg19 500kb bins with GC
content and an MCF-7 RepliSeq replication-timing prior (5451 rows).  That
file is measured data we cannot redistribute, so this module *generates*
a drop-in table with the same schema (``chr, start, end, gc, mcf7rt,
bin_size``) over the real hg19 chromosome lengths, with smooth synthetic
GC and RT profiles: autocorrelated along the genome like the real
quantities, deterministic given the seed, and explicitly synthetic.

Use it anywhere the reference's notebooks read mcfrt.csv:

    from scdna_replication_tools_tpu_torch.data.example_bins import make_example_bins
    bins = make_example_bins()            # 500kb, genome-wide, ~5.7k rows
    chr1 = bins[bins.chr == "1"]
"""

from __future__ import annotations

import numpy as np
import pandas as pd

# hg19 (GRCh37) chromosome lengths in bp — public genome-assembly facts
HG19_CHROM_LENGTHS = {
    "1": 249_250_621, "2": 243_199_373, "3": 198_022_430, "4": 191_154_276,
    "5": 180_915_260, "6": 171_115_067, "7": 159_138_663, "8": 146_364_022,
    "9": 141_213_431, "10": 135_534_747, "11": 135_006_516,
    "12": 133_851_895, "13": 115_169_878, "14": 107_349_540,
    "15": 102_531_392, "16": 90_354_753, "17": 81_195_210,
    "18": 78_077_248, "19": 59_128_983, "20": 63_025_520, "21": 48_129_895,
    "22": 51_304_566, "X": 155_270_560, "Y": 59_373_566,
}


def _smooth_track(n: int, rng: np.random.Generator, lo: float, hi: float,
                  wavelength_bins: float) -> np.ndarray:
    """Autocorrelated track in [lo, hi]: sum of a few random sinusoids."""
    pos = np.arange(n, dtype=np.float64)
    track = np.zeros(n)
    for k in range(1, 5):
        freq = k / wavelength_bins
        track += rng.normal(0, 1) / k * np.sin(
            2 * np.pi * freq * pos + rng.uniform(0, 2 * np.pi))
    track = (track - track.min()) / max(track.max() - track.min(), 1e-12)
    return lo + (hi - lo) * track


def make_example_bins(bin_size: int = 500_000, seed: int = 0,
                      chroms=None) -> pd.DataFrame:
    """Schema-compatible stand-in for the reference's mcfrt.csv.

    Columns: ``chr`` (str), ``start``/``end`` (bp), ``gc`` in ~[0.33,
    0.62], ``mcf7rt`` in [0, 1] (higher = earlier replication),
    ``bin_size``.
    """
    rng = np.random.default_rng(seed)
    frames = []
    for chrom in (chroms if chroms is not None else HG19_CHROM_LENGTHS):
        length = HG19_CHROM_LENGTHS[str(chrom)]
        n = length // bin_size
        starts = np.arange(n, dtype=np.int64) * bin_size
        gc = _smooth_track(n, rng, 0.33, 0.62, wavelength_bins=40.0)
        gc += rng.normal(0, 0.01, n)
        # RT correlates positively with GC genome-wide; blend a GC-tracking
        # component with an independent smooth component
        rt = 0.5 * (gc - gc.min()) / max(gc.max() - gc.min(), 1e-12) \
            + 0.5 * _smooth_track(n, rng, 0.0, 1.0, wavelength_bins=60.0)
        frames.append(pd.DataFrame({
            "chr": str(chrom),
            "start": starts,
            "end": starts + bin_size,
            "gc": np.clip(gc, 0.25, 0.75),
            "mcf7rt": np.clip(rt, 0.0, 1.0),
            "bin_size": bin_size,
        }))
    return pd.concat(frames, ignore_index=True)
