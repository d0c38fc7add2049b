"""Reference-genome coordinate info for genome-axis plotting (port, a
copy, of the JAX package's ``plotting/refgenome.py``).

The reference depends on the external ``scgenome.refgenome`` package for
chromosome starts/ends/midpoints (reference: plot_utils.py:6, 41-44,
134-142); here the hg19 chromosome lengths (GRCh37 assembly, public
constants) are inlined so plotting has no external genomics dependency.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

# GRCh37/hg19 chromosome lengths
HG19_CHROM_LENGTHS = {
    "1": 249250621, "2": 243199373, "3": 198022430, "4": 191154276,
    "5": 180915260, "6": 171115067, "7": 159138663, "8": 146364022,
    "9": 141213431, "10": 135534747, "11": 135006516, "12": 133851895,
    "13": 115169878, "14": 107349540, "15": 102531392, "16": 90354753,
    "17": 81195210, "18": 78077248, "19": 59128983, "20": 63025520,
    "21": 48129895, "22": 51304566, "X": 155270560, "Y": 59373566,
}


class GenomeInfo:
    """Cumulative chromosome coordinates for a linear genome axis."""

    def __init__(self, chrom_lengths=None):
        lengths = dict(chrom_lengths or HG19_CHROM_LENGTHS)
        self.chromosomes = list(lengths.keys())
        ends = np.cumsum(list(lengths.values()))
        starts = np.concatenate([[0], ends[:-1]])
        self.chromosome_info = pd.DataFrame({
            "chr": self.chromosomes,
            "chromosome_length": list(lengths.values()),
            "chromosome_start": starts,
            "chromosome_end": ends,
        })
        self.chromosome_end = pd.Series(ends, index=self.chromosomes)
        self.chromosome_mid = starts + np.asarray(list(lengths.values())) / 2
        self.chrom_idxs = pd.DataFrame({
            "chr": self.chromosomes,
            "chr_index": np.arange(len(self.chromosomes)),
        })


info = GenomeInfo()
