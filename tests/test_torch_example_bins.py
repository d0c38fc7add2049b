"""The port's example bin table (``data/example_bins.py``) against the
JAX package's: the same frame, exactly (``assert_frame_equal`` with
``check_exact``), for the whole genome and for ``chroms`` subsets, at
several seeds and bin sizes; and JAX's own schema test
(tests/test_data_loader.py:61) run against the port.
"""

import pandas as pd
import pytest

from scdna_replication_tools_tpu.data import example_bins as jbins
from scdna_replication_tools_tpu_torch.data import example_bins as tbins


@pytest.mark.parametrize("kwargs", [
    {},
    {"seed": 3},
    {"bin_size": 1_000_000, "seed": 1},
    {"chroms": ["1", "2", "X"]},
    {"chroms": ["X", "7"], "seed": 5},
    {"chroms": [21, "Y"], "bin_size": 250_000},
], ids=["genome", "seed3", "1mb", "chroms_1_2_X", "chroms_X_7",
        "chroms_21_Y_250kb"])
def test_example_bins_equal_jax(kwargs):
    got = tbins.make_example_bins(**kwargs)
    want = jbins.make_example_bins(**kwargs)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_chromosome_lengths_equal_jax():
    assert tbins.HG19_CHROM_LENGTHS == jbins.HG19_CHROM_LENGTHS


def test_example_bins_schema():
    """JAX's tests/test_data_loader.py::test_example_bins_schema on the
    port."""
    bins = tbins.make_example_bins(chroms=["1", "2", "X"])
    assert list(bins.columns) == ["chr", "start", "end", "gc", "mcf7rt",
                                  "bin_size"]
    assert set(bins.chr) == {"1", "2", "X"}
    assert (bins.end - bins.start == 500_000).all()
    assert bins.gc.between(0.25, 0.75).all()
    assert bins.mcf7rt.between(0.0, 1.0).all()
    again = tbins.make_example_bins(chroms=["1", "2", "X"])
    assert bins.equals(again)
    full = tbins.make_example_bins()
    assert 5000 < len(full) < 6500
