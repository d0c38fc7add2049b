"""The port's deterministic levels (``infer(level='cell'|'clone'|
'bulk')``, ``pipeline/{deterministic,normalize,binarize,pseudobulk,
twidth}.py``) against the JAX package's on the same simulated frames.

Held: the same columns; rt_value to 1e-6 relative (of 1 + |value|: the
profiles are centred); rt_state on >= 99.9 % of bins; frac_rt to 1e-5.
With clone discovery (``clone_col=None``) the two k-means name their
clusters differently, so the frames are compared without that column.
"""

import numpy as np
import pandas as pd
import pytest

from scdna_replication_tools_tpu.api import scRT as JaxScRT
from scdna_replication_tools_tpu.models.simulator import pert_simulator
from scdna_replication_tools_tpu.pipeline import binarize as jbin
from scdna_replication_tools_tpu.pipeline import normalize as jnorm
from scdna_replication_tools_tpu.pipeline import twidth as jtw
from scdna_replication_tools_tpu_torch import scRT as TorchScRT
from scdna_replication_tools_tpu_torch.pipeline import binarize as tbin
from scdna_replication_tools_tpu_torch.pipeline import normalize as tnorm
from scdna_replication_tools_tpu_torch.pipeline import twidth as ttw

from test_torch_model import one_torch_thread  # noqa: F401

KEYS = ["cell_id", "chr", "start"]
ALIKE = 0.999


@pytest.fixture(scope="module")
def sim_data(synthetic_frames):
    df_s, df_g = synthetic_frames
    sim_s, sim_g = pert_simulator(
        df_s, df_g, num_reads=50_000, rt_cols=["rt_A", "rt_B"],
        clones=["A", "B"], lamb=0.75, betas=[0.5, 0.0], a=10.0, seed=5)
    for df in (sim_s, sim_g):
        df["reads"] = df["true_reads_norm"]
        df["state"] = df["true_somatic_cn"].astype(int)
        df["copy"] = df["true_somatic_cn"].astype(float)
    return sim_s, sim_g


OPTS = dict(input_col="reads", assign_col="copy", rt_prior_col=None)


def _levels(sim_data, level, clone_col):
    sim_s, sim_g = sim_data
    j = JaxScRT(sim_s.copy(), sim_g.copy(), clone_col=clone_col, **OPTS)
    t = TorchScRT(sim_s.copy(), sim_g.copy(), clone_col=clone_col,
                  device="cpu", **OPTS)
    return (j, j.infer(level)), (t, t.infer(level))


def _compare(jout, tout, drop=()):
    jout = jout.drop(columns=list(drop))
    tout = tout.drop(columns=list(drop))
    assert list(tout.columns) == list(jout.columns)
    assert len(tout) == len(jout)
    m = jout.merge(tout, on=KEYS, suffixes=("_jax", "_torch"))
    assert len(m) == len(jout)
    rv = m["rt_value_torch"] - m["rt_value_jax"]
    assert float((rv.abs() / (1 + m["rt_value_jax"].abs())).max()) <= 1e-6
    assert (m["rt_state_torch"] == m["rt_state_jax"]).mean() >= ALIKE
    assert float((m["frac_rt_torch"] - m["frac_rt_jax"]).abs().max()) \
        <= 1e-5


@pytest.mark.parametrize("level", ["cell", "clone", "bulk"])
def test_level_frames_match_jax(sim_data, level):
    (j, jres), (t, tres) = _levels(sim_data, level, "clone_id")
    _compare(jres[0], tres[0])
    for a, b in zip(jres[1:], tres[1:]):
        assert a.empty and b.empty
    assert list(t.manhattan_df.columns) == list(j.manhattan_df.columns)


@pytest.mark.parametrize("level", ["cell", "clone"])
def test_levels_with_clone_discovery_match_jax(sim_data, level):
    (j, jres), (t, tres) = _levels(sim_data, level, None)
    assert j.clone_col == t.clone_col == "cluster_id"
    _compare(jres[0], tres[0], drop=("cluster_id",))


def test_normalize_by_cell_engines_match_jax(sim_data):
    sim_s, sim_g = sim_data
    kw = dict(input_col="reads", clone_col="clone_id")
    ref = jnorm.normalize_by_cell(sim_s.copy(), sim_g.copy(), **kw)
    for engine in ("batch", "loop"):
        got = tnorm.normalize_by_cell(sim_s.copy(), sim_g.copy(),
                                      engine=engine, **kw)
        pd.testing.assert_frame_equal(
            got.sort_values(KEYS).reset_index(drop=True),
            ref.sort_values(KEYS).reset_index(drop=True), check_like=True)


def test_binarize_profiles_match_jax(sim_data):
    sim_s, _ = sim_data
    ref, ref_m = jbin.binarize_profiles(sim_s.copy(), "reads")
    got, got_m = tbin.binarize_profiles(sim_s.copy(), "reads", device="cpu")
    assert list(got.columns) == list(ref.columns)
    assert (got["rt_state"] == ref["rt_state"]).mean() >= ALIKE
    for col in ("frac_rt", "binary_thresh", "mean_0", "mean_1"):
        np.testing.assert_allclose(got[col], ref[col], rtol=1e-5,
                                   atol=1e-5, err_msg=col)
    np.testing.assert_allclose(got_m["manhattan_dist"],
                               ref_m["manhattan_dist"], rtol=1e-5)


def test_pseudobulk_and_twidth_match_jax(sim_data):
    """On the same input frame the copies give JAX's tables and
    T-width exactly; end to end (each package's own clone level) the
    T-width, a sigmoid fit to binned replicated fractions, agrees to
    1 % (a bin whose rt_state differs moves the bins' fractions)."""
    from scdna_replication_tools_tpu.pipeline import pseudobulk as jpb
    from scdna_replication_tools_tpu_torch.pipeline import pseudobulk as tpb
    (j, _), (t, _) = _levels(sim_data, "clone", "clone_id")
    bulk = jpb.compute_pseudobulk_rt_profiles(j.cn_s, "rt_value")
    pd.testing.assert_frame_equal(
        tpb.compute_pseudobulk_rt_profiles(j.cn_s, "rt_value"), bulk)
    cn = jtw.compute_time_from_scheduled_column(pd.merge(j.cn_s, bulk))
    pd.testing.assert_frame_equal(ttw.compute_time_from_scheduled_column(
        pd.merge(j.cn_s, bulk)), cn)
    for curve in ("sigmoid", "linear"):
        ref = jtw.calculate_twidth(cn, curve=curve)
        got = ttw.calculate_twidth(cn, curve=curve)
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-9)
        np.testing.assert_allclose(got[3], ref[3], rtol=1e-9)
        assert got[4] == ref[4] and got[5] == ref[5]
    j.compute_pseudobulk_rt_profiles()
    t.compute_pseudobulk_rt_profiles()
    jw, tw = j.calculate_twidth(), t.calculate_twidth()
    assert abs(tw[0] - jw[0]) <= 1e-2 * abs(jw[0])


@pytest.mark.parametrize("profile_col", ["reads", "state"])
def test_normalize_by_clone_frame_equals_jax(sim_data, profile_col):
    """The port's one-gather normalisation against JAX's per-cell
    merges, frame for frame (a clone consensus of reads, and of states,
    whose zero bins the eps guards)."""
    from scdna_replication_tools_tpu.pipeline.consensus import (
        compute_consensus_clone_profiles,
    )
    sim_s, sim_g = sim_data
    profiles = compute_consensus_clone_profiles(sim_g, profile_col,
                                                clone_col="clone_id")
    s = sim_s[sim_s["start"] < 55_000_000]     # loci the profiles lack too
    ref = jnorm.normalize_by_clone(s.copy(), profiles.iloc[:100],
                                   input_col="reads")
    got = tnorm.normalize_by_clone(s.copy(), profiles.iloc[:100],
                                   input_col="reads")
    pd.testing.assert_frame_equal(got, ref)
    with pytest.raises(KeyError):
        tnorm.normalize_by_clone(s.assign(clone_id="Z"), profiles,
                                 input_col="reads")
