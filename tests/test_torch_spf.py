"""The port's ``SPF`` (per-clone S-phase fraction with bootstrap
errors) against the JAX package's: the same tables on the same clones
(the bootstrap is NumPy's multivariate hypergeometric on
``default_rng(seed)`` in both), and, with clone discovery, the same
partition and fractions up to the clusters' names."""

import numpy as np
import pandas as pd
import pytest

from scdna_replication_tools_tpu.api import SPF as JaxSPF
from scdna_replication_tools_tpu.models.simulator import pert_simulator
from scdna_replication_tools_tpu_torch import SPF as TorchSPF

from test_torch_model import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def sim_data(synthetic_frames):
    df_s, df_g = synthetic_frames
    sim_s, sim_g = pert_simulator(
        df_s, df_g, num_reads=50_000, rt_cols=["rt_A", "rt_B"],
        clones=["A", "B"], lamb=0.75, betas=[0.5, 0.0], a=10.0, seed=8)
    for df in (sim_s, sim_g):
        df["reads"] = df["true_reads_norm"]
    # a third clone of G1 cells only, so one SPF is 0
    extra = sim_g[sim_g["cell_id"].str.contains("_A_")].copy()
    extra["cell_id"] = extra["cell_id"] + "_c"
    extra["clone_id"] = "C"
    return sim_s, pd.concat([sim_g, extra], ignore_index=True)


@pytest.mark.parametrize("seed", [0, 3])
def test_spf_tables_equal_jax(sim_data, seed):
    sim_s, sim_g = sim_data
    js, jt = JaxSPF(sim_s.copy(), sim_g.copy(), seed=seed).infer()
    ts, tt = TorchSPF(sim_s.copy(), sim_g.copy(), seed=seed,
                      device="cpu").infer()
    pd.testing.assert_frame_equal(tt, jt)
    pd.testing.assert_frame_equal(ts, js)


def test_spf_with_clone_discovery_matches_jax(sim_data):
    sim_s, sim_g = sim_data
    _, jt = JaxSPF(sim_s.copy(), sim_g.copy(), clone_col=None).infer()
    _, tt = TorchSPF(sim_s.copy(), sim_g.copy(), clone_col=None,
                     device="cpu").infer()
    key = ["num_s", "num_g"]
    j = jt.sort_values(key).reset_index(drop=True)
    t = tt.sort_values(key).reset_index(drop=True)
    np.testing.assert_array_equal(t[key], j[key])
    np.testing.assert_allclose(t["SPF"], j["SPF"])


def test_spf_refuses_frames_without_their_columns(sim_data):
    sim_s, sim_g = sim_data
    with pytest.raises(ValueError, match="clone_id"):
        TorchSPF(sim_s, sim_g.drop(columns=["clone_id"]),
                 device="cpu").infer()
