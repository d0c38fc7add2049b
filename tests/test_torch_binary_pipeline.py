"""The binary + bfloat16-moment configuration as a whole:
``scRT(enum_impl='binary', optimizer_state_dtype='bfloat16')`` from the
PyTorch package against the JAX package on the same simulator frames.

The JAX package runs it on the CPU as ``binary_xla`` with the XLA fused
Adam; the port runs on ``device='cpu'`` through the plain versions of its
binary kernels and of its bfloat16-moment Adam.  Steps 2 (dense
composite prior) and 3 (sparse clone prior) take the binary encoding,
step 1 stays categorical; all three store the pi moments in bfloat16.
"""

import numpy as np
import pytest

from scdna_replication_tools_tpu.api import scRT as JaxScRT
from scdna_replication_tools_tpu_torch import scRT as TorchScRT

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_pipeline import OPTS, _merged, sim_data  # noqa: F401

BINARY = dict(OPTS, enum_impl="binary", optimizer_state_dtype="bfloat16")


@pytest.fixture(scope="module")
def outputs(sim_data):  # noqa: F811
    sim_s, sim_g = sim_data
    jax_out = JaxScRT(sim_s.copy(), sim_g.copy(), compile_cache_dir=None,
                      **BINARY).infer(level="pert")
    port = TorchScRT(sim_s.copy(), sim_g.copy(), device="cpu", **BINARY)
    torch_out = port.infer(level="pert")
    return jax_out, torch_out, port


def test_binary_path_is_taken(outputs):
    """Steps 2 and 3 fit the Kb = 4 binary planes, step 1 the P = 13
    categorical ones; every step stores the pi moments in bfloat16."""
    import torch
    steps = outputs[2].steps
    keys = ["pi_logits", "pi_bin_logits", "pi_bin_logits"]
    for step, key in zip(steps, keys):
        assert step.spec.binary_pi == (key == "pi_bin_logits")
        p = step.fit.params[key]
        assert p.shape[0] == (4 if key == "pi_bin_logits" else 13)
        assert step.fit.opt_state.mu[key].dtype == torch.bfloat16
        assert step.fit.opt_state.nu["tau_raw"].dtype == torch.float32


@pytest.mark.parametrize("frame", [0, 2], ids=["s_cells", "g1_cells"])
def test_binary_states_and_tau_agree_with_jax(outputs, frame):
    """CN and replication states agree on >= 99% of bins and per-cell tau
    correlates >= 0.99 with the JAX run (the JAX side enumerates the
    materialised log_pi with XLA's lgamma, the port the fused plain
    versions with the Stirling series: near-tied bins may decode
    apart)."""
    jax_out, torch_out, _ = outputs
    m = _merged(jax_out[frame], torch_out[frame])
    assert len(m) == len(jax_out[frame]) == len(torch_out[frame])
    for col in ("model_cn_state", "model_rep_state"):
        agree = (m[f"{col}_jax"] == m[f"{col}_torch"]).mean()
        assert agree >= 0.99, (col, agree)
    tau = m.groupby("cell_id")[["model_tau_jax", "model_tau_torch"]].first()
    r = np.corrcoef(tau["model_tau_jax"], tau["model_tau_torch"])[0, 1]
    assert r >= 0.99, r


def test_binary_lambda_agrees_with_jax(outputs):
    jax_out, torch_out, _ = outputs
    lam = [o[1].query("param == 'model_lambda'")["value"].iloc[0]
           for o in (jax_out, torch_out)]
    assert abs(lam[0] - lam[1]) < 1e-3, lam


def test_binary_port_recovers_simulated_truth(outputs):
    """The simulate-and-recover bars of tests/test_end_to_end.py."""
    cn_s, supp_s, cn_g1, _ = outputs[1]
    assert (cn_s["model_rep_state"] == cn_s["true_rep"]).mean() > 0.80
    assert (cn_s["model_cn_state"] == cn_s["true_somatic_cn"]).mean() > 0.90
    per_cell = cn_s.groupby("cell_id").agg(
        tau=("model_tau", "first"), true_t=("true_t", "first"))
    assert np.corrcoef(per_cell["tau"], per_cell["true_t"])[0, 1] > 0.8
    lamb = supp_s.query("param == 'model_lambda'")["value"].iloc[0]
    assert 0.5 < lamb < 0.95
    loss_s = supp_s.query("param == 'loss_s'")["value"].to_numpy()
    assert np.isfinite(loss_s).all() and loss_s[-1] < loss_s[0]
    for col in ["model_cn_state", "model_rep_state", "model_tau", "model_u",
                "model_rho", "model_p_rep"]:
        assert col in cn_s.columns and col in cn_g1.columns, col
