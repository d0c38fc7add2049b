"""The port's default configuration as a whole against the JAX package:
``scRT(cn_s, cn_g1)`` with every option at its default -- the adaptive
controller, the model-health QC, the controller-gated mirror rescue and
the run log -- on the simulator frames of tests/test_torch_pipeline.py.
The port runs on the CPU through the plain versions of its kernels; the
``control_decision`` and ``fit_health`` events are read from the run
log each side wrote (to a file under the test's temporary directory).
"""

import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from scdna_replication_tools_tpu.api import scRT as JaxScRT
from scdna_replication_tools_tpu_torch import scRT as TorchScRT

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_pipeline import _merged, sim_data  # noqa: F401

DEFAULTS = dict(input_col="reads", clone_col="clone_id", assign_col="copy",
                max_iter=300, min_iter=100, rt_prior_col=None)


def _logged(scrt):
    """(event, payload) of every line of the run's log."""
    out = []
    for line in Path(scrt.run_log_path).read_text().splitlines():
        payload = json.loads(line)
        out.append((payload.pop("event"), payload))
    return out


def _decisions(events):
    return [dict(p) for e, p in events if e == "control_decision"]


@pytest.fixture(scope="module")
def outputs(sim_data, tmp_path_factory):  # noqa: F811
    sim_s, sim_g = sim_data
    root = tmp_path_factory.mktemp("default")
    jscrt = JaxScRT(sim_s.copy(), sim_g.copy(), compile_cache_dir=None,
                    telemetry_path=str(root / "jax.jsonl"), **DEFAULTS)
    jax_out = jscrt.infer(level="pert")
    tscrt = TorchScRT(sim_s.copy(), sim_g.copy(), device="cpu",
                      telemetry_path=str(root / "port.jsonl"), **DEFAULTS)
    torch_out = tscrt.infer(level="pert")
    jevents, tevents = _logged(jscrt), _logged(tscrt)
    return dict(jax=(jscrt, jax_out, _decisions(jevents)),
                jax_events=jevents,
                torch=(tscrt, torch_out, _decisions(tevents)))


def test_default_config_runs_in_the_port(outputs):
    """Every default-on feature ran: the controller decided, the QC table
    exists, and the S frame carries the entropy column."""
    tscrt, (cn_s, supp_s, cn_g1, _), decisions = outputs["torch"]
    assert decisions, "the controller recorded no decision"
    assert "model_cn_entropy" in cn_s.columns
    ent = cn_s["model_cn_entropy"].to_numpy()
    assert np.all((ent >= 0) & (ent <= 1))
    qc = tscrt.cell_qc()
    assert len(qc) == cn_s["cell_id"].nunique()
    assert cn_g1 is not None


@pytest.mark.parametrize("frame", [0, 2], ids=["s_cells", "g1_cells"])
def test_default_frames_agree_with_jax(outputs, frame):
    """States agree on >= 99 % of bins and per-cell tau correlates >=
    0.99 with the JAX run (the bars of test_torch_pipeline.py), the
    entropy column within 1e-3 on 99 % of bins."""
    _, jout, _ = outputs["jax"]
    _, tout, _ = outputs["torch"]
    m = _merged(jout[frame], tout[frame])
    assert len(m) == len(jout[frame]) == len(tout[frame])
    for col in ("model_cn_state", "model_rep_state"):
        agree = (m[f"{col}_jax"] == m[f"{col}_torch"]).mean()
        assert agree >= 0.99, (col, agree)
    tau = m.groupby("cell_id")[["model_tau_jax", "model_tau_torch"]].first()
    r = np.corrcoef(tau["model_tau_jax"], tau["model_tau_torch"])[0, 1]
    assert r >= 0.99, r
    if frame == 0:
        keys = ["cell_id", "chr", "start"]
        e = pd.merge(jout[0][keys + ["model_cn_entropy"]],
                     tout[0][keys + ["model_cn_entropy"]], on=keys,
                     suffixes=("_jax", "_torch"))
        close = np.abs(e["model_cn_entropy_jax"]
                       - e["model_cn_entropy_torch"]) < 1e-3
        assert close.mean() >= 0.99, close.mean()


def _decision_key(d):
    return (d["step"], d["action"], d["iter"], d["budget"],
            d.get("iters_granted"), d.get("outcome"))


def test_decision_lists_agree_with_jax(outputs):
    """The same decisions per step -- action, iteration, budget, grant --
    read from each side's run log, in the same order."""
    jdec = outputs["jax"][2]
    tdec = outputs["torch"][2]
    assert [_decision_key(d) for d in tdec] \
        == [_decision_key(d) for d in jdec], (tdec, jdec)


def test_fit_iterations_agree_with_jax(outputs):
    """Each step ran as many iterations as JAX's (the supp tables' loss
    histories) and reads the same doctor verdict (JAX's fit_health
    events); the port launched at least as many as it counted."""
    jscrt, jout, _ = outputs["jax"]
    tscrt, tout, _ = outputs["torch"]

    def lengths(out):
        supp_s, supp_g1 = out[1], out[3]
        n = lambda df, p: int((df["param"] == p).sum())  # noqa: E731
        return [n(supp_s, "loss_g"), n(supp_s, "loss_s"),
                n(supp_g1, "loss_s")]
    assert lengths(tout) == lengths(jout)
    fits = [s.fit for s in tscrt.steps]
    assert [f.num_iters for f in fits] == lengths(tout)
    assert all(f.timings["dispatched"] >= f.num_iters for f in fits)
    jverdicts = {p["step"]: p["verdict"]
                 for e, p in outputs["jax_events"] if e == "fit_health"}
    assert {f"step{k + 1}": f.verdict for k, f in enumerate(fits)} \
        == jverdicts


QC_EXACT = ["cell_id", "rescue_candidate", "rescue_accepted"]
QC_CLOSE = ["model_tau", "mean_cn_entropy", "max_cn_entropy",
            "frac_low_conf", "mean_rep_entropy", "ppc_deviance"]


def test_cell_qc_agrees_with_jax(outputs):
    """The cell_qc() tables: same cells and rescue columns; tau, the
    entropy aggregates and the observed deviance within 1e-3 of each
    column's scale; the flags other than ppc_outlier the same on >= 95 %
    of cells (ppc_z rests on each side's own replicate draws, and is held
    to JAX's through the seam in tests/test_torch_qc.py)."""
    jqc = outputs["jax"][0].cell_qc()
    tqc = outputs["torch"][0].cell_qc()
    assert list(jqc.columns) == list(tqc.columns)
    assert len(jqc) == len(tqc)
    for col in QC_EXACT:
        assert (jqc[col].to_numpy() == tqc[col].to_numpy()).all(), col
    for col in QC_CLOSE:
        a, b = jqc[col].to_numpy(float), tqc[col].to_numpy(float)
        scale = max(1.0, np.abs(a).max())
        assert np.abs(a - b).max() <= 1e-3 * scale, (col,
                                                      np.abs(a - b).max())

    def flags(df):
        return df["qc_flags"].map(
            lambda s: tuple(f for f in s.split(",") if f
                            and f != "ppc_outlier"))
    assert (flags(jqc) == flags(tqc)).mean() >= 0.95
