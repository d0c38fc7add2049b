"""The port's degradation ladders on the packaging side, in the cases of
JAX's tests/test_resilience.py: the decode's OOM ladder
(``infer.runner._decode_with_degradation``: halve the slab, then drop
the QC entropy surfaces, then abort resumably; other errors propagate
untouched), ``package_step_output`` marking a dropped QC surface, and
the PPC's OOM rung to NaN columns, each fault injected at its site
(``{prefix}/decode``, ``qc/ppc``) on the port's uninterrupted run of
tests/test_torch_resilience.py.
"""

import json

import numpy as np
import pytest
import torch

from scdna_replication_tools_tpu_torch.config import ColumnConfig
from scdna_replication_tools_tpu_torch.infer.runner import (
    _decode_with_degradation,
    package_step_output,
)
from scdna_replication_tools_tpu_torch.obs import runlog, schema
from scdna_replication_tools_tpu_torch.utils import faults

from test_torch_model import one_torch_thread  # noqa: F401
from test_torch_resilience import (  # noqa: F401
    _clear_fault_plan,
    golden,
    port_frames,
)


def _ladder(golden, spec, tmp_path, entropy=True, params=None,
            hmm_self_prob=None):
    """The ladder on the uninterrupted run's step 2 under fault plan
    ``spec``, inside a run log; returns (result or exception, the
    ``degrade`` actions logged)."""
    inf, _, step2, _ = golden
    faults.install(faults.FaultPlan.from_spec(spec) if spec else None)
    log = runlog.RunLog(str(tmp_path / "d.jsonl"))
    out = None
    with log.session():
        try:
            out = _decode_with_degradation(
                step2.spec, params or step2.fit.params, step2.fixed,
                step2.batch, entropy, "pkg", data=inf._step2_data,
                hmm_self_prob=hmm_self_prob)
        except Exception as exc:  # noqa: BLE001 — the outcome compared
            out = exc
    assert schema.validate_run(tmp_path / "d.jsonl") == []
    actions = [e["action"] for e in map(
        json.loads, (tmp_path / "d.jsonl").read_text().splitlines())
        if e["event"] == "degrade"]
    return out, actions


def test_decode_ladder_halves_slab_on_oom(golden, tmp_path):
    (decoded, ent, want), actions = _ladder(golden, "oom@pkg/decode#1",
                                            tmp_path)
    assert faults.active().fired[0]["kind"] == "oom"
    (ref, ref_ent, _), _ = _ladder(golden, None, tmp_path)
    assert want is True and ent is not None and len(decoded) == 3
    assert actions == ["halve_decode_slab"]
    for a, b in zip(decoded + ent, ref + ref_ent):
        assert torch.equal(a, b)   # a smaller slab decodes the same bins


def test_decode_ladder_drops_qc_surfaces_when_halving_fails(golden,
                                                            tmp_path):
    (decoded, ent, want), actions = _ladder(golden, "oom@pkg/decode#1-4",
                                            tmp_path)
    assert want is False and ent is None and len(decoded) == 3
    assert actions == ["halve_decode_slab"] * 3 + ["drop_qc_surfaces"]


def test_decode_ladder_exhausted_reraises(golden, tmp_path):
    exc, actions = _ladder(golden, "oom@pkg/decode#*", tmp_path)
    assert isinstance(exc, faults.SimulatedResourceExhausted)
    assert actions == ["halve_decode_slab"] * 3 + ["drop_qc_surfaces",
                                                   "abort_resumable"]


def test_viterbi_decode_ladder_drops_qc_surfaces_at_once(golden, tmp_path):
    """The Viterbi decode has no slab to halve: an OOM drops the QC
    surfaces at once (JAX's ladder), and the retry decodes the bins the
    undisturbed Viterbi decode does."""
    (decoded, ent, want), actions = _ladder(golden, "oom@pkg/decode#1",
                                            tmp_path, hmm_self_prob=0.99)
    assert want is False and ent is None
    assert actions == ["drop_qc_surfaces"]
    (ref, _, _), _ = _ladder(golden, None, tmp_path, hmm_self_prob=0.99)
    for a, b in zip(decoded, ref):
        assert torch.equal(a, b)


def test_decode_ladder_propagates_deterministic_errors(golden, tmp_path):
    """A non-OOM error escapes from the first attempt: no rung runs."""
    _, _, step2, _ = golden
    bad = dict(step2.fit.params)
    bad.pop("tau_raw")
    exc, actions = _ladder(golden, None, tmp_path, entropy=False,
                           params=bad)
    assert faults.classify_exception(exc) == "deterministic"
    assert actions == []


def test_packaging_marks_dropped_qc_surfaces(golden, synthetic_frames):
    """When the ladder drops the entropy planes, packaging says so in
    qc_collect and the S frame carries no entropy column."""
    inf, step1, step2, _ = golden
    df_s, _ = port_frames(synthetic_frames)
    faults.install(faults.FaultPlan.from_spec(
        "oom@package_s/decode#1-4"))
    qc_collect = {}
    out, _ = package_step_output(
        df_s, inf._step2_data, step2, 0.75, step1.fit.losses,
        step2.fit.losses, ColumnConfig(rt_prior_col=None),
        qc_collect=qc_collect, phase_prefix="package_s")
    assert qc_collect == {"degraded": True}
    assert "model_cn_entropy" not in out.columns
    assert "model_cn_state" in out.columns


def test_ppc_oom_degrades_to_nan_columns(golden):
    inf, _, step2, _ = golden
    n = inf._step2_data.num_cells
    frac_low = np.zeros(n, np.float32)
    qc_stats = {
        "tau": np.full(step2.batch.reads.shape[0], 0.5, np.float32),
        "mean_cn_entropy": frac_low + 0.1,
        "max_cn_entropy": frac_low + 0.2,
        "frac_low_conf": frac_low,
        "mean_rep_entropy": frac_low + 0.1,
        "cn_map": np.full(tuple(step2.batch.reads.shape), 2, np.int32),
        "rep_map": np.zeros(tuple(step2.batch.reads.shape), np.int32),
    }
    faults.install(faults.FaultPlan.from_spec("oom@qc/ppc#1"))
    df = inf.build_cell_qc(step2, inf._step2_data, qc_stats)
    assert df["ppc_z"].isna().all() and df["ppc_deviance"].isna().all()
    assert not df["qc_flags"].str.contains("ppc_outlier").any()
    # the PPC drop must not poison the non_finite flag
    assert not df["qc_flags"].str.contains("non_finite").any()
    assert df["qc_pass"].all()


def test_ppc_non_oom_error_propagates(golden):
    inf, _, step2, _ = golden
    faults.install(faults.FaultPlan.from_spec("preempt@qc/ppc#1"))
    with pytest.raises(faults.SimulatedPreemption):
        inf.build_cell_qc(step2, inf._step2_data, {})
