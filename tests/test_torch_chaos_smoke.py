"""The port's chaos smoke (``python -m
scdna_replication_tools_tpu_torch.tools.chaos_smoke``) at a tiny size on
the CPU: the golden run, the run killed by ``preempt@step2/chunk#3`` and
the resumed run, every check of its verdict ok (the resumed run's tau
bit for bit the golden run's), and the verdict document's keys those of
JAX's single-process scenario; ``--report`` renders the resumed run's
log with the port's ``tools/pert_report``."""

from __future__ import annotations

import json

from scdna_replication_tools_tpu_torch.tools import chaos_smoke
from scdna_replication_tools_tpu_torch.tools import pert_report
from scdna_replication_tools_tpu_torch.utils import faults

from test_torch_model import one_torch_thread  # noqa: F401

# the keys of the verdict JAX's tools/chaos_smoke.py prints for its
# single-process scenario
JAX_VERDICT_KEYS = {"metric", "kill_at", "cells", "checks",
                    "tau_max_abs_delta", "ok", "workdir"}


def test_chaos_smoke_kill_and_resume_is_bit_exact(tmp_path, capsys):
    out = tmp_path / "verdict.json"
    try:
        rc = chaos_smoke.main(["--device", "cpu", "--cells", "8",
                               "--g1-cells", "6", "--loci", "96",
                               "--workdir", str(tmp_path / "work"),
                               "--out", str(out)])
    finally:
        faults.install(None)
    verdict = json.loads(out.read_text())
    assert rc == 0 and verdict["ok"], verdict["checks"]
    assert set(verdict) == JAX_VERDICT_KEYS
    assert set(verdict["checks"]) == {
        "preemption_fired", "killed_log_has_fault_event",
        "killed_run_ended_error", "resumed_log_schema_valid",
        "resumed_log_has_resume_trail", "tau_bit_exact_vs_golden"}
    assert verdict["tau_max_abs_delta"] == 0.0
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == verdict


def test_workload_shape_and_columns():
    s, g = chaos_smoke.make_workload(4, 2, 50, device="cpu")
    assert s["cell_id"].nunique() == 4 and g["cell_id"].nunique() == 2
    assert len(s) == 4 * 50
    for col in ("reads", "state", "copy", "clone_id", "gc", "library_id"):
        assert col in s.columns


def test_chaos_smoke_report_has_the_resilience_section(tmp_path, capsys):
    """--report writes the resumed run's report with its Resilience
    section filled, and the verdict carries the check, true."""
    report = tmp_path / "resumed.md"
    try:
        rc = chaos_smoke.main(["--device", "cpu", "--cells", "8",
                               "--g1-cells", "6", "--loci", "96",
                               "--workdir", str(tmp_path / "work"),
                               "--report", str(report)])
    finally:
        faults.install(None)
    verdict = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and verdict["ok"], verdict["checks"]
    assert verdict["checks"]["report_has_resilience_section"] is True
    text = report.read_text()
    section = text.split("## Resilience", 1)[1].split("\n## ", 1)[0]
    assert "- **resume (" in section and "_clean run" not in section
    assert text == pert_report.render_report(
        tmp_path / "work" / "resumed.jsonl") + "\n"
