"""The port's ``tools/pert_watch`` (``python -m
scdna_replication_tools_tpu_torch.tools.pert_watch``) in the CLI cases of
JAX's ``tests/test_watch.py``: ``check``'s exit codes, verdict document
and textfile gauges, ``watch --once``'s frame, ``report``'s markdown and
the run-directory resolution; then every output against JAX's
``tools/pert_watch.py`` on the same heartbeat trees, and a tree that a
port run wrote.  The tool reads with the port's ``obs/heartbeat`` and
``obs/alerts`` and imports nothing of JAX."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from scdna_replication_tools_tpu_torch.obs import heartbeat as hb
from scdna_replication_tools_tpu_torch.tools import pert_watch
from tools import pert_watch as jax_watch

from test_torch_model import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def _doc(rank, *, state="running", step="step2", chunk=3, iteration=60,
         budget=100, interval=10.0, age=0.0, now=None, count=2, eta=4.0):
    """One heartbeat document, ``age`` seconds old (JAX's test helper)."""
    now = time.time() if now is None else now
    return {
        "kind": hb.HEARTBEAT_KIND, "version": hb.HEARTBEAT_VERSION,
        "process_index": rank, "process_count": count, "state": state,
        "interval_seconds": interval, "step": step, "chunk": chunk,
        "iteration": iteration, "budget": budget,
        "ms_per_iter_ewma": 12.0, "eta_seconds": eta,
        "written_unix": now - age, "seq": 7, "metrics": {},
    }


def _tree(tmp_path, docs):
    health = tmp_path / "health"
    health.mkdir(parents=True, exist_ok=True)
    for doc in docs:
        hb.host_path(health, doc["process_index"]).write_text(
            json.dumps(doc))
    return health


def test_watch_check_exit_codes_and_textfile(tmp_path, capsys):
    _tree(tmp_path, [_doc(0), _doc(1)])
    prom = tmp_path / "watch.prom"
    rc = pert_watch.main(["check", str(tmp_path),
                          "--metrics-textfile", str(prom)])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    assert out["kind"] == "pert_watch_check" and out["failing"] == []
    text = prom.read_text()
    for name in ("pert_heartbeat_lag_seconds",
                 "pert_straggler_spread_chunks", "pert_run_eta_seconds"):
        assert name in text
    stale = tmp_path / "stale"
    _tree(stale, [_doc(0), _doc(1, interval=0.5, age=300.0)])
    rc = pert_watch.main(["check", str(stale)])
    captured = capsys.readouterr()
    assert rc == 1 and "host-presumed-lost" in captured.err
    assert json.loads(captured.out)["failing"] == ["host-presumed-lost"]


def test_watch_check_empty_dir_fails_absence(tmp_path, capsys):
    (tmp_path / "health").mkdir()
    assert pert_watch.main(["check", str(tmp_path)]) == 1
    assert "missing-heartbeats" in capsys.readouterr().err


def test_watch_once_renders_mission_control(tmp_path, capsys):
    _tree(tmp_path, [_doc(0, chunk=5, iteration=90),
                     _doc(1, chunk=2, iteration=40)])
    assert pert_watch.main(["watch", str(tmp_path), "--once"]) == 0
    out = capsys.readouterr().out
    assert "host0" in out and "host1" in out
    assert "spread 3 chunks / 50 iters" in out and "ETA" in out


def test_watch_report_markdown(tmp_path, capsys):
    _tree(tmp_path, [_doc(0), _doc(1, interval=0.5, age=300.0)])
    assert pert_watch.main(["report", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "## Run health" in out and "presumed_lost" in out
    assert "host-presumed-lost" in out
    assert any("no heartbeats" in ln for ln in
               pert_watch.render_health_markdown(
                   hb.aggregate_health(tmp_path / "none"), []))


def test_resolve_health_dir_accepts_run_dir_or_health_dir(tmp_path):
    health = _tree(tmp_path, [_doc(0)])
    assert pert_watch.resolve_health_dir(str(tmp_path)) == health
    assert pert_watch.resolve_health_dir(str(health)) == health


@pytest.mark.parametrize("cmd", [["check"], ["report"],
                                 ["watch", "--once", "--no-runlog"]])
def test_outputs_equal_jax_tools(tmp_path, capsys, cmd):
    """The same tree read by both tools prints the same document, apart
    from the ages that the two reads take at their own instants."""
    now = time.time()
    _tree(tmp_path, [_doc(0, now=now, chunk=5, iteration=90),
                     _doc(1, now=now, interval=0.5, age=300.0)])

    def run(tool):
        rc = tool.main([cmd[0], str(tmp_path)] + cmd[1:])
        out = capsys.readouterr().out
        return rc, _without_ages(out)
    assert run(pert_watch) == run(jax_watch)


def _without_ages(text: str) -> str:
    import re

    return re.sub(r"(lag|age_seconds|max_lag_seconds|lag \(s\))[^,|\n]*",
                  r"\1", re.sub(r"\d+\.\d+s", "T", text))


def test_reads_a_tree_a_port_run_wrote(synthetic_frames, tmp_path, capsys):
    from scdna_replication_tools_tpu_torch.config import PertConfig

    from test_torch_resilience import BASE, run_port

    run_port(synthetic_frames, PertConfig(**BASE,
                                          checkpoint_dir=str(tmp_path)))
    assert pert_watch.main(["check", str(tmp_path)]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["aggregate"]["states"] == {"done": 1}


def test_module_runs_and_imports_no_jax(tmp_path):
    _tree(tmp_path, [_doc(0, count=1)])
    code = ("import sys, runpy\n"
            "sys.argv = ['pert_watch', 'check', sys.argv[1]]\n"
            "try:\n"
            "    runpy.run_module('scdna_replication_tools_tpu_torch.tools."
            "pert_watch', run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.split('.')[0] == "
            "'scdna_replication_tools_tpu']\n"
            "print('BAD', bad, 'RC', rc)\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         capture_output=True, text=True, cwd=str(REPO),
                         timeout=120).stdout
    assert "BAD [] RC 0" in out
