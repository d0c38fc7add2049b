"""Chaos smoke of the port: inject a mid-fit preemption, resume, assert
bit-parity (port of ``tools/chaos_smoke.py``'s single-process scenario).

Three runs of one simulated workload:

1. **golden**: uninterrupted, no checkpointing;
2. **killed**: the same with ``faults='preempt@<site>'`` and a checkpoint
   after every chunk; dies mid-step-2 by design;
3. **resumed**: ``resume='auto'`` against the killed run's checkpoint
   directory; continues the step-2 fit mid-budget.

Checks (exit 1 on any failure): the killed run raised
``SimulatedPreemption``, its log carries ``fault_injected`` and ends
``run_end`` 'error'; the resumed log is schema-valid and carries the
``resume`` trail; the resumed run's per-cell ``model_tau`` equals the
golden run's bit for bit.  The JAX tool's ``--multiprocess`` scenario
(sharded checkpoints resumed on a smaller grid) has its port counterpart
in ``tests/test_torch_sharded_chaos.py``.  ``--report PATH`` renders the
resumed run's log with the port's ``tools/pert_report`` into PATH and
adds the check that it has a ``## Resilience`` section.

Usage::

    python -m scdna_replication_tools_tpu_torch.tools.chaos_smoke \\
        --device cpu --out chaos_smoke.json [--report resumed.md]
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile


def make_workload(cells: int, g1_cells: int, num_loci: int, seed: int = 0,
                  device=None):
    """(cn_s, cn_g1): two clones (a gain in B, an amplification in A) on
    one chromosome of ``num_loci`` 500 kb bins, reads simulated by the
    port's ``pert_simulator`` (lambda 0.75, a = 10), with the columns
    ``scRT`` reads."""
    import numpy as np
    import pandas as pd

    from scdna_replication_tools_tpu_torch.models.simulator import (
        pert_simulator,
    )

    rng = np.random.default_rng(seed)
    loci = np.arange(num_loci)
    starts = (loci * 500_000).astype(np.int64)
    gc = np.clip(0.45 + 0.08 * np.sin(loci / 9.0)
                 + rng.normal(0, 0.02, num_loci), 0.3, 0.65)
    rt_a = 0.5 + 0.45 * np.sin(loci / 15.0 + 1.0)
    rt_b = 0.5 + 0.45 * np.sin(loci / 15.0 + 2.2)
    cn_a = np.full(num_loci, 2.0)
    cn_a[int(0.66 * num_loci):int(0.83 * num_loci)] = 4.0
    cn_b = np.full(num_loci, 2.0)
    cn_b[int(0.17 * num_loci):int(0.42 * num_loci)] = 3.0

    def frame(prefix, n):
        rows = []
        for i in range(n):
            clone, cn = ("A", cn_a) if i % 2 == 0 else ("B", cn_b)
            rows.append(pd.DataFrame({
                "cell_id": f"{prefix}_{clone}_{i}", "chr": "1",
                "start": starts, "end": starts + 500_000, "gc": gc,
                "rt_A": rt_a, "rt_B": rt_b, "library_id": "LIB0",
                "clone_id": clone, "true_somatic_cn": cn}))
        return pd.concat(rows, ignore_index=True)

    sim_s, sim_g = pert_simulator(
        frame("s", cells), frame("g", g1_cells), num_reads=50_000,
        rt_cols=["rt_A", "rt_B"], clones=["A", "B"], lamb=0.75,
        betas=[0.5, 0.0], a=10.0, seed=seed, device=device)
    for df in (sim_s, sim_g):
        df["reads"] = df["true_reads_norm"]
        df["state"] = df["true_somatic_cn"].astype(int)
        df["copy"] = df["true_somatic_cn"].astype(float)
    return sim_s, sim_g


def _infer(df_s, df_g, telemetry, device, **extra):
    import numpy as np

    from scdna_replication_tools_tpu_torch.api import scRT

    scrt = scRT(df_s.copy(), df_g.copy(), input_col="reads",
                clone_col="clone_id", assign_col="copy", rt_prior_col=None,
                cn_prior_method="g1_clones", max_iter=100, min_iter=25,
                rel_tol=0.0, run_step3=False, telemetry_path=telemetry,
                device=device, **extra)
    cn_s_out, _, _, _ = scrt.infer(level="pert")
    tau = cn_s_out.groupby("cell_id").agg(
        tau=("model_tau", "first")).sort_index()["tau"].to_numpy()
    return np.asarray(tau), scrt


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", type=int, default=32)
    ap.add_argument("--g1-cells", type=int, default=16)
    ap.add_argument("--loci", type=int, default=620,
                    help="500 kb bins of the simulated chromosome")
    ap.add_argument("--kill-at", default="step2/chunk#3",
                    help="fault site of the injected preemption")
    ap.add_argument("--device", default=None,
                    help="where the fits run: the GPU by default, or "
                         "'cpu'")
    ap.add_argument("--workdir", default=None,
                    help="checkpoint and run-log directory (default: a "
                         "fresh temporary one)")
    ap.add_argument("--out", default=None, help="JSON verdict path")
    ap.add_argument("--report", default=None,
                    help="write the resumed run's rendered markdown "
                         "report here (the 'Resilience' section)")
    args = ap.parse_args(argv)

    import numpy as np

    from scdna_replication_tools_tpu_torch.obs.schema import validate_run
    from scdna_replication_tools_tpu_torch.utils import faults as faults_mod

    work = pathlib.Path(args.workdir) if args.workdir \
        else pathlib.Path(tempfile.mkdtemp(prefix="pert_chaos_"))
    work.mkdir(parents=True, exist_ok=True)
    ck = work / "ck"
    shutil.rmtree(ck, ignore_errors=True)
    df_s, df_g = make_workload(args.cells, args.g1_cells, args.loci,
                               device=args.device)

    print(f"chaos_smoke: golden run ({args.cells} S cells)...",
          file=sys.stderr)
    tau_golden, _ = _infer(df_s, df_g, str(work / "golden.jsonl"),
                           args.device)
    print(f"chaos_smoke: killed run (preempt@{args.kill_at})...",
          file=sys.stderr)
    preempted = False
    try:
        _infer(df_s, df_g, str(work / "killed.jsonl"), args.device,
               checkpoint_dir=str(ck), checkpoint_every=1,
               faults=f"preempt@{args.kill_at}")
    except faults_mod.SimulatedPreemption:
        preempted = True
    faults_mod.install(None)
    print("chaos_smoke: resumed run (resume='auto')...", file=sys.stderr)
    tau_resumed, _ = _infer(df_s, df_g, str(work / "resumed.jsonl"),
                            args.device, checkpoint_dir=str(ck),
                            checkpoint_every=1)

    def events(name):
        return [json.loads(line) for line in
                (work / name).read_text().splitlines()]

    resumed, killed = events("resumed.jsonl"), events("killed.jsonl")
    same = len(tau_golden) == len(tau_resumed)
    checks = {
        "preemption_fired": preempted,
        "killed_log_has_fault_event": any(
            ev["event"] == "fault_injected" for ev in killed),
        "killed_run_ended_error": (killed[-1]["event"] == "run_end"
                                   and killed[-1]["status"] == "error"),
        "resumed_log_schema_valid":
            validate_run(work / "resumed.jsonl") == [],
        "resumed_log_has_resume_trail": any(
            ev["event"] == "resume" for ev in resumed),
        "tau_bit_exact_vs_golden": bool(
            same and np.array_equal(tau_golden, tau_resumed)),
    }
    if args.report:
        from scdna_replication_tools_tpu_torch.tools.pert_report import (
            render_report,
        )

        report = render_report(work / "resumed.jsonl")
        pathlib.Path(args.report).write_text(report + "\n")
        checks["report_has_resilience_section"] = "## Resilience" in report
    verdict = {
        "metric": "chaos_smoke_kill_and_resume",
        "kill_at": args.kill_at,
        "cells": args.cells,
        "checks": checks,
        "tau_max_abs_delta": float(np.max(np.abs(
            tau_golden - tau_resumed))) if same else float("inf"),
        "ok": all(checks.values()),
        "workdir": str(work),
    }
    print(json.dumps(verdict))
    if args.out:
        pathlib.Path(args.out).write_text(json.dumps(verdict, indent=1)
                                          + "\n")
    if not verdict["ok"]:
        failing = [k for k, v in checks.items() if not v]
        print(f"chaos_smoke: FAILED checks: {failing}", file=sys.stderr)
        return 1
    print("chaos_smoke: OK: kill-and-resume parity holds", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
