#!/usr/bin/env python3
"""Build and drive the PyTorch/CUDA port of PERT on one GPU, and check it.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. the card (exits non-zero without a CUDA device), with its maximum SM
   clock, which sets the bounds' special-function-unit rate;
2. nvcc builds of every kernel source of the port, in parallel, and each
   kernel's instruction, MUFU, vote, branch and bulk-copy counts from
   ``cuobjdump -sass`` where the toolkit has it, with its registers,
   shared memory and spills from ptxas, and a check that the kernels
   that ``UNCHANGED_SASS`` lists compiled as before;
3. each kernel entry point against its plain PyTorch version on the
   card, at the full-width shape and at a ragged one, with a 1e6 prior
   and with a flat one (the enumeration's own share of out and dpi), the
   unfused pair also at P = 15 and 16, with its time (launches back to
   back between one pair of CUDA events; the single-call reading beside
   it), the plain version's time, its bound (the largest of the bytes,
   float32 operations and special-function-unit instructions that these
   operands need) and (Adam) a PyTorch library call; Adam's live gate
   bit for bit (live = 0 writes its operands through, live = 1 equals
   the plain version);
4. the port's main path with the controller and the QC off,
   ``scRT(..., controller=False, qc=False, mirror_rescue=False)``, on
   simulated long-form frames of 1000 S + 250 G1 cells x 5451 loci
   (500 kb bins): kernel launch counts against dispatched iterations
   (the fit reads the host once per chunk of 25 iterations, and a
   chunk's iterations after the stop are launched and masked), per-step
   times, peak memory and the simulate-and-recover bars of
   tests/test_end_to_end.py; then each kernel against its plain version
   on the operands of one more iteration of each step, from the step's
   fitted parameters, and each fused kernel's time and bound there,
   with the share of its warps that take the NB cores' shift branch;
5. where each step's time goes: device time by kernel from
   torch.profiler over a window of iterations, and the card's idle share;
6. the default config, ``scRT(cn_s, cn_g1)`` with no option given: the
   adaptive controller, the model-health QC, the controller-gated mirror
   rescue and the run log at ``telemetry_path='auto'``, at the default
   iteration budgets; per step the controller's decisions,
   the verdict and the counted and dispatched iterations, the rescue
   gate's decision and trigger, the rescue's candidates and accepted
   cells, the cell_qc flag counts, the launch checks (enum_fwd twice if
   and only if the gate let the rescue run) and the recovery bars with
   tau correlation no more than 0.01 below the categorical run's; the
   run log: every line valid under the port's schema, one ``fit_end``
   per step with the counted iterations, the decisions, the rescue and
   the QC flag counts of the run, a ``compile`` event per kernel library
   loaded, ``run_end`` with status ok, and the registry's peak device
   memory equal to ``torch.cuda.max_memory_allocated`` (the log is
   copied to ``chiprun_out/default_run.jsonl``, which the [readers]
   phase renders with the port's ``tools/pert_report``); the chunks of
   a short controlled step-2 fit under
   ``torch.cuda.set_sync_debug_mode("error")`` with a run-log session
   open and a checkpoint after every chunk (no operation inside a chunk
   waits on the card, nothing is emitted there, and the saves copy to
   the host between chunks), then the same fit graphed, every chunk
   after the capturing one under the guard; phase 5 for steps 2 and 3;
6b. ``[graphs]``, CUDA graphs of the fit iteration, on phase 6's frames:
   ``scRT(cn_s, cn_g1, executable_cache_dir=D)`` at every other default
   (D a temporary directory), held bit for bit to phase 6 (every step's
   losses and decisions, the rescue's statistics and accepted cells,
   both frames' model columns, the QC table; on a difference, the ops
   PyTorch reports as nondeterministic), each fit's captures (at most
   its forms), replays (its dispatched iterations) and warm-ups, its
   ms/iteration beside phase 6's, the peak, the run log's compile
   events of the graphs (the decode and PPC slab programs': a miss per
   program key, then hits, with the steps they belong to), each decode
   and PPC program's device bytes, the kernel libraries saved to D,
   nothing left in the store after the run, the launches (replays and
   warm-ups);
   phase 5 on graphed windows (the idle share); ``pert/fit_step``'s
   device time against its trace's for eager and graphed iterations;
   the same run with ``profile_dir=T`` (bit for bit phase 6 again, a
   trace per step fit and the packaging's, run_end's snapshot holding
   ``pert_xla_scope_seconds`` > 0 for the four named ranges, fit_step's
   no larger than the step traces' kernel time; the summary goes to
   ``chiprun_out/graphs_trace_summary.txt``); and, in processes spawned
   beside the later phases (``[graphs child]``, joined at the end), the
   same default run on D with ``compile_cache_dir=None`` (every kernel
   library a disk_hit from D, the decode and PPC programs captured again,
   a miss per key then hits, the device memory back within 64 MiB after
   the run) and, after one library record is truncated, a fresh
   process loading every library through D (the record quarantined to
   ``*.bad``, its library rebuilt, the other a disk_hit);
7. durable runs: the default config three more times with
   ``checkpoint_dir`` in a temporary directory outside the checkout —
   uninterrupted, killed by ``faults='preempt@step2/chunk#3'`` and
   resumed with ``resume='auto'`` — with the launch checks on the
   uninterrupted run (the durable path), the kill raising
   ``SimulatedPreemption`` with its log ending ``run_end`` 'error', the
   resume restoring step 1 and resuming step 2 from the killed run's
   save, both complete runs' output columns, losses and parameters bit
   for bit phase 6's and their decisions phase 6's (a suffix after the
   restore), every step complete in the manifest and the heartbeat
   ending 'done' with its sequence number rising; each step's
   checkpoint bytes and save and load seconds, and each run's wall and
   peak memory beside phase 6's (the logs, the manifest and the
   heartbeat go to ``chiprun_out/durable_*``; on a difference, the ops
   PyTorch reports as nondeterministic); then the run-health checks of
   the [analysis] phase (``[analysis health]``): the resume traces its
   spans, and ``aggregate_health`` of its ``health/`` reads every host
   ``done`` with no missing rank, no rule of ``alert_rules.json``
   fails, and the heartbeat's ``last_span`` is a span the resume
   closed;
8. phases 4 and 5 again for the binary path, ``scRT(...,
   enum_impl='binary', optimizer_state_dtype='bfloat16')`` on the same
   frames (the binary kernels in steps 2 and 3, the bfloat16-moment Adam
   in all three steps), with two more bars against the categorical run:
   tau correlation >= 0.99 x and CN accuracy >= its value - 0.02;
9. phase 4 again for the mirror-rescue path, ``scRT(...,
   mirror_rescue=True)`` without the controller on the same frames: the
   categorical fit, then the rescue's sub-fit of the boundary-tau cells
   (the dense kernels and Adam) and its per-cell scoring, which runs the
   unfused enumeration kernel twice; it fails without candidates or
   without an enum_fwd launch, and holds tau correlation to no more than
   0.01 below the categorical run's.  Then, on the rescue's own
   operands, the dense fused pair and Adam against their plain versions
   over one more sub-fit iteration, per_cell_objective on the card
   against the same function through the plain enumeration, and both
   unfused kernels against their plain versions and timed there, each
   with its bound;
10. the unlabelled path, a lab's sample without clone labels: the
    port's ``pert_simulator`` on the card at the full shape (and
    ``simulate_s_reads`` against its CPU run on the card's draws: phi,
    theta and delta within 1e-5, the NB counts' mean and variance), then
    ``scRT(cn_s, cn_g1, clone_col=None, cell_chunk=256,
    cn_hmm_self_prob=0.99).infer('pert')`` on the frames without
    clone_id, every other option at its default, with phase 4's checks
    (the fused pair once per chunk of each iteration: 1000 S cells pad
    to 1024, four chunks; step 3 one) and: k-means on the card picks
    k = 3 and recovers the simulated clones (adjusted Rand index 1.0),
    the chunked loss and gradients equal the unchunked ones from step
    2's fitted state (1e-5 relative), the Viterbi paths on the card
    equal the CPU's on the same emissions (the first 128 cells), every
    kernel against its plain version at the chunk shapes this path gave
    it (as phase 4); then the
    LOWESS curve on the card (and against its float64 CPU run on the
    first 1000 loci's points), ``infer(level='clone'|'bulk'|'cell')``
    (the cell level on a listed cut of 250 S cells) with rt_state held
    against the simulated replication state (``LEVEL_BARS``), ``SPF``
    with clone discovery, and ``simulator_main``, ``infer_scrt_main``
    (pert at its default --max-iter, then --level clone) and
    ``infer_spf_main`` end to end through TSVs on a listed cut of 200 S +
    100 G1 cells; seconds per part, peak memory and the card beside them
    (``[unlabelled ...]`` lines).  The levels, SPF and the CLI (host
    pandas, TSVs and changepoint sweeps) run in a spawned process beside
    phase 11 and print when it is joined (``[unlabelled tail]``); a
    process spawned after the [graphs] phase runs the [analysis] phase
    on the default cell's output (phase 6) beside phases 7-10 (joined
    before phase 11): ``predict_cycle_phase`` (S, G1/2 and LQ counts and
    seconds; simulated G1 cells called G1/2 or LQ > 0.7; simulated S
    cells called S no fewer than on the simulated states less 0.02, and
    90 % of the labels as the simulated states give them, with the S
    share printed against JAX's 0.7, see ``PHASE_BAR``),
    ``compute_ccc_features`` with its 2-GMM on
    the card and on the CPU (madn, breakpoints and both corrected
    columns equal, lrs within ``TOL_LRS``, both seconds), the loader's
    four ``pivot_matrix`` calls on the default cell's frames through the
    native library and with ``use_native=False`` (bit for bit equal,
    NaN positions included; both seconds beside the default cell's load
    phase), and a ``matplotlib: <version>|absent`` line (nothing is
    plotted on the card);
11. serving: four requests of the same shape (seeds 0-3, every option at
    its JAX default) submitted with ``submit_frames`` by four processes
    while the earlier phases run, to a spool in ``/dev/shm`` (outside the
    checkout; finished requests' checkpoints are removed as they finish,
    since a request writes ~12 GB of them) and drained by
    ``ServeWorker(max_batch=4,
    exit_when_idle=True)`` on the card (its compiled-program store under
    the spool, JAX's ``'auto'``: the status document's block, every
    request's solo chunks, packaging decode and PPC replayed from
    graphs, every packed dispatch
    from the rung's ``slab{W}`` program, none eager and none degraded,
    replays equal to the slab iterations launched, the slab programs'
    captures by rung and form, one packed dispatch of two lanes run again
    without the store and held to its replay bit for bit, the program
    records' device bytes by tag against the worker's cap), and the first
    step-3 chunks of two requests dispatched again after the drain as one
    W = 2 slab, replayed from a ``slab2`` program and by the eager slab,
    bit for bit (``[serve step3 slab]``: with graphed solo chunks a
    flagship step 3 lasts under a second, so the four requests seldom
    pack it); the first request's data through a serial worker
    (``max_batch=1``, the first worker life, on a spool and store of its
    own) in a spawned process beside phases 7-10, started after
    ``[graphs]`` (:class:`EarlyServing`), and, the moment it exits, a
    second worker
    life (a serial worker in
    another spawned process on that spool and store: its warm-up ranks
    the records by the first worker's ``buckets_served`` and captures the
    solo programs again, the decode and PPC programs among them, each
    per-form key hash one of the first life's ``compile`` events'; then
    the first request's data again: only ``hit`` events, the decode and
    PPC programs' too, its output the serial run's bit for bit; ``[serve
    second life]``; the batched drain starts once it has ended and its
    checks run after the drain); beside them too, in a
    spawned process, two copies of a 128 S + 64 G1 cell request through
    ``ServeWorker(max_batch=2)`` with the clones' G1 prior and a long step
    2 (``[serve pair]``: they share step 2, on the sparse kernels, so the
    sparse block-axis kernels launch on the serving path, which the four
    flagship requests' timing does not promise; both ok, decoding >= 99 %
    of bins alike; its launches count with the batched drain's): every
    ticket done, packed
    dispatches > 0
    with at least two lanes each, every request log schema-valid with
    its ``request_id`` and ``slab_width=4``, ``request_start`` and
    ``request_end`` in the worker log, packed and serial outputs
    decoding >= 99 % of bins alike with tau correlation within 0.01, and
    the first request's tau correlation within 0.01 of the default
    cell's; per request its wall and queue wait, the slab's dispatches,
    lanes and width rungs, step 2's ms per slab iteration and
    cell-iterations per second beside the serial run's (and beside the
    eager slab's 50.612 ms and its kernels' 21.86 ms on an NVIDIA H100
    80GB HBM3, 700.00 W, PERF.md), the idle
    share of a profiled slab dispatch of steps 2 and 3, and each drain's
    peak memory,
    with the batched drain's device-memory timeline by request and phase
    (``chiprun_out/serve_memory.jsonl``, its peak printed with every
    request's phase then).  Then the block-axis kernels at the slab's shape (W = 4 and 2 lanes
    of 1024 x 8192): every lane bit for bit a solo launch on its
    operands, the plain versions within ``TOL`` (and under a flat
    prior), Adam's lane axis with a parked lane bit for bit, each timed
    with its bound (Adam's beside one ``torch._fused_adam_`` over the W
    lane tensors, a step tensor per lane and one learning rate);
11b. ``[readers]``, the port's run-log readers on this run's own logs,
    in four threads started when the drain ends and joined after the
    lanes (:class:`ReadersPhase`): every command is ``python -m
    scdna_replication_tools_tpu_torch.tools.<tool> ...`` in a subprocess
    behind an import hook that refuses ``jax`` and the JAX package
    (``BLOCK_JAX``), and each must exit 0: ``pert_report`` renders phase
    6's log to ``chiprun_out/default_run_report.md`` with no placeholder
    section and a filled "Compiled programs" section, and ``--compare``
    holds it against [graphs]'s graphed log with a metrics-compare
    section; ``pert_trace export --perfetto --profile-dir T`` on the
    profiled graphed run gives a trace that ``validate`` passes, its
    ``pert_xla_scope_seconds`` counter track the four named ranges above
    0 and equal to that run's run_end gauges; ``pert_trace waterfall
    --spool`` covers every request of the batched drain with every
    component of its vocabulary; ``pert_meter report`` and
    ``attribution --check`` on the drain's spool conserve (every
    ledger's gap within 1 %); ``pert_fleet index`` over ``chiprun_out/``
    lists phase 6's and [graphs]'s runs, ``regress --write-baseline``
    records phase 6's log and ``regress --baseline`` judges the graphed
    log against it, every metric's verdict printed and the exit code the
    one its verdicts imply (eager and graphed are different runs, so no
    pass is required); each tool's ``--help``; the phase's seconds;
12. sharded fits, in a thread beside phase 11 (``ShardedPhase``): ranks
    spawned with ``torch.multiprocessing`` (start method ``spawn``), each
    joining a gloo group through a ``file://`` store in a temporary
    directory (``init_distributed('gloo', ...)``, a 300 s collective
    timeout) and all sharing cuda:0, on the phase-4 frames: first
    ``scRT(cn_s, cn_g1, num_shards=2)`` with every other option at its
    default (heartbeats and the run log in the temporary directory),
    then ``[elastic 2x1]``, the same run durable (``checkpoint_dir`` in
    the temporary directory, ``checkpoint_every=ELASTIC_EVERY``) with
    rank 1 killed in step 2 (``ELASTIC_KILL``), then ``num_shards=2,
    loci_shards=2`` on the categorical path at its depth cut
    (``MAX_ITER``).  [elastic 2x1]'s checks: rank 1 exits non-zero and
    rank 0 exits 0 within 420 s, rank 0's run log (valid under the
    port's schema) holds one ``degrade mesh_shrink`` (hostloss, cells 2
    -> 1) and step 2's resharded resume, rank 0 ends on one rank with
    the recovery bars, rep and CN within 0.005 of phase 6's and tau r no
    more than 0.01 below, ``aggregate_health`` shows rank 1 lost
    (presumed lost, its heartbeat every ``ELASTIC_HEARTBEAT_S``) and
    rank 0 done, the ``mesh-shrunk`` rule fires, and the dense and
    sparse fused pairs and Adam launch on one rank after the shrink
    (the run's launches, both ranks', count in the kernels line);
    printed: the seconds from the kill to the re-formed group and to
    step 2's fit on one rank, rank 0's ``infer`` wall against [sharded
    2x1]'s, the checkpoint bytes saved and left, the peak.  Last, once
    phase 11's drain is over (``AFTER_DRAIN``: beside it, four ranks
    reloading full generations passed the machine's 96 GiB),
    ``[elastic 2x2]``: the default run on a 2 x 2 grid, durable, with
    rank 3's process ended outright in step 2 (``ELASTIC_EXIT``: ``os._exit``, nothing
    marks it lost, so the survivors' rendezvous waits out its settle
    window); checks: the survivors exit 0 and rank 3 non-zero, the three
    return the same frames, ranks 0 and 1 end on 1 x 2 and rank 2 stands
    by, one ``degrade mesh_shrink`` (2 x 2 -> 1 x 2) and step 2's
    resharded resume in a valid log, the recovery bars, rep and CN within
    0.005 of phase 6's and tau r no more than 0.01 below, the fused pairs
    and Adam on both ranks of 1 x 2 after the shrink; printed: each
    survivor's seconds from the kill to the rung, the re-formed group and
    the fit on 1 x 2, the ``infer`` wall against [sharded 2x1]'s, the
    checkpoint bytes, the peak.  The other runs' checks: every rank exits 0 within 420 s
    and returns the same four frames; every rank launched the dense and
    sparse fused pairs and Adam (its counts summed into the path's); the
    recovery bars; the 2 x 1 run within 0.005 of phase 6's rep and CN
    accuracy and tau r no more than 0.01 below, its run log once (rank
    0's) and ``aggregate_health`` reading two hosts and no missing rank;
    the 2 x 2 run's step 1 and 2 iteration-0 losses within 1e-5 of phase
    4's (step 3's within ``SHARDED_LOSS0_STEP3``) and every step's losses within 5e-2 (without the Dirichlet
    normaliser; step 1's from iteration 25 on, ``SHARDED_SETTLED``), each
    step's converged loss within ``SHARDED_END`` and step 2's fitted rho
    and a within ``SHARDED_RHO`` / ``SHARDED_A`` of phase 4's; each
    kernel against its plain version on the operands of
    one more iteration of each step at rank 0's shapes (as phase 4).
    Printed per rank: its start-and-import seconds, ``infer`` wall, step
    ms/iteration, peak memory, the gradient all-reduce's ms alone, its
    launches (``[sharded ...]`` lines);
13. the lowest available host memory seen while the script ran
    (``[host memory]``), the card's name and power limit, one JSON line
    of the kernels (each
    with its launches summed over the paths' runs and by path),
    then the result line.

It imports nothing of JAX or the JAX package.  The full record goes to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import json
import logging
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PKG = "scdna_replication_tools_tpu_torch"

# full width of the flagship workload: 1000 S cells x 5451 loci, P = 13
CELLS, LOCI, P = 1000, 5451, 13
RAGGED = (37, 1001)
G1_CELLS, CLONES = 250, 3
MAX_ITER = 300            # depth cut: 300 step-2 iterations (150 steps 1/3)
SEED = 0

KB = 4                    # binary planes, ceil(log2 P)

# H100 SXM published peaks (NVIDIA data sheet): HBM rate, float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# kernel-vs-plain tolerances on max|kernel - plain| / max(1, max|plain|,
# scale), where scale is, for out and dpi, the largest term that they
# sum (fused_errors): near a fitted optimum both cancel terms of the
# prior's size (1e6).  The kernels repeat the plain versions' float32
# operations in the same order; they differ by FMA contraction and the
# exp/log ulps of the two builds.  The NB values nb(chi) run to ~1e4,
# where an ulp is up to 1e-3, and the posterior weights
# exp(lp + bern + nb - lse) carry that absolute rounding as a relative
# one: dmu and dphi, which sum those weights times slopes of opposite
# sign, 1e-3 (tests/test_torch_gpu.py holds the same bounds).
TOL = {"out": 1e-5, "lse": 1e-5, "dpi": 1e-5, "dmu": 1e-3, "dphi": 1e-3,
       "param": 1e-6, "m": 1e-6, "v": 1e-6}
# With the prior's data term removed (flat_prior), max|dpi| is O(|g|):
# the bounds are then absolute ones on the enumeration's own share, a
# sum of posterior weights each carrying that relative rounding (dpi
# 3e-3), which a misrouted or dropped weight moves by O(0.1-1);
# "hoisted" is out - lse = x log(lamb) - lgamma(x + 1), held per element
# as |a - b| / (1 + |b|).
TOL_FLAT = {"out": 1e-5, "lse": 1e-5, "hoisted": 1e-5, "dmu": 1e-3,
            "dphi": 1e-3, "dpi": 3e-3}

# The unfused pair has no prior.  Its ll = lse + x log(lamb) - lgamma(x
# + 1) is a few units where the three terms run to thousands (a float32
# ulp ~1e-4 there), so ll is held per element to 1e-5 of 1 + |lse| +
# |x log(lamb) - lgamma(x + 1)| (ll_scale), the fused kernels' out
# bound: inside lse the NB core's lgamma(x + delta) and lgamma(delta)
# are larger still, and their ulps land on ll (readings up to 1.2e-6,
# ~8 ulps of the scale).  dmu and dphi as above, dlog_pi, a sum of
# posterior weights, like the flat prior's dpi.  per_cell_objective with
# the kernel against the same with the plain enumeration differs only
# by the enumerated term: held per cell to 1e-6 of the sum over loci of
# that scale (rounding errors of opposite signs cancel in the sum).
TOL_ENUM = {"ll": 1e-5, "dmu": 1e-3, "dphi": 1e-3, "dlog_pi": 3e-3,
            "per_cell": 1e-6}

# bfloat16 moments (m', v'): at most one bfloat16 ulp per element apart.
# The kernel repeats the plain version's roundings (no FMA contraction,
# csrc/adam.cu), so readings are 0; one ulp is what a float32 rounding
# that tips a round-to-nearest-even at a boundary would leave.  param'
# stays at TOL["param"].
BF16_ULPS = 1

_EK = "scdna_replication_tools_tpu/ops/enum_kernel.py"
TPU_KERNEL = {
    "enum_fwd": f"{_EK}:444",
    "enum_bwd": f"{_EK}:466",
    "fused_fwd_dense": f"{_EK}:741",
    "fused_bwd_dense": f"{_EK}:766",
    "fused_fwd_sparse": f"{_EK}:856",
    "fused_bwd_sparse": f"{_EK}:881",
    "fused_fwd_dense_binary": f"{_EK}:976",
    "fused_bwd_dense_binary": f"{_EK}:1002",
    "fused_fwd_sparse_binary": f"{_EK}:1073",
    "fused_bwd_sparse_binary": f"{_EK}:1100",
    "adam": "scdna_replication_tools_tpu/ops/adam_kernel.py:168",
    "adam_bf16": "scdna_replication_tools_tpu/ops/adam_kernel.py:168",
    # the block axis: the same pallas_calls under jax.vmap's batching
    # rule (infer/svi.py _run_fit_chunk_slab); the JAX slab takes XLA's
    # Adam, the port the lane axis of row 11's kernel
    "fused_fwd_dense_lanes": f"{_EK}:741",
    "fused_bwd_dense_lanes": f"{_EK}:766",
    "fused_fwd_sparse_lanes": f"{_EK}:856",
    "fused_bwd_sparse_lanes": f"{_EK}:881",
    "adam_lanes": "scdna_replication_tools_tpu/ops/adam_kernel.py:168",
}
SOURCE = {name: f"{PKG}/csrc/enum_fused.cu" for name in TPU_KERNEL}
SOURCE["adam"] = SOURCE["adam_bf16"] = SOURCE["adam_lanes"] = \
    f"{PKG}/csrc/adam.cu"

FAILURES: list = []


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}")
    if not ok:
        FAILURES.append(what)


# ---------------------------------------------------------------------------
# operation counts (for the bound), from the kernels' own loop structure
# ---------------------------------------------------------------------------

# The Stirling series of csrc/enum_fused.cu, split at its shift: each call
# costs its series at one argument; the 8-step recurrence is what an
# argument below 8 needs on top (shift_census).  With every argument
# shifted the sums are the full 34 and 56.
LGAMMA_OPS = 16        # lgamma_ge1: compare, zz, 1/zz, series, log, terms
LGAMMA_SHIFT_OPS = 18  # min, 7 adds, 7 products, their log, subtract, select
LGDG_OPS = 24          # lgamma_digamma_ge1: both series on one 1/zz, log
LGDG_SHIFT_OPS = 32    # + 8 reciprocals and their 7 adds, two subtractions


def binary_adds(P: int) -> tuple:
    """(expansion, fold) adds per bin of the binary encoding: each state
    logit sums its set bits' planes (one add fewer than its bits), and
    the backward adds each state's dpi to each of its bits' dz."""
    from scdna_replication_tools_tpu_torch.ops.enum_kernel import state_codes
    codes = state_codes(P)
    bits = sum(len(c) for c in codes)
    return bits - sum(1 for c in codes if c), bits


def fwd_ops_per_bin(P: int, sparse: bool, binary: bool = False) -> int:
    from scdna_replication_tools_tpu_torch.ops.enum_kernel import chi_slots
    nonzero = len(chi_slots(P)) - 1
    softmax = (P - 1) + 3 * P + 2 + P
    data = (4 if sparse else 3) * P
    slots = nonzero * (3 + 2 * LGAMMA_OPS + 4) + 1
    pairs = 2 * P * 8
    expand = binary_adds(P)[0] if binary else 0
    return 2 + softmax + data + (1 + LGAMMA_OPS) + slots + pairs + 6 + expand


def bwd_ops_per_bin(P: int, sparse: bool, binary: bool = False) -> int:
    from scdna_replication_tools_tpu_torch.ops.enum_kernel import chi_slots
    nonzero = len(chi_slots(P)) - 1
    softmax = (P - 1) + 3 * P + 2 + P
    init = (1 + 3 * P) if sparse else 3 * P
    slots = nonzero * (4 + 2 * LGDG_OPS + 10) + (2 + LGAMMA_OPS)
    pairs = 2 * P * 11
    extra = sum(binary_adds(P)) if binary else 0
    return 5 + softmax + init + slots + pairs + 3 * P + extra


def enum_fwd_ops_per_bin(P: int) -> int:
    """The unfused forward: the fused one's enumeration and read term,
    without the softmax and the Dirichlet data term."""
    from scdna_replication_tools_tpu_torch.ops.enum_kernel import chi_slots
    nonzero = len(chi_slots(P)) - 1
    slots = nonzero * (3 + 2 * LGAMMA_OPS + 4) + 1
    pairs = 2 * P * 8
    return 2 + (1 + LGAMMA_OPS) + slots + pairs + 5


def enum_bwd_ops_per_bin(P: int) -> int:
    """The unfused backward: lgamma(x + 1) and ll less the read term,
    then the fused backward's chi sweep, without its softmax, Dirichlet
    start and softmax Jacobian."""
    from scdna_replication_tools_tpu_torch.ops.enum_kernel import chi_slots
    nonzero = len(chi_slots(P)) - 1
    slots = nonzero * (4 + 2 * LGDG_OPS + 10) + 1
    pairs = 2 * P * 11
    return 5 + (1 + LGAMMA_OPS) + 3 + slots + pairs


def mufu_calls_per_bin(name: str, P: int) -> dict:
    """Calls per bin of the functions that run on the special-function
    unit (SFU), by kind, with every argument at 8 or above: ``exp``
    (expf), ``log`` (logf, log1pf) and ``rcp`` (a float32 division).
    The fused kernels' softmax takes P exps and one log (and the
    backward's Jacobian P exps more); the two Bernoulli logs; lgamma(x +
    1), one reciprocal and one log; two lgamma (backward: lgamma and
    digamma on one reciprocal and one log) per nonzero chi slot; one exp
    per (state, rep) pair; the forward's final log; the backward's two
    Bernoulli slopes, one division each.  The unfused pair has no
    softmax."""
    from scdna_replication_tools_tpu_torch.ops.enum_kernel import chi_slots
    nonzero = len(chi_slots(P)) - 1
    backward = "_bwd" in name
    softmax = 0 if name.startswith("enum_") else P
    return {"exp": softmax * (2 if backward else 1) + 2 * P,
            "log": (softmax > 0) + 2 + 1 + 2 * nonzero + (not backward),
            "rcp": 1 + 2 * nonzero + 2 * backward}


# SFU instructions per call of each kind, as the kernels' SASS listings
# show them (nvcc 12.9, sm_90a): expf one MUFU.EX2, a float32 division
# one MUFU.RCP (with FMA refinement), and logf / log1pf none -- they are
# a polynomial of some 25 instructions on the FMA pipes.  The rest of
# each function is float32 work, counted in the operations above.
MUFU_PER_CALL = {"exp": 1, "log": 0, "rcp": 1}
# Hopper's SFU: 16 results per SM per clock (CUDA C++ Programming Guide,
# arithmetic instruction throughput, compute capability 9.0)
MUFU_PER_SM_PER_CLOCK = 16


def mufu_ops(name: str, P: int, census: dict) -> int:
    """SFU instructions of one launch of kernel ``name`` on the operands
    that ``census`` describes: the per-bin calls without the shift, plus
    the shift of every argument below 8 (one log of the product; the
    digamma's 8 reciprocals besides in the backward's chi slots), each
    call at its ``MUFU_PER_CALL``."""
    per_bin = sum(MUFU_PER_CALL[k] * v
                  for k, v in mufu_calls_per_bin(name, P).items())
    chi_shift = MUFU_PER_CALL["log"] + ("_bwd" in name) * 8 \
        * MUFU_PER_CALL["rcp"]
    return (per_bin * census["bins"] + MUFU_PER_CALL["log"] * census["x1"]
            + chi_shift * (census["xd"] + census["d"]))


WARP = 32


def shift_census(reads, mu, q, P: int) -> dict:
    """Where the NB cores' shift is needed on these operands.  Per bin the
    kernels call lgamma(x + 1) once and, for each nonzero chi slot,
    lgamma(x + delta) and lgamma(delta) (delta = max(mu chi q, 1), float32
    as the kernels round it).  Returns the arguments below 8 of each call
    (``x1``, ``xd``, ``d``), the share of (bin, chi) pairs with x + delta
    < 8 or delta < 8, and the share of warps (32 consecutive bins of the
    flattened grid) with a bin that has any argument below 8: such a warp
    takes the kernels' select-form sweep, every other warp the series
    alone."""
    import torch
    from scdna_replication_tools_tpu_torch.ops.enum_kernel import chi_slots
    x, m = reads.reshape(-1), mu.reshape(-1)
    n = x.numel()
    warps = -(-n // WARP)
    small = (x + 1.0) < 8.0
    x1 = int(small.sum())
    xd = d = pairs = 0
    nonzero = [chi for chi, _ in chi_slots(P) if chi != 0.0]
    for chi in nonzero:
        delta = torch.clamp(m * (chi * q), min=1.0)
        s_xd, s_d = (x + delta) < 8.0, delta < 8.0
        xd, d = xd + int(s_xd.sum()), d + int(s_d.sum())
        pairs += int((s_xd | s_d).sum())
        small = small | s_xd | s_d
    lanes = torch.zeros(warps * WARP, dtype=torch.bool, device=x.device)
    lanes[:n] = small
    taken = int(lanes.view(warps, WARP).any(dim=1).sum())
    return {"bins": n, "warps": warps, "taken": taken, "x1": x1, "xd": xd,
            "d": d, "pair_share": pairs / (n * max(len(nonzero), 1)),
            "warp_share": taken / warps}


def enum_ops(name: str, P: int, census: dict) -> int:
    """float32 operations of one launch of kernel ``name`` on the operands
    that ``census`` describes: the per-bin count without the shift, plus
    the shift of every argument below 8."""
    binary, sparse = name.endswith("_binary"), "_sparse" in name
    backward = "_bwd" in name
    if name == "enum_fwd":
        per_bin = enum_fwd_ops_per_bin(P)
    elif name == "enum_bwd":
        per_bin = enum_bwd_ops_per_bin(P)
    elif backward:
        per_bin = bwd_ops_per_bin(P, sparse, binary)
    else:
        per_bin = fwd_ops_per_bin(P, sparse, binary)
    chi_shift = LGDG_SHIFT_OPS if backward else LGAMMA_SHIFT_OPS
    return (per_bin * census["bins"] + LGAMMA_SHIFT_OPS * census["x1"]
            + chi_shift * (census["xd"] + census["d"]))


ADAM_OPS = 14        # bfloat16 moments add 4 conversions, not counted


# SFU results per second of the card in use: its SM count times
# MUFU_PER_SM_PER_CLOCK times its maximum SM clock (main() sets it)
MUFU_PER_S = None


def bound_terms(nbytes: int, ops: int, mufu: int = 0,
                mufu_per_s=None) -> dict:
    """ms of the bytes over the HBM rate, the float32 operations over the
    float32 rate and the SFU instructions over the SFU rate."""
    rate = mufu_per_s or MUFU_PER_S
    return {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
            "float32": ops / F32_OPS_PER_S * 1e3,
            "mufu": mufu / rate * 1e3 if mufu else 0.0}


def bound(nbytes: int, ops: int, mufu: int = 0, mufu_per_s=None) -> tuple:
    """(ms, "bytes" | "operations", term): the largest of
    :func:`bound_terms` (``term`` says which of "bytes", "float32" and
    "mufu")."""
    terms = bound_terms(nbytes, ops, mufu, mufu_per_s)
    term = max(terms, key=terms.get)
    return terms[term], "bytes" if term == "bytes" else "operations", term


def nbytes(*tensors) -> int:
    return int(sum(t.numel() * t.element_size() for t in tensors
                   if t is not None))


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device time per call: after warm-up, ``reps`` calls back to back
    between one pair of CUDA events, over ``reps``.  While the card runs
    call k the host enqueues call k + 1, so the wrapper's host work (shape
    checks, allocation, the ctypes call) stays out of the window wherever
    it is shorter than the kernel."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def time_single_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median over ``reps`` calls, each alone between its own pair of
    events: the card is idle when the first is stamped, so each window
    also holds the wrapper's host work.  Kept beside :func:`time_ms` for
    comparison with readings taken this way."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def amax(t) -> float:
    return float(t.abs().max())


def rel_err(got, ref, scale: float = 0.0) -> tuple:
    """(max abs error, that over max(1, max|ref|, scale)); ``scale`` is
    the size of the largest term that ``ref`` is a sum of, where those
    terms cancel."""
    d = amax(got - ref)
    return d, d / max(1.0, amax(ref), scale)


def elementwise_err(got, ref) -> tuple:
    """(max abs error, max over elements of |got - ref| / (1 + |ref|))."""
    d = (got - ref).abs()
    return float(d.max()), float((d / (1.0 + ref.abs())).max())


# ---------------------------------------------------------------------------
# phase 2: what the compiler made of each kernel
# ---------------------------------------------------------------------------

# kernel entry -> its function in the library (demangled as _sass_name does)
SASS_FUNCTION = {
    "enum_fwd": "enum_fwd_kernel", "enum_bwd": "enum_bwd_kernel",
    "fused_fwd_dense": "fused_fwd_kernel<false, false>",
    "fused_bwd_dense": "fused_bwd_kernel<false, false>",
    "fused_fwd_sparse": "fused_fwd_kernel<true, false>",
    "fused_bwd_sparse": "fused_bwd_kernel<true, false>",
    "fused_fwd_dense_binary": "fused_fwd_kernel<false, true>",
    "fused_bwd_dense_binary": "fused_bwd_kernel<false, true>",
    "fused_fwd_sparse_binary": "fused_fwd_kernel<true, true>",
    "fused_bwd_sparse_binary": "fused_bwd_kernel<true, true>",
    "adam": "adam_kernel<float>", "adam_bf16": "adam_kernel<__nv_bfloat16>",
    # a launch with a lane axis runs the same kernel with gridDim.y lanes
    "fused_fwd_dense_lanes": "fused_fwd_kernel<false, false>",
    "fused_bwd_dense_lanes": "fused_bwd_kernel<false, false>",
    "fused_fwd_sparse_lanes": "fused_fwd_kernel<true, false>",
    "fused_bwd_sparse_lanes": "fused_bwd_kernel<true, false>",
    "adam_lanes": "adam_kernel<float>",
}
_TEMPLATE_ARGS = {"Lb0E": "false", "Lb1E": "true", "f": "float",
                  "13__nv_bfloat16": "__nv_bfloat16"}


def _sass_name(mangled: str) -> str:
    """The kernel's name with its template arguments, from the mangled
    symbol of one of this port's kernels (else the symbol itself)."""
    import re
    m = re.search(r"\d+((?:fused|enum)_(?:fwd|bwd)_kernel|adam_kernel)"
                  r"(?:I((?:Lb[01]E|f|13__nv_bfloat16)+)E)?", mangled)
    if not m:
        return mangled
    if not m.group(2):
        return m.group(1)
    args = re.findall(r"Lb[01]E|f|13__nv_bfloat16", m.group(2))
    return f"{m.group(1)}<{', '.join(_TEMPLATE_ARGS[a] for a in args)}>"


ASYNC_OPS = ("UBLKCP", "UTMA", "SYNCS")


def parse_sass(text: str) -> dict:
    """Per function of ``cuobjdump -sass`` output: instructions (NOPs left
    out), MUFU instructions (the special-function unit: exp2, log2,
    reciprocal) by kind, warp votes, branches, the votes that a
    predicated branch follows within 48 instructions (a vote whose result
    the compiler folded into selects has none), the bulk-copy and barrier
    instructions by kind (``UBLKCP``: cp.async.bulk; ``UTMA``: the
    tensor-map forms and the bulk groups' commit; ``SYNCS``: mbarrier
    operations) and the bulk copies among them (``UBLKCP``, ``UTMALDG``,
    ``UTMASTG``)."""
    import re
    funcs: dict = {}
    ops: list = []
    for line in text.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            ops = []
            funcs[_sass_name(head.group(1))] = ops
            continue
        ins = re.search(r"/\*[0-9a-f]{4,}\*/\s+(@!?U?P[T0-9]+\s+)?"
                        r"([A-Z][A-Z0-9]*(?:\.[A-Z0-9_]+)*)", line)
        if ins and not ins.group(2).startswith("NOP"):
            ops.append((bool(ins.group(1)), ins.group(2)))
    out = {}
    for name, ops in funcs.items():
        votes = [k for k, (_, op) in enumerate(ops) if op.startswith("VOTE")]
        mufu: dict = {}
        asyncs: dict = {}
        for _, op in ops:
            if op.startswith("MUFU"):
                mufu[op] = mufu.get(op, 0) + 1
            if op.startswith(ASYNC_OPS):
                asyncs[op] = asyncs.get(op, 0) + 1
        out[name] = {
            "instructions": len(ops), "mufu": sum(mufu.values()),
            "mufu_by_kind": mufu, "votes": len(votes),
            "branches": sum(op.startswith("BRA") for _, op in ops),
            "votes_guarding_a_branch": sum(
                any(pred and op.startswith("BRA")
                    for pred, op in ops[k + 1:k + 49]) for k in votes),
            "bulk_copies": sum(v for k, v in asyncs.items() if k.startswith(
                ("UBLKCP", "UTMALDG", "UTMASTG"))),
            "async_by_kind": asyncs}
    return out


def parse_ptxas(log: str) -> dict:
    """Per kernel of ``nvcc -Xptxas -v`` output: registers, shared memory
    per block (static, bytes) and spill stores and loads (bytes)."""
    import re
    out: dict = {}
    entry = props = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = _sass_name(m.group(1))
            out[entry] = {"registers": None, "smem": 0, "spill_stores": 0,
                          "spill_loads": 0}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = _sass_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props in out:
            out[props].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry].update(registers=int(m.group(1)),
                              smem=int(smem.group(1)) if smem else 0)
    return out


# Rows 1 and 3-10 as their present design compiles (instructions, MUFU
# instructions), read from this script's [sass] phase on the H100 (nvcc
# 12.9, sm_90a; rows 3-10 with their lane axis): a change that leaves
# these kernels alone must not move their listings (a redesign of one of
# them, or another nvcc, updates this table)
UNCHANGED_SASS = {
    "enum_fwd_kernel": (8799, 162),
    "fused_fwd_kernel<false, false>": (9265, 178),
    "fused_bwd_kernel<false, false>": (15995, 566),
    "fused_fwd_kernel<true, false>": (9113, 178),
    "fused_bwd_kernel<true, false>": (15818, 566),
    "fused_fwd_kernel<false, true>": (9257, 178),
    "fused_bwd_kernel<false, true>": (15845, 565),
    "fused_fwd_kernel<true, true>": (9019, 178),
    "fused_bwd_kernel<true, true>": (15637, 565),
}


def sass_report(info: dict, out_dir: Path) -> dict:
    """Instruction, MUFU, vote, branch and bulk-copy counts of every
    kernel of the built libraries (:func:`parse_sass`) with its
    registers, shared memory and spills (:func:`parse_ptxas`), printed;
    the full listings go to ``out_dir``.  Checks that rows 1 and 3-10
    compiled to :data:`UNCHANGED_SASS`.  Prints that cuobjdump is missing
    where it is (and returns no counts)."""
    import shutil

    from scdna_replication_tools_tpu_torch.ops import _cuda
    tool = shutil.which("cuobjdump")
    if tool is None:
        cand = Path(_cuda._nvcc()).parent / "cuobjdump"
        tool = str(cand) if cand.exists() else None
    if tool is None:
        print("[sass] cuobjdump is missing: no instruction counts")
        return {}
    counts = {}
    for name, meta in info.items():
        sass = subprocess.run([tool, "-sass", meta["path"]],
                              capture_output=True, text=True, timeout=300)
        if sass.returncode != 0:
            print(f"[sass] {name}: cuobjdump exited {sass.returncode}: "
                  f"{sass.stderr[:200]}")
            continue
        (out_dir / f"{name}.sass").write_text(sass.stdout)
        found = parse_sass(sass.stdout)
        ptxas = parse_ptxas(meta["log"])
        for fn, c in found.items():
            c.update(ptxas.get(fn, {}))
        counts.update(found)
    print(f"[sass] cuobjdump -sass of the built libraries (listings in "
          f"{out_dir.name}/)")
    for fn, c in sorted(counts.items()):
        print(f"  {fn}: {c['instructions']} instructions, {c['mufu']} MUFU "
              f"{json.dumps(c['mufu_by_kind'])}, {c['votes']} votes "
              f"({c['votes_guarding_a_branch']} guarding a branch), "
              f"{c['branches']} branches; {c.get('registers')} registers, "
              f"{c.get('smem')} B shared memory, spills "
              f"{c.get('spill_stores')}/{c.get('spill_loads')} B; "
              f"{c['bulk_copies']} bulk copies "
              f"{json.dumps(c['async_by_kind'])}")
    for fn, (ins, mufu) in UNCHANGED_SASS.items():
        c = counts.get(fn, {})
        check(c.get("instructions") == ins and c.get("mufu") == mufu
              and not c.get("bulk_copies"),
              f"[sass] {fn}: {c.get('instructions')} instructions, "
              f"{c.get('mufu')} MUFU, no bulk copy, as recorded: {ins} and "
              f"{mufu}")
    return counts


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def kernel_inputs(C, L, gen, dev):
    import torch
    f32 = dict(dtype=torch.float32, device=dev)
    u = lambda lo, hi, shape: lo + (hi - lo) * torch.rand(  # noqa: E731
        shape, generator=gen, **f32)
    # reads around mu * chi with mu down to 0.2: the low-chi slots, where
    # delta = mu * chi * q sits at its clamp of 1, carry posterior weight
    mu = u(0.2, 80, (C, L))
    chi = torch.randint(1, 7, (C, L), generator=gen, device=dev)
    reads = torch.poisson(mu * chi, generator=gen)
    phi = u(0.001, 0.999, (C, L))
    pi_t = 2.0 * torch.randn((P, C, L), generator=gen, **f32)
    g = -torch.ones((C, L), **f32)                 # d loss / d out
    # composite-like dense prior: 1 + weight at the clone state and at
    # the states of the top-J G1 cells (weights up to 1e6)
    etas_t = torch.ones((P, C, L), **f32)
    for w in (1e6, 5e5, 4e5, 3e5):
        idx = torch.randint(0, P, (1, C, L), generator=gen, device=dev)
        etas_t.scatter_add_(0, idx, torch.full((1, C, L), w, **f32))
    eidx = torch.randint(0, P, (C, L), generator=gen, device=dev).float()
    ew = torch.where(torch.rand((C, L), generator=gen, **f32) < 0.95,
                     torch.full((C, L), 1e6, **f32), torch.zeros((C, L), **f32))
    lamb = torch.tensor(0.75, **f32)
    # the unfused pair's cells-major log-simplex: random and non-uniform,
    # so that a swapped state index shows
    log_pi = torch.log_softmax(
        2.0 * torch.randn((C, L, P), generator=gen, **f32), dim=-1)
    return dict(reads=reads, mu=mu, phi=phi, pi_t=pi_t, g=g, etas_t=etas_t,
                eidx=eidx, ew=ew, lamb=lamb, log_pi=log_pi)


def flat_prior(prior: dict) -> dict:
    """The same prior encoding with no data term (etas = 1, eta_w = 0):
    then out - lse is the hoisted x log(lamb) - lgamma(x + 1) alone and
    every cotangent is the enumeration's own, at O(|g|) scale, where the
    1e6 concentrations no longer set the scale of the comparison."""
    import torch
    if "etas_t" in prior:
        return dict(etas_t=torch.ones_like(prior["etas_t"]))
    return dict(eta_idx=prior["eta_idx"],
                eta_w=torch.zeros_like(prior["eta_w"]))


def fused_errors(args, prior, g, flat: bool, binary_P=None) -> tuple:
    """Kernel against plain version on one set of operands: forward and
    backward errors, each {part: (max abs, relative)}.  Both backwards
    take the plain forward's lse, so each kernel is judged alone.
    ``binary_P``: args carry the Kb binary planes of P states."""
    import torch
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
    kw = dict(prior, binary_P=binary_P)
    out_k, lse_k = ek.fused_fwd(*args, **kw)
    out_p, lse_p = ek.fused_fwd_plain(*args, **kw)
    # out = lse + (x log lamb - lgamma(x + 1) + data term) and dpi =
    # dlp - softmax * sum(dlp), whose dlp carry g times the prior weight
    # (dz sums such dpi): near a fitted optimum both cancel terms of
    # those sizes
    out_scale = max(amax(lse_p), amax(out_p - lse_p))
    weight = prior["etas_t"] - 1.0 if "etas_t" in prior else prior["eta_w"]
    dpi_scale = amax(g) * amax(weight)
    fwd = {"out": rel_err(out_k, out_p, out_scale),
           "lse": rel_err(lse_k, lse_p)}
    if flat:
        fwd["hoisted"] = elementwise_err(out_k - lse_k, out_p - lse_p)
    got = ek.fused_bwd(*args, lse_p, g, **kw)
    ref = ek.fused_bwd_plain(*args, lse_p, g, **kw)
    torch.cuda.synchronize()
    bwd = {"dmu": rel_err(got[0], ref[0]), "dphi": rel_err(got[1], ref[1]),
           "dpi": rel_err(got[2], ref[2], dpi_scale)}
    return fwd, bwd


def report(results, name, errs, tol, label) -> None:
    for part, (abs_e, rel_e) in errs.items():
        check(rel_e <= tol[part], f"{name} {label} {part}: max abs err "
              f"{abs_e:.3e}, rel {rel_e:.3e} <= {tol[part]:.0e}")
    entry = results.setdefault(name, {"max_abs_err": 0.0})
    entry["max_abs_err"] = max(entry["max_abs_err"],
                               max(e[0] for e in errs.values()))


def kernel_name(kind: str, sparse: bool, binary_P=None) -> str:
    name = f"fused_{kind}_{'sparse' if sparse else 'dense'}"
    return name if binary_P is None else name + "_binary"


def check_fused(results, args, prior, g, sparse, label, binary_P=None):
    """Both fused kernels of one encoding on one set of operands, with
    the prior as given (``TOL``) and with its data term removed
    (``TOL_FLAT``)."""
    for flat in (False, True):
        fwd, bwd = fused_errors(args, flat_prior(prior) if flat else prior,
                                g, flat, binary_P)
        tol, tag = (TOL_FLAT, "flat prior") if flat else (TOL, "prior")
        for kind, errs in (("fwd", fwd), ("bwd", bwd)):
            report(results, kernel_name(kind, sparse, binary_P), errs, tol,
                   f"{label}, {tag}")


def ll_scale(ll, reads, scal):
    """Per element 1 + |lse| + |x log(lamb) - lgamma(x + 1)|: the size of
    the terms that the unfused ll sums."""
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
    hoisted = reads * scal[0] - ek.lgamma_ge1(reads + 1.0)
    return 1.0 + (ll - hoisted).abs() + hoisted.abs()


def enum_errors(args, g) -> tuple:
    """The unfused kernels against their plain versions on one set of
    operands (reads, mu, log_pi, phi, scal); the backward takes the
    plain forward's ll, so each kernel is judged alone.  Also returns the
    launch keys that the two kernel calls counted."""
    import torch
    from scdna_replication_tools_tpu_torch.ops import _cuda
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
    before = dict(_cuda.LAUNCHES)
    ll_k = ek.enum_fwd(*args)
    ll_p = ek.enum_fwd_plain(*args)
    got = ek.enum_bwd(*args, ll_p, g)
    ref = ek.enum_bwd_plain(*args, ll_p, g)
    torch.cuda.synchronize()
    keys = sorted(k for k, v in _cuda.LAUNCHES.items() if v != before[k])
    d = (ll_k - ll_p).abs()
    fwd = {"ll": (float(d.max()),
                  float((d / ll_scale(ll_p, args[0], args[4])).max()))}
    bwd = {name: rel_err(a, b) for name, a, b in
           zip(("dmu", "dphi", "dlog_pi"), got, ref)}
    return fwd, bwd, keys


def check_enum(results, args, g, label) -> None:
    """:func:`enum_errors` at ``TOL_ENUM``, and that the backward staged
    its dlog_pi (every grid here holds a full block)."""
    fwd, bwd, keys = enum_errors(args, g)
    report(results, "enum_fwd", fwd, TOL_ENUM, label)
    report(results, "enum_bwd", bwd, TOL_ENUM, label)
    want = ["enum_bwd_staged", "enum_fwd"]
    check(keys == want, f"enum pair {label}: launched {keys}, expected "
          f"{want}")


def time_kernel(results, name, fk, fp, ins, census, label=None,
                single=False) -> None:
    """One kernel's device time (:func:`time_ms`) and its bound from the
    bytes of ``ins`` and of its outputs, the float32 operations and the
    SFU instructions that ``census``'s operands need.  Without ``label``
    (the full-width synthetic operands) also the single-call reading and
    the plain version's time, in the kernel's row; with one (a main-path
    launch's operands) under the row's ``main``, with the single-call
    reading where ``single``."""
    outs = fk()
    moved = nbytes(*ins, *(outs if isinstance(outs, tuple) else (outs,)))
    del outs
    ops = enum_ops(name, P, census)
    mufu = mufu_ops(name, P, census)
    b_ms, b_by, b_term = bound(moved, ops, mufu)
    t = {"ms": time_ms(fk), "bound_ms": b_ms, "bound_by": b_by,
         "bound_term": b_term,
         "bound_terms_ms": bound_terms(moved, ops, mufu),
         "bytes": moved, "ops": ops, "mufu": mufu,
         "shift_pair_share": census["pair_share"],
         "shift_warp_share": census["warp_share"]}
    where = label or f"{CELLS}x{LOCI}"
    plain = ""
    if label is None or single:
        t["ms_single"] = time_single_ms(fk)
        plain = f", single-call {t['ms_single']:.4f} ms"
    if label is None:
        t.update(plain_ms=time_ms(fp, reps=20, warmup=1), library_ms=None)
        results[name].update(t)
        plain += f", plain {t['plain_ms']:.4f} ms"
    else:
        results[name].setdefault("main", {})[label] = t
    print(f"  {name} {where}: kernel {t['ms']:.4f} ms{plain}, bound "
          f"{b_ms:.4f} ms ({b_term}); {moved} bytes, {ops} float32 "
          f"operations, {mufu} SFU instructions; shift in "
          f"{census['pair_share']:.4%} of (bin, chi) pairs, taken by "
          f"{census['taken']} of {census['warps']} 32-bin warps")


def time_enum(results, args, g, label=None) -> None:
    """Kernel, plain version and bound of the unfused pair at the
    full-width shape, or (``label``) kernel times, single-call too, and
    bound on a main-path launch's operands."""
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
    ll = ek.enum_fwd_plain(*args)
    bargs = args + (ll, g)
    census = shift_census(args[0], args[1], args[4][2], P)
    time_kernel(results, "enum_fwd", lambda: ek.enum_fwd(*args),
                lambda: ek.enum_fwd_plain(*args), args, census, label, True)
    time_kernel(results, "enum_bwd", lambda: ek.enum_bwd(*bargs),
                lambda: ek.enum_bwd_plain(*bargs), bargs, census, label,
                True)


def time_even_p(results, x, scal) -> None:
    """The staged backward's shared-memory writes at stride P words: at
    odd P a warp's 32 writes fall in 32 banks, at P = 16 in 2 (16-way
    conflicts).  Both kernels at P = 15 and 16 on the full-width
    operands, back to back (PERF.md compares them with per-thread
    stores)."""
    import torch
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
    g, dev = x["g"], x["mu"].device
    for p in (15, 16):
        gen = torch.Generator(device=dev).manual_seed(SEED + p)
        log_pi = torch.log_softmax(2.0 * torch.randn(
            (CELLS, LOCI, p), generator=gen, device=dev), dim=-1)
        args = (x["reads"], x["mu"], log_pi, x["phi"], scal)
        ll = ek.enum_fwd_plain(*args)
        fwd = time_ms(lambda: ek.enum_fwd(*args))
        bwd = time_ms(lambda: ek.enum_bwd(*args, ll, g))
        for name, ms in (("enum_fwd", fwd), ("enum_bwd", bwd)):
            results[name].setdefault("even_p", {})[f"P={p}"] = ms
        print(f"  enum pair {CELLS}x{LOCI}, P = {p}: forward {fwd:.4f} ms, "
              f"backward {bwd:.4f} ms")
        del args, ll, log_pi
        torch.cuda.empty_cache()


def bf16_ulps(a, b):
    """Per-element distance of two bfloat16 tensors in bfloat16 ulps
    (steps between adjacent representable values; +0 and -0 one
    point)."""
    import torch

    def ordered(t):
        i = t.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -(i & 0x7FFF), i)
    return (ordered(a) - ordered(b)).abs()


def check_adam(results, args, label, moment_dtype="float32") -> tuple:
    """One Adam sweep, kernel against plain version: param', m', v' to
    ``TOL``, or, with bfloat16 moments, m' and v' to ``BF16_ULPS`` per
    element (the count of elements apart is printed)."""
    from scdna_replication_tools_tpu_torch.ops import adam_kernel as ak
    got = ak.adam_update(*args, moment_dtype)
    ref = ak.adam_update_plain(*args)
    if moment_dtype == "float32":
        errs = {part: rel_err(a, b) for part, a, b in
                zip(("param", "m", "v"), got, ref)}
        report(results, "adam", errs, TOL, label)
        return got
    report(results, "adam_bf16", {"param": rel_err(got[0], ref[0])}, TOL,
           label)
    entry = results["adam_bf16"]
    for part, a, b in zip(("m", "v"), got[1:], ref[1:]):
        ulps = bf16_ulps(a, b)
        worst, apart = int(ulps.max()), int((ulps > 0).sum())
        abs_e = amax(a.float() - b.float())
        check(worst <= BF16_ULPS and a.dtype == b.dtype,
              f"adam_bf16 {label} {part}: {worst} bfloat16 ulp(s) at most "
              f"<= {BF16_ULPS}, {apart} of {ulps.numel()} elements apart, "
              f"max abs err {abs_e:.3e}")
        entry["max_abs_err"] = max(entry["max_abs_err"], abs_e)
        entry.setdefault("elements_apart", {})[f"{label} {part}"] = apart
    return got


def adam_scal(dev, step: int, live: bool = True):
    """The (4,) [lr, bc1, bc2, live] device operand of one Adam step at
    count ``step``."""
    import torch
    from scdna_replication_tools_tpu_torch.ops import adam_kernel as ak
    return ak.adam_scalars(ak.adam_constants(0.05, 0.8, 0.99, dev),
                           torch.tensor(step, dtype=torch.int32, device=dev),
                           torch.tensor(live, device=dev))


def check_adam_gate(results, args, label, moment_dtype, dev) -> None:
    """The live gate: with live = 0 the kernel writes param, m and v
    through bit for bit; with live = 1 it equals the plain version bit
    for bit (it repeats the plain version's roundings)."""
    import torch
    from scdna_replication_tools_tpu_torch.ops import adam_kernel as ak
    name = "adam" if moment_dtype == "float32" else "adam_bf16"
    off = ak.adam_update(*args[:4], adam_scal(dev, 7, False), *args[5:],
                         moment_dtype)
    on = ak.adam_update(*args, moment_dtype)
    ref = ak.adam_update_plain(*args)
    torch.cuda.synchronize()
    through = all(torch.equal(a, b)
                  for a, b in zip(off, (args[0], args[2], args[3])))
    same = all(torch.equal(a, b) for a, b in zip(on, ref))
    check(through, f"{name} {label}: live = 0 writes param, m and v "
          "through bit for bit")
    check(same, f"{name} {label}: live = 1 equals the plain version bit "
          "for bit")
    results[name].setdefault("gate", {})[label] = {
        "live0_bit_exact": through, "live1_bit_exact": same}


def time_fused(results, args, prior, g, sparse, binary_P=None,
               label=None) -> None:
    """Both fused kernels of one encoding, timed by :func:`time_kernel`:
    at the full-width synthetic shape, or (``label``) on the operands of
    a main-path launch.  The backward takes the plain forward's lse."""
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
    kw = dict(prior, binary_P=binary_P)
    _, lse = ek.fused_fwd_plain(*args, **kw)
    bargs = args + (lse, g)
    census = shift_census(args[0], args[1], args[4][2], P)
    time_kernel(results, kernel_name("fwd", sparse, binary_P),
                lambda: ek.fused_fwd(*args, **kw),
                lambda: ek.fused_fwd_plain(*args, **kw),
                args + tuple(prior.values()), census, label)
    time_kernel(results, kernel_name("bwd", sparse, binary_P),
                lambda: ek.fused_bwd(*bargs, **kw),
                lambda: ek.fused_bwd_plain(*bargs, **kw),
                bargs + tuple(prior.values()), census, label)


def time_adam(results, aargs, moment_dtype, dev) -> None:
    """Kernel, plain version, bound and PyTorch's fused Adam (on copies
    of the same tensors; used nowhere in the port) of one Adam sweep."""
    import torch
    from scdna_replication_tools_tpu_torch.ops import adam_kernel as ak
    name = "adam" if moment_dtype == "float32" else "adam_bf16"
    param, grad, m, v = aargs[:4]
    got = ak.adam_update(*aargs, moment_dtype)
    n = param.numel()
    moved = nbytes(param, grad, m, v) + nbytes(*got)
    del got
    b_ms, b_by, _ = bound(moved, ADAM_OPS * n)
    k_ms = time_ms(lambda: ak.adam_update(*aargs, moment_dtype))
    k_single = time_single_ms(lambda: ak.adam_update(*aargs, moment_dtype))
    p_ms = time_ms(lambda: ak.adam_update_plain(*aargs))
    lp, lm, lv = param.clone(), m.clone(), v.clone()
    step = [torch.tensor(7.0, device=dev)]

    def lib():
        torch._fused_adam_([lp], [grad], [lm], [lv], [], step, lr=0.05,
                           beta1=0.8, beta2=0.99, weight_decay=0.0, eps=1e-8,
                           amsgrad=False, maximize=False)
    l_ms = l_single = None
    l_note = "torch._fused_adam_"
    try:
        if moment_dtype != "float32":
            # the yardstick call may refuse float32 parameters with
            # bfloat16 moments; its refusal is recorded, not a failure of
            # the port
            lib()
            torch.cuda.synchronize()
        l_ms, l_single = time_ms(lib), time_single_ms(lib)
    except RuntimeError as exc:
        if moment_dtype == "float32":
            raise
        l_note = f"torch._fused_adam_ refused: {str(exc)[:120]}"
    results[name].update(ms=k_ms, ms_single=k_single, plain_ms=p_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=l_ms,
                         library_ms_single=l_single, library=l_note,
                         bytes=moved, ops=ADAM_OPS * n,
                         shape=list(param.shape))
    lib_s = (f"{l_ms:.4f} ms (single-call {l_single:.4f} ms)"
             if l_ms is not None else l_note)
    print(f"  {name} {tuple(param.shape)}: kernel {k_ms:.4f} ms, "
          f"single-call {k_single:.4f} ms, plain {p_ms:.4f} ms, library "
          f"{lib_s}, bound {b_ms:.4f} ms ({b_by}); {moved} bytes")
    del lp, lm, lv


def compare_kernels(dev, record):
    import torch
    from scdna_replication_tools_tpu_torch.ops import adam_kernel as ak
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek

    gen = torch.Generator(device=dev)
    results = {}
    for shape in [(CELLS, LOCI), RAGGED]:
        gen.manual_seed(SEED)
        x = kernel_inputs(*shape, gen, dev)
        scal = ek.scalars(x["lamb"])
        z_t = 2.0 * torch.randn((KB,) + shape, generator=gen, device=dev)
        full = shape == (CELLS, LOCI)
        label = f"{shape[0]}x{shape[1]}"
        print(f"[kernels] shape cells x loci = {label}, P = {P}, Kb = {KB}")
        eargs = (x["reads"], x["mu"], x["log_pi"], x["phi"], scal)
        check_enum(results, eargs, x["g"], label)
        if full:
            time_enum(results, eargs, x["g"])
            time_even_p(results, x, scal)
        del eargs
        x.pop("log_pi")
        torch.cuda.empty_cache()
        for binary_P in (None, P):
            args = (x["reads"], x["mu"], x["pi_t"] if binary_P is None
                    else z_t, x["phi"], scal)
            for sparse in (False, True):
                prior = dict(eta_idx=x["eidx"], eta_w=x["ew"]) if sparse \
                    else dict(etas_t=x["etas_t"])
                check_fused(results, args, prior, x["g"], sparse, label,
                            binary_P)
                if full:
                    time_fused(results, args, prior, x["g"], sparse,
                               binary_P)
            torch.cuda.empty_cache()
        del x, z_t, args
        torch.cuda.empty_cache()

        # Adam at step 7: float32 moments on a (P, cells, loci) parameter,
        # bfloat16 moments on the (Kb, cells, loci) binary one
        for planes, mdt in ((P, "float32"), (KB, "bfloat16")):
            pshape = (planes,) + shape
            param = torch.randn(pshape, generator=gen, device=dev)
            grad = torch.randn(pshape, generator=gen, device=dev)
            m = (0.1 * torch.randn(pshape, generator=gen, device=dev)) \
                .to(ak.moment_torch_dtype(mdt))
            v = (0.1 * torch.rand(pshape, generator=gen, device=dev)) \
                .to(ak.moment_torch_dtype(mdt))
            aargs = (param, grad, m, v, adam_scal(dev, 7), 0.8, 0.99)
            check_adam(results, aargs, f"{planes}x{label}", mdt)
            check_adam_gate(results, aargs, f"{planes}x{label}", mdt, dev)
            if full:
                time_adam(results, aargs, mdt, dev)
            del param, grad, m, v, aargs
            torch.cuda.empty_cache()
    record["kernels"] = results
    return results


class LaunchOperands:
    """Keeps the operands of the last launch of the fused backward and of
    Adam at each shape while it is open (the backward's operands hold the
    forward's too).  It wraps the module attributes that the model and
    the fit loop call; the wrapped functions count launches as before."""

    def __init__(self):
        from scdna_replication_tools_tpu_torch.infer import svi
        from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
        self.sites = [(ek, "fused_bwd"), (svi, "adam_update")]
        self.calls: dict = {}
        self.originals: list = []

    def __enter__(self):
        for mod, attr in self.sites:
            orig = getattr(mod, attr)
            self.originals.append((mod, attr, orig))

            def keep(*a, _orig=orig, _attr=attr, **kw):
                if _attr == "fused_bwd":
                    kind = "dense" if kw.get("etas_t") is not None \
                        else "sparse"
                    if kw.get("binary_P") is not None:
                        kind += "_binary"
                else:
                    kind = a[7] if len(a) > 7 else "float32"
                self.calls[(_attr, kind, tuple(a[0].shape))] = (a, kw)
                return _orig(*a, **kw)
            setattr(mod, attr, keep)
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in self.originals:
            setattr(mod, attr, orig)
        return False


def check_main_path_shapes(dev, scrt, results, path: str) -> None:
    """Every kernel against its plain version at the shapes that the main
    path gave it and on its values: one more iteration of each step's fit
    from the step's fitted parameters, through the same entry points,
    yields the operands of each launch (after the main path, so that its
    peak memory holds none of them)."""
    mdt = scrt.config.optimizer_state_dtype
    print(f"[kernels] on the operands of each step of the {path} path, from "
          "its fitted parameters")
    for name, step in zip(("step1", "step2", "step3"), scrt.steps):
        # a finished step's pi planes may have moved to the host
        params = {k: v.to(dev) for k, v in step.fit.params.items()}
        check_one_iteration(dev, results, step.spec, params, step.fixed,
                            step.batch, mdt, f"{path} {name}")


def check_one_iteration(dev, results, spec, params, fixed, batch, mdt,
                        prefix: str) -> None:
    """One ``fit_map`` iteration from ``params`` under ``LaunchOperands``,
    then each captured launch of the fused backward (with its forward) and
    of Adam against the plain versions on its operands; each fused pair
    is also timed there, with the share of its warps that take the NB
    cores' shift."""
    import torch
    from scdna_replication_tools_tpu_torch.infer.runner import _PertLossFn
    from scdna_replication_tools_tpu_torch.infer.svi import fit_map

    with LaunchOperands() as operands:
        fit_map(_PertLossFn(spec), params, (fixed, batch), max_iter=1,
                min_iter=1, device=dev, moment_dtype=mdt)
    for (attr, kind, shape), (a, kw) in sorted(operands.calls.items()):
        label = f"{prefix} {'x'.join(map(str, shape))}"
        a = tuple(t.detach() if torch.is_tensor(t) else t for t in a)
        kw = {k: t.detach() if torch.is_tensor(t) else t
              for k, t in kw.items() if t is not None}
        with torch.no_grad():
            if attr == "fused_bwd":
                binary_P = kw.pop("binary_P", None)
                sparse = kind.startswith("sparse")
                check_fused(results, a[:5], kw, a[6], sparse, label,
                            binary_P)
                time_fused(results, a[:5], kw, a[6], sparse, binary_P,
                           label)
            else:
                check_adam(results, a[:7], label, kind)
    del operands
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the main path on simulated frames
# ---------------------------------------------------------------------------

# hg19 autosome lengths (Mb): 500 kb bins are spread over them in
# proportion, 5451 in all
HG19_MB = [249, 243, 198, 191, 181, 171, 159, 146, 141, 136, 135, 134, 115,
           107, 103, 90, 81, 78, 59, 63, 48, 51]


def _smooth(rng, n, scale):
    """A smooth random profile in [0, 1]: a few sinusoids."""
    x = np.arange(n) / scale
    y = sum(rng.uniform(0.3, 1.0) * np.sin(x * rng.uniform(0.5, 2.0)
                                           + rng.uniform(0, 2 * np.pi))
            for _ in range(3))
    return (y - y.min()) / (y.max() - y.min())


def simulate_frames(seed: int = SEED, num_reads: float = 1e6,
                    lamb: float = 0.75, a: float = 10.0,
                    betas=(0.5, 0.0), num_cells=None):
    """Long-form S and G1 frames from the PERT generative process
    (scdna_replication_tools_tpu/models/simulator.py:55-146): per-cell
    GC betas around ``betas`` with logspace(1 -> 10^-K) stds,
    tau ~ U(0, 1), rep ~ Bernoulli(sigmoid(a (tau - rho))), Gamma-Poisson
    NB reads at total CN (1 + rep) * cn, normalised to ``num_reads``.
    Three clones with their own CN and RT profiles; every cell also
    carries private CN changes, so the composite prior stays dense.
    ``num_cells``: (S, G1) cells; by default ``CELLS`` and ``G1_CELLS``."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    counts = np.floor(np.asarray(HG19_MB) / sum(HG19_MB) * LOCI).astype(int)
    counts[: LOCI - counts.sum()] += 1
    chrom = np.repeat([str(i + 1) for i in range(22)], counts)
    start = np.concatenate([np.arange(c) * 500_000 for c in counts])
    gc = np.clip(0.42 + 0.1 * (_smooth(rng, LOCI, 40.0) - 0.5)
                 + rng.normal(0, 0.01, LOCI), 0.3, 0.65).astype(np.float32)

    # one replication-timing program per sample, each clone shifted a
    # little from it (the model fits one rho profile for all S cells)
    base_rt = _smooth(rng, LOCI, 25.0)
    clone_cn, clone_rt = [], []
    for _ in range(CLONES):
        cn = np.full(LOCI, 2.0)
        for _ in range(6):
            s0 = rng.integers(0, LOCI - 200)
            cn[s0:s0 + rng.integers(40, 200)] = rng.choice([1.0, 3.0, 4.0])
        clone_cn.append(cn)
        rt = 0.9 * base_rt + 0.1 * _smooth(rng, LOCI, 25.0)
        clone_rt.append((rt - rt.min()) / (rt.max() - rt.min()))

    K = len(betas) - 1
    stds = np.logspace(0.0, -K, K + 1)

    def cells(n, phase):
        clone = rng.integers(0, CLONES, n)
        cn = np.stack([clone_cn[c] for c in clone])
        for i in range(n):                         # private changes
            for _ in range(rng.integers(1, 3)):
                s0 = rng.integers(0, LOCI - 60)
                seg = slice(s0, s0 + rng.integers(10, 60))
                cn[i, seg] = np.clip(cn[i, seg] + rng.choice([-1, 1]), 1, 6)
        cb = np.asarray(betas) + stds * rng.normal(size=(n, K + 1))
        feats = gc[:, None] ** np.arange(K, -1, -1)[None, :]
        omega = np.exp(cb @ feats.T)
        if phase == "s":
            tau = rng.uniform(0, 1, n)
            rho = np.stack([1.0 - clone_rt[c] for c in clone])
            phi = 1.0 / (1.0 + np.exp(-a * (tau[:, None] - rho)))
            rep = (rng.uniform(size=phi.shape) < phi).astype(float)
            u = num_reads / (1.5 * LOCI * cn.mean())
        else:
            tau = np.zeros(n)
            rep = np.zeros_like(cn)
            u = num_reads / (1.0 * LOCI * cn.mean())
        theta = u * cn * (1.0 + rep) * omega
        delta = np.maximum(theta * (1.0 - lamb) / lamb, 1.0)
        raw = rng.poisson(rng.gamma(delta) * lamb / (1.0 - lamb))
        reads = np.floor(raw / raw.sum(axis=1, keepdims=True) * num_reads)
        ids = np.array([f"{phase}_{i}" for i in range(n)], dtype=object)
        frame = pd.DataFrame({
            "cell_id": np.repeat(ids, LOCI),
            "chr": np.tile(chrom, n),
            "start": np.tile(start, n),
            "gc": np.tile(gc, n),
            "library_id": "LIB0",
            "clone_id": np.repeat(np.array([f"C{c}" for c in clone]), LOCI),
            "reads": reads.reshape(-1),
            "state": cn.reshape(-1).astype(int),
            "copy": cn.reshape(-1),
            "true_somatic_cn": cn.reshape(-1),
            "true_rep": rep.reshape(-1),
            "true_t": np.repeat(tau, LOCI),
        })
        return frame

    # each clone's RT profile, for the simulator's rt columns (phase 10)
    CLONE_RT[seed] = {f"C{c}": rt for c, rt in enumerate(clone_rt)}
    n_s, n_g = num_cells or (CELLS, G1_CELLS)
    return cells(n_s, "s"), cells(n_g, "g")


# seed -> {clone: RT profile} of the frames simulate_frames made
CLONE_RT: dict = {}


CATEGORICAL = ("fused_fwd_dense", "fused_bwd_dense", "fused_fwd_sparse",
               "fused_bwd_sparse", "adam")
BINARY = ("fused_fwd_dense_binary", "fused_bwd_dense_binary",
          "fused_fwd_sparse_binary", "fused_bwd_sparse_binary", "adam_bf16")
RESCUE = CATEGORICAL + ("enum_fwd",)
# the options of every path but the default one: the frames' columns,
# the depth cut and no run log; the reference-faithful paths run without
# the controller and the QC
FIXED = dict(input_col="reads", clone_col="clone_id", assign_col="copy",
             cn_prior_method="g1_composite", max_iter=MAX_ITER, min_iter=100,
             rt_prior_col=None, telemetry_path=None)
OFF = dict(FIXED, controller=False, qc=False)
PATHS = {
    # path -> (scRT options, the launch keys its main path counts); the
    # unfused backward runs on no path (the rescue scores without
    # gradients), so enum_bwd is held against its plain version only
    "categorical": (dict(OFF, mirror_rescue=False), CATEGORICAL),
    # the default config, scRT(cn_s, cn_g1) with no option given:
    # controller, QC, the controller-gated rescue (enum_fwd only when the
    # gate lets it run) and the run log
    "default": (dict(), CATEGORICAL),
    "binary": (dict(OFF, mirror_rescue=False, enum_impl="binary",
                    optimizer_state_dtype="bfloat16"), BINARY),
    "rescue": (dict(OFF, mirror_rescue=True), RESCUE),
    # a lab's sample without clone labels (phase 10): the frames without
    # clone_id, clones found by k-means on the card, the fused kernels
    # run per chunk of 256 cells, CN decoded by Viterbi; every other
    # option at its default
    "unlabelled": (dict(clone_col=None, cell_chunk=256,
                        cn_hmm_self_prob=0.99), CATEGORICAL),
}


def main_path(dev, record, frames, path: str, reference=None):
    """``scRT(...).infer('pert')`` of one path on the simulated frames:
    launch counts against dispatched iteration counts (a chunk's
    iterations after a fit stopped are launched and masked), times,
    peak memory, the controller's decisions and the recovery bars (the
    other paths also against the categorical run's ``reference``
    figures)."""
    import torch
    from scdna_replication_tools_tpu_torch import scRT
    from scdna_replication_tools_tpu_torch.ops import _cuda

    options, kernels = PATHS[path]
    cn_s, cn_g1 = frames
    scrt = scRT(cn_s.copy(), cn_g1.copy(), **options)
    tag = f"[main {path}]"
    check(scrt.device.type == "cuda", f"{path}: scRT runs on {scrt.device}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the libraries this process loaded before the run: the run's first
    # compile event of each is a hit, of any other a miss or disk hit
    loaded_before = set(_cuda._LIBS)
    # a run log that could not be created, or disabled itself on a failed
    # write, says so once on the package's logger (the fit goes on)
    disabled = _LogDisabled()
    pkg_logger = logging.getLogger("scdna_replication_tools_tpu_torch")
    pkg_logger.addHandler(disabled)
    _cuda.reset_launches()
    t0 = time.perf_counter()
    try:
        out_s, supp_s, out_g1, supp_g1 = scrt.infer("pert")
        torch.cuda.synchronize()
    finally:
        pkg_logger.removeHandler(disabled)
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    scrt.outputs = (out_s, supp_s, out_g1, supp_g1)
    step1, step2, step3 = scrt.steps
    iters = [s.fit.num_iters for s in (step1, step2, step3)]
    disp = [s.fit.timings["dispatched"] for s in (step1, step2, step3)]
    print(f"{tag} {json.dumps(options) if options else 'no option given'}: "
          f"infer('pert') wall {wall:.2f} s; phases "
          + ", ".join(f"{k} {v:.2f} s" for k, v in scrt.phase_report.items()))
    for name, st in zip(("step1", "step2", "step3"), (step1, step2, step3)):
        f = st.fit
        print(f"  {name}: {f.num_iters} iterations counted, "
              f"{f.timings['dispatched']} dispatched (budget {f.budget}), "
              f"fit {f.timings['fit']:.3f} s = {f.timings['ms_per_iter']:.3f} "
              f"ms/iteration, cells {int(st.batch.reads.shape[0])}, "
              f"prior {'sparse' if st.spec.sparse_etas else 'dense'}, pi "
              f"{'binary' if st.spec.binary_pi else 'categorical'}, "
              f"loss {f.losses[0]:.6g} -> {f.losses[-1]:.6g}; verdict "
              f"{f.verdict}; decisions "
              + (", ".join(f"{d['action']}@{d['iter']}" for d in f.decisions)
                 or "none"))
    cells_per_s = CELLS * step2.fit.num_iters / step2.fit.timings["fit"]
    print(f"  step2: {cells_per_s:.1f} cells/s (cell-iterations per second)")
    print(f"  peak device memory {peak / 2**30:.3f} GiB ({peak} bytes)")
    print(f"  launches {json.dumps(launches)}")

    check(not step2.spec.sparse_etas and step3.spec.sparse_etas,
          f"{path}: step 2 fits the dense composite prior, step 3 the "
          "sparse one")
    events = [json.loads(line) for line in
              Path(scrt.run_log_path).read_text().splitlines()] \
        if scrt.run_log_path else []
    gate = next((e for e in events if e["event"] == "control_decision"
                 and e["action"] in ("rescue", "rescue_skip")), None)
    if gate is not None:
        print(f"  rescue gate: {gate['action']} at iteration {gate['iter']}"
              f", trigger {json.dumps(gate['trigger'])}")
    ran = scrt.mirror_rescue_fit is not None
    rescue = rescue_record(scrt, tag) if options.get("mirror_rescue", True) \
        else None
    if ran and "enum_fwd" not in kernels:
        kernels = kernels + ("enum_fwd",)
    # the rescue's sub-fit runs the dense pair and Adam on the candidates
    # (unchunked); with cell_chunk each step's pair runs once per chunk of
    # its padded cells per iteration
    sub = rescue["dispatched"] if rescue else 0
    chunk = options.get("cell_chunk")
    ch2, ch3 = ((int(st.batch.reads.shape[0]) // chunk if chunk else 1)
                for st in (step2, step3))
    fwd_d, bwd_d, fwd_s, bwd_s, adam = kernels[:5]
    check(launches[fwd_d] == ch2 * disp[1] + sub
          and launches[bwd_d] == ch2 * disp[1] + sub,
          f"{path}: {fwd_d}/{bwd_d} launched once per chunk ({ch2}) of "
          f"each dispatched step-2 iteration ({disp[1]}) and once per "
          f"rescue sub-fit iteration ({sub})")
    check(launches[fwd_s] == ch3 * disp[2]
          and launches[bwd_s] == ch3 * disp[2],
          f"{path}: {fwd_s}/{bwd_s} launched once per chunk ({ch3}) of "
          f"each dispatched step-3 iteration ({disp[2]})")
    check(launches[adam] == sum(disp) + sub,
          f"{path}: {adam} launched once per dispatched iteration of every "
          f"step and of the rescue sub-fit ({sum(disp) + sub})")
    if rescue is not None:
        check(launches["enum_fwd"] == (2 if ran else 0),
              f"{path}: enum_fwd launched {launches['enum_fwd']} times, "
              f"{'twice (the gate let the rescue run)' if ran else 'never (no rescue ran)'}")
    if path == "rescue":
        check(rescue["candidates"] > 0 and ran,
              f"{path}: {rescue['candidates']} boundary-tau candidates > 0, "
              f"sub-fit of {rescue['iters']} iterations")
    check(all(launches[k] > 0 for k in kernels)
          and not any(v for k, v in launches.items() if k not in kernels),
          f"{path}: every kernel of the path launched, no other kernel")
    for name, st in zip(("step1", "step2", "step3"), (step1, step2, step3)):
        losses = st.fit.losses
        check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0]
              and not st.fit.nan_abort,
              f"{path}: {name} losses finite and falling")
    qc_counts = None
    if scrt.config.qc:
        qc = scrt.cell_qc()
        flags = [f for s in qc["qc_flags"] for f in s.split(",") if f]
        qc_counts = {f: flags.count(f) for f in sorted(set(flags))}
        qc_counts["qc_pass"] = int(qc["qc_pass"].sum())
        print(f"  cell_qc: {len(qc)} cells, flags {json.dumps(qc_counts)}")
        check(len(qc) == CELLS and "model_cn_entropy" in out_s.columns,
              f"{path}: cell_qc has a row per S cell ({len(qc)}) and the S "
              "frame a model_cn_entropy column")
    if path == "default":
        # the default run writes its log; none may be missing or cut
        check(scrt.run_log_path is not None and not disabled.messages,
              f"[runlog] the run wrote its log ({scrt.run_log_path}) and "
              "it stayed enabled"
              + (": " + "; ".join(disabled.messages)
                 if disabled.messages else ""))
        check_run_log(scrt, events, qc_counts, peak, record, loaded_before)

    rec = recovery(out_s, supp_s)
    rep_acc, cn_acc, tau_r, lamb = (rec[k] for k in ("rep_acc", "cn_acc",
                                                     "tau_r", "lambda"))
    check(len(out_s) == CELLS * LOCI and len(out_g1) == G1_CELLS * LOCI,
          f"{path}: output frames cover every bin ({len(out_s)} S, "
          f"{len(out_g1)} G1 rows)")
    check(rep_acc > 0.80, f"{path}: rep-state accuracy {rep_acc:.4f} > 0.80")
    check(cn_acc > 0.90, f"{path}: CN accuracy {cn_acc:.4f} > 0.90")
    check(tau_r > 0.8, f"{path}: tau correlation {tau_r:.4f} > 0.8")
    check(0.5 < lamb < 0.95, f"{path}: lambda {lamb:.4f} in (0.5, 0.95)")
    if reference is not None and rescue is not None:
        # the rescue is objective-improving per cell and the controller
        # only stops, extends or gates: neither may lose the categorical
        # run's recovery
        check(tau_r >= reference["tau_r"] - 0.01,
              f"{path}: tau correlation {tau_r:.4f} >= categorical "
              f"{reference['tau_r']:.4f} - 0.01")
    elif reference is not None:
        # the JAX package's own bars for the binary encoding against the
        # categorical one (tests/test_binary_encoding.py:445-464)
        check(tau_r >= 0.99 * reference["tau_r"],
              f"{path}: tau correlation {tau_r:.4f} >= 0.99 x categorical "
              f"{reference['tau_r']:.4f}")
        check(cn_acc >= reference["cn_acc"] - 0.02,
              f"{path}: CN accuracy {cn_acc:.4f} >= categorical "
              f"{reference['cn_acc']:.4f} - 0.02")
    if chunk:
        record.setdefault("unlabelled", {})["chunks"] = [ch2, ch3]
    record[f"main_{path}"] = {
        "options": options, "cells_s": CELLS, "cells_g1": G1_CELLS,
        "loci": LOCI, "P": P, "clones": CLONES,
        "max_iter": scrt.config.max_iter,
        "iters": iters, "dispatched": disp,
        "budgets": [s.fit.budget for s in (step1, step2, step3)],
        "verdicts": [s.fit.verdict for s in (step1, step2, step3)],
        "decisions": [s.fit.decisions for s in (step1, step2, step3)],
        "gate": gate, "cell_qc_flags": qc_counts,
        "wall_s": wall, "phases_s": scrt.phase_report,
        "ms_per_iter": [s.fit.timings["ms_per_iter"]
                        for s in (step1, step2, step3)],
        "step2_cells_per_s": cells_per_s, "peak_bytes": peak,
        "launches": launches, "rep_acc": rep_acc, "cn_acc": cn_acc,
        "tau_r": tau_r, "lambda": lamb, "rescue": rescue,
        "losses": [[float(v) for v in s.fit.losses]
                   for s in (step1, step2, step3)],
        "normaliser": [_normaliser_sum(s) for s in (step1, step2, step3)],
    }
    if path == "categorical":
        record[f"main_{path}"]["step2_globals"] = _fitted_globals(step2)
    return launches, scrt


class _LogDisabled(logging.Handler):
    """Keeps the package logger's warnings that a run log or telemetry
    was disabled."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith(("telemetry disabled", "run log disabled")):
            self.messages.append(msg)


def check_run_log(scrt, events, qc_counts, peak, record,
                  loaded_before) -> None:
    """The default run's log against the run: schema-valid, one fit_end
    per step with its counted iterations, the controller's decisions,
    the rescue's statistics and the QC flag counts, a compile event per
    kernel library and step (a hit unless the run loaded the library
    first), run_end last with status ok, and the registry's peak device
    memory.  Copied to chiprun_out/default_run.jsonl."""
    import shutil

    from scdna_replication_tools_tpu_torch.obs import schema
    from scdna_replication_tools_tpu_torch.ops import _cuda

    path = Path(scrt.run_log_path)
    errors = schema.validate_run(path)
    check(not errors, f"[runlog] {len(events)} lines valid under the "
          f"port's schema (v{schema.load_schema()['schema_version']})"
          + (f": {errors[:5]}" if errors else ""))
    kinds = [e["event"] for e in events]
    steps = [("step1", "step2", "step3")[i] for i, st in enumerate(scrt.steps)
             if st is not None]
    fit_ends = [(e["step"], e["iters"]) for e in events
                if e["event"] == "fit_end"]
    check(fit_ends == [(n, st.fit.num_iters)
                       for n, st in zip(steps, scrt.steps)],
          f"[runlog] fit_end per step with the counted iterations: "
          f"{fit_ends}")
    logged = [(e["step"], e["action"], e["iter"]) for e in events
              if e["event"] == "control_decision"
              and e["action"] not in ("rescue", "rescue_skip")]
    fitted = [(n, d["action"], d["iter"])
              for n, st in zip(steps, scrt.steps) for d in st.fit.decisions]
    gates = [e["action"] for e in events if e["event"] == "control_decision"
             and e["action"] in ("rescue", "rescue_skip")]
    ran = scrt.mirror_rescue_fit is not None
    check(logged == fitted and gates == ["rescue" if ran else "rescue_skip"],
          f"[runlog] control_decision events equal the steps' decisions "
          f"{fitted} and the gate {gates}")
    (rescue,) = [e for e in events if e["event"] == "rescue"]
    stats = scrt.mirror_rescue_stats
    check({k: rescue[k] for k in ("candidates", "accepted", "capped_to")}
          == {"candidates": stats["candidates"],
              "accepted": stats["accepted"],
              "capped_to": stats.get("capped_to")},
          f"[runlog] rescue event equals mirror_rescue_stats {stats}")
    (qc_event,) = [e for e in events if e["event"] == "cell_qc_summary"]
    flags = {k: v for k, v in qc_counts.items() if k != "qc_pass"}
    check(qc_event["flag_counts"] == flags
          and qc_event["num_cells"] == CELLS,
          f"[runlog] cell_qc_summary flag counts "
          f"{qc_event['flag_counts']} equal cell_qc()'s {flags}")
    compiled = [(e["label"], e["cache"]) for e in events
                if e["event"] == "compile"]
    want, seen = [], set(loaded_before)
    for _ in steps:
        for name, source in _cuda.SOURCES.items():
            want.append((source, "hit" if name in seen else "loaded"))
            seen.add(name)
    got = [(label, "hit" if cache == "hit" else
            "loaded" if cache in ("miss", "disk_hit") else cache)
           for label, cache in compiled]
    check(got == want,
          f"[runlog] a compile event per kernel library and step, a hit "
          f"unless the run loaded it first: {compiled}")
    end = events[-1]
    check(end["event"] == "run_end" and end["status"] == "ok"
          and end["events_emitted"] == len(events) - 1,
          f"[runlog] last line run_end, status {end.get('status')}, "
          f"{end.get('events_emitted')} events before it")
    gauge = scrt.metrics_registry.gauge(
        "pert_device_hbm_peak_bytes", labels={"device": "0"}).value
    check(gauge == peak, f"[runlog] pert_device_hbm_peak_bytes {gauge} = "
          f"torch.cuda.max_memory_allocated {peak}")
    out = REPO / "chiprun_out" / "default_run.jsonl"
    shutil.copyfile(path, out)
    nbytes_log = path.stat().st_size
    create_s = scrt.phase_report.get("telemetry/create")
    print(f"[runlog] {len(events)} events, {nbytes_log} bytes, "
          f"telemetry/create {create_s} s, telemetry/open "
          f"{scrt.phase_report.get('telemetry/open')} s; event counts "
          + json.dumps({k: kinds.count(k) for k in sorted(set(kinds))})
          + f"; copied to {out.relative_to(REPO)}")
    record["run_log"] = {
        "events": len(events), "bytes": nbytes_log,
        "telemetry_create_s": create_s,
        "telemetry_open_s": scrt.phase_report.get("telemetry/open"),
        "hbm_peak_gauge": gauge, "max_memory_allocated": peak,
        "schema_errors": errors, "compile": [
            {k: e.get(k) for k in ("label", "cache", "compile_seconds",
                                   "deserialize_seconds")}
            for e in events if e["event"] == "compile"]}


def rescue_record(scrt, tag) -> dict:
    """The mirror rescue's statistics, sub-fit and phase time, printed."""
    stats = dict(scrt.mirror_rescue_stats or {})
    sub = scrt.mirror_rescue_fit
    fit = sub.fit if sub else None
    rec = {**stats, "iters": fit.num_iters if fit else 0,
           "dispatched": fit.timings["dispatched"] if fit else 0,
           "fit_s": fit.timings["fit"] if fit else 0.0,
           "ms_per_iter": fit.timings["ms_per_iter"] if fit else None,
           "fitted_cells": int(len(sub.cells)) if sub else 0,
           "phase_s": scrt.phase_report.get("step2/rescue")}
    print(f"  rescue: {stats.get('candidates', 0)} candidates, "
          f"{stats.get('accepted', 0)} accepted, capped_to "
          f"{stats.get('capped_to', 'none')}; sub-fit of "
          f"{rec['fitted_cells']} cells, {rec['iters']} iterations "
          f"({rec['dispatched']} dispatched) in "
          f"{rec['fit_s']:.3f} s; step2/rescue phase "
          f"{rec['phase_s'] or 0.0:.3f} s")
    return rec


class SwapEnumFwd:
    """Replaces the unfused forward that ``enum_loglik`` calls (the module
    attribute ``enum_fwd``) while open: ``plain=True`` sends every call to
    the plain version; otherwise each call's operands are kept and the
    kernel runs as before."""

    def __init__(self, plain: bool = False):
        self.plain = plain
        self.calls: list = []

    def __enter__(self):
        from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
        self.orig = ek.enum_fwd

        def swapped(*a):
            if self.plain:
                return ek.enum_fwd_plain(*a)
            self.calls.append(a)
            return self.orig(*a)
        ek.enum_fwd = swapped
        return self

    def __exit__(self, *exc):
        from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
        ek.enum_fwd = self.orig
        return False


def check_rescue_scoring(dev, scrt, results) -> None:
    """On the rescue's own operands (the re-fitted candidates' sub-batch
    under the rescue's conditioning): the dense fused pair and Adam
    against their plain versions over one more sub-fit iteration from the
    sub-fit's parameters; then per_cell_objective on the card (the
    unfused kernel) against the same function through the plain
    enumeration, and both unfused kernels against their plain versions
    and timed (back to back and single-call, with their bounds), with the
    step-2 parameters (after the splice) and with the sub-fit's."""
    import dataclasses

    import torch
    from scdna_replication_tools_tpu_torch.models import pert as mp
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
    from scdna_replication_tools_tpu_torch.ops.transforms import (
        to_positive,
        to_unit_interval,
    )

    step2, sub = scrt.steps[1], scrt.mirror_rescue_fit
    cells = sub.cells
    params = step2.fit.params
    spec = dataclasses.replace(step2.spec, cond_rho=True, cond_a=True)
    with torch.no_grad():
        fixed = dict(step2.fixed, rho=to_unit_interval(params["rho_raw"]),
                     a=to_positive(params["a_raw"]))
        sub_params, sub_batch = mp.slice_cells(params, step2.batch, cells)
    print(f"[kernels] on the operands of the rescue sub-fit, from its "
          f"fitted parameters ({len(cells)} cells)")
    check_one_iteration(dev, results, spec, sub.fit.params, fixed, sub_batch,
                        scrt.config.optimizer_state_dtype, "rescue sub-fit")
    rescued = dict(sub.fit.params, beta_stds_raw=params["beta_stds_raw"])
    gen = torch.Generator(device=dev).manual_seed(SEED)
    label = f"rescue {len(cells)}x{LOCI}"
    print(f"[kernels] per_cell_objective and the unfused pair on the "
          f"rescue's operands ({label})")
    for name, p in (("step-2 fit", sub_params), ("sub-fit", rescued)):
        with torch.no_grad():
            with SwapEnumFwd() as kept:
                obj_k = mp.per_cell_objective(spec, p, fixed, sub_batch)
            with SwapEnumFwd(plain=True):
                obj_p = mp.per_cell_objective(spec, p, fixed, sub_batch)
            (args,) = kept.calls
            scale = ll_scale(ek.enum_fwd_plain(*args), args[0],
                             args[4]).sum(dim=1)
            err = float(((obj_k - obj_p).abs() / scale).max())
            g = torch.randn(args[0].shape, generator=gen, device=dev)
            check_enum(results, args, g, f"{label} {name}")
            # timed with the cotangent of per_cell_objective's sum
            time_enum(results, args, torch.ones_like(g), f"{label} {name}")
        check(err <= TOL_ENUM["per_cell"] and bool(torch.isfinite(obj_k).all()),
              f"per_cell_objective {label} {name}: kernel against plain "
              f"enumeration, max |diff| / ll scale per cell {err:.3e} <= "
              f"{TOL_ENUM['per_cell']:.0e}")
        del kept, args, obj_k, obj_p
    torch.cuda.empty_cache()


def check_sync_free_chunk(dev, scrt, record) -> None:
    """The chunks of a short controlled step-2 fit of the default path
    (two chunks, ``min_iter`` at the budget so that the controller cannot
    stop it before its second, and any the controller extends it by),
    from the
    step's fitted parameters, with every launch of each chunk under
    ``torch.cuda.set_sync_debug_mode("error")``: any operation that
    waits on the card inside a chunk (a ``.item()``, a host-to-device
    copy from a Python number, a NumPy conversion) raises there.  The
    chunk's one read follows outside the guard.  A run-log session is
    open and current around the fit, and the log must hold nothing but
    its run_start and run_end: no event is emitted inside a fit.  The
    fit checkpoints after every chunk (``checkpoint_every=1``, into a
    temporary directory): the saves copy the chunk boundary's tensors to
    the host between the guarded chunks.  Then the same fit graphed (a
    compiled-program store in a temporary directory): its first chunk
    captures the graphs (a capture synchronizes, once per program) and
    runs unguarded, every later chunk replays them under the guard."""
    for graphed in (False, True):
        _sync_free_fit(dev, scrt, record, graphed)


def _sync_free_fit(dev, scrt, record, graphed: bool) -> None:
    import tempfile

    import torch
    from scdna_replication_tools_tpu_torch.infer import aotcache
    from scdna_replication_tools_tpu_torch.infer import checkpoint as ckpt
    from scdna_replication_tools_tpu_torch.infer import svi
    from scdna_replication_tools_tpu_torch.obs import runlog
    from scdna_replication_tools_tpu_torch.infer.runner import _PertLossFn
    from scdna_replication_tools_tpu_torch.obs.controller import (
        ControllerPolicy,
    )

    step = scrt.steps[1]
    cfg = scrt.config
    every = cfg.fit_diag_every
    orig = svi._launch_chunk
    guarded, free = [], []

    def launch(*a, **kw):
        if graphed and not free:
            # the capturing chunk
            out = orig(*a, **kw)
            free.append((a[3], a[4]))
            return out
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = orig(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        guarded.append((a[3], a[4]))
        return out
    svi._launch_chunk = launch
    name = "sync_chunk_graphed" if graphed else "sync_chunk"
    log_path = REPO / "chiprun_out" / f"{name}.jsonl"
    log = runlog.RunLog(str(log_path))
    err, fit, current = None, None, False
    saves = []
    with tempfile.TemporaryDirectory(prefix="pert_sync_") as ck:
        def save(*, params, opt_state, losses, num_iters, state=None,
                 exact=True):
            saves.append(int(num_iters))
            ckpt.save_step(ck, "step2", params, losses, opt_state=opt_state,
                           num_iters=num_iters, converged=False,
                           extra=ckpt.pack_controller_state(state))
        scope = aotcache.run_scope(str(Path(ck) / "store"), None) \
            if graphed else contextlib.nullcontext()
        try:
            with log.session(config=cfg, device=dev), scope:
                current = runlog.current() is log
                fit = svi.fit_map(_PertLossFn(step.spec), step.fit.params,
                                  (step.fixed, step.batch),
                                  max_iter=2 * every,
                                  min_iter=2 * every, device=dev,
                                  moment_dtype=cfg.optimizer_state_dtype,
                                  diag_every=every,
                                  controller=ControllerPolicy.from_config(
                                      cfg, 2 * every),
                                  checkpoint_every=1, checkpoint_cb=save)
        except RuntimeError as exc:
            err = f"{type(exc).__name__}: {str(exc)[:300]}"
        finally:
            svi._launch_chunk = orig
    logged = [json.loads(line)["event"]
              for line in log_path.read_text().splitlines()] \
        if log_path.exists() else []
    chunks = free + guarded
    replayed = fit is not None and fit.timings.get("replays", 0) > 0
    ok = err is None and chunks[:2] == [(0, every), (every, 2 * every)] \
        and current and logged == ["run_start", "run_end"] \
        and saves[:1] == [every] and (replayed or not graphed)
    what = (f"graphed step-2 chunks after the capturing one {free}"
            if graphed else f"step-2 chunks of up to {every} iterations")
    check(ok, f"[sync] {what} ({CELLS}x{LOCI}) under "
          f"set_sync_debug_mode('error'), a run-log session open and "
          f"current ({current}), a checkpoint after every chunk (saved at "
          f"{saves}): {'no synchronizing operation' if err is None else err}"
          f"; guarded chunks {guarded}; the session's log holds {logged}")
    record["sync_free_chunk" + ("_graphed" if graphed else "")] = {
        "ok": ok, "error": err, "saves": saves, "chunks": chunks,
        "guarded": guarded, "log": logged}


# ---------------------------------------------------------------------------
# phase 6b: CUDA graphs of the fit iteration, the store and the profiled run
# ---------------------------------------------------------------------------

# the four named ranges of the profiled run (utils/profiling.scope); a
# gauge's key is the range's full path (pert/decode/pert/qc_entropy)
GRAPH_SCOPES = ("pert/fit_step", "pert/decode", "pert/qc_entropy",
                "pert/ppc")
# a spawned process's device memory after its graphed run (its scRT
# gone) against before it: the store's graphs and pools are freed
GRAPHS_MEMORY_SLACK = 64 * 2**20
# the library whose store record the [graphs] phase truncates
GRAPHS_TRUNCATED = "adam"


def _model_frame(df):
    keys = ["cell_id", "chr", "start"]
    return df[keys + sorted(c for c in df.columns
                            if c.startswith("model_"))].copy()


def graphs_reference(scrt) -> dict:
    """What the graphed runs are held to, host copies of phase 6's run:
    every step's losses and decisions, the rescue's statistics and
    accepted cells, both frames' model columns, the QC table, each
    step's ms/iteration."""
    qc = scrt.cell_qc().copy()
    return {"losses": [s.fit.losses.copy() for s in scrt.steps],
            "decisions": [[(d["action"], d["iter"]) for d in s.fit.decisions]
                          for s in scrt.steps],
            "rescue": (dict(scrt.mirror_rescue_stats or {}),
                       sorted(qc.loc[qc["rescue_accepted"], "cell_id"])),
            "frames": [_model_frame(scrt.outputs[0]),
                       _model_frame(scrt.outputs[2])],
            "qc": qc,
            "ms_per_iter": [s.fit.timings["ms_per_iter"]
                            for s in scrt.steps]}


def _first_difference(scrt, ref):
    """None when the run's losses, decisions, rescue, model columns and
    QC table equal ``ref`` bit for bit; else what differs first."""
    got = graphs_reference(scrt)
    for i in range(3):
        if not np.array_equal(got["losses"][i], ref["losses"][i]):
            a, b = got["losses"][i], ref["losses"][i]
            n = min(len(a), len(b))
            first = int(np.argmax(a[:n] != b[:n])) if n else 0
            return (f"step{i + 1} losses (lengths {len(a)} / {len(b)}, "
                    f"first at iteration {first})")
        if got["decisions"][i] != ref["decisions"][i]:
            return f"step{i + 1} decisions {got['decisions'][i]}"
    if got["rescue"] != ref["rescue"]:
        return f"the rescue {got['rescue'][0]}"
    for name, a, b in zip(("S", "G1"), got["frames"], ref["frames"]):
        if not a.equals(b):
            cols = [c for c in a.columns if not a[c].equals(b[c])]
            return f"the {name} frame's columns {cols}"
    if not got["qc"].equals(ref["qc"]):
        return "the QC table"
    return None


def _compile_events(path) -> list:
    return [json.loads(line) for line in Path(path).read_text().splitlines()
            if '"compile"' in line]


# the decode and PPC slab programs' compile-event tags, and the steps a
# default run's events carry (the rescue gate's and the PPC's: step 2;
# the packaging decodes')
PASS_TAGS = ("decode_slab", "ppc")
PASS_STEPS = ("step2", "package_s", "package_g1")


def pass_events(events) -> list:
    """``(step, tag, cache, key_hash)`` of the decode and PPC programs'
    ``compile`` events, in the log's order."""
    return [(e.get("step"), e["tag"], e["cache"], e["key_hash"])
            for e in events if e.get("tag") in PASS_TAGS]


def check_pass_events(tag: str, passes: list, want_miss: bool) -> None:
    """A default run's decode and PPC events: both tags, the packaging's
    steps, and per program key its first event a ``miss`` (a ``hit``
    with ``want_miss`` False: the programs were captured before) and
    every later one a ``hit``."""
    first, ok = set(), True
    for step, ptag, cache, key in passes:
        want = ("miss" if want_miss else "hit") if key not in first \
            else "hit"
        first.add(key)
        ok = ok and cache == want and step in PASS_STEPS
    seq = ", ".join(f"{step} {ptag} {cache}" for step, ptag, cache, _
                    in passes)
    check(ok and {p[1] for p in passes} == set(PASS_TAGS),
          f"{tag} the decode and PPC programs' compile events, "
          f"{len(first)} program keys: "
          + ("a miss per key, then hits" if want_miss else "all hits")
          + f" ({seq})")


def _graphed_launches(scrt) -> dict:
    """Launches each kernel of the graphed default path makes: each step
    fit's (and the rescue sub-fit's) dispatched iterations, all
    replays, plus its warm-up iterations, which run eagerly before each
    capture; the rescue's scoring launches enum_fwd twice."""
    fits = [s.fit for s in scrt.steps]
    sub = scrt.mirror_rescue_fit.fit if scrt.mirror_rescue_fit else None

    def n(fit):
        return fit.timings["dispatched"] + fit.timings.get("warmups", 0) \
            if fit is not None else 0
    return {"fused_fwd_dense": n(fits[1]) + n(sub),
            "fused_bwd_dense": n(fits[1]) + n(sub),
            "fused_fwd_sparse": n(fits[2]), "fused_bwd_sparse": n(fits[2]),
            "adam": sum(n(f) for f in fits) + n(sub),
            "enum_fwd": 2 if sub is not None else 0}


def graphs_phase(dev, record, frames, ref):
    """The [graphs] phase on phase 6's frames (module docstring): the
    default config with ``executable_cache_dir`` (graphed), held bit for
    bit to phase 6; each step's graphed ms/iteration and idle share; the
    same run profiled into ``profile_dir``; the spawned processes on the
    same store (:class:`GraphsChild`, joined at the end of the script).
    Returns (the graphed run's launches, the child)."""
    import gc
    import tempfile

    import torch
    from scdna_replication_tools_tpu_torch import scRT
    from scdna_replication_tools_tpu_torch.infer import aotcache
    from scdna_replication_tools_tpu_torch.ops import _cuda
    from scdna_replication_tools_tpu_torch.utils import trace_summary

    tag = "[graphs]"
    out = REPO / "chiprun_out"
    tmp = Path(tempfile.mkdtemp(prefix="pert_graphs_"))
    store_dir = tmp / "store"
    rec = record.setdefault("graphs", {})
    cn_s, cn_g1 = frames
    base = record["main_default"]

    def run(log, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        scrt = scRT(cn_s.copy(), cn_g1.copy(), telemetry_path=str(log),
                    executable_cache_dir=str(store_dir), **kw)
        outs = scrt.infer("pert")
        torch.cuda.synchronize()
        scrt.outputs = outs
        return scrt, time.perf_counter() - t0, dict(_cuda.LAUNCHES), \
            torch.cuda.max_memory_allocated()

    log1 = out / "graphs_run.jsonl"
    scrt, wall, launches, peak = run(log1)
    diff = _first_difference(scrt, ref)
    check(diff is None, f"{tag} scRT(cn_s, cn_g1, executable_cache_dir=D) "
          "bit-equal to phase 6's eager run: every step's losses and "
          "decisions, the rescue, both frames' model columns, the QC table"
          + (f"; first difference: {diff}" if diff else ""))
    if diff:
        print(f"  {tag} ops PyTorch reports as nondeterministic: "
              f"{name_nondeterministic_ops(dev, scrt)}")
    fits = [("step1", scrt.steps[0].fit), ("step2", scrt.steps[1].fit),
            ("step3", scrt.steps[2].fit)]
    if scrt.mirror_rescue_fit is not None:
        fits.append(("rescue", scrt.mirror_rescue_fit.fit))
    events = _compile_events(log1)
    programs = [(e["step"], e["label"], e["cache"]) for e in events
                if e.get("tag") in ("chunk", "fit")]
    print(f"{tag} infer('pert') wall {wall:.2f} s (phase 6: "
          f"{base['wall_s']:.2f} s); peak device memory {peak} B (phase 6: "
          f"{base['peak_bytes']} B)")
    steps_rec = {}
    for i, (name, fit) in enumerate(fits):
        t = fit.timings
        forms = 2 if name != "rescue" else 1
        # the captures' seconds (warm-ups included) and the fit's pace
        # without them
        capture_s = sum(e.get("compile_seconds", 0.0) for e in fit.programs)
        steady = 1e3 * (t["fit"] - capture_s) / max(t["dispatched"], 1)
        line = (f"  {name}: {fit.num_iters} iterations counted, "
                f"{t['dispatched']} dispatched, {t['replays']} replays, "
                f"{t['captures']} captures ({capture_s:.3f} s), "
                f"{t['warmups']} warm-ups; {t['ms_per_iter']:.3f} "
                f"ms/iteration, {steady:.3f} ms per dispatched iteration "
                "without the captures")
        if i < 3:
            line += f" (phase 6 eager: {ref['ms_per_iter'][i]:.3f})"
        print(line)
        check(0 < t["captures"] <= forms and t["replays"] == t["dispatched"],
              f"{tag} {name}: {t['captures']} captures (at most {forms}, "
              f"the forms of its key), replays {t['replays']} = "
              f"dispatched {t['dispatched']} (the warm-ups are scratch)")
        steps_rec[name] = {k: t[k] for k in ("dispatched", "replays",
                                             "captures", "warmups",
                                             "ms_per_iter")}
        steps_rec[name].update(capture_s=capture_s, steady_ms=steady)
    order = ("step1", "step2", "rescue", "step3")   # as the log has them
    want = [(name, f"{'chunk' if name != 'rescue' else 'fit'}:{form}",
             "miss") for name in order if name in dict(fits)
            for form in (("diag", "plain") if name != "rescue"
                         else ("plain",))]
    check(programs == want, f"{tag} the run log's compile events of the "
          f"graph programs: a capture (miss) per form and fit: {programs}")
    passes = pass_events(events)
    check_pass_events(tag, passes, want_miss=True)
    libs = [(e["label"], e["cache"]) for e in events
            if e.get("tag") == "kernel_library"]
    store = aotcache.ExecutableStore(str(store_dir))
    # the library records (each captured program also leaves a record)
    every = store.entries()
    entries = [e for e in every if e["meta"].get("kind") != "program"]
    store.close()
    # each decode and PPC program's buffers, and the one graph pool they
    # share (the growth of reserved memory while their graphs were
    # captured), held to the store's estimate for the largest pass
    metas = [e["meta"] for e in every if e["meta"].get("tag") in PASS_TAGS]
    pass_bytes = sorted(
        (m["tag"], next(s for s in m["shapes"]
                        if len(s) == 2 and s[1] == LOCI),
         int(m["nbytes"])) for m in metas)
    pool = max((int(m["pool_bytes"]) for m in metas), default=0)
    estimate = max((int(m["pool_estimate"]) for m in metas), default=0)
    print(f"{tag} decode and PPC programs (tag, slab, buffers): "
          + "; ".join(f"{t} {shape} {b} B" for t, shape, b in pass_bytes)
          + f"; their shared pool {pool} B; "
          f"{sum(b for *_, b in pass_bytes) + pool} B in all")
    check(0 < pool <= estimate, f"{tag} the decode and PPC programs' pool "
          f"{pool} B within the store's estimate for the largest pass, "
          f"{estimate} B")
    check(len(entries) == len(_cuda.SOURCES) and all(
        c == "hit" for _, c in libs), f"{tag} the kernel libraries (loaded "
          f"before: {sorted(set(libs))}) saved to the store: "
          f"{len(entries)} records")
    check(aotcache.live_program_count() == 0,
          f"{tag} no program is left after the run")
    expect = _graphed_launches(scrt)
    got = {k: launches[k] for k in expect}
    check(got == expect, f"{tag} launches by replay and warm-up {got} = "
          f"dispatched + warm-up iterations {expect}")
    rec["run"] = {"wall_s": wall, "peak_bytes": peak, "steps": steps_rec,
                  "launches": launches, "programs": programs,
                  "first_difference": diff, "library_records": len(entries),
                  "passes": passes, "pass_bytes": pass_bytes,
                  "pass_pool": pool, "pass_pool_estimate": estimate}
    profile_steps(dev, scrt, record, "graphed", graphed_dir=tmp / "windows")
    busy = {k: v for k, v in record.get("profile", {}).items()
            if k.startswith(("graphed", "default"))}
    print(f"{tag} idle share, graphed against eager: " + ", ".join(
        f"{k} {v.get('idle_share', float('nan')):.3f}" for k, v in
        sorted(busy.items())))
    attribution(dev, scrt, tmp, rec)
    del scrt
    child = GraphsChild(str(store_dir))

    prof = tmp / "profile"
    log2 = out / "graphs_profiled.jsonl"
    scrt, wall2, _, _ = run(log2, profile_dir=str(prof))
    diff2 = _first_difference(scrt, ref)
    traces = sorted(Path(p).name.split(".")[0] for p in
                    prof.glob("*.trace.json.gz"))
    check(diff2 is None and traces == ["package", "step1", "step2", "step3"],
          f"{tag} profiled run ({wall2:.2f} s) bit-equal to phase 6 "
          f"({diff2 or 'no difference'}); traces {traces}: one per step fit "
          "and the packaging's")
    snap = [json.loads(line) for line in log2.read_text().splitlines()
            if '"metrics_snapshot"' in line][-1]
    gauges = {k.split('scope="', 1)[1].rstrip('"}'): v["value"]
              for k, v in snap["metrics"].items()
              if k.startswith("pert_xla_scope_seconds{")}
    step_device = sum(trace_summary.device_seconds(str(p))
                      for p in prof.glob("step*.trace.json.gz"))
    print(f"{tag} pert_xla_scope_seconds in run_end's snapshot: "
          + json.dumps(gauges) + f"; the step traces' device time "
          f"{step_device:.6f} s")
    for scope in GRAPH_SCOPES:
        keys = [k for k in gauges if k.endswith(scope)]
        check(snap["phase"] == "run_end" and keys
              and all(gauges[k] > 0 for k in keys),
              f"{tag} run_end's snapshot holds pert_xla_scope_seconds for "
              f"{scope} ({keys}) > 0")
    check(gauges.get("pert/fit_step", 0.0) <= step_device,
          f"{tag} pert/fit_step {gauges.get('pert/fit_step')} s <= the "
          f"step traces' kernel time {step_device:.6f} s")
    (out / "graphs_trace_summary.txt").write_text(
        trace_summary.summarise(str(prof), top=12))
    rec["profiled"] = {"wall_s": wall2, "traces": traces, "gauges": gauges,
                       "step_device_s": step_device,
                       "first_difference": diff2, "profile_dir": str(prof)}
    del scrt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, child


def attribution(dev, scrt, tmp, rec) -> None:
    """``pert/fit_step``'s device time against its trace's kernel time,
    for 25 eager and 25 graphed iterations of step 2 from the run's
    fitted state: a range around a replay carries the replayed kernels."""
    from scdna_replication_tools_tpu_torch.infer import aotcache
    from scdna_replication_tools_tpu_torch.infer.runner import _PertLossFn
    from scdna_replication_tools_tpu_torch.infer.svi import fit_map
    from scdna_replication_tools_tpu_torch.utils import profiling
    from scdna_replication_tools_tpu_torch.utils import trace_summary

    step = scrt.steps[1]

    def fit():
        return fit_map(_PertLossFn(step.spec), step.fit.params,
                       (step.fixed, step.batch), max_iter=25, min_iter=25,
                       device=dev, moment_dtype=scrt.config
                       .optimizer_state_dtype)
    shares = {}
    for mode in ("eager", "graphed"):
        where = tmp / f"attr_{mode}"
        scope = aotcache.run_scope(str(tmp / "attr_store"), None) \
            if mode == "graphed" else contextlib.nullcontext()
        with scope:
            fit()                      # warm (the capture, when graphed)
            with profiling.trace(str(where), label="step2"):
                fit()
        (path,) = where.glob("*.trace.json.gz")
        device = trace_summary.device_seconds(str(path))
        scoped = trace_summary.scope_totals(str(where)).get(
            "pert/fit_step", 0.0)
        shares[mode] = (scoped, device)
        check(0.9 * device <= scoped <= device,
              f"[graphs] {mode} step 2: pert/fit_step {scoped:.6f} s of the "
              f"trace's {device:.6f} s device time (>= 0.9)")
    rec["attribution"] = shares


def _graphs_child(store_dir: str, mode: str) -> dict:
    """A fresh process on the [graphs] store.  ``run``: the default
    config with the store and ``compile_cache_dir=None`` (a build
    directory of its own, so a library it does not read from the store
    runs nvcc), its compile events, and its device memory before and
    after the run; ``libraries``: each kernel library loaded through the
    store."""
    import gc
    import io
    import tempfile
    import traceback

    import torch

    rec: dict = {}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        try:
            from scdna_replication_tools_tpu_torch.ops import _cuda
            torch.cuda.init()
            if mode == "run":
                from scdna_replication_tools_tpu_torch import scRT
                cn_s, cn_g1 = simulate_frames()
                before = torch.cuda.memory_allocated(0)
                log = Path(tempfile.mkdtemp(prefix="pert_child_")) / "r.jsonl"
                scrt = scRT(cn_s, cn_g1, executable_cache_dir=store_dir,
                            compile_cache_dir=None, telemetry_path=str(log))
                scrt.infer("pert")
                events = _compile_events(log)
                rec["compile"] = [(e.get("step"), e["label"], e["cache"])
                                  for e in events]
                rec["passes"] = pass_events(events)
                del scrt
                gc.collect()
                torch.cuda.synchronize()
                rec["memory"] = (before, torch.cuda.memory_allocated(0))
            else:
                from scdna_replication_tools_tpu_torch.infer import aotcache
                _cuda.configure_build_dir(None)
                store = aotcache.ExecutableStore(store_dir)
                rec["libraries"] = {name: _cuda.load_event(name, store)
                                    for name in _cuda.SOURCES}
                store.close()
        except Exception:
            rec["error"] = traceback.format_exc()
    rec["wall_s"] = time.perf_counter() - t0
    return {"log": out.getvalue(), "record": rec}


class GraphsChild:
    """The [graphs] phase's spawned processes, one after the other in a
    thread beside the later phases: the default run on the store in a
    fresh process, then one library record truncated and a second fresh
    process loading every library through the store.  :meth:`finish`
    waits and checks them."""

    def __init__(self, store_dir: str):
        import threading

        self.store_dir = store_dir
        self.results: dict = {}
        self.t0 = time.perf_counter()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _spawn(self, mode: str) -> dict:
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        with ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) \
                as pool:
            return pool.submit(_graphs_child, self.store_dir, mode).result()

    def _run(self) -> None:
        from scdna_replication_tools_tpu_torch.infer import aotcache
        from scdna_replication_tools_tpu_torch.ops import _cuda

        try:
            self.results["run"] = self._spawn("run")
            path = aotcache.ExecutableStore(self.store_dir).path(
                _cuda.store_digest(GRAPHS_TRUNCATED)[0])
            size = os.path.getsize(path)
            with open(path, "r+b") as fh:
                fh.truncate(size // 2)
            self.results["truncated"] = (path, size)
            self.results["libraries"] = self._spawn("libraries")
        except Exception as exc:  # noqa: BLE001 — finish() reports it
            self.results["error"] = repr(exc)

    def finish(self, record) -> None:
        self.thread.join()
        tag = "[graphs child]"
        res = self.results
        print(f"{tag} joined after {time.perf_counter() - self.t0:.1f} s")
        if "error" in res:
            check(False, f"{tag} the spawned processes failed: "
                  f"{res['error']}")
            return
        run, libs = res["run"]["record"], res["libraries"]["record"]
        print(res["run"]["log"] + res["libraries"]["log"], end="")
        for part in (run, libs):
            if "error" in part:
                check(False, f"{tag} a spawned process raised:\n"
                      f"{part['error']}")
                return
        first = {}
        for step, label, cache in run["compile"]:
            if label.endswith(".cu"):
                first.setdefault(label, cache)
        before, after = run["memory"]
        print(f"{tag} run on the store in a fresh process ({run['wall_s']:.1f}"
              f" s): compile events {run['compile']}; device memory "
              f"{before} B before, {after} B after")
        check(sorted(first.values()) == ["disk_hit"] * len(first)
              and len(first) == 2,
              f"{tag} every kernel library a disk_hit from the store: "
              f"{first}")
        # a CUDA graph cannot leave its process: the fresh run captures
        # its decode and PPC programs again
        check_pass_events(tag, [tuple(p) for p in run["passes"]],
                          want_miss=True)
        check(after - before <= GRAPHS_MEMORY_SLACK,
              f"{tag} torch.cuda.memory_allocated back to its value before "
              f"the run within 64 MiB ({after - before} B): the store's "
              "graphs and pools went with the run")
        path, size = res["truncated"]
        caches = {n: e["cache"] for n, e in libs["libraries"].items()}
        print(f"{tag} {GRAPHS_TRUNCATED}'s record truncated from {size} B; "
              f"a fresh process's loads: {json.dumps(libs['libraries'])}")
        check(caches[GRAPHS_TRUNCATED] == "miss"
              and os.path.exists(path + ".bad") and os.path.exists(path)
              and all(c == "disk_hit" for n, c in caches.items()
                      if n != GRAPHS_TRUNCATED),
              f"{tag} the truncated record went to *.bad and its library was "
              f"rebuilt and saved again, the other a disk_hit: {caches}")
        record.setdefault("graphs", {})["child"] = {
            "run": run, "libraries": libs, "truncated": [path, size]}


# ---------------------------------------------------------------------------
# phase 7: durable runs (checkpoints, the kill, the resume)
# ---------------------------------------------------------------------------

DURABLE_KILL = "preempt@step2/chunk#3"
OUT_COLUMNS = ("model_tau", "model_cn_state", "model_rep_state")


def durable_reference(scrt) -> dict:
    """What the durable runs are held to, copied to the host from phase
    6's run (its device state then goes): the S frame's output columns,
    each step's losses, parameters and decisions, wall and peak."""
    rec = {"cols": {c: scrt.cn_s[c].to_numpy() for c in OUT_COLUMNS},
           "losses": [s.fit.losses for s in scrt.steps],
           "params": [{k: v.detach().cpu() for k, v in s.fit.params.items()}
                      for s in scrt.steps],
           "decisions": [[(d["action"], d["iter"]) for d in s.fit.decisions]
                         for s in scrt.steps]}
    return rec


def _same_run(scrt, ref) -> tuple:
    """(identical, where it first differs): the run's S output columns,
    every step's losses and parameters, bit for bit, against ``ref``."""
    import torch

    for c in OUT_COLUMNS:
        if not np.array_equal(scrt.cn_s[c].to_numpy(), ref["cols"][c]):
            return False, f"column {c}"
    for i, st in enumerate(scrt.steps):
        if not np.array_equal(st.fit.losses, ref["losses"][i]):
            return False, f"step{i + 1} losses"
        for k, v in ref["params"][i].items():
            got = st.fit.params[k].detach().cpu()
            if not torch.equal(got, v):
                return False, (f"step{i + 1} {k} (max abs diff "
                               f"{float((got - v).abs().max()):.3g})")
    return True, ""


def _ckpt_events(path: Path) -> list:
    return [json.loads(line) for line in path.read_text().splitlines()]


def name_nondeterministic_ops(dev, scrt) -> list:
    """The ops of a few iterations of each step that PyTorch reports as
    nondeterministic (``use_deterministic_algorithms(warn_only=True)``):
    the diagnosis when two runs of one input part."""
    import warnings

    import torch
    from scdna_replication_tools_tpu_torch.infer.runner import _PertLossFn
    from scdna_replication_tools_tpu_torch.infer.svi import fit_map

    names = set()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for st in scrt.steps:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                fit_map(_PertLossFn(st.spec), st.fit.params,
                        (st.fixed, st.batch), max_iter=3, min_iter=3,
                        device=dev,
                        moment_dtype=scrt.config.optimizer_state_dtype)
                torch.cuda.synchronize()
            names |= {str(w.message).split(" does not have")[0]
                      for w in caught if "deterministic" in str(w.message)}
    finally:
        torch.use_deterministic_algorithms(False)
    return sorted(names)


def run_health(health_dir: Path, doc: dict, resumed_at: float) -> dict:
    """The [analysis] phase's run-health checks on the durable cell's
    ``D/health/`` after the resume: the port's ``aggregate_health`` says
    every host is ``done`` with no missing rank, no alert rule of
    ``alert_rules.json`` fails, and the heartbeat's ``last_span`` names a
    span the resumed run closed."""
    from scdna_replication_tools_tpu_torch.obs import alerts, heartbeat

    tag = "[analysis health]"
    t0 = time.perf_counter()
    agg = heartbeat.aggregate_health(health_dir)
    verdicts = alerts.evaluate(alerts.load_rules(), agg)
    failing = alerts.failing(verdicts)
    secs = time.perf_counter() - t0
    last = doc.get("last_span")
    print(f"{tag} aggregate_health of the resumed durable run's health/: "
          f"states {json.dumps(agg['states'])}, {agg['hosts_seen']} of "
          f"{agg['process_count']} hosts, missing {agg['missing_ranks']}, "
          f"worst freshness {agg['worst_freshness']}; "
          f"{len(verdicts)} rules, fired "
          f"{[v['name'] for v in verdicts if v['fired']]}, failing "
          f"{[v['name'] for v in failing]} ({secs * 1e3:.1f} ms); "
          f"last_span {json.dumps(last)}")
    check(agg["hosts_seen"] >= 1 and agg["states"] == {"done":
                                                       agg["hosts_seen"]}
          and agg["missing_ranks"] == [],
          f"{tag} every host done, no missing rank: "
          f"{json.dumps(agg['states'])}, missing {agg['missing_ranks']}")
    check(not failing, f"{tag} no alert rule fails: "
          f"{[(v['name'], v['detail']) for v in failing]}")
    check(last is not None and last.get("end_unix", 0) >= round(
        resumed_at, 3), f"{tag} the heartbeat's last_span is a span the "
          f"resumed run closed: {json.dumps(last)}")
    return {"states": agg["states"], "missing_ranks": agg["missing_ranks"],
            "fired": [v["name"] for v in verdicts if v["fired"]],
            "failing": [v["name"] for v in failing], "last_span": last,
            "seconds": secs}


def durable_runs(dev, record, frames, ref) -> dict:
    """The default cell three ways with ``checkpoint_dir`` (a temporary
    directory outside the checkout): uninterrupted, killed by
    ``faults='preempt@step2/chunk#3'``, and resumed with
    ``resume='auto'`` (and ``trace_spans=True``; :func:`run_health`
    reads its ``health/``).  Checks: the kill raises SimulatedPreemption and
    its log has the fault and ends run_end 'error'; the resumed log
    restores step 1 and resumes step 2 from the killed run's last save;
    the output columns, losses and parameters of both complete runs are
    phase 6's bit for bit, and their decisions phase 6's (the resumed
    step 2's a suffix); the manifest marks every step complete; the
    heartbeat ends 'done' with its sequence number rising across the
    kill.  Prints each step's checkpoint bytes and save and load seconds
    and the walls and peaks beside phase 6's; the three logs, the
    manifest and the heartbeat go to chiprun_out/ (no checkpoint)."""
    import gc
    import shutil
    import tempfile

    import torch
    from scdna_replication_tools_tpu_torch import scRT
    from scdna_replication_tools_tpu_torch.ops import _cuda
    from scdna_replication_tools_tpu_torch.utils import faults

    cn_s, cn_g1 = frames
    out = REPO / "chiprun_out"
    tag = "[durable]"
    logs = {k: out / f"durable_{k}.jsonl"
            for k in ("uninterrupted", "killed", "resumed")}
    res: dict = {}

    def run(name, ck, **kw):
        """One run; returns (scRT, the class of what it raised, or
        None).  The exception itself is not kept: its traceback holds
        the killed fit's device tensors, which would count in the next
        run's peak."""
        scrt = scRT(cn_s.copy(), cn_g1.copy(), checkpoint_dir=ck,
                    telemetry_path=str(logs[name]), **kw)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        err = None
        try:
            scrt.infer("pert")
        except BaseException as exc:  # noqa: BLE001 — the kill is checked
            err = type(exc)
            print(f"  {tag} {name} run raised {exc!r}")
        torch.cuda.synchronize()
        res[name] = {"wall_s": time.perf_counter() - t0,
                     "peak_bytes": torch.cuda.max_memory_allocated()}
        return scrt, err

    with tempfile.TemporaryDirectory(prefix="pert_durable_") as tmp:
        ck1, ck2 = str(Path(tmp) / "uninterrupted"), str(Path(tmp) / "kill")
        _cuda.reset_launches()
        scrt, err = run("uninterrupted", ck1)
        launches = dict(_cuda.LAUNCHES)
        check(err is None, f"{tag} uninterrupted durable run completed")
        kernels = CATEGORICAL + (("enum_fwd",) if scrt.mirror_rescue_fit
                                 is not None else ())
        check(all(launches[k] > 0 for k in kernels)
              and not any(v for k, v in launches.items() if k not in kernels),
              f"{tag} every kernel of the path launched, no other kernel: "
              + json.dumps({k: v for k, v in launches.items() if v}))
        same, where = _same_run(scrt, ref)
        if not same:
            ops = name_nondeterministic_ops(dev, scrt)
            print(f"  {tag} ops PyTorch reports as nondeterministic on "
                  f"these steps: {ops or 'none'}")
            res["nondeterministic_ops"] = ops
        check(same, f"{tag} uninterrupted durable run: output columns, "
              "losses and parameters bit-identical to phase 6's"
              + (f" (first difference: {where})" if not same else ""))
        decisions = [[(d["action"], d["iter"]) for d in s.fit.decisions]
                     for s in scrt.steps]
        check(decisions == ref["decisions"],
              f"{tag} uninterrupted durable run: phase 6's decisions "
              f"{decisions}")
        manifest = json.loads((Path(ck1) / "manifest.json").read_text())
        check({k: v["status"] for k, v in manifest["steps"].items()}
              == {"step1": "complete", "step2": "complete",
                  "step3": "complete"},
              f"{tag} uninterrupted manifest: "
              + json.dumps({k: v["status"]
                            for k, v in manifest["steps"].items()}))
        events = _ckpt_events(logs["uninterrupted"])
        saves = [e for e in events if e["event"] == "checkpoint"
                 and e["action"] == "save"]
        sizes = {e["step"]: os.path.getsize(Path(ck1) / f"pert_{e['step']}"
                                            ".npz")
                 for e in saves}
        for step in ("step1", "step2", "step3"):
            mine = [e for e in saves if e["step"] == step]
            print(f"  {tag} {step}: {len(mine)} saves ("
                  + ", ".join(f"it {e['num_iters']}: {e['bytes']} B in "
                              f"{e['seconds']:.3f} s" for e in mine)
                  + f"); file {sizes.get(step)} B")
        res["saves"] = [{k: e[k] for k in ("step", "num_iters", "bytes",
                                           "seconds", "completed")}
                        for e in saves]
        del scrt
        torch.cuda.empty_cache()
        shutil.rmtree(ck1)

        scrt, err = run("killed", ck2, faults=DURABLE_KILL)
        faults.install(None)
        killed = _ckpt_events(logs["killed"])
        check(err is faults.SimulatedPreemption,
              f"{tag} {DURABLE_KILL} raised "
              f"{getattr(err, '__name__', None)}")
        check(any(e["event"] == "fault_injected" for e in killed)
              and killed[-1]["event"] == "run_end"
              and killed[-1]["status"] == "error",
              f"{tag} killed log: fault_injected, last line run_end status "
              f"{killed[-1].get('status')}")
        saved2 = [e["num_iters"] for e in killed
                  if e["event"] == "checkpoint" and e["step"] == "step2"]
        hb_path = Path(ck2) / "health" / "host_0.json"
        hb_killed = json.loads(hb_path.read_text())
        del scrt
        torch.cuda.empty_cache()

        # the resume traces its spans (pure observability, outside the
        # config hash), so its heartbeat carries the last one it closed
        resumed_at = time.time()
        scrt, err = run("resumed", ck2, trace_spans=True)
        check(err is None, f"{tag} resumed run completed")
        resumed = _ckpt_events(logs["resumed"])
        resumes = {e["step"]: e for e in resumed if e["event"] == "resume"}
        check(resumes.get("step1", {}).get("action") == "restored"
              and resumes.get("step2", {}).get("action") == "resumed"
              and saved2 and resumes["step2"]["from_iter"] == saved2[-1]
              and all(e["fingerprint_verified"] for e in resumes.values()),
              f"{tag} resumed log: step1 "
              f"{resumes.get('step1', {}).get('action')}, step2 "
              f"{resumes.get('step2', {}).get('action')} from iteration "
              f"{resumes.get('step2', {}).get('from_iter')} (the killed "
              f"run's step-2 saves: {saved2})")
        same, where = _same_run(scrt, ref)
        check(same, f"{tag} resumed run: output columns, losses and "
              "parameters bit-identical to phase 6's and the uninterrupted "
              "durable run's" + (f" (first difference: {where})"
                                 if not same else ""))
        got = [[(d["action"], d["iter"]) for d in s.fit.decisions]
               for s in scrt.steps]
        start = resumes.get("step2", {}).get("from_iter", 0)
        want = [[], [d for d in ref["decisions"][1] if d[1] > start],
                ref["decisions"][2]]
        check(got == want, f"{tag} resumed decisions {got}: the suffix of "
              f"phase 6's {ref['decisions']} after the restore")
        manifest = json.loads((Path(ck2) / "manifest.json").read_text())
        check({k: v["status"] for k, v in manifest["steps"].items()}
              == {"step1": "complete", "step2": "complete",
                  "step3": "complete"},
              f"{tag} resumed manifest: "
              + json.dumps({k: v["status"]
                            for k, v in manifest["steps"].items()}))
        hb_done = json.loads(hb_path.read_text())
        check(hb_killed["state"] == "running" and hb_done["state"] == "done"
              and hb_done["seq"] > hb_killed["seq"],
              f"{tag} heartbeat: killed run left state "
              f"{hb_killed['state']} at seq {hb_killed['seq']}, the resume "
              f"ended {hb_done['state']} at seq {hb_done['seq']}")
        res["health"] = run_health(Path(ck2) / "health", hb_done,
                                   resumed_at)
        loads = [e for e in resumed if e["event"] == "checkpoint"
                 and e["action"] == "load"]
        for e in loads:
            print(f"  {tag} load {e['step']} (it {e['num_iters']}, "
                  f"{'complete' if e['completed'] else 'partial'}): "
                  f"{e['bytes']} B in {e['seconds']:.3f} s")
        res["loads"] = [{k: e[k] for k in ("step", "num_iters", "bytes",
                                           "seconds", "completed")}
                        for e in loads]
        shutil.copyfile(Path(ck2) / "manifest.json",
                        out / "durable_manifest.json")
        shutil.copyfile(hb_path, out / "durable_heartbeat.json")
        del scrt
        torch.cuda.empty_cache()

    gc.collect()
    base = record["main_default"]
    for name in ("uninterrupted", "killed", "resumed"):
        print(f"  {tag} {name}: wall {res[name]['wall_s']:.2f} s, peak "
              f"{res[name]['peak_bytes']} B (phase 6: "
              f"{base['wall_s']:.2f} s, {base['peak_bytes']} B)")
    record["durable"] = res
    return launches


# ---------------------------------------------------------------------------
# phase 5: where each step's time goes
# ---------------------------------------------------------------------------

PROFILE_ITERS = 30
PORT_KERNELS = ("fused_fwd_kernel", "fused_bwd_kernel", "adam_kernel",
                "enum_fwd_kernel", "enum_bwd_kernel")


def _short(kernel: str) -> str:
    for noise in ("void ", "(anonymous namespace)::", "at::native::"):
        kernel = kernel.replace(noise, "")
    return kernel[:100]


def profile_steps(dev, scrt, record, path: str,
                  steps=("step1", "step2", "step3"), graphed_dir=None):
    """Device time by kernel over a window of iterations of each of
    ``steps``, from torch.profiler, against the same window's unprofiled
    wall: the idle share is the part of an iteration in which the card
    runs nothing (Python dispatch and the per-iteration loss read).  Each
    window is a fresh fit from the step's fitted parameters; with
    ``graphed_dir`` the windows of a step replay CUDA graphs from one
    store there (the first window, which warms the allocator, captures
    them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from scdna_replication_tools_tpu_torch.infer import aotcache
    from scdna_replication_tools_tpu_torch.infer.runner import _PertLossFn
    from scdna_replication_tools_tpu_torch.infer.svi import fit_map

    mdt = scrt.config.optimizer_state_dtype
    prof_record = record.setdefault("profile", {})
    for name, step in zip(("step1", "step2", "step3"), scrt.steps):
        if name not in steps:
            continue

        def window():
            return fit_map(_PertLossFn(step.spec), step.fit.params,
                           (step.fixed, step.batch), max_iter=PROFILE_ITERS,
                           min_iter=PROFILE_ITERS, device=dev,
                           moment_dtype=mdt)

        scope = contextlib.nullcontext() if graphed_dir is None else \
            aotcache.run_scope(str(graphed_dir), None)
        with scope:
            window()                          # warm the allocator
            wall_ms = window().timings["ms_per_iter"]
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                window()
        by_name: dict = {}
        for ev in prof.key_averages():
            # the named ranges' device spans (utils/profiling.scope)
            # cover kernels that count on their own
            if ev.device_type != DeviceType.CUDA \
                    or ev.key.startswith("pert/"):
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            key = _short(ev.key)
            by_name[key] = by_name.get(key, 0.0) + us / 1e3 / PROFILE_ITERS
        busy = sum(by_name.values())
        key = f"{path} {name}"
        if busy == 0.0:
            print(f"[profile] {key}: torch.profiler saw no device time; "
                  "device busy and idle share not measured")
            prof_record[key] = {"wall_ms_per_iter": wall_ms,
                                "busy_ms_per_iter": None}
            continue
        port = sum(v for k, v in by_name.items()
                   if any(p in k for p in PORT_KERNELS))
        print(f"[profile] {key}, {PROFILE_ITERS} iterations: unprofiled "
              f"{wall_ms:.3f} ms/iteration; device busy {busy:.3f} "
              f"ms/iteration (idle share {1.0 - busy / wall_ms:.3f}); the "
              f"port's kernels {port:.3f} ms, PyTorch's {busy - port:.3f} ms "
              f"over {len(by_name)} kernel names")
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        for kernel, ms in top[:10]:
            print(f"  {ms:8.4f} ms/iteration {ms / busy:6.1%}  {kernel}")
        prof_record[key] = {
            "iters": PROFILE_ITERS, "wall_ms_per_iter": wall_ms,
            "busy_ms_per_iter": busy, "idle_share": 1.0 - busy / wall_ms,
            "port_kernels_ms_per_iter": port,
            "kernels_ms_per_iter": dict(top)}


# ---------------------------------------------------------------------------
# phase 10: the unlabelled path (clone discovery, chunked fit, Viterbi,
# the deterministic levels, SPF, the command line)
# ---------------------------------------------------------------------------

UNLABELLED_CHUNK = 256
UNLABELLED_HMM = 0.99
# the deterministic levels' rt_state against the simulated replication
# state, bars set before the first run on the card (PERF.md §6)
LEVEL_BARS = {"clone": 0.85, "bulk": 0.75, "cell": 0.70}
# the columns a simulator input carries (with an rt column per clone)
SIM_INPUT = ["cell_id", "chr", "start", "gc", "library_id", "clone_id",
             "true_somatic_cn"]
# a listed cut (S cells) of the cell level, whose per-cell changepoint
# rounds took 63 s at 1000 S cells and would push the script past its
# time limit; the clone and bulk levels run whole
LEVEL_CUT = {"clone": None, "bulk": None, "cell": 250}
# the LOWESS curve on the card is held against its float64 CPU run on
# the G1 points of the first loci only (the CPU took 7-10 s for all
# 5451); the card's time is taken on all of them
LOWESS_CPU_LOCI = 1000
# the Viterbi paths are compared with the CPU's on the first cells only
# (the CPU takes 18 s for all 1024)
VITERBI_CPU_CELLS = 128
# the CLI's listed cut, at its default --max-iter: writing the TSVs
# costs minutes of host time (200 S + 100 G1 cells took 148 s through
# the three functions; run in a row with the other phases, the whole
# script took 1103 s of its 1200 s on an H100 machine)
CLI_CUT = (200, 100)
# the LOWESS curve on the card against the float64 CPU plain version,
# relative (summation order only)
TOL_LOWESS = 1e-9
# the chunked objective against the unchunked one from the same state
TOL_CHUNKED = 1e-5


def unlabelled_frames(frames) -> tuple:
    """The frames without clone_id: a lab's sample with no clone labels;
    also the simulated clone of each G1 cell."""
    cn_s, cn_g1 = frames
    truth = cn_g1.drop_duplicates("cell_id").set_index("cell_id")["clone_id"]
    return (cn_s.drop(columns=["clone_id"]),
            cn_g1.drop(columns=["clone_id"])), truth


def adjusted_rand(a, b) -> float:
    """Adjusted Rand index of two labelings (no sklearn on the card's
    machine)."""
    import pandas as pd
    a = pd.factorize(np.asarray(a))[0]
    b = pd.factorize(np.asarray(b))[0]
    ct = np.zeros((a.max() + 1, b.max() + 1))
    np.add.at(ct, (a, b), 1)

    def pairs(x):
        return x * (x - 1) / 2.0

    sum_ij = pairs(ct).sum()
    sa, sb = pairs(ct.sum(1)).sum(), pairs(ct.sum(0)).sum()
    expected = sa * sb / pairs(len(a))
    top = (sa + sb) / 2.0
    return float((sum_ij - expected) / (top - expected)) \
        if top != expected else 1.0


def check_simulator(dev, frames, record, card) -> None:
    """The port's ``pert_simulator`` on the card at the full shape, and
    ``simulate_s_reads`` on the card against its plain CPU run with the
    card's tau, beta-noise and replication draws handed in through the
    seam: phi, theta and delta to float32 rounding, the NB counts to
    their moments."""
    import torch
    from scdna_replication_tools_tpu_torch.models import simulator as sim

    cn_s, cn_g1 = frames
    rts = CLONE_RT[SEED]
    # the simulator's input: the frames' CN, without their simulated reads
    s_in, g_in = cn_s[SIM_INPUT].copy(), cn_g1[SIM_INPUT].copy()
    for clone, rt in rts.items():
        # the frames hold each cell's loci in the profiles' order
        s_in[f"rt_{clone}"] = np.tile(rt, len(s_in) // LOCI)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim_s, sim_g = sim.pert_simulator(
        s_in, g_in, 1_000_000, [f"rt_{c}" for c in rts], list(rts), 0.75,
        [0.5, 0.0], 10.0, seed=SEED, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"[unlabelled simulator] {card}: pert_simulator on {dev}, "
          f"{CELLS} S + {G1_CELLS} G1 cells x {LOCI} loci, "
          f"{len(rts)} clones: {wall:.2f} s")
    check(len(sim_s) == CELLS * LOCI and len(sim_g) == G1_CELLS * LOCI
          and bool(np.isfinite(sim_s["true_reads_norm"]).all())
          and bool(np.isfinite(sim_g["true_reads_norm"]).all()),
          "[unlabelled] pert_simulator covers every bin, reads finite")

    # the S sampler of one clone on the card, then on the CPU with the
    # card's draws
    first = s_in[s_in["clone_id"] == "C0"]
    cn = first["true_somatic_cn"].to_numpy(np.float32).reshape(-1, LOCI)
    gc = first["gc"].to_numpy(np.float32)[:LOCI]
    rho = sim.convert_rt_units(rts["C0"])
    libs = np.zeros(cn.shape[0], np.int32)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    on_card = sim.simulate_s_reads(gen, cn, gc, rho, libs, 1e6, 0.75,
                                   [0.5, 0.0], 10.0)
    stds = torch.logspace(0.0, -1, 2, dtype=torch.float32, device=dev)
    noise = (on_card["betas"] - torch.tensor([0.5, 0.0], device=dev)) \
        / stds
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(SEED)
    plain = sim.simulate_s_reads(cpu_gen, cn, gc, rho, libs, 1e6, 0.75,
                                 [0.5, 0.0], 10.0,
                                 tau=on_card["tau"].cpu(),
                                 beta_noise=noise.cpu(),
                                 rep=on_card["rep"].cpu())
    errs = {k: float(torch.max(torch.abs(on_card[k].cpu() - plain[k])
                               / torch.clamp(torch.abs(plain[k]), min=1.0)))
            for k in ("p_rep", "theta", "delta")}
    reads = on_card["reads"].double()
    # NB(delta, 0.75): mean 3 delta (theta where delta is not clamped to
    # 1), variance mean + mean^2 / delta, so the standardized residuals'
    # mean square is 1 in expectation
    mean = on_card["delta"].double() * 3.0
    ratio = float(reads.sum() / mean.sum())
    var = mean + mean ** 2 / on_card["delta"].double()
    z2 = float(torch.mean((reads - mean) ** 2 / var))
    print(f"  simulate_s_reads: card vs CPU with the card's draws, max "
          f"relative error {json.dumps(errs)}; NB counts: sum/sum(mean) "
          f"{ratio:.6f}, mean squared standardized residual {z2:.4f}")
    check(all(v < 1e-5 for v in errs.values()),
          "[unlabelled] simulator's phi, theta, delta on the card equal "
          "its CPU run's within 1e-5")
    check(abs(ratio - 1.0) < 1e-3 and abs(z2 - 1.0) < 0.02,
          "[unlabelled] simulator's NB counts hold their mean (1e-3) and "
          "variance (2 %)")
    record["unlabelled"].update(simulator_s=wall, simulator_err=errs,
                                nb_ratio=ratio, nb_z2=z2)


def check_unlabelled_fit(dev, scrt, truth, record, card) -> None:
    """What the unlabelled run must show beyond main_path's checks: the
    clones k-means found, the chunked objective against the unchunked
    one, the Viterbi paths on the card against the CPU's."""
    import dataclasses
    import torch
    from scdna_replication_tools_tpu_torch.models import hmm
    from scdna_replication_tools_tpu_torch.models import pert as pert_mod
    from scdna_replication_tools_tpu_torch.utils.chrom import (
        as_chr_categorical,
    )

    rec = record["unlabelled"]
    found = scrt.cn_g1.drop_duplicates("cell_id").set_index("cell_id")[
        scrt.clone_col]
    k = int(found.nunique())
    ari = adjusted_rand(found.to_numpy(),
                        truth.reindex(found.index).to_numpy())
    prep = scrt.phase_report.get("clone_prep", float("nan"))
    print(f"[unlabelled fit] {card}: k-means on {dev} chose k = {k}, "
          f"ARI {ari:.4f} against the simulated clones; clone_prep "
          f"{prep:.2f} s (k-means, consensus, assignment)")
    check(scrt.clone_col == "cluster_id" and k == CLONES,
          f"[unlabelled] k-means picks k = {k} = {CLONES}")
    check(ari == 1.0, f"[unlabelled] ARI {ari:.4f} = 1.0")

    # chunked against unchunked, from step 2's fitted state
    st = scrt.steps[1]
    whole = dataclasses.replace(st.spec, cell_chunk=None)

    def loss_and_grads(spec):
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in st.fit.params.items()}
        loss = pert_mod.pert_loss(spec, params, st.fixed, st.batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        return float(loss.detach()), dict(zip(params, grads))

    # both sides add the same parameter-free Dirichlet normaliser (~1.7e11
    # at this shape, against a loss of ~1e9), whose float32 sum would set
    # the loss's rounding: the comparison leaves it out of both, so the
    # loss compared is the priors and the kernels' data term
    cache = st.batch.cache
    norm = cache["dir_norm"]
    cache["dir_norm"] = torch.zeros_like(norm)
    try:
        l_ch, g_ch = loss_and_grads(st.spec)
        l_wh, g_wh = loss_and_grads(whole)
    finally:
        cache["dir_norm"] = norm
    rel = abs(l_ch - l_wh) / abs(l_wh)
    grad_rel = {k: float(torch.max(torch.abs(g_ch[k] - g_wh[k]))
                         / max(float(torch.max(torch.abs(g_wh[k]))), 1e-30))
                for k in g_wh if g_wh[k] is not None}
    print(f"  step 2 at its fitted state, loss without the normaliser: "
          f"chunked {l_ch:.9g}, unchunked {l_wh:.9g} (relative difference "
          f"{rel:.3g}); gradients' max relative error "
          f"{max(grad_rel.values()):.3g} ({max(grad_rel, key=grad_rel.get)})")
    check(rel <= TOL_CHUNKED and max(grad_rel.values()) <= TOL_CHUNKED,
          f"[unlabelled] chunked loss and gradients equal the unchunked "
          f"ones within {TOL_CHUNKED}")
    del g_ch, g_wh
    st.batch.cache.pop("etas_t", None)

    # Viterbi on the card against the CPU, on the same emissions
    with torch.no_grad():
        joint = pert_mod.model_joint_logits(st.spec, st.fit.params,
                                            st.fixed, st.batch)
        emissions = torch.logsumexp(joint, dim=-1)
        del joint
    # the chain restarts where the loader's loci (genome order: the
    # chromosome's rank, then start) change chromosome
    loci = scrt.cn_s.drop_duplicates(["chr", "start"])[["chr", "start"]]
    loci = loci.assign(chr=as_chr_categorical(loci["chr"]))
    chroms = loci.sort_values(["chr", "start"])["chr"].astype(str) \
        .to_numpy()
    restart = np.r_[1.0, (chroms[1:] != chroms[:-1]).astype(np.float32)]
    trans = hmm.transition_log_probs(P, UNLABELLED_HMM, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on_card = hmm.viterbi_paths(emissions, restart, trans)
    torch.cuda.synchronize()
    vit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    on_cpu = hmm.viterbi_paths(emissions[:VITERBI_CPU_CELLS].cpu(), restart,
                               trans.cpu())
    cpu_s = time.perf_counter() - t0
    same = bool(torch.equal(on_card[:VITERBI_CPU_CELLS].cpu(), on_cpu))
    print(f"  Viterbi of {emissions.shape[0]} cells x {LOCI} loci: card "
          f"{vit_s:.3f} s; the first {VITERBI_CPU_CELLS} cells' paths on "
          f"the CPU ({cpu_s:.3f} s) {'equal' if same else 'DIFFER FROM'} "
          "the card's")
    check(same, "[unlabelled] Viterbi paths on the card equal the CPU's "
          "bit for bit")
    rec.update(k=k, ari=ari, clone_prep_s=prep, chunked_loss_rel=rel,
               chunked_grad_rel=grad_rel, viterbi_s=vit_s,
               viterbi_cpu_s=cpu_s, viterbi_equal=same)


def check_lowess(dev, frames, record, card) -> None:
    """The LOWESS curve of the G1 rpm against GC on the card over every
    point, then card against its float64 CPU run on the first loci's
    points."""
    import torch
    from scdna_replication_tools_tpu_torch.pipeline import gc_correction

    rec = record["unlabelled"]
    cn_s, cn_g1 = frames
    # the LOWESS curve of the G1 rpm against GC: on the card over every
    # point, then card against CPU on the first loci's points
    g1 = gc_correction.compute_reads_per_million(cn_g1)
    xv = np.sort(cn_s["gc"].unique())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gc_correction.lowess(g1["rpm"].to_numpy(), g1["gc"].to_numpy(), xv,
                         device=dev)
    card_s = time.perf_counter() - t0
    cut = g1[g1.groupby("cell_id").cumcount() < LOWESS_CPU_LOCI]
    x_cut = np.sort(cut["gc"].unique())
    curve = gc_correction.lowess(cut["rpm"].to_numpy(),
                                 cut["gc"].to_numpy(), x_cut, device=dev)
    t0 = time.perf_counter()
    plain = gc_correction.lowess(cut["rpm"].to_numpy(),
                                 cut["gc"].to_numpy(), x_cut, device="cpu")
    cpu_s = time.perf_counter() - t0
    lowess_rel = float(np.max(np.abs(curve - plain) / np.abs(plain)))
    print(f"[unlabelled levels] {card}: LOWESS over {len(g1)} G1 points "
          f"({len(np.unique(g1['gc']))} distinct GC values) on the card "
          f"{card_s:.3f} s; on the first {LOWESS_CPU_LOCI} loci's "
          f"{len(cut)} points the float64 CPU plain version took "
          f"{cpu_s:.3f} s, max relative difference {lowess_rel:.3g}")
    check(lowess_rel <= TOL_LOWESS,
          f"[unlabelled] LOWESS on the card equals the CPU's within "
          f"{TOL_LOWESS}")
    rec.update(lowess_s=card_s, lowess_cpu_s=cpu_s, lowess_rel=lowess_rel)


def levels_spf(dev, frames, record, card) -> None:
    """The deterministic levels on the unlabelled frames (k-means again,
    rt_state against the simulated replication state) and SPF."""
    import torch
    from scdna_replication_tools_tpu_torch import SPF, scRT

    rec = record["unlabelled"]
    cn_s, cn_g1 = frames
    print(f"[unlabelled levels] {card}: the levels and SPF on {dev}, in a "
          "process beside phase 11")
    levels = {}
    for level in ("clone", "bulk", "cell"):
        cut = LEVEL_CUT[level]
        s_in = cn_s if cut is None else \
            cn_s[cn_s["cell_id"].isin(cn_s["cell_id"].unique()[:cut])]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out, supp_s, out_g1, supp_g1 = scRT(
            s_in.copy(), cn_g1.copy(), clone_col=None).infer(level)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        acc = float((out["rt_state"] == out["true_rep"]).mean())
        cols = ("rt_value", "rt_state", "frac_rt", "binary_thresh")
        n_s = int(s_in["cell_id"].nunique())
        levels[level] = {"wall_s": wall, "rt_state_acc": acc,
                         "rows": len(out), "s_cells": n_s,
                         "peak_bytes": torch.cuda.max_memory_allocated()}
        print(f"  level={level}: {n_s} S cells, {wall:.2f} s, "
              f"{len(out)} rows, rt_state "
              f"against true_rep {acc:.4f} (bar {LEVEL_BARS[level]}), "
              f"peak {levels[level]['peak_bytes']} bytes")
        check(all(c in out.columns for c in cols) and supp_s.empty
              and out_g1.empty and supp_g1.empty,
              f"[unlabelled] level={level} adds {list(cols)}, the other "
              "three frames empty")
        check(acc > LEVEL_BARS[level],
              f"[unlabelled] level={level} rt_state accuracy {acc:.4f} > "
              f"{LEVEL_BARS[level]}")
    rec["levels"] = levels

    t0 = time.perf_counter()
    spf_cells, spf = SPF(cn_s.copy(), cn_g1.copy(), clone_col=None).infer()
    spf_s = time.perf_counter() - t0
    print(f"  SPF (clones by k-means on {dev}, max_k 100): {spf_s:.2f} s, "
          f"{len(spf)} clones: " + "; ".join(
              f"{r.clone_id}: {r.SPF:.3f} +- {r.SPF_std:.3f} "
              f"({r.num_s} S, {r.num_g} G1)" for r in spf.itertuples()))
    check(int(spf["num_s"].sum()) == CELLS
          and int(spf["num_g"].sum()) == G1_CELLS
          and bool(spf["SPF"].between(0, 1).all())
          and bool(np.isfinite(spf["SPF_std"]).all()),
          "[unlabelled] SPF counts every cell, fractions in [0, 1]")
    rec.update(spf_s=spf_s, spf_clones=len(spf))


def cli_drive(frames, rec, card) -> None:
    """simulator_main (on the labelled frames: it simulates clone by
    clone), then infer_scrt_main (pert, then --level clone) and
    infer_spf_main without the clone labels, through TSVs, on the first
    ``CLI_CUT`` cells."""
    import tempfile
    import pandas as pd
    from scdna_replication_tools_tpu_torch import cli

    cn_s, cn_g1 = frames
    n_s, n_g = CLI_CUT
    rts = CLONE_RT[SEED]
    keep_s = cn_s["cell_id"].isin(cn_s["cell_id"].unique()[:n_s])
    keep_g = cn_g1["cell_id"].isin(cn_g1["cell_id"].unique()[:n_g])
    s_in = cn_s.loc[keep_s, SIM_INPUT].copy()
    g_in = cn_g1.loc[keep_g, SIM_INPUT].copy()
    for clone, rt in rts.items():
        s_in[f"rt_{clone}"] = np.tile(rt, n_s)
    walls = {}
    with tempfile.TemporaryDirectory(prefix="pert-cli-") as tmp:
        d = Path(tmp)
        s_in.to_csv(d / "s_in.tsv", sep="\t", index=False)
        g_in.to_csv(d / "g_in.tsv", sep="\t", index=False)
        t0 = time.perf_counter()
        cli.simulator_main([
            "-si", str(d / "s_in.tsv"), "-gi", str(d / "g_in.tsv"),
            "-n", "1000000", "-l", "0.75", "-a", "10", "-b", "0.5", "0.0",
            "-rt", *[f"rt_{c}" for c in rts], "-c", *rts,
            "-so", str(d / "sim_s.tsv"), "-go", str(d / "sim_g.tsv")])
        walls["simulator_main"] = time.perf_counter() - t0
        for name in ("sim_s", "sim_g"):
            df = pd.read_csv(d / f"{name}.tsv", sep="\t", dtype={"chr": str})
            df = df.drop(columns=["clone_id"])
            df["reads"] = df["true_reads_norm"]
            df["state"] = df["true_somatic_cn"].astype(int)
            df["copy"] = df["true_somatic_cn"].astype(float)
            df.to_csv(d / f"{name}_in.tsv", sep="\t", index=False)
        inputs = [str(d / "sim_s_in.tsv"), str(d / "sim_g_in.tsv")]
        t0 = time.perf_counter()
        cli.infer_scrt_main(inputs + [
            str(d / "out.tsv"), str(d / "supp.tsv"), "--clone-col", "none",
            "--telemetry", "none"])
        walls["infer_scrt_main pert"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli.infer_scrt_main(inputs + [
            str(d / "clone.tsv"), str(d / "clone_supp.tsv"), "--clone-col",
            "none", "--level", "clone"])
        walls["infer_scrt_main clone"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cli.infer_spf_main(inputs + [
            str(d / "spf_s.tsv"), str(d / "spf.tsv"), "--clone-col", "none"])
        walls["infer_spf_main"] = time.perf_counter() - t0
        out = pd.read_csv(d / "out.tsv", sep="\t", dtype={"chr": str})
        clone = pd.read_csv(d / "clone.tsv", sep="\t", dtype={"chr": str})
        spf = pd.read_csv(d / "spf.tsv", sep="\t")
        supp = pd.read_csv(d / "supp.tsv", sep="\t")
    rep_acc = float((out["model_rep_state"] == out["true_rep"]).mean())
    print(f"[unlabelled cli] {card}: {n_s} S + {n_g} G1 cells x {LOCI} "
          "loci through TSVs: " + ", ".join(
              f"{k} {v:.2f} s" for k, v in walls.items())
          + f"; pert rep-state accuracy {rep_acc:.4f}")
    check(len(out) == n_s * LOCI and rep_acc > 0.80
          and {"model_cn_state", "model_rep_state", "model_tau",
               "cluster_id"} <= set(out.columns)
          and "model_lambda" in set(supp["param"]),
          f"[unlabelled] CLI pert output covers every bin with the model "
          f"columns, rep-state accuracy {rep_acc:.4f} > 0.80")
    check({"rt_value", "rt_state", "frac_rt", "binary_thresh"}
          <= set(clone.columns) and len(spf) > 0
          and {"SPF", "SPF_std", "num_s", "num_g"} <= set(spf.columns),
          "[unlabelled] CLI clone level and SPF tables carry their columns")
    rec["cli_s"] = walls


def unlabelled(dev, record, frames, card, results) -> dict:
    """Phase 10: the path of a lab whose sample has no clone labels, on
    the full-width frames without clone_id.  Its host-bound tail (the
    levels, SPF, the CLI) runs in a process of its own beside phase 11
    (:class:`HostTail`)."""
    import torch
    record["unlabelled"] = {}
    bare, truth = unlabelled_frames(frames)
    t0 = time.perf_counter()
    check_simulator(dev, frames, record, card)
    launches, scrt = main_path(dev, record, bare, "unlabelled")
    check_unlabelled_fit(dev, scrt, truth, record, card)
    # the kernels at the chunk shapes this path gave them
    check_main_path_shapes(dev, scrt, results, "unlabelled")
    del scrt
    torch.cuda.empty_cache()
    check_lowess(dev, bare, record, card)
    record["unlabelled"]["wall_s"] = time.perf_counter() - t0
    print(f"[unlabelled] {card}: phase {record['unlabelled']['wall_s']:.1f} "
          "s (without the tail that runs beside phase 11)")
    return launches


# ---------------------------------------------------------------------------
# the [analysis] phase: phase calling, cell-cycle features and the pivot
# on the default cell's frames (in the spawned process beside phase 11);
# its run-health checks run at the end of phase 7
# ---------------------------------------------------------------------------

# JAX's bar for simulated S cells called S (tests/test_d1_shape.py:147),
# and the same bar for simulated G1 cells called G1/2 or LQ.  On these
# frames the phase caller does not reach it for S cells even on the
# simulated states themselves (true_rep, true_somatic_cn): 74 of 100 and
# 271 of 400 simulated S cells called S on cuts of seed 0's frames (on
# the CPU; the rest LQ, rep autocorrelation > 0.2 along the smooth
# simulated timing, or G1/2, replicated fraction outside (0.05, 0.95)).
# So the S share on the card's output is held to that of the simulated
# states less PHASE_SLACK, each cell's label to the one the simulated
# states give it for PHASE_AGREE of the cells, and the S share against
# 0.7 is printed; the G1 share is held to 0.7
PHASE_BAR = 0.7
PHASE_SLACK = 0.02
PHASE_AGREE = 0.9
# the cell-cycle features on the card against the same call on the CPU:
# lrs within 1e-5 of max(1, |lrs|) -- a few float32 ulps of the 2-GMM's
# mean log-likelihood, which lrs is the difference of (the float32 EM on
# the CPU read 2.5e-7-3.8e-7 against a float64 EM and 4.3e-7-4.6e-7
# against JAX's; tests/test_torch_ccc_features.py); the other feature
# columns are float64 host work and must be equal
TOL_LRS = 1e-5
CCC_EXACT = ("madn", "breakpoints", "corrected_madn",
             "corrected_breakpoints")
# the columns of the default cell's output that the analysis reads
ANALYSIS_COLS = ["cell_id", "chr", "start", "clone_id", "reads", "state",
                 "model_rep_state", "model_cn_state", "true_rep",
                 "true_somatic_cn"]
# the loader's four pivots of a run (data/loader.build_pert_inputs)
PIVOTS = (("s", "reads"), ("g1", "reads"), ("g1", "state"), ("s", "state"))


def analysis_input(out_s, out_g1):
    """concat(cn_s_out, cn_g1_out) with ``rpm`` formed as JAX's
    tests/test_d1_shape.py:140-141 forms it."""
    import pandas as pd

    cn = pd.concat([out_s[ANALYSIS_COLS], out_g1[ANALYSIS_COLS]],
                   ignore_index=True)
    cn["rpm"] = cn["reads"] / cn.groupby("cell_id")["reads"] \
        .transform("sum") * 1e6
    return cn


def analysis(dev, frames, cn, load_s, card) -> dict:
    """Phase calling, the cell-cycle features (the 2-GMM on the card and
    on the CPU) and the loader's pivots through the library and NumPy."""
    import importlib.metadata
    import importlib.util

    import pandas as pd
    import torch
    from scdna_replication_tools_tpu_torch.data.loader import pivot_matrix
    from scdna_replication_tools_tpu_torch.pipeline.ccc_features import (
        compute_ccc_features,
    )
    from scdna_replication_tools_tpu_torch.pipeline.phase import (
        predict_cycle_phase,
    )

    rec: dict = {}
    tag = "[analysis]"
    n_cells = cn["cell_id"].nunique()
    print(f"{tag} {card}: on the default cell's output, {n_cells} cells x "
          f"{LOCI} loci ({len(cn)} rows), in a process beside phase 11")
    mpl = importlib.util.find_spec("matplotlib")
    mpl_version = importlib.metadata.version("matplotlib") if mpl else None
    print(f"{tag} matplotlib: {mpl_version or 'absent'} (no plotting on "
          "the card)")
    rec["matplotlib"] = mpl_version

    def call(frame):
        t0 = time.perf_counter()
        phased = predict_cycle_phase(frame)
        secs = time.perf_counter() - t0
        labels = pd.concat(phased, ignore_index=True) \
            .groupby("cell_id")["PERT_phase"].first()
        return labels, secs, float(
            (labels[labels.index.str.startswith("s_")] == "S").mean())

    labels, phase_s, s_share = call(cn.drop(columns=["true_rep",
                                                     "true_somatic_cn"]))
    truth, _, s_truth = call(cn.drop(columns=[
        "model_rep_state", "model_cn_state"]).rename(columns={
            "true_rep": "model_rep_state",
            "true_somatic_cn": "model_cn_state"}))
    counts = {k: int(v) for k, v in labels.value_counts().items()}
    g_share = float(labels[labels.index.str.startswith("g_")]
                    .isin(["G1/2", "LQ"]).mean())
    agree = float((labels == truth.reindex(labels.index)).mean())
    print(f"{tag} predict_cycle_phase: {json.dumps(counts)} in "
          f"{phase_s:.2f} s; simulated S called S {s_share:.4f} (on the "
          f"simulated states {s_truth:.4f}; JAX's bar {PHASE_BAR}: "
          f"{'met' if s_share > PHASE_BAR else 'not met'}), simulated G1 "
          f"called G1/2 or LQ {g_share:.4f}, labels as the simulated "
          f"states' {agree:.4f}")
    check(len(labels) == n_cells,
          f"{tag} every cell gets a PERT_phase ({len(labels)} of {n_cells})")
    check(s_share >= s_truth - PHASE_SLACK,
          f"{tag} simulated S cells called S {s_share:.4f} >= "
          f"{s_truth:.4f} (the simulated states') - {PHASE_SLACK}")
    check(agree >= PHASE_AGREE, f"{tag} each cell's label is the one its "
          f"simulated states give it for {agree:.4f} >= {PHASE_AGREE}")
    check(g_share > PHASE_BAR, f"{tag} simulated G1 cells called G1/2 or "
          f"LQ {g_share:.4f} > {PHASE_BAR}")
    rec.update(phase_s=phase_s, phase_counts=counts, s_share=s_share,
               s_share_simulated=s_truth, label_agreement=agree,
               g1_share=g_share)

    cn = cn.drop(columns=["true_rep", "true_somatic_cn"])
    feats, secs = {}, {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        _, f = compute_ccc_features(cn.copy(), device=d)
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        feats[name] = f.sort_values("cell_id").reset_index(drop=True)
    card_f, cpu_f = feats["card"], feats["cpu"]
    same = {c: bool(np.array_equal(card_f[c].to_numpy(),
                                   cpu_f[c].to_numpy()))
            for c in CCC_EXACT}
    lrs_err = float(np.max(np.abs(card_f["lrs"].to_numpy()
                                  - cpu_f["lrs"].to_numpy())
                           / np.maximum(1.0, np.abs(cpu_f["lrs"].to_numpy()))))
    print(f"{tag} compute_ccc_features: card {secs['card']:.2f} s, CPU "
          f"{secs['cpu']:.2f} s; {len(card_f)} cells, lrs "
          f"{cpu_f['lrs'].min():.4g}..{cpu_f['lrs'].max():.4g}, card "
          f"against CPU {lrs_err:.3g} of max(1, |lrs|) (bound {TOL_LRS})")
    check(list(card_f["cell_id"]) == list(cpu_f["cell_id"])
          and len(card_f) == n_cells and all(same.values()),
          f"{tag} features on the card: {', '.join(CCC_EXACT)} equal the "
          f"CPU's ({json.dumps(same)})")
    check(lrs_err <= TOL_LRS and bool(np.isfinite(card_f["lrs"]).all()),
          f"{tag} lrs on the card within {TOL_LRS} of the CPU's "
          f"({lrs_err:.3g})")
    rec.update(ccc_card_s=secs["card"], ccc_cpu_s=secs["cpu"],
               lrs_err=lrs_err)

    frame = dict(zip(("s", "g1"), frames))
    route_s = {"library": 0.0, "numpy": 0.0}
    equal = []
    for which, col in PIVOTS:
        mats = {}
        for route, native in (("library", None), ("numpy", False)):
            t0 = time.perf_counter()
            mats[route] = pivot_matrix(frame[which], col,
                                       use_native=native)
            route_s[route] += time.perf_counter() - t0
        a, b = mats["library"], mats["numpy"]
        equal.append(a.index.equals(b.index) and a.columns.equals(b.columns)
                     and np.array_equal(np.isnan(a.to_numpy()),
                                        np.isnan(b.to_numpy()))
                     and a.to_numpy().tobytes() == b.to_numpy().tobytes())
    print(f"{tag} pivot_matrix, the loader's {len(PIVOTS)} pivots of the "
          f"default cell's frames: library {route_s['library']:.3f} s, "
          f"NumPy {route_s['numpy']:.3f} s; the default cell's load phase "
          f"{load_s:.2f} s (4-6 s on the NumPy scatter, PERF.md §5)")
    check(all(equal), f"{tag} every pivot through the library equals the "
          "NumPy scatter bit for bit, NaN positions included")
    rec.update(pivot_library_s=route_s["library"],
               pivot_numpy_s=route_s["numpy"], load_s=load_s)
    return rec


def _host_tail(card: str, part: str, analysis_in=None,
               load_s: float = 0.0) -> dict:
    """Phase 10's host-bound tail (``part='levels'``: the deterministic
    levels and SPF on the unlabelled frames, then the three CLI functions
    through TSVs) or the [analysis] phase (``part='analysis'``: phase
    calling, the cell-cycle features and the pivots on the default
    cell's output and frames), each the task of a process of its own.
    Returns what it printed, the checks that failed and its parts of the
    record."""
    import io
    import traceback
    import torch

    record = {"unlabelled": {}, "analysis": {}}
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        if part == "levels":
            try:
                frames = simulate_frames()
                bare, _ = unlabelled_frames(frames)
                levels_spf(torch.device("cuda", 0), bare, record, card)
                cli_drive(frames, record["unlabelled"], card)
            except Exception:
                check(False, "[unlabelled] the host tail raised:\n"
                      + traceback.format_exc())
            record["unlabelled"]["tail_s"] = time.perf_counter() - t0
        else:
            try:
                record["analysis"] = analysis(
                    torch.device("cuda", 0), simulate_frames(), analysis_in,
                    load_s, card)
            except Exception:
                check(False, "[analysis] the phase raised:\n"
                      + traceback.format_exc())
            record["analysis"]["wall_s"] = time.perf_counter() - t0
    return {"log": out.getvalue(), "failures": list(FAILURES),
            "record": record}


class HostTail:
    """A host-bound part of the script in a spawned process of its own
    (:func:`_host_tail`): ``'levels'``, phase 10's levels, SPF and CLI
    functions (250-370 s of a slow host's time), runs beside phase 11;
    ``'analysis'``, the [analysis] phase (120-210 s), starts after the
    [graphs] phase and runs beside phases 7-10 (its card work, the
    features' 2-GMM, falls in phase 7, which times no kernel), so that
    the script stays inside its time limit.  :meth:`finish` waits,
    prints what it printed and counts its checks; :meth:`close` stops it,
    also when a phase fails on the way."""

    def __init__(self, card: str, part: str, *args):
        import atexit
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        self.part = part
        self.t0 = time.perf_counter()
        self.pool = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
        self.future = self.pool.submit(_host_tail, card, part, *args)
        atexit.register(self.close)

    def finish(self, record) -> None:
        try:
            tail = self.future.result()
        except Exception as exc:     # the process died
            check(False, f"[unlabelled] the {self.part} tail's process "
                  f"failed: {exc!r}")
            return
        finally:
            self.close()
        wait = time.perf_counter() - self.t0
        print(tail["log"], end="")
        FAILURES.extend(tail["failures"])
        rec = tail["record"]
        if self.part == "levels":
            print(f"[unlabelled tail] levels, SPF and CLI in a process beside "
                  f"phase 11: {rec['unlabelled']['tail_s']:.1f} s (joined "
                  f"after {wait:.1f} s)")
            record["unlabelled"].update(rec["unlabelled"])
        else:
            print(f"[analysis] in a process beside phases 7-10: "
                  f"{rec['analysis']['wall_s']:.1f} s (joined after "
                  f"{wait:.1f} s)")
            record.setdefault("analysis", {}).update(rec["analysis"])

    def close(self) -> None:
        self.pool.shutdown(wait=True, cancel_futures=True)


class HostMemory:
    """A thread sampling the machine's available memory (``MemAvailable``
    of ``/proc/meminfo``) every second while the script runs: its lowest
    reading and when, printed at the end (the card's machine has 96 GiB
    for every process of the script and the serving spool in
    ``/dev/shm``)."""

    def __init__(self, t_start: float):
        import threading

        self.t_start = t_start
        # the last [timeline] mark: the lowest reading is printed with
        # the phase it came after
        self.after = "start"
        self.low = (float("inf"), 0.0, self.after)
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="host-memory")
        self.thread.start()

    @staticmethod
    def available() -> float:
        with open("/proc/meminfo") as fh:
            for line in fh:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024.0
        return float("nan")

    def _run(self) -> None:
        while not self.stop.wait(1.0):
            try:
                avail = self.available()
            except OSError:
                return
            if avail < self.low[0]:
                self.low = (avail, time.perf_counter() - self.t_start,
                            self.after)

    def report(self, record) -> None:
        self.stop.set()
        self.thread.join(timeout=5)
        low, at, after = self.low
        print(f"[host memory] lowest MemAvailable {low / 2**30:.2f} GiB at "
              f"{at:.1f} s (after the {after} mark)")
        record["host_memory_low"] = {"bytes": low, "at_s": at,
                                     "after": after}


# ---------------------------------------------------------------------------
# phase 12: sharded fits on ranks of a gloo group that share the card
# ---------------------------------------------------------------------------

# run -> (cells x loci grid, scRT options besides the grid): the default
# config (every option at its default; heartbeats on, so that every rank
# publishes one) and the categorical path of phase 4 on a 2 x 2 grid at
# its depth cut (MAX_ITER)
# [elastic 2x1]: the 2 x 1 default run again, durable, with rank 1 killed
# in step 2 (its process preempted: ELASTIC_KILL) after the generation of
# step 2's fourth chunk was committed; rank 0 walks the elastic rung and
# ends the run on one rank
ELASTIC_EVERY = 4           # checkpoint_every (chunks of 25 iterations)
ELASTIC_KILL = "preempt@step2/chunk#6@proc1"
# the heartbeat's cadence in the elastic run (s): the killed rank's goes
# stale (presumed_lost past 30 of them) before the survivor ends
ELASTIC_HEARTBEAT_S = 0.5
# [elastic 2x2]: the default run on a 2 x 2 grid, durable, with rank 3's
# process ended outright (os._exit: no handler runs, nothing marks it lost, so the
# survivors' rendezvous waits out RENDEZVOUS_SETTLE_SECONDS) at step 2's
# sixth chunk; ranks 0 and 1 end on a 1 x 2 grid, rank 2 stands by
ELASTIC_EXIT = ("step2/chunk", 6, 3)
# the rank each elastic run loses
ELASTIC_LOST = {"elastic 2x1": 1, "elastic 2x2": ELASTIC_EXIT[2]}
# runs that start only once phase 11's drain is over (ShardedPhase.
# drained): four ranks reloading full generations beside the drain pass
# the machine's 96 GiB of host memory
AFTER_DRAIN = {"elastic 2x2"}
SHARDED = {
    "2x1": ((2, 1), dict()),
    "elastic 2x1": ((2, 1), dict(checkpoint_every=ELASTIC_EVERY,
                                 faults=ELASTIC_KILL,
                                 heartbeat_interval_seconds=(
                                     ELASTIC_HEARTBEAT_S))),
    "2x2": ((2, 2), dict(OFF, mirror_rescue=False)),
    "elastic 2x2": ((2, 2), dict(checkpoint_every=ELASTIC_EVERY)),
}
# bars of the sharded runs against the one-rank runs of the same script
SHARDED_ACC = 0.005        # rep and CN accuracy, 2 x 1 against default
SHARDED_TAU = 0.01         # tau r, 2 x 1 against default
SHARDED_LOSS0 = 1e-5       # iteration-0 loss of steps 1 and 2, 2 x 2
                           # against categorical
SHARDED_TRAJ = 5e-2        # loss trajectories, 2 x 2 against categorical
# step 3's iteration-0 loss, 2 x 2 against categorical: it starts from
# step 2's fitted rho and a, which the two runs reach along trajectories
# apart (two runs on an H100 80GB HBM3 at 700 W read 2.3e-4)
SHARDED_LOSS0_STEP3 = 1e-3
# step 1's trajectory is held from the end of its first chunk: its first
# Adam steps move rho on gradients that are rounding noise (the doubled
# G1 and G2 copies' replication terms cancel), so the order of the sums
# sets their signs and the first iterations part chaotically (JAX's own
# 2 x 2 mesh against its one device: 0.94 at iteration 2, ROADMAP C)
SHARDED_SETTLED = 25
# each step's converged loss (the last of its trajectory), 2 x 2 against
# categorical, normaliser out: two runs on an H100 80GB HBM3 at 700 W
# read 7.5e-6 / 7.4e-6 / 3.1e-4 (steps 1 / 2 / 3, the same in both)
SHARDED_END = (2e-5, 2e-5, 1e-3)
# step 2's fitted rho (largest absolute difference) and a (relative), 2 x 2
# against categorical
SHARDED_RHO = 5e-2
SHARDED_A = 5e-2
# a collective waits at most this long for a peer rank (seconds); a run's
# ranks are killed at the run's limit
SHARDED_COLLECTIVE_S = 300.0
SHARDED_RUN_S = 420.0


def _normaliser_sum(step) -> float:
    """One rank's share of a step's parameter-free Dirichlet normaliser
    over its real bins (0 for step 1): the term the loss comparisons take
    out, since its float32 lgamma sum at 1e6 concentrations moves with
    the order of the sum."""
    cache = step.batch.cache
    if "dir_norm" not in cache:
        return 0.0
    b = step.batch
    bin_mask = b.mask[:, None] * b.effective_loci_mask()[None, :]
    return float((cache["dir_norm"] * bin_mask).sum())


def _fitted_globals(step, mesh=None) -> dict:
    """A step's fitted rho (the real loci, gathered over the ranks'
    loci tiles with ``mesh``: every rank calls) and a."""
    import torch

    from scdna_replication_tools_tpu_torch.models.pert import _sites

    with torch.no_grad():
        c = _sites(step.spec, step.fit.params, step.fixed)
    rho = c["rho"] if mesh is None else mesh.gather(c["rho"], ("loci",))
    rho = rho.detach().cpu().numpy() if torch.is_tensor(rho) else rho
    return {"rho": [float(v) for v in np.asarray(rho)[:LOCI]],
            "a": float(c["a"])}


def recovery(out_s, supp_s) -> dict:
    """The recovery figures of the simulate-and-recover bars."""
    per_cell = out_s.groupby("cell_id").agg(tau=("model_tau", "first"),
                                            true_t=("true_t", "first"))
    return {
        "rep_acc": float((out_s["model_rep_state"]
                          == out_s["true_rep"]).mean()),
        "cn_acc": float((out_s["model_cn_state"]
                         == out_s["true_somatic_cn"]).mean()),
        "tau_r": float(np.corrcoef(per_cell["tau"],
                                   per_cell["true_t"])[0, 1]),
        "lambda": float(supp_s.query("param == 'model_lambda'")["value"]
                        .iloc[0])}


def _sharded_rank(rank, world, store, frames_path, run, tmp, spawned_at,
                  mufu_per_s) -> None:
    """One rank of a sharded run (spawned): joins the gloo group on
    cuda:0, runs ``scRT(...).infer('pert')`` with the run's grid and
    options, times the gradient all-reduce alone, and on rank 0 holds
    the kernels against their plain versions at its shapes; writes its
    record to ``tmp/<run>.rank<k>.pkl`` and its printed lines to
    ``tmp/<run>.rank<k>.log``."""
    import pickle

    tmp = Path(tmp)
    log = open(tmp / f"{run}.rank{rank}.log", "w")
    sys.stdout = log
    rec: dict = {"rank": rank}
    try:
        import pandas as pd
        import torch

        sys.path.insert(0, str(REPO))
        from scdna_replication_tools_tpu_torch import scRT
        from scdna_replication_tools_tpu_torch.ops import _cuda
        from scdna_replication_tools_tpu_torch.parallel import (
            init_distributed,
        )

        global MUFU_PER_S
        MUFU_PER_S = mufu_per_s
        init_distributed("gloo", f"file://{store}", world, rank,
                         timeout=SHARDED_COLLECTIVE_S)
        rec["ready_s"] = time.time() - spawned_at
        cn_s, cn_g1 = pickle.loads(Path(frames_path).read_bytes())
        (cells, loci), options = SHARDED[run]
        options = dict(options, num_shards=cells, loci_shards=loci)
        elastic = run.startswith("elastic")
        if run == "2x1":
            options["heartbeat_dir"] = str(tmp / "health")
            options["telemetry_path"] = str(tmp / "logs")
        if elastic:
            tag = run.replace(" ", "_")
            options["heartbeat_dir"] = str(tmp / f"{tag}_health")
            options["telemetry_path"] = str(tmp / f"{tag}_logs")
            options["checkpoint_dir"] = str(tmp / f"{tag}_ck")
            _instrument_elastic(rec)
            if run == "elastic 2x2" and rank == ELASTIC_EXIT[2]:
                _exit_at(*ELASTIC_EXIT[:2], tmp / f"{tag}.kill")
        scrt = scRT(cn_s, cn_g1, **options)
        dev = scrt.device
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        out_s, supp_s, out_g1, supp_g1 = scrt.infer("pert")
        torch.cuda.synchronize()
        rec["wall_s"] = time.perf_counter() - t0
        rec["launches"] = dict(_cuda.LAUNCHES)
        rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        rec["device"] = str(dev)
        rec["phases_s"] = scrt.phase_report
        rec["run_log_path"] = scrt.run_log_path
        rec["digest"] = [int(pd.util.hash_pandas_object(o).sum())
                         for o in (out_s, supp_s, out_g1, supp_g1)]
        rec.update(recovery(out_s, supp_s))
        rec["standby"] = scrt.steps[1] is None
        if rec["standby"]:
            # a survivor beyond the smaller grid: the frames only
            return
        rec["steps"] = [{
            "iters": st.fit.num_iters, "dispatched":
            st.fit.timings["dispatched"], "ms_per_iter":
            st.fit.timings["ms_per_iter"], "cells":
            int(st.batch.reads.shape[0]), "loci":
            int(st.batch.reads.shape[1]), "losses":
            [float(v) for v in st.fit.losses],
            "normaliser": _normaliser_sum(st),
            "decisions": [f"{d['action']}@{d['iter']}"
                          for d in st.fit.decisions]} for st in scrt.steps]
        rec["rescue"] = scrt.mirror_rescue_stats
        rec["step2_globals"] = _fitted_globals(scrt.steps[1], scrt.mesh)
        rec["rows"] = [len(out_s), len(out_g1)]
        if elastic:
            # the survivors end on the smaller grid (2 x 1: one rank, at
            # phase 6's shapes, where phases 4 and 6 hold the kernels)
            rec["mesh_after"] = dict(scrt.mesh.shape) if scrt.mesh else {}
            return
        rec["allreduce_ms"] = _time_allreduce(scrt)
        if rank == 0:
            results = {name: {"max_abs_err": 0.0} for name in TPU_KERNEL}
            check_main_path_shapes(dev, scrt, results, f"sharded {run}")
            rec["kernels"] = {k: v for k, v in results.items() if "main" in v}
    except BaseException as exc:
        import traceback

        if run.startswith("elastic") and rank == 1 \
                and type(exc).__name__ == "SimulatedPreemption":
            # the kill the elastic run injects: this rank is the lost one
            from scdna_replication_tools_tpu_torch.ops import _cuda

            rec["killed"] = f"{type(exc).__name__}: {exc}"
            rec["launches"] = dict(_cuda.LAUNCHES)
            raise
        traceback.print_exc(file=log)
        check(False, f"[sharded {run}] rank {rank} failed: "
              + traceback.format_exc().strip().splitlines()[-1])
    finally:
        rec["failures"] = list(FAILURES)
        log.flush()
        (tmp / f"{run}.rank{rank}.pkl").write_bytes(pickle.dumps(rec))
        # the group (one the elastic rung re-formed included) ends before
        # the process does: left to the interpreter's exit, a re-formed
        # gloo group's threads aborted a survivor (SIGABRT) on the CPU
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()


def _exit_at(site: str, hit: int, stamp: Path) -> None:
    """End this process outright (``os._exit``: no handler runs, nothing
    marks the rank lost) at the ``hit``-th pass of the fault site
    ``site``, after writing the time to ``stamp``."""
    from scdna_replication_tools_tpu_torch.utils import faults

    point, hits = faults.point, [0]

    def exiting(name):
        if name == site:
            hits[0] += 1
            if hits[0] == hit:
                stamp.write_text(repr(time.time()))
                os._exit(3)
        return point(name)
    faults.point = exiting


def _instrument_elastic(rec: dict) -> None:
    """Timestamps of the elastic run in this spawned rank, by wrapping
    three functions (no behaviour changes): the injected kill
    (``fault_unix``), the rung (``rung_unix``, ``reformed_unix``, with the
    launches counted before it) and the first fit entered after it
    (``refit_unix``: step 2's resumed fit on one rank, whose first chunk
    follows at once)."""
    from scdna_replication_tools_tpu_torch.infer import runner
    from scdna_replication_tools_tpu_torch.ops import _cuda
    from scdna_replication_tools_tpu_torch.utils import faults

    point = faults.point
    rung = runner.PertInference._elastic_rung
    fit = runner.PertInference._fit_map

    def timed_point(site):
        try:
            return point(site)
        except BaseException:
            rec.setdefault("fault_unix", time.time())
            raise

    def timed_rung(self, *args, **kwargs):
        rec["rung_unix"] = time.time()
        rec["launches_before"] = dict(_cuda.LAUNCHES)
        try:
            return rung(self, *args, **kwargs)
        finally:
            rec["reformed_unix"] = time.time()

    def timed_fit(self, *args, **kwargs):
        if "rung_unix" in rec:
            rec.setdefault("refit_unix", time.time())
        return fit(self, *args, **kwargs)

    faults.point = timed_point
    runner.PertInference._elastic_rung = timed_rung
    runner.PertInference._fit_map = timed_fit


def _time_allreduce(scrt, reps: int = 20) -> float:
    """ms of one gradient all-reduce (``RankMesh.reduce_grads``) of step
    2's parameters at this rank's shapes, alone: zeros of each gradient's
    shape, ``reps`` times back to back, every rank at once."""
    import torch

    mesh = scrt.mesh
    step2 = scrt.steps[1]
    dev = scrt.device
    grads = {k: torch.zeros_like(v, device=dev)
             for k, v in step2.fit.params.items()}
    loss = torch.zeros((), device=dev)
    mesh.reduce_grads(loss, grads)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.reduce_grads(loss, grads)
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


class ShardedPhase:
    """Phase 12, beside phase 11: each run of ``SHARDED`` on its grid of
    spawned ranks sharing the card (a gloo group through a ``file://``
    store in a temporary directory), one run after the other in a
    thread, so that the script stays inside its time limit.
    :meth:`finish` waits for it, prints the ranks' lines and holds the
    runs to the one-rank ones; :meth:`close` kills ranks left over."""

    def __init__(self, frames, mufu_per_s):
        import pickle
        import tempfile
        import threading

        self.tmp = Path(tempfile.mkdtemp(prefix="pert_sharded_"))
        (self.tmp / "frames.pkl").write_bytes(pickle.dumps(frames))
        self.mufu_per_s = mufu_per_s
        self.procs: list = []
        self.runs: dict = {}
        self.t0 = time.perf_counter()
        self.drained = threading.Event()
        self.thread = threading.Thread(target=self._run_all, daemon=True)
        self.thread.start()

    def _run_all(self) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        for run, ((cells, loci), _) in SHARDED.items():
            world = cells * loci
            store = self.tmp / f"{run}.store"
            if run in AFTER_DRAIN:
                self.drained.wait()
            t0 = time.perf_counter()
            procs = [ctx.Process(target=_sharded_rank, args=(
                rank, world, str(store), str(self.tmp / "frames.pkl"), run,
                str(self.tmp), time.time(), self.mufu_per_s))
                for rank in range(world)]
            self.procs += procs
            for p in procs:
                p.start()
            deadline = time.perf_counter() + SHARDED_RUN_S
            for p in procs:
                p.join(max(deadline - time.perf_counter(), 0.1))
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
                p.join(10)
            self.runs[run] = {"wall_s": time.perf_counter() - t0,
                              "exitcodes": [p.exitcode for p in procs],
                              "killed": len(alive)}

    def finish(self, record, results, by_path) -> None:
        import pickle

        self.drained.set()
        self.thread.join()
        try:
            self._finish(record, results, by_path)
        finally:
            self.close()

    def _finish(self, record, results, by_path) -> None:
        import pickle

        rec = record.setdefault("sharded", {})
        print(f"[sharded] the runs on ranks sharing the card, beside phase "
              f"11 (joined after {time.perf_counter() - self.t0:.1f} s)")
        for run, ((cells, loci), options) in SHARDED.items():
            world = cells * loci
            info = self.runs.get(run, {"exitcodes": [None] * world,
                                       "killed": 0, "wall_s": 0.0})
            ranks = []
            for k in range(world):
                logf = self.tmp / f"{run}.rank{k}.log"
                if logf.exists():
                    text = logf.read_text()
                    if text.strip():
                        print(f"  --- {run} rank {k} ---")
                        print(text, end="")
                pk = self.tmp / f"{run}.rank{k}.pkl"
                ranks.append(pickle.loads(pk.read_bytes())
                             if pk.exists() else {"failures": []})
            for r in ranks:
                FAILURES.extend(r.get("failures", []))
            if run.startswith("elastic"):
                lost, codes = ELASTIC_LOST[run], info["exitcodes"]
                check(all(c == 0 for k, c in enumerate(codes) if k != lost)
                      and codes[lost] not in (0, None)
                      and not info["killed"],
                      f"[{run}] the survivors exited 0 and the killed rank "
                      f"{lost} non-zero (exit codes {codes}, "
                      f"{info['killed']} killed at the {SHARDED_RUN_S:.0f} "
                      f"s limit) in {info['wall_s']:.1f} s")
                if "steps" in ranks[0]:
                    report = self._report_elastic if run == "elastic 2x1" \
                        else self._report_elastic_2x2
                    report(run, ranks, record, by_path)
                rec[run] = {"wall_s": info["wall_s"], "ranks": ranks}
                continue
            check(info["exitcodes"] == [0] * world and not info["killed"],
                  f"[sharded {run}] {world} ranks exited 0 (exit codes "
                  f"{info['exitcodes']}, {info['killed']} killed at the "
                  f"{SHARDED_RUN_S:.0f} s limit) in {info['wall_s']:.1f} s")
            if not all("steps" in r for r in ranks):
                rec[run] = {"ranks": ranks, **info}
                continue
            self._report(run, cells, loci, ranks, record, results, by_path)
            rec[run] = {"wall_s": info["wall_s"], "ranks": [
                {k: v for k, v in r.items() if k not in ("kernels",)}
                for r in ranks]}

    def _report(self, run, cells, loci, ranks, record, results,
                by_path) -> None:
        from scdna_replication_tools_tpu_torch.obs.heartbeat import (
            aggregate_health,
        )

        tag = f"[sharded {run}]"
        r0 = ranks[0]
        print(f"{tag} scRT(num_shards={cells}, loci_shards={loci}"
              + (", " + json.dumps(SHARDED[run][1]) if SHARDED[run][1]
                 else ", every other option at its default") + ")")
        for r in ranks:
            steps = r["steps"]
            print(f"  rank {r['rank']} on {r['device']}: ready "
                  f"{r['ready_s']:.1f} s after its spawn (start and imports),"
                  f" infer('pert') {r['wall_s']:.2f} s, step 1/2/3 "
                  + " / ".join(f"{s['ms_per_iter']:.3f}" for s in steps)
                  + " ms/iteration ("
                  + " / ".join(f"{s['iters']} of {s['dispatched']}"
                               for s in steps)
                  + " iterations counted of dispatched, cells x loci "
                  + " / ".join(f"{s['cells']}x{s['loci']}" for s in steps)
                  + f"), peak {r['peak_bytes']} bytes, gradient all-reduce "
                  f"{r['allreduce_ms']:.3f} ms alone, decisions "
                  + json.dumps([s["decisions"] for s in steps])
                  + f", launches {json.dumps(r['launches'])}")
        check(all(r["digest"] == r0["digest"] for r in ranks),
              f"{tag}: every rank returns the same four output frames")
        check(r0["rows"] == [CELLS * LOCI, G1_CELLS * LOCI],
              f"{tag}: the frames cover every bin ({r0['rows']})")
        for r in ranks:
            L = r["launches"]
            check(all(L[k] > 0 for k in CATEGORICAL),
                  f"{tag}: rank {r['rank']} launched the dense pair, the "
                  "sparse pair and Adam at its shapes")
        by_path[f"sharded {run}"] = {
            k: sum(r["launches"][k] for r in ranks) for k in r0["launches"]}
        check(r0["rep_acc"] > 0.80 and r0["cn_acc"] > 0.90
              and r0["tau_r"] > 0.8 and 0.5 < r0["lambda"] < 0.95,
              f"{tag}: rep {r0['rep_acc']:.4f} > 0.80, CN "
              f"{r0['cn_acc']:.4f} > 0.90, tau r {r0['tau_r']:.4f} > 0.8, "
              f"lambda {r0['lambda']:.4f} in (0.5, 0.95)")
        for name, entry in r0.get("kernels", {}).items():
            res = results.setdefault(name, {"max_abs_err": 0.0})
            res["max_abs_err"] = max(res.get("max_abs_err", 0.0),
                                     entry["max_abs_err"])
            res.setdefault("main", {}).update(entry["main"])
        if run == "2x1":
            ref = record["main_default"]
            for key, tol in (("rep_acc", SHARDED_ACC),
                             ("cn_acc", SHARDED_ACC)):
                check(abs(r0[key] - ref[key]) <= tol,
                      f"{tag}: {key} {r0[key]:.4f} within {tol} of the one-"
                      f"rank default run's {ref[key]:.4f}")
            check(r0["tau_r"] >= ref["tau_r"] - SHARDED_TAU,
                  f"{tag}: tau r {r0['tau_r']:.4f} >= default "
                  f"{ref['tau_r']:.4f} - {SHARDED_TAU}")
            logs = [r["run_log_path"] for r in ranks]
            check(logs[0] is not None and Path(logs[0]).exists()
                  and logs[1:] == [None] * (len(ranks) - 1),
                  f"{tag}: the run log exists once, rank 0's ({logs})")
            agg = aggregate_health(str(self.tmp / "health"))
            check(agg["hosts_seen"] == len(ranks)
                  and agg["missing_ranks"] == [],
                  f"{tag}: aggregate_health reads {agg['hosts_seen']} "
                  f"hosts, missing ranks {agg['missing_ranks']}")
            print(f"  rescue {json.dumps(r0['rescue'])}; one-rank default: "
                  f"rep {ref['rep_acc']:.4f}, CN {ref['cn_acc']:.4f}, tau r "
                  f"{ref['tau_r']:.4f}; sharded: rep {r0['rep_acc']:.4f}, "
                  f"CN {r0['cn_acc']:.4f}, tau r {r0['tau_r']:.4f}, lambda "
                  f"{r0['lambda']:.4f}")
        else:
            ref = record["main_categorical"]
            for k, name in enumerate(("step1", "step2", "step3")):
                norm = sum(r["steps"][k]["normaliser"] for r in ranks)
                got = np.asarray(r0["steps"][k]["losses"], np.float64) + norm
                want = np.asarray(ref["losses"][k], np.float64) \
                    + ref["normaliser"][k]
                n = min(len(got), len(want))
                rel = np.abs(got[:n] - want[:n]) / np.abs(want[:n])
                bar = SHARDED_LOSS0 if k < 2 else SHARDED_LOSS0_STEP3
                check(rel[0] <= bar,
                      f"{tag}: {name} iteration-0 loss {got[0]:.8g} within "
                      f"{bar} of the categorical run's {want[0]:.8g} (rel "
                      f"{rel[0]:.3e}; normaliser out)")
                start = SHARDED_SETTLED if k == 0 else 0
                check(rel[start:].max() <= SHARDED_TRAJ,
                      f"{tag}: {name} losses within {SHARDED_TRAJ} of the "
                      f"categorical run's over iterations {start}-{n - 1} "
                      f"(worst {rel[start:].max():.3e}; over every "
                      f"iteration {rel.max():.3e} at {int(rel.argmax())})")
                # where each fit converged, whatever the iteration
                end = abs(got[-1] - want[-1]) / abs(want[-1])
                check(end <= SHARDED_END[k],
                      f"{tag}: {name} converged loss {got[-1]:.8g} (iter "
                      f"{len(got) - 1}) within {SHARDED_END[k]} of the "
                      f"categorical run's {want[-1]:.8g} (iter "
                      f"{len(want) - 1}; rel {end:.3e}; normaliser out)")
            mine, theirs = r0["step2_globals"], ref["step2_globals"]
            drho = float(np.abs(np.asarray(mine["rho"])
                                - np.asarray(theirs["rho"])).max())
            da = abs(mine["a"] - theirs["a"]) / abs(theirs["a"])
            check(drho <= SHARDED_RHO and da <= SHARDED_A,
                  f"{tag}: step 2's fitted rho within {SHARDED_RHO} (worst "
                  f"{drho:.3e}) and a {mine['a']:.6g} within {SHARDED_A} "
                  f"(rel {da:.3e}) of the categorical run's {theirs['a']:.6g}")

    def _report_elastic(self, run, ranks, record, by_path) -> None:
        """[elastic 2x1]: the run log's rung, the resharded resume, the
        recovery bars against phase 6, the killed rank's heartbeat and the
        ``mesh-shrunk`` rule, the launches after the shrink, and the
        seconds from the kill to the survivor's fit on one rank."""
        from scdna_replication_tools_tpu_torch.obs import alerts
        from scdna_replication_tools_tpu_torch.obs.heartbeat import (
            aggregate_health,
        )
        from scdna_replication_tools_tpu_torch.obs.schema import validate_run

        tag = f"[{run}]"
        r0, r1 = ranks
        steps = r0["steps"]
        print(f"{tag} scRT(num_shards=2, checkpoint_dir=D, checkpoint_every="
              f"{ELASTIC_EVERY}, faults={ELASTIC_KILL!r}), every other "
              "option at its default, on ranks sharing the card")
        log = Path(r0["run_log_path"] or "")
        events = [json.loads(line) for line in log.read_text()
                  .splitlines()] if log.is_file() else []
        shrinks = [e for e in events if e["event"] == "degrade"
                   and e.get("action") == "mesh_shrink"]
        resumes = [e for e in events if e["event"] == "resume"
                   and e.get("resharded")]
        check(len(shrinks) == 1 and shrinks[0]["error_class"] == "hostloss"
              and shrinks[0]["from_topology"]["mesh_axes"] == {"cells": 2}
              and shrinks[0]["to_topology"]["mesh_axes"] == {"cells": 1},
              f"{tag} one degrade mesh_shrink (hostloss, cells 2 -> 1): "
              + json.dumps([{k: e.get(k) for k in (
                  "step", "error_class", "from_topology", "to_topology")}
                  for e in shrinks]))
        check(any(e["step"] == "step2" and e["action"] == "resumed"
                  for e in resumes),
              f"{tag} step 2 resumed resharded: "
              + json.dumps([(e["step"], e["action"], e["from_iter"])
                            for e in resumes]))
        errors = validate_run(log) if events else ["no log"]
        check(not errors, f"{tag} the run log validates: {errors[:3]}")
        check(r0.get("mesh_after") == {} and "killed" in r1,
              f"{tag} rank 1 killed ({r1.get('killed')}), rank 0 ended on "
              f"one rank ({r0.get('mesh_after')})")
        check(r0["rep_acc"] > 0.80 and r0["cn_acc"] > 0.90
              and r0["tau_r"] > 0.8 and 0.5 < r0["lambda"] < 0.95,
              f"{tag}: rep {r0['rep_acc']:.4f} > 0.80, CN "
              f"{r0['cn_acc']:.4f} > 0.90, tau r {r0['tau_r']:.4f} > 0.8, "
              f"lambda {r0['lambda']:.4f} in (0.5, 0.95)")
        ref = record["main_default"]
        for key in ("rep_acc", "cn_acc"):
            check(abs(r0[key] - ref[key]) <= SHARDED_ACC,
                  f"{tag}: {key} {r0[key]:.4f} within {SHARDED_ACC} of the "
                  f"one-rank default run's {ref[key]:.4f}")
        check(r0["tau_r"] >= ref["tau_r"] - SHARDED_TAU,
              f"{tag}: tau r {r0['tau_r']:.4f} >= default "
              f"{ref['tau_r']:.4f} - {SHARDED_TAU}")
        agg = aggregate_health(str(self.tmp / "elastic_2x1_health"))
        hosts = {h["rank"]: h for h in agg["hosts"]}
        lost = hosts.get(1)
        fired = [v["name"] for v in alerts.evaluate(alerts.load_rules(), agg)
                 if v["fired"]]
        print(f"  aggregate_health: states {json.dumps(agg['states'])}, "
              f"missing {agg['missing_ranks']}, freshness "
              + json.dumps({k: h["freshness"] for k, h in hosts.items()})
              + f"; rules fired {fired}")
        check((lost is None or lost["freshness"] == "presumed_lost")
              and hosts.get(0, {}).get("doc", {}).get("state") == "done",
              f"{tag} aggregate_health shows rank 1 lost (missing or "
              "presumed_lost) and rank 0 done")
        check("mesh-shrunk" in fired, f"{tag} the mesh-shrunk rule fires")
        before = r0.get("launches_before", {})
        after = {k: v - before.get(k, 0) for k, v in r0["launches"].items()}
        check(all(after[k] > 0 for k in CATEGORICAL),
              f"{tag} the dense and sparse fused pairs and Adam launched on "
              f"one rank after the shrink: {json.dumps(after)}")
        by_path[run] = {k: r0["launches"][k] + r1.get("launches", {}).get(
            k, 0) for k in r0["launches"]}
        nan = float("nan")
        kill = r1.get("fault_unix", nan)
        for key in ("rung_unix", "reformed_unix", "refit_unix"):
            r0.setdefault(key, nan)
        check(all(np.isfinite([kill, r0["reformed_unix"],
                               r0["refit_unix"]])),
              f"{tag} the kill, the re-formed group and the fit on one "
              "rank were each seen")
        ck = self.tmp / "elastic_2x1_ck"
        disk = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
        saved = sum(e.get("bytes") or 0 for e in events
                    if e["event"] == "checkpoint" and e["action"] == "save")
        sharded = (record.get("sharded", {}).get("2x1") or {}).get("ranks")
        ref_wall = sharded[0]["wall_s"] if sharded else float("nan")
        print(f"  kill at rank 1's step2/chunk#6; rank 0: the group "
              f"re-formed {r0['reformed_unix'] - kill:.2f} s after it (the "
              f"rung entered at {r0['rung_unix'] - kill:.2f} s), step 2's fit "
              f"re-entered on one rank at {r0['refit_unix'] - kill:.2f} s; "
              f"infer('pert') {r0['wall_s']:.2f} s against [sharded 2x1]'s "
              f"{ref_wall:.2f} s; step 1/2/3 "
              + " / ".join(f"{s['ms_per_iter']:.3f}" for s in steps)
              + " ms/iteration ("
              + " / ".join(f"{s['iters']} of {s['dispatched']}"
                           if s["dispatched"] else f"{s['iters']} restored"
                           for s in steps)
              + f" counted of dispatched on one rank); checkpoints: rank 0 "
              f"saved {saved} bytes, D holds {disk} bytes at the end; peak "
              f"{r0['peak_bytes']} bytes; launches after the shrink "
              + json.dumps(after))
        print(f"  rescue {json.dumps(r0['rescue'])}; one-rank default: rep "
              f"{ref['rep_acc']:.4f}, CN {ref['cn_acc']:.4f}, tau r "
              f"{ref['tau_r']:.4f}; elastic: rep {r0['rep_acc']:.4f}, CN "
              f"{r0['cn_acc']:.4f}, tau r {r0['tau_r']:.4f}, lambda "
              f"{r0['lambda']:.4f}")
        r0["kill_to_reformed_s"] = r0["reformed_unix"] - kill
        r0["kill_to_refit_s"] = r0["refit_unix"] - kill
        r0["checkpoint_saved_bytes"] = saved
        r0["checkpoint_dir_bytes"] = disk

    def _report_elastic_2x2(self, run, ranks, record, by_path) -> None:
        """[elastic 2x2]: rank 3 ended outright; the three survivors'
        frames, the 1 x 2 grid and the standby rank, the run log's rung,
        the recovery bars against phase 6, the launches after the
        shrink, and the seconds from the kill to the survivors' fit on
        the smaller grid (the rendezvous's settle window inside)."""
        from scdna_replication_tools_tpu_torch.obs.schema import validate_run
        from scdna_replication_tools_tpu_torch.parallel.distributed import (
            RENDEZVOUS_SETTLE_SECONDS,
        )

        tag = f"[{run}]"
        lost = ELASTIC_LOST[run]
        alive = [r for k, r in enumerate(ranks) if k != lost]
        r0 = alive[0]
        print(f"{tag} scRT(num_shards=2, loci_shards=2, checkpoint_dir=D, "
              f"checkpoint_every={ELASTIC_EVERY}), every other option at "
              f"its default, rank {lost} ended outright (os._exit) at the pass "
              f"{ELASTIC_EXIT[1]} of {ELASTIC_EXIT[0]}")
        check(all(r.get("digest") == r0["digest"] for r in alive),
              f"{tag} the {len(alive)} survivors return the same four "
              "output frames")
        check([r.get("mesh_after") for r in alive[:2]]
              == [{"cells": 1, "loci": 2}] * 2
              and [r.get("standby") for r in alive] == [False, False, True],
              f"{tag} ranks 0 and 1 end on a 1 x 2 grid "
              f"({[r.get('mesh_after') for r in alive[:2]]}) and rank 2 "
              f"stands by ({[r.get('standby') for r in alive]})")
        log = Path(r0["run_log_path"] or "")
        events = [json.loads(line) for line in log.read_text()
                  .splitlines()] if log.is_file() else []
        shrinks = [e for e in events if e["event"] == "degrade"
                   and e.get("action") == "mesh_shrink"]
        check(len(shrinks) == 1 and shrinks[0]["error_class"] == "hostloss"
              and shrinks[0]["from_topology"]["mesh_axes"]
              == {"cells": 2, "loci": 2}
              and shrinks[0]["to_topology"]["mesh_axes"]
              == {"cells": 1, "loci": 2},
              f"{tag} one degrade mesh_shrink (hostloss, 2 x 2 -> 1 x 2): "
              + json.dumps([{k: e.get(k) for k in (
                  "step", "error_class", "from_topology", "to_topology")}
                  for e in shrinks]))
        check(any(e["event"] == "resume" and e.get("resharded")
                  and e["step"] == "step2" and e["action"] == "resumed"
                  for e in events),
              f"{tag} step 2 resumed resharded")
        errors = validate_run(log) if events else ["no log"]
        check(not errors, f"{tag} the run log validates: {errors[:3]}")
        check(r0["rep_acc"] > 0.80 and r0["cn_acc"] > 0.90
              and r0["tau_r"] > 0.8 and 0.5 < r0["lambda"] < 0.95,
              f"{tag}: rep {r0['rep_acc']:.4f} > 0.80, CN "
              f"{r0['cn_acc']:.4f} > 0.90, tau r {r0['tau_r']:.4f} > 0.8, "
              f"lambda {r0['lambda']:.4f} in (0.5, 0.95)")
        ref = record["main_default"]
        for key in ("rep_acc", "cn_acc"):
            check(abs(r0[key] - ref[key]) <= SHARDED_ACC,
                  f"{tag}: {key} {r0[key]:.4f} within {SHARDED_ACC} of the "
                  f"one-rank default run's {ref[key]:.4f}")
        check(r0["tau_r"] >= ref["tau_r"] - SHARDED_TAU,
              f"{tag}: tau r {r0['tau_r']:.4f} >= default "
              f"{ref['tau_r']:.4f} - {SHARDED_TAU}")
        after = [{k: v - r.get("launches_before", {}).get(k, 0)
                  for k, v in r["launches"].items()} for r in alive[:2]]
        check(all(a[k] > 0 for a in after for k in CATEGORICAL),
              f"{tag} the dense and sparse fused pairs and Adam launched on "
              "both ranks of the 1 x 2 grid after the shrink: "
              + json.dumps(after))
        by_path[run] = {k: sum(r.get("launches", {}).get(k, 0)
                               for r in alive) for k in r0["launches"]}
        nan = float("nan")
        stamp = self.tmp / f"{run.replace(' ', '_')}.kill"
        kill = float(stamp.read_text()) if stamp.is_file() else nan
        for r in alive:
            for key in ("rung_unix", "reformed_unix", "refit_unix"):
                r.setdefault(key, nan)
        check(bool(np.isfinite([kill, r0["reformed_unix"],
                                r0["refit_unix"]]).all()),
              f"{tag} the kill, the re-formed group and the fit on the "
              "1 x 2 grid were each seen")
        ck = self.tmp / "elastic_2x2_ck"
        disk = sum(f.stat().st_size for f in ck.rglob("*") if f.is_file())
        saved = sum(e.get("bytes") or 0 for e in events
                    if e["event"] == "checkpoint" and e["action"] == "save")
        sharded = (record.get("sharded", {}).get("2x1") or {}).get("ranks")
        ref_wall = sharded[0]["wall_s"] if sharded else nan
        print(f"  kill at rank {lost}'s {ELASTIC_EXIT[0]}#{ELASTIC_EXIT[1]}; "
              "the rung entered / the group re-formed / the fit re-entered "
              "on the smaller grid, seconds after it: "
              + "; ".join(f"rank {k} {r['rung_unix'] - kill:.2f} / "
                          f"{r['reformed_unix'] - kill:.2f} / "
                          f"{r['refit_unix'] - kill:.2f}"
                          for k, r in enumerate(alive))
              + f" (settle window {RENDEZVOUS_SETTLE_SECONDS:.1f} s); "
              f"infer('pert') rank 0 {r0['wall_s']:.2f} s against [sharded "
              f"2x1]'s {ref_wall:.2f} s; step 1/2/3 "
              + " / ".join(f"{st['ms_per_iter']:.3f}" for st in r0["steps"])
              + f" ms/iteration; checkpoints: rank 0 logged {saved} bytes "
              f"saved, D holds {disk} bytes at the end; peak "
              f"{max(r.get('peak_bytes', 0) for r in alive)} bytes; "
              "launches after the shrink " + json.dumps(after))
        print(f"  rescue {json.dumps(r0.get('rescue'))}; one-rank default: "
              f"rep {ref['rep_acc']:.4f}, CN {ref['cn_acc']:.4f}, tau r "
              f"{ref['tau_r']:.4f}; elastic: rep "
              f"{r0['rep_acc']:.4f}, CN {r0['cn_acc']:.4f}, tau r "
              f"{r0['tau_r']:.4f}, lambda {r0['lambda']:.4f}")
        r0["kill_to_reformed_s"] = r0["reformed_unix"] - kill
        r0["kill_to_refit_s"] = r0["refit_unix"] - kill
        r0["checkpoint_saved_bytes"] = saved
        r0["checkpoint_dir_bytes"] = disk

    def close(self) -> None:
        import shutil

        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(10)
        shutil.rmtree(self.tmp, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 11: the serving worker with continuous batching
# ---------------------------------------------------------------------------

SERVE_SEEDS = (0, 1, 2, 3)     # four requests, seeds of simulate_frames
SERVE_SERIAL = 1               # the first again through a serial worker
SERVE_WIDTH = 4                # ServeWorker(max_batch=4)
# the block-axis kernels and the row of the solo kernel each one batches
LANES = {"fused_fwd_dense_lanes": "fused_fwd_dense",
         "fused_bwd_dense_lanes": "fused_bwd_dense",
         "fused_fwd_sparse_lanes": "fused_fwd_sparse",
         "fused_bwd_sparse_lanes": "fused_bwd_sparse",
         "adam_lanes": "adam"}
# decoded bins of a packed request that must equal its serial run's
SERVE_AGREE = 0.99


class MemoryTimeline:
    """While open, the card's allocated bytes by request and phase: a
    sample at every change of a serving request's phase (its thread's
    ``PhaseTimer`` phases, each step's fit, each packed dispatch) and
    every 0.25 s, each with every request's phase at that moment.  The
    samples go to ``path`` as JSON lines; :meth:`report` prints the peak
    with the phases then, per phase the most allocated while some
    request was in it, and the least memory free on the card (every
    process's use; read every 0.25 s)."""

    def __init__(self, path: Path):
        self.path = path
        self.samples: list = []

    def _label(self, request_thread_prefix="pert-serve-block-"):
        import threading
        name = threading.current_thread().name
        return name[len(request_thread_prefix):] \
            if name.startswith(request_thread_prefix) else None

    def _sample(self):
        import torch
        self.samples.append((round(time.perf_counter() - self.t0, 3),
                             torch.cuda.memory_allocated(),
                             dict(self.phases)))

    @contextlib.contextmanager
    def _in(self, label):
        rid = self._label()
        if rid is None:
            yield
            return
        stack = self.stacks.setdefault(rid, [])
        stack.append(label)
        with self.lock:
            self.phases[rid] = label
            self._sample()
        try:
            yield
        finally:
            stack.pop()
            with self.lock:
                self.phases[rid] = stack[-1] if stack else "-"
                self._sample()

    def __enter__(self):
        import threading

        import torch
        from scdna_replication_tools_tpu_torch.infer import runner, svi
        from scdna_replication_tools_tpu_torch.utils import profiling
        self.t0 = time.perf_counter()
        self.lock = threading.Lock()
        self.phases: dict = {}
        self.stacks: dict = {}
        self.stop = threading.Event()
        tl = self
        self.orig = (profiling.PhaseTimer.phase, runner.PertInference._fit_map,
                     svi.dispatch_chunk_slab)
        phase, fit_map, slab = self.orig

        @contextlib.contextmanager
        def timed_phase(timer, name):
            with tl._in(name), phase(timer, name):
                yield

        def timed_fit(inf, spec, *args, **kw):
            with tl._in(f"{args[5]}/fit"):
                return fit_map(inf, spec, *args, **kw)

        def timed_slab(calls, width, timings=None):
            with tl._in(f"slab x{len(calls)}"):
                return slab(calls, width, timings)
        profiling.PhaseTimer.phase = timed_phase
        runner.PertInference._fit_map = timed_fit
        svi.dispatch_chunk_slab = timed_slab
        self.mods = (profiling, runner, svi)

        self.low_free = None

        def tick():
            while not self.stop.wait(0.25):
                free = torch.cuda.mem_get_info()[0]
                with self.lock:
                    self._sample()
                    if self.low_free is None or free < self.low_free[1]:
                        self.low_free = (self.samples[-1][0], free,
                                         torch.cuda.memory_reserved())
        self.thread = threading.Thread(target=tick, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=5)
        profiling, runner, svi = self.mods
        (profiling.PhaseTimer.phase, runner.PertInference._fit_map,
         svi.dispatch_chunk_slab) = self.orig
        with open(self.path, "w") as fh:
            for t, b, ph in self.samples:
                fh.write(json.dumps({"t": t, "allocated": b,
                                     "phases": ph}) + "\n")
        return False

    def report(self, tag: str) -> dict:
        if not self.samples:
            return {}
        t, peak, at = max(self.samples, key=lambda s: s[1])
        by_phase: dict = {}
        for _, b, ph in self.samples:
            for label in set(ph.values()):
                by_phase[label] = max(by_phase.get(label, 0), b)
        print(f"[serve memory] {tag}: peak allocated {peak} B at "
              f"{t:.1f} s with the requests in {json.dumps(at)}; "
              f"{len(self.samples)} samples in {self.path.name}")
        print("  most allocated while some request was in: " + ", ".join(
            f"{k} {v / 2**30:.2f} GiB" for k, v in sorted(
                by_phase.items(), key=lambda kv: -kv[1])[:12]))
        low = {}
        if self.low_free is not None:
            low = dict(zip(("t", "free", "reserved"), self.low_free))
            print(f"  least free on the card {low['free']} B at "
                  f"{low['t']:.1f} s (this process reserved "
                  f"{low['reserved']} B then; the rest is other processes' "
                  "and the contexts')")
        return {"peak": peak, "peak_t": t, "peak_phases": at,
                "by_phase": by_phase, "low_free": low}


# the eager slab's step 2 at W = 4 and the three W = 4 kernels of its
# iteration (rows 3b, 4b and 11b), ms on an NVIDIA H100 80GB HBM3,
# 700.00 W (PERF.md, the serving cell)
SLAB_EAGER_MS = 50.612
SLAB_KERNELS_MS = 5.797 + 11.917 + 4.150


class SlabProbe:
    """Wraps ``svi.dispatch_chunk_slab`` while open: records each packed
    dispatch (its rung, live lanes, step, slab iterations, wall, and with
    the store its program, each form's hit or miss, captures and
    replays); profiles one packed step-2 dispatch with torch.profiler
    (device busy time against the dispatch's wall: the idle share of a
    slab; the card also runs whatever the other lanes' threads launch
    meanwhile), the first of a rung dispatched before that captured
    nothing (a profile of a dispatch that captured is dropped); and runs
    the first packed dispatch of two lanes (step 2 or 3) again without
    the store (the eager slab, on a thread of its own, from the same
    entry states and loss arguments), its outputs held to the replayed
    program's bit for bit.  It also keeps a copy of the first step-3
    chunk call of two requests (flagship step 3 seldom packs: a graphed
    step 3 is short), which :func:`check_step3_slab` dispatches as one
    slab after the drain."""

    def __init__(self):
        self.dispatches: list = []
        # request thread -> a copy of its first step-3 ChunkCall
        self.step3: dict = {}
        # step -> the profile of one of its packed dispatches
        self.profiles: dict = {}
        self.eager = None
        self.lock = None
        # (step, rung) of the dispatches so far: a profiled dispatch
        # replays a program that an earlier one made
        self.seen: set = set()

    def __enter__(self):
        import threading

        from scdna_replication_tools_tpu_torch.infer import svi
        self.lock = threading.Lock()
        self.svi, self.orig = svi, svi.dispatch_chunk_slab

        def probe(calls, width, timings=None, _orig=self.orig):
            t = {} if timings is None else timings
            spec = getattr(calls[0].loss_fn, "spec", None)
            step = "step1" if spec is not None and spec.step1 else \
                "step3" if spec is not None and spec.sparse_etas else "step2"
            with self.lock:
                rung = 2
                while rung < len(calls):
                    rung *= 2
                want = step in ("step2", "step3") \
                    and step not in self.profiles \
                    and (step, rung) in self.seen
                if want:
                    self.profiles[step] = {}
                same = step in ("step2", "step3") and self.eager is None \
                    and len(calls) == 2
                if same:
                    self.eager = {}
            if not want:
                out = _orig(calls, width, t)
            else:
                try:
                    prof = self._profiled(_orig, calls, width, t)
                except BaseException:
                    # no profile of a dispatch that failed: another of
                    # the step's may be profiled
                    with self.lock:
                        del self.profiles[step]
                    raise
                out = prof.pop("out")
                with self.lock:
                    if t.get("captures"):
                        del self.profiles[step]
                    else:
                        self.profiles[step] = prof
            if same:
                self._eager_again(_orig, calls, width, out, t)
            with self.lock:
                self.seen.add((step, rung))
                self.dispatches.append({
                    "step": step, "lanes": len(calls),
                    "rung": t.get("slab_width"),
                    "launched": t.get("launched"),
                    "seconds": t.get("seconds"),
                    "program": t.get("program"), "forms": t.get("forms"),
                    "captures": t.get("captures"),
                    "replays": t.get("replays")})
            return out
        svi.dispatch_chunk_slab = probe

        from scdna_replication_tools_tpu_torch.serve import slab
        self.slab_mod = slab
        self.orig_dispatch = slab.SlabFitCoordinator.dispatch

        def dispatch(coord, call, _orig=self.orig_dispatch):
            self._keep_step3(call)
            return _orig(coord, call)
        slab.SlabFitCoordinator.dispatch = dispatch
        return self

    def _keep_step3(self, call) -> None:
        """A copy of ``call`` (its entry state cloned, no store view, no
        meter) when it is the first step-3 chunk of its request and two
        are not kept yet."""
        import dataclasses
        import threading
        spec = getattr(call.loss_fn, "spec", None)
        if spec is None or spec.step1 or not spec.sparse_etas:
            return
        name = threading.current_thread().name
        with self.lock:
            if name in self.step3 or len(self.step3) >= 2:
                return
            self.step3[name] = None
        a = call.args
        state = self.svi._clone_tree(tuple(a[:4]))
        self.step3[name] = dataclasses.replace(
            call, args=state + tuple(a[4:]), programs=None, meter=None)

    def _eager_again(self, orig, calls, width, out, t):
        """The same calls through the eager slab on a thread without a
        store scope; compared with ``out`` bit for bit."""
        import threading

        import torch
        box = {}

        def run():
            try:
                box["out"] = orig(calls, width, {})
            except BaseException as exc:  # noqa: BLE001 — reported
                box["error"] = f"{type(exc).__name__}: {exc}"
        from scdna_replication_tools_tpu_torch.infer import aotcache
        from scdna_replication_tools_tpu_torch.ops import _cuda
        before = {k: v for k, v in _cuda.LAUNCHES.items()
                  if k.endswith("_lanes")}
        th = threading.Thread(target=run, name="slab-eager-again")
        th.start()
        th.join()
        # a device-wide synchronisation must not meet another request
        # thread's CUDA graph capture: it takes the captures' lock
        with aotcache.CAPTURE_LOCK:
            torch.cuda.synchronize()
        # a comparison's launches are not the serving path's (only a
        # slab dispatch, here the leader's, launches the lane kernels)
        extra = {k: _cuda.LAUNCHES[k] - v for k, v in before.items()}
        same, worst = _same_dispatch(self.svi, out, box["out"]) \
            if "out" in box else (True, 0)
        self.eager = {"graphed": "program" in t, "same": same and "out" in box,
                      "differing_elements": worst,
                      "error": box.get("error"),
                      "lanes": len(calls), "step": "step3"
                      if calls[0].loss_fn.spec.sparse_etas else "step2",
                      "i0": [int(c.args[4]) for c in calls],
                      "launches": extra}
        del box

    def _profiled(self, orig, calls, width, t):
        import torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from scdna_replication_tools_tpu_torch.infer import aotcache
        # the profiler's start and stop synchronise the device, which a
        # CUDA graph capture on another request's thread may not meet
        # (both would fail): they take the captures' lock, the dispatch
        # between them not
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with aotcache.CAPTURE_LOCK:
            prof.__enter__()
        try:
            out = orig(calls, width, t)
        finally:
            with aotcache.CAPTURE_LOCK:
                prof.__exit__(None, None, None)
        by_name: dict = {}
        for ev in prof.key_averages():
            # the named ranges' device spans (utils/profiling.scope)
            # cover kernels that count on their own
            if ev.device_type != DeviceType.CUDA \
                    or ev.key.startswith("pert/"):
                continue
            us = getattr(ev, "self_device_time_total", None)
            if us is None:
                us = ev.self_cuda_time_total
            by_name[_short(ev.key)] = by_name.get(_short(ev.key), 0.0) \
                + us / 1e3
        busy = sum(by_name.values())
        wall = 1e3 * t["seconds"]
        n = max(int(t["launched"]), 1)
        with aotcache.CAPTURE_LOCK:
            torch.cuda.synchronize()
        return {
            "out": out, "lanes": len(calls), "iterations": n,
            "wall_ms": wall, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall if busy else None,
            "graphed": "program" in t, "captures": t.get("captures"),
            "kernels_ms_per_iter": {
                k: v / n for k, v in sorted(by_name.items(),
                                            key=lambda kv: -kv[1])[:10]}}

    def __exit__(self, *exc):
        self.svi.dispatch_chunk_slab = self.orig
        self.slab_mod.SlabFitCoordinator.dispatch = self.orig_dispatch
        return False


def _same_dispatch(svi, a, b) -> tuple:
    """(bit-equal, differing elements) of two ``dispatch_chunk_slab``
    results: every lane's parameters, Adam state, losses and ring, its
    iteration count and flags, and the losses and ring it read back."""
    import torch
    same, worst = True, 0
    for (ca, _, ra), (cb, _, rb) in zip(a, b):
        leaves_a: list = []
        leaves_b: list = []
        svi._flatten((ca.params, ca.state, ca.losses, ca.diag), leaves_a)
        svi._flatten((cb.params, cb.state, cb.losses, cb.diag), leaves_b)
        for x, y in zip(leaves_a, leaves_b):
            if not torch.equal(x, y):
                same = False
                worst = max(worst, int((x != y).sum()))
        same = same and (ra.i, ra.converged, ra.is_nan) \
            == (rb.i, rb.converged, rb.is_nan) \
            and np.array_equal(ra.losses, rb.losses) \
            and np.array_equal(ra.diag, rb.diag)
    return same, worst


def check_step3_slab(probe, root: Path, record: dict) -> None:
    """The first step-3 chunks of two flagship requests (the probe's
    copies of their entry states, at the bucket's 1024 x 8192 padding)
    dispatched as one W = 2 slab: replayed from a ``slab2`` program of a
    store of its own (each form captured), then by the eager slab; the
    two held bit for bit.  Flagship step 3 seldom packs in the drain
    (graphed, it lasts under a second), so this is where a graphed
    step-3 slab meets the eager one at that shape; its launches are a
    comparison's, not the serving path's."""
    import shutil

    import torch
    from scdna_replication_tools_tpu_torch.infer import aotcache, svi
    calls = [c for c in probe.step3.values() if c is not None]
    probe.step3.clear()
    tag = "[serve step3 slab]"
    if len(calls) < 2:
        check(False, f"{tag} two requests' step-3 chunks were kept "
              f"({len(calls)})")
        return
    torch.cuda.empty_cache()
    store = root / "step3_store"
    t: dict = {}
    graphed = eager = None
    t0 = time.perf_counter()
    try:
        with aotcache.run_scope(str(store), None):
            graphed = svi.dispatch_chunk_slab(calls, 2, t)
        t_graphed = time.perf_counter() - t0
        t0 = time.perf_counter()
        eager = svi.dispatch_chunk_slab(calls, 2, {})
        t_eager = time.perf_counter() - t0
        same, worst = _same_dispatch(svi, graphed, eager)
        err = None
    except Exception as exc:  # noqa: BLE001 — reported as a check
        same, worst, err = False, None, f"{type(exc).__name__}: {exc}"
        t_graphed = t_eager = None
    finally:
        shutil.rmtree(store, ignore_errors=True)
    pi = svi.pi_param_name(calls[0].args[0])
    shape = tuple(calls[0].args[0][pi].shape) if pi else None
    print(f"{tag} two requests' first step-3 chunks (i0 "
          f"{[int(c.args[4]) for c in calls]}, stop "
          f"{[int(c.args[5]) for c in calls]}, pi {shape}) as one W = 2 "
          f"slab: graphed {t.get('forms')} ({t.get('captures')} captures, "
          f"{t.get('replays')} replays) in {t_graphed} s, eager in "
          f"{t_eager} s; bit-equal {same}, differing elements {worst}, "
          f"error {err}")
    check(same and "program" in t,
          f"{tag} a replayed step-3 slab at the flagship bucket's shape "
          "equals the eager slab on the same lanes bit for bit")
    record.setdefault("serve", {})["step3_slab"] = {
        "forms": t.get("forms"), "replays": t.get("replays"),
        "graphed_s": t_graphed, "eager_s": t_eager, "same": same,
        "differing_elements": worst, "error": err}
    del calls
    graphed = eager = None
    torch.cuda.empty_cache()


def _submit_seed(spool: str, seed: int) -> str:
    """Simulate one request's frames (seed ``seed``) and submit them to
    the spool at ``spool``: the task of one process of the pool that
    prepares the serving phase's requests side by side (writing a
    request's long-form TSVs takes tens of seconds)."""
    from scdna_replication_tools_tpu_torch.serve.queue import SpoolQueue
    cn_s, cn_g1 = simulate_frames(seed)
    return SpoolQueue(spool).submit_frames(cn_s, cn_g1,
                                           request_id=f"seed{seed}")


class Janitor:
    """While open, a thread that removes what a spool's workers no longer
    need: every finished request's checkpoint directory and the
    superseded ``.prev`` checkpoint files of the requests in flight.  A
    flagship request writes 12-14 GB of checkpoints at the worker's
    defaults (an in-fit save holds parameters, both moments and the
    best-loss copy; step 1 fits 2048 doubled G1 cells), which four of
    them at once would keep in the machine's memory, where the spool
    lies: the card's machine counts every byte written to its disk,
    deleted or not, against 45 GiB, and the phase's six requests write
    ~75 GB, so the spool is a fresh directory in /dev/shm, removed when
    the phase ends or fails."""

    def __init__(self, queue):
        import threading
        self.queue = queue
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="serve-janitor")

    def _run(self):
        import shutil
        while not self.stop.wait(0.5):
            for ck in (self.queue.root / "results").glob("*/ckpt"):
                doc = self.queue.status(ck.parent.name) or {}
                if doc.get("state") in ("done", "failed"):
                    shutil.rmtree(ck, ignore_errors=True)
                    continue
                for prev in ck.glob("*.prev"):
                    prev.unlink(missing_ok=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join(timeout=30)
        return False


def _ckpt_bytes(events) -> int:
    """Checkpoint bytes a request's run wrote (its ``checkpoint`` save
    events)."""
    return int(sum(e.get("bytes") or 0 for e in events
                   if e["event"] == "checkpoint"
                   and e.get("action") == "save"))


# the served output's columns the checks read
SERVED_COLUMNS = ("cell_id", "chr", "start", "model_cn_state",
                  "model_rep_state", "model_tau", "true_rep",
                  "true_somatic_cn", "true_t")


def _served(queue, rid):
    """A request's S output frame (the columns the checks read) and its
    run log's events."""
    import pandas as pd
    d = queue.results_dir(rid)
    out = pd.read_csv(d / "output.tsv", sep="\t", dtype={"chr": str},
                      usecols=list(SERVED_COLUMNS))
    events = [json.loads(line) for line in
              (d / "run.jsonl").read_text().splitlines()]
    return out, events


def _recovery(out) -> dict:
    per_cell = out.groupby("cell_id").agg(tau=("model_tau", "first"),
                                          true_t=("true_t", "first"))
    return {
        "rep_acc": float((out["model_rep_state"] == out["true_rep"]).mean()),
        "cn_acc": float((out["model_cn_state"]
                         == out["true_somatic_cn"]).mean()),
        "tau_r": float(np.corrcoef(per_cell["tau"],
                                   per_cell["true_t"])[0, 1])}


def _drain(queue, max_batch: int, store_dir: str = "auto") -> tuple:
    """One worker over ``queue`` until it is empty, on the card, its
    compiled-program store in ``store_dir`` ('auto': under the spool);
    returns (worker, stats, wall seconds, launches, peak bytes)."""
    import torch
    from scdna_replication_tools_tpu_torch.ops import _cuda
    from scdna_replication_tools_tpu_torch.serve import ServeWorker
    worker = ServeWorker(queue, max_batch=max_batch, exit_when_idle=True,
                         executable_cache_dir=store_dir)
    want = str(queue.root / "exec_cache") if store_dir == "auto" \
        else store_dir
    check(worker.device.type == "cuda"
          and worker.executable_cache_dir == want,
          f"[serve] ServeWorker(max_batch={max_batch}) runs on "
          f"{worker.device} with the compiled-program store "
          f"{worker.executable_cache_dir} ('auto', JAX's rule, or the "
          "batched drain's)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t0 = time.perf_counter()
    stats = worker.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (worker, stats, wall, dict(_cuda.LAUNCHES),
            torch.cuda.max_memory_allocated())


def _store_block(queue, rids, tag: str, store_dir=None, doc=None) -> dict:
    """The worker's status document's (``doc``, else the spool's)
    ``executable_cache`` block and the graph programs of each request's
    run (its ``compile`` events of the solo chunks and, in a slab, of the
    ``slab{W}`` programs)."""
    import collections

    if doc is None:
        doc = json.loads(queue.status_path.read_text())
    block = doc.get("executable_cache") or {}
    graphs, slabs, passes = {}, {}, {}
    for rid in rids:
        path = queue.results_dir(rid) / "run.jsonl"
        if path.exists():
            events = _compile_events(path)
            graphs[rid] = dict(collections.Counter(
                e["cache"] for e in events if e.get("tag") in ("chunk",
                                                               "fit")))
            slabs[rid] = dict(collections.Counter(
                f"{e['label']} {e['cache']}" for e in events
                if str(e.get("tag", "")).startswith("slab")))
            passes[rid] = dict(collections.Counter(
                f"{e['tag']} {e['cache']}" for e in events
                if e.get("tag") in PASS_TAGS))
    shown = {k: v for k, v in block.items()
             if k != "precaptured_key_hashes"}
    print(f"  {tag} store: status.json executable_cache {json.dumps(shown)}"
          f"; graph programs per request (captured / found) "
          f"{json.dumps(graphs)}" + (f"; slab programs per request "
                                     f"{json.dumps(slabs)}"
                                     if any(slabs.values()) else "")
          + f"; decode and PPC programs per request {json.dumps(passes)}")
    check(block.get("dir") == (store_dir or str(queue.root / "exec_cache"))
          and block.get("done") is True and {"preloaded", "entries",
                                             "programs", "program_bytes"}
          <= set(block),
          f"[serve] {tag}: the status document shows the store's block")
    check(graphs and all(g.get("miss", 0) + g.get("hit", 0) > 0
                         for g in graphs.values()),
          f"[serve] {tag}: every request's solo chunks replayed graphs")
    check(passes and all(set(c.split()[0] for c in p) == set(PASS_TAGS)
                         for p in passes.values()),
          f"[serve] {tag}: every request's decode and PPC replayed "
          "programs")
    return {"status": block, "graphs": graphs, "slabs": slabs,
            "passes": passes}


# the pair: two copies of one request of seed PAIR_SEED's frames,
# through ServeWorker(max_batch=2): the clones' G1 prior (one-hot, so
# step 2 takes the sparse kernels as step 3 does) and a long step 2
# (min_iter 500, no convergence test, no rescue), so that the two lanes
# share step 2 and the sparse block-axis kernels launch on the serving
# path whatever the four flagship requests' timing (with graphed solo
# chunks a flagship step 3 lasts well under a second: two requests
# seldom share it; their step 2, on the dense kernels, they do).  It
# runs beside phases 7-10, not beside the batched drain, whose late
# packaging is the host's memory low (a pair beside it ran the machine
# out of host memory)
PAIR_SEED = 4
PAIR_CELLS = (128, 64)             # S, G1 cells
PAIR_OPTIONS = {"cn_prior_method": "g1_clones", "min_iter": 500,
                "max_iter": 1000, "rel_tol": 0.0, "mirror_rescue": False}


def _pair_drain(root: Path) -> dict:
    """Two copies of one request (``PAIR_*``) drained by
    ``ServeWorker(max_batch=2)`` on its own spool: both ok, their
    outputs alike, packed dispatches on the sparse lane kernels; returns
    its launches, stats, wall and peak."""
    import pandas as pd

    from scdna_replication_tools_tpu_torch.serve import SpoolQueue

    cn_s, cn_g1 = simulate_frames(PAIR_SEED, num_cells=PAIR_CELLS)
    queue = SpoolQueue(root)
    for rid in ("pair_a", "pair_b"):
        queue.submit_frames(cn_s, cn_g1, options=PAIR_OPTIONS,
                            request_id=rid)
    with Janitor(queue):
        worker, stats, wall, launches, peak = _drain(queue, 2)
    coord = worker.slab_coordinator
    outs = [pd.read_csv(queue.results_dir(r) / "output.tsv", sep="\t",
                        dtype={"chr": str}) for r in ("pair_a", "pair_b")
            if queue.status(r).get("status") == "ok"]
    print(f"[serve pair] ServeWorker(max_batch=2), two copies of a "
          f"{PAIR_CELLS[0]} S + {PAIR_CELLS[1]} G1 cell request at "
          f"{json.dumps(PAIR_OPTIONS)}: {json.dumps(stats['by_status'])} in "
          f"{wall:.2f} s; packed {coord.packed_dispatches} of "
          f"{coord.dispatches} dispatches (graphed {coord.packed_graphed}, "
          f"degraded {coord.degraded}); lane "
          "launches " + json.dumps({k: v for k, v in launches.items()
                                    if k.endswith("_lanes")}))
    # a copy's chunk runs alone while its twin is still in another step
    # (a packed lane rounds as a solo fit does not), so the two are held
    # as packed requests are to their serial run
    same = float(((outs[0]["model_cn_state"] == outs[1]["model_cn_state"])
                  & (outs[0]["model_rep_state"]
                     == outs[1]["model_rep_state"])).mean()) \
        if len(outs) == 2 else 0.0
    check(stats["by_status"] == {"ok": 2} and same >= SERVE_AGREE,
          f"[serve pair] both copies end ok, their outputs decoding "
          f"{same:.4%} of bins alike >= {SERVE_AGREE:.0%}")
    check(coord.packed_dispatches > 0 and coord.packed_graphed
          == coord.packed_dispatches and coord.degraded == 0
          and launches["fused_fwd_sparse_lanes"] > 0
          and launches["fused_bwd_sparse_lanes"] > 0,
          "[serve pair] it packed (the sparse lane kernels launched), "
          "each packed dispatch replaying a slab program")
    return {"launches": launches, "wall": wall, "peak": peak,
            "stats": {k: stats[k] for k in ("processed", "by_status")}}


def _serial_drain(root: str, store_dir: str) -> dict:
    """The serial worker's drain of ``root`` (``max_batch=1``) with the
    store in ``store_dir`` ('auto': under the spool), the task of a
    spawned process beside the earlier phases: what it printed, the
    checks that failed, its stats, wall and peak."""
    import io

    from scdna_replication_tools_tpu_torch.serve import SpoolQueue

    out = io.StringIO()
    queue = SpoolQueue(root)
    with contextlib.redirect_stdout(out):
        _, stats, wall, _, peak = _drain(queue, 1, store_dir)
    # the worker's last status document (the next worker on the spool
    # rewrites it)
    return {"log": out.getvalue(), "failures": list(FAILURES),
            "stats": {k: stats[k] for k in ("processed", "by_status")},
            "wall": wall, "peak": peak,
            "status": json.loads(queue.status_path.read_text())}


def _pair_task(root: str) -> dict:
    """:func:`_pair_drain` in a spawned process: what it printed, the
    checks that failed and its result."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = _pair_drain(Path(root))
    return dict(res, log=out.getvalue(), failures=list(FAILURES))


class SerialDrain:
    """A drain in a spawned process of its own, beside the earlier phases
    (:class:`EarlyServing`): the serial worker (the first worker life),
    or the pair (``task=_pair_task``); :meth:`result` waits, prints what
    it printed and counts its checks."""

    def __init__(self, *args, task=_serial_drain):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        # the process ends with its task, so that its memory goes back
        # to the host before the result is read
        self.pool = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"),
                                        max_tasks_per_child=1)
        self.future = self.pool.submit(task, *[str(a) for a in args])

    def result(self) -> dict:
        try:
            res = self.future.result()
        finally:
            self.pool.shutdown(wait=True, cancel_futures=True)
        print(res["log"], end="")
        FAILURES.extend(res["failures"])
        return res


# the second worker life waits for this much free host memory before it
# starts (the spool and its checkpoints lie in /dev/shm)
SECOND_LIFE_HOST_GIB = 8.0
SECOND_LIFE_WARMUP_S = 600.0


def _second_life(root: str, rid: str, store_dir: str, data: str) -> dict:
    """A second worker life on the first life's spool and store (the
    serial worker's), the task of a spawned process started when that
    worker has exited: a serial worker (``max_batch=1``, one request)
    whose warm-up ranks the store's records by the first worker's
    ``buckets_served`` ledger and captures the programs again; once the
    status document says the warm-up is done, request ``rid``'s data (its
    TSVs in ``data``, where the first life's ticket pointed) is submitted
    again and drained.  Returns
    the warm-up's block, its seconds, the new request's id, wall, state
    and ``compile`` events, the ledger it read and the peak."""
    import threading

    import torch
    from scdna_replication_tools_tpu_torch.serve import (
        ServeWorker,
        SpoolQueue,
    )

    queue = SpoolQueue(root)
    t0 = time.perf_counter()
    started = time.time() - 1.0
    worker = ServeWorker(queue, max_batch=1, max_requests=1,
                         executable_cache_dir=store_dir)
    ledger = dict(worker._prior_buckets)
    torch.cuda.reset_peak_memory_stats()
    thread = threading.Thread(target=worker.run, name="second-life")
    thread.start()
    def block() -> dict:
        """This worker's status document's store block ({} while the
        file is still the first life's)."""
        try:
            doc = json.loads(queue.status_path.read_text())
        except (OSError, ValueError):
            return {}
        if doc.get("pid") != os.getpid() \
                or doc.get("started_unix", 0) < started:
            return {}
        return doc.get("executable_cache") or {}
    deadline = time.monotonic() + SECOND_LIFE_WARMUP_S
    while time.monotonic() < deadline and thread.is_alive() \
            and not block().get("done"):
        time.sleep(0.25)
    warm_s = time.perf_counter() - t0
    src = Path(data)
    new = queue.submit(str(src / "cn_s.tsv"), str(src / "cn_g1.tsv"),
                       request_id=f"{rid}_life2")
    t1 = time.perf_counter()
    thread.join(timeout=900)
    wall = time.perf_counter() - t1
    if thread.is_alive():
        worker.request_drain()
        thread.join(timeout=60)
    path = queue.results_dir(new) / "run.jsonl"
    return {"warmup": block(), "warmup_s": warm_s, "rid": new,
            "wall": wall, "ledger": ledger,
            "state": queue.status(new) or {},
            "events": _compile_events(path) if path.exists() else [],
            "peak": torch.cuda.max_memory_allocated()}


class SecondLife:
    """:func:`_second_life` in a spawned process, started when the first
    life has exited (:class:`EarlyServing`) and joined after the batched
    drain (:meth:`finish`)."""

    def __init__(self, root, rid, store_dir, data):
        import multiprocessing as mp
        from concurrent.futures import ProcessPoolExecutor

        from scdna_replication_tools_tpu_torch.serve import SpoolQueue

        self.janitor = Janitor(SpoolQueue(root)).__enter__()
        waited = 0.0
        while HostMemory.available() < SECOND_LIFE_HOST_GIB * 2**30 \
                and waited < 120.0:
            time.sleep(1.0)
            waited += 1.0
        self.free = HostMemory.available()
        # the process ends with its task, so that its device memory goes
        # back before the batched drain starts (:class:`EarlyServing`)
        self.pool = ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"),
                                        max_tasks_per_child=1)
        self.future = self.pool.submit(_second_life, str(root), rid,
                                       str(store_dir), str(data))
        self.root, self.rid = Path(root), rid

    def finish(self, record: dict, first: dict) -> None:
        """Its checks: every pre-captured program's per-form key hash is
        one of the first life's ``compile`` events' (``first['hashes']``),
        the request ends ok, every ``compile`` event of it is a ``hit``,
        and its output equals the first life's solo run of the same data
        (the serial drain's) bit for bit."""
        import collections

        import pandas as pd
        try:
            res = self.future.result()
        finally:
            self.pool.shutdown(wait=True, cancel_futures=True)
            self.janitor.__exit__(None, None, None)
        warm = res["warmup"]
        keys = warm.get("precaptured_key_hashes") or []
        cache = collections.Counter(f"{e.get('tag')}:{e.get('cache')}"
                                    for e in res["events"])
        print(f"[serve second life] a serial worker on the first life's "
              f"spool and store ({self.free / 2**30:.1f} GiB of host memory "
              f"free at its start), ledger {json.dumps(res['ledger'])}: warm-up "
              f"done after {res['warmup_s']:.1f} s, {warm.get('precaptured')}"
              f" programs captured again in {warm.get('precapture_seconds')}"
              f" s ({len(keys)} forms), {warm.get('preloaded')} ready, "
              f"{warm.get('entries')} records, error "
              f"{warm.get('error')}; request {res['rid']} "
              f"{res['state'].get('state')}/{res['state'].get('status')} in "
              f"{res['wall']:.1f} s (the first life's solo run of its data: "
              f"{first['serial_wall']} s, its batched run: "
              f"{first['batched_wall']} s); compile events "
              f"{json.dumps(dict(cache))}; peak {res['peak']} B")
        check(warm.get("done") is True and warm.get("precaptured", 0) > 0
              and not warm.get("error"),
              "[serve second life] the warm-up captured the ranked programs "
              "again before traffic, without an error")
        check(bool(keys) and set(keys) <= first["hashes"],
              "[serve second life] every pre-captured program's key hash is "
              "a compile event's of the first life")
        check(res["state"].get("status") == "ok",
              f"[serve second life] {res['rid']} ends done/ok")
        check(bool(res["events"]) and all(
            e.get("cache") == "hit" for e in res["events"]),
              f"[serve second life] every compile event of {res['rid']} is "
              f"a hit ({json.dumps(dict(cache))})")
        check_pass_events("[serve second life]",
                          pass_events(res["events"]), want_miss=False)
        same = False
        if res["state"].get("status") == "ok" and first.get("output") \
                is not None:
            d = self.root / "results" / res["rid"] / "output.tsv"
            out = pd.read_csv(d, sep="\t", dtype={"chr": str},
                              usecols=list(SERVED_COLUMNS))
            same = bool(out.equals(first["output"]))
        check(same, f"[serve second life] {res['rid']}'s output equals the "
              "first life's solo run of the same data bit for bit")
        record.setdefault("serve", {})["second_life"] = {
            k: res[k] for k in ("warmup_s", "rid", "wall", "ledger", "peak")}
        record["serve"]["second_life"].update(
            warmup={k: v for k, v in warm.items()
                    if k != "precaptured_key_hashes"},
            compile=dict(cache), bit_equal=same)


def _top_phases(events, n: int = 8) -> str:
    """The request run's ``n`` longest phases (its run_end's ledger)."""
    end = events[-1] if events and events[-1]["event"] == "run_end" else {}
    phases = {k: v for k, v in (end.get("phases") or {}).items()
              if k != "total_accounted"}
    top = sorted(phases.items(), key=lambda kv: -kv[1])[:n]
    return ", ".join(f"{k} {v:.1f} s" for k, v in top)


def _step2_rate(events) -> tuple:
    """(step-2 ms per iteration, cell-iterations per second) of one
    request's fit, over its real S cells, without the in-fit checkpoint
    saves that its fit wall holds (the ``checkpoint`` events before its
    ``fit_end``)."""
    end = next(i for i, e in enumerate(events) if e["event"] == "fit_end"
               and e["step"] == "step2")
    saves = sum(e.get("seconds") or 0.0 for e in events[:end]
                if e["event"] == "checkpoint" and e.get("step") == "step2"
                and e.get("action") == "save")
    wall = events[end]["wall_seconds"] - saves
    iters = max(events[end]["iters"], 1)
    return 1e3 * wall / iters, CELLS * iters / max(wall, 1e-9)


class ServeSpool:
    """The serving phase's spool and its requests, prepared from the
    start of the script: four spawned processes (they need no card)
    simulate the requests and write their TSVs (~60 s of the host's time)
    while the earlier phases run.  The spool lies in ``/dev/shm`` (see
    :class:`Janitor`); :meth:`close` stops the processes and removes it,
    also when a phase fails on the way."""

    def __init__(self):
        import atexit
        import multiprocessing as mp
        import tempfile
        from concurrent.futures import ProcessPoolExecutor

        shm = Path("/dev/shm")
        self.root = Path(tempfile.mkdtemp(
            prefix="pert_serve_", dir=shm if shm.is_dir() else None))
        self.t0 = time.perf_counter()
        self.pool = ProcessPoolExecutor(len(SERVE_SEEDS),
                                        mp_context=mp.get_context("spawn"))
        self.futures = [self.pool.submit(_submit_seed,
                                         str(self.root / "batched"), seed)
                        for seed in SERVE_SEEDS]
        atexit.register(self.close)

    def requests(self) -> list:
        """The request ids, once every process has submitted its own."""
        rids = [f.result() for f in self.futures]
        self.pool.shutdown(wait=True)
        return rids

    def close(self) -> None:
        import shutil
        self.pool.shutdown(wait=True, cancel_futures=True)
        shutil.rmtree(self.root, ignore_errors=True)


def _request_wall(queue, rid):
    """A request's wall in its worker's log (``request_end``), or None."""
    for path in queue.root.glob("worker_*.jsonl"):
        for line in path.read_text().splitlines():
            try:
                ev = json.loads(line)
            except ValueError:     # a line another worker is writing
                continue
            if ev.get("event") == "request_end" \
                    and ev.get("request_id") == rid:
                return ev.get("wall_seconds")
    return None


def slab_programs(coord, probe) -> dict:
    """The batched drain's slab programs: captures by rung and form,
    replays against the slab iterations launched, and the coordinator's
    counts of graphed, eager and degraded packed dispatches (with a
    store every packed dispatch must replay a program: none eager, none
    degraded); the eager re-run of one dispatch held to its replay."""
    import collections

    packed = [d for d in probe.dispatches if d["lanes"] >= 2]
    caps = collections.Counter()
    hits = collections.Counter()
    for d in packed:
        for form, c in (d["forms"] or {}).items():
            (caps if c == "miss" else hits)[f"slab{d['rung']}:{form}"] += 1
    replays = sum(d["replays"] or 0 for d in packed)
    launched = sum(d["launched"] or 0 for d in packed)
    programs = sorted({d["program"] for d in packed if d["program"]})
    print(f"  slab programs: {len(programs)} ({', '.join(programs)}); "
          f"captures by rung and form {json.dumps(dict(caps))}, replays of "
          f"captured forms {json.dumps(dict(hits))}; {replays} replays for "
          f"{launched} slab iterations launched; packed dispatches "
          f"graphed {coord.packed_graphed}, eager "
          f"{coord.packed_dispatches - coord.packed_graphed}, "
          f"degraded {coord.degraded} ({coord.degrade_error})")
    check(packed and all(d["program"] for d in packed)
          and coord.degraded == 0
          and coord.packed_graphed == coord.packed_dispatches,
          "[serve] with the store every packed dispatch replayed a slab "
          "program: none ran eagerly, none degraded lane by lane")
    check(replays == launched, f"[serve] slab replays {replays} equal the "
          f"slab iterations launched {launched}")
    eager = probe.eager or {}
    print(f"  eager slab again on one dispatch's lanes ({eager.get('step')}"
          f", i0 {eager.get('i0')}): bit-equal {eager.get('same')}, "
          f"differing elements {eager.get('differing_elements')}, error "
          f"{eager.get('error')}")
    check(bool(eager.get("graphed")) and eager.get("same") is True,
          "[serve] a replayed slab of two lanes equals the eager slab on "
          "the same lanes bit for bit")
    return {"programs": programs, "captures": dict(caps),
            "hits": dict(hits), "replays": replays, "launched": launched,
            "graphed": coord.packed_graphed,
            "eager": coord.packed_dispatches - coord.packed_graphed,
            "degraded": coord.degraded, "eager_again": eager}


def program_records(store_dir, block: dict) -> dict:
    """The program records the drain left in its store (tag, forms and
    device bytes each: buffers and pool, the decode and PPC programs'
    shared pool once, as ``pass pool``), summed by tag against the
    worker's cap on the programs it holds at once, and (``block``, the
    status document's store block) the programs the cap released and
    the most the store held at once."""
    import torch
    from scdna_replication_tools_tpu_torch.infer import aotcache
    from scdna_replication_tools_tpu_torch.serve import worker

    recs = [e["meta"] for e in aotcache.ExecutableStore(
        str(store_dir)).entries() if e["meta"].get("kind") == "program"]
    by_tag: dict = {}
    for m in recs:
        by_tag[m["tag"]] = by_tag.get(m["tag"], 0) + int(m.get("nbytes", 0))
        if "pool_bytes" in m:
            by_tag["pass pool"] = max(by_tag.get("pass pool", 0),
                                      int(m["pool_bytes"]))
    cap = int(worker.PROGRAM_MEMORY_SHARE * torch.cuda.get_device_properties(
        0).total_memory)
    total = sum(by_tag.values())
    released = block.get("programs_released", 0)
    print(f"  program records: {len(recs)}, device bytes by tag "
          f"{json.dumps(by_tag)}, {total} B in all against the worker's "
          f"cap of {cap} B: {released} idle programs released, at most "
          f"{block.get('peak_program_bytes')} B held at once")
    check(total <= cap or released > 0,
          "[serve] the programs past the worker's cap were released")
    return {"records": recs, "bytes_by_tag": by_tag, "cap": cap,
            "released": released}


class EarlyServing:
    """The serving phase's processes that run beside phases 7-10,
    started once the [graphs] phase is done (its timings are held to
    phase 6's, which ran alone): the pair
    (:func:`_pair_task`) and, as soon as the first request's data is
    written, the first worker life (a serial worker, ``max_batch=1``, on
    seed 0's data in a spool and store of its own); the moment that
    worker exits, a thread starts the second worker life
    (:class:`SecondLife`) on its spool and store.  The batched drain
    later runs with neither beside it (:meth:`wait_second`): the late
    packaging of its four requests is the host's memory low (11-12 GiB
    of the machine's 96 GiB free in runs on an H100 80GB HBM3 host), a
    second life beside its first packed dispatches ran the card out of
    memory (its decode and PPC programs held beside the drain's), and
    with a drain beside it the whole script took over 1100 s on a slow
    host.  Started after phase 6, beside [graphs], the lives ended before
    the drain, but shared the card with [graphs]' timed run."""

    def __init__(self, spool: ServeSpool):
        import threading

        from scdna_replication_tools_tpu_torch.serve import SpoolQueue
        self.spool = spool
        self.pair = SerialDrain(spool.root / "pair", task=_pair_task)
        self.serial = SpoolQueue(spool.root / "serial")
        self.janitor = Janitor(self.serial).__enter__()
        self.first = None
        self.second = None
        self.error = None
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="serve-lives")
        self.thread.start()

    def _run(self) -> None:
        try:
            rids = [f.result() for f in self.spool.futures[:SERVE_SERIAL]]
            for rid in rids:
                src = self.spool.root / "batched" / "data" / rid
                self.serial.submit(str(src / "cn_s.tsv"),
                                   str(src / "cn_g1.tsv"), request_id=rid)
            self.first = SerialDrain(self.serial.root, "auto")
            self.first.future.exception()
            self.second = SecondLife(
                self.serial.root, rids[0],
                str(self.serial.root / "exec_cache"),
                self.spool.root / "batched" / "data" / rids[0])
        except BaseException as exc:  # noqa: BLE001 — raised by join()
            self.error = exc

    def join(self) -> None:
        """Wait until the second life has started (the first has ended)."""
        self.thread.join()
        if self.error is not None:
            raise self.error

    def wait_second(self) -> float:
        """Wait until the second life's process has ended and given its
        device memory back (its result is read by ``SecondLife.finish``);
        returns the seconds waited."""
        import concurrent.futures

        t0 = time.perf_counter()
        self.join()
        concurrent.futures.wait([self.second.future])
        self.second.pool.shutdown(wait=True)
        return time.perf_counter() - t0

    def close(self) -> None:
        self.janitor.__exit__(None, None, None)
        for job in (self.pair, self.first):
            if job is not None:
                job.pool.shutdown(wait=True, cancel_futures=True)
        if self.second is not None:
            self.second.pool.shutdown(wait=True, cancel_futures=True)


def serving(dev, record, default_ref, spool: ServeSpool,
            early: EarlyServing) -> tuple:
    """The serving path: four flagship requests (seeds 0-3, every option
    at its JAX default) through ``ServeWorker(max_batch=4)``, the first
    of them through a serial worker and the pair (both started beside
    the earlier phases, ``early``); the checks of the serving phase
    (module docstring, phase 11).  Returns the launches of the batched
    drain and the pair, the second worker life (:class:`SecondLife`,
    started; the spool stays until it is joined) and what it is held
    to."""
    import torch
    from scdna_replication_tools_tpu_torch.obs.schema import validate_run
    from scdna_replication_tools_tpu_torch.serve import SpoolQueue

    root = spool.root
    rec = record.setdefault("serve", {})
    second = None
    try:
        queue = SpoolQueue(root / "batched")
        t0 = time.perf_counter()
        rids = spool.requests()
        print(f"[serve] {len(rids)} requests of {CELLS} S + {G1_CELLS} G1 "
              f"cells x {LOCI} loci simulated and submitted by "
              f"{len(SERVE_SEEDS)} processes into {root} while the earlier "
              f"phases ran ({time.perf_counter() - spool.t0:.1f} s since "
              f"they started; waited {time.perf_counter() - t0:.1f} s here)")
        serial = early.serial
        waited = early.wait_second()
        print(f"[serve] the second worker life ended {waited:.1f} s after "
              "the earlier phases: the batched drain runs alone")
        timeline = MemoryTimeline(REPO / "chiprun_out" / "serve_memory.jsonl")
        with timeline, SlabProbe() as probe, Janitor(queue):
            worker, stats, wall, launches, peak = _drain(queue, SERVE_WIDTH)
        for k, v in ((probe.eager or {}).get("launches") or {}).items():
            launches[k] -= v
        # both worker lives ended beside the earlier phases
        second = early.second
        sres = early.first.result()
        # the serving path's launches: the batched drain's and the pair's
        pair = early.pair.result()
        launches = {k: v + pair["launches"].get(k, 0)
                    for k, v in launches.items()}
        rec["pair"] = {k: pair[k] for k in ("wall", "peak", "stats")}
        rec["batched_memory"] = timeline.report("batched")
        coord = worker.slab_coordinator
        rungs = sorted({d["rung"] for d in probe.dispatches})
        print(f"[serve batched] ServeWorker(max_batch={SERVE_WIDTH}) drained "
              f"{stats['processed']} requests in {wall:.2f} s: "
              f"{json.dumps(stats['by_status'])}; fit dispatches "
              f"{coord.dispatches}, packed {coord.packed_dispatches} with "
              f"{coord.packed_lanes} lanes, rungs {rungs}; peak device "
              f"memory {peak} bytes")
        print(f"  launches (the batched drain's and the pair's) "
              f"{json.dumps(launches)}")
        rec["batched_store"] = _store_block(queue, rids, "batched")
        rec["slab_programs"] = slab_programs(coord, probe)
        check_step3_slab(probe, root, record)
        rec["program_records"] = program_records(
            queue.root / "exec_cache", rec["batched_store"]["status"])
        ends = {}
        for line in Path(stats["worker_log"]).read_text().splitlines():
            ev = json.loads(line)
            if ev["event"] in ("request_start", "request_end"):
                ends.setdefault(ev["request_id"], {})[ev["event"]] = ev
            elif ev["event"] == "span_end" and ev["name"] in (
                    "admission", "stream_back"):
                rid = (ev.get("attrs") or {}).get("request_id")
                ends.setdefault(rid, {})[ev["name"]] = ev["duration_seconds"]
        for rid in rids:
            doc = queue.status(rid)
            start = ends.get(rid, {}).get("request_start", {})
            end = ends.get(rid, {}).get("request_end", {})
            print(f"  {rid}: {doc.get('state')} / {doc.get('status')}, wall "
                  f"{end.get('wall_seconds')} s (admission "
                  f"{ends.get(rid, {}).get('admission')} s, stream back "
                  f"{ends.get(rid, {}).get('stream_back')} s), queue wait "
                  f"{start.get('queue_wait_seconds')} s, bucket "
                  f"{json.dumps(start.get('bucket'))}, pad_frac "
                  f"{start.get('pad_frac')}, retired_early "
                  f"{end.get('retired_early')}")
            check(doc.get("state") == "done" and doc.get("status") == "ok",
                  f"[serve] {rid} ends done/ok")
            check("request_start" in ends.get(rid, {})
                  and "request_end" in ends.get(rid, {}),
                  f"[serve] {rid}: request_start and request_end in the "
                  "worker log")
        check(coord.packed_dispatches > 0
              and coord.packed_lanes >= 2 * coord.packed_dispatches,
              f"[serve] packed dispatches {coord.packed_dispatches} > 0, "
              f"lanes {coord.packed_lanes} >= 2 x dispatches")
        check(validate_run(stats["worker_log"]) == [],
              "[serve] the worker log is schema-valid")
        for name in LANES:
            check(launches[name] > 0, f"[serve] {name} launched "
                  f"{launches[name]} times on the serving path")
        packed, rates = {}, {}
        for rid in rids:
            if queue.status(rid).get("status") != "ok":
                continue
            out, events = _served(queue, rid)
            path = queue.results_dir(rid) / "run.jsonl"
            start = events[0]
            check(validate_run(path) == [] and start.get("request_id") == rid
                  and start.get("slab_width") == SERVE_WIDTH,
                  f"[serve] {rid}: its log is schema-valid, run_start "
                  f"carries request_id {start.get('request_id')} and "
                  f"slab_width {start.get('slab_width')}")
            packed[rid] = (out, _recovery(out))
            rates[rid] = _step2_rate(events)
            ends[rid]["ckpt_bytes"] = _ckpt_bytes(events)
            print(f"  {rid} phases: {_top_phases(events)}")
        slab2 = [d for d in probe.dispatches if d["step"] == "step2"]
        it2 = sum(d["launched"] for d in slab2)
        s2 = sum(d["seconds"] for d in slab2)
        lane_it2 = sum(d["launched"] * d["lanes"] for d in slab2)
        slab_ms = 1e3 * s2 / max(it2, 1)
        slab_cells = CELLS * lane_it2 / max(s2, 1e-9)
        warm2 = [d for d in slab2 if not d["captures"]]
        warm_ms = 1e3 * sum(d["seconds"] for d in warm2) / max(
            sum(d["launched"] for d in warm2), 1) if warm2 else None
        print(f"  step 2 packed without a capture: {len(warm2)} slab "
              f"dispatches, {warm_ms if warm_ms is None else round(warm_ms, 3)}"
              " ms per slab iteration")
        print(f"  step 2 packed: {len(slab2)} slab dispatches, {it2} slab "
              f"iterations, {slab_ms:.3f} ms per slab iteration (the eager "
              f"slab's at W = 4: {SLAB_EAGER_MS} ms; its W = 4 kernels "
              f"{SLAB_KERNELS_MS:.2f} ms), "
              f"{slab_cells:.1f} cell-iterations/s over the slab's live "
              "lanes; per request (fit wall, waits included): "
              + ", ".join(f"{r} {v[0]:.3f} ms/iteration {v[1]:.1f} "
                          "cells/s" for r, v in rates.items())
              + " (in-fit checkpoint saves left out)")
        print("  checkpoint bytes written per request: " + ", ".join(
            f"{r} {ends[r]['ckpt_bytes']}" for r in packed))
        for step, pr in sorted(probe.profiles.items()):
            print(f"[profile] serve slab {step}, {pr['lanes']} lanes, "
                  f"{pr['iterations']} iterations, "
                  f"{'graphed' if pr['graphed'] else 'eager'}: wall "
                  f"{pr['wall_ms'] / pr['iterations']:.3f} ms/iteration, "
                  f"device busy {pr['busy_ms'] / pr['iterations']:.3f} "
                  f"ms/iteration (idle share {pr['idle_share']:.3f})")
            for k, v in list(pr["kernels_ms_per_iter"].items())[:8]:
                print(f"  {v:8.4f} ms/iteration  {k}")
        rec["batched"] = {
            "wall_s": wall, "stats": {k: stats[k] for k in
                                      ("processed", "by_status")},
            "dispatches": coord.dispatches,
            "packed_dispatches": coord.packed_dispatches,
            "packed_lanes": coord.packed_lanes, "rungs": rungs,
            "slab_dispatches": probe.dispatches,
            "profiles": probe.profiles,
            "peak_bytes": peak, "launches": launches,
            "step2_slab_ms_per_iter": slab_ms,
            "step2_slab_ms_per_iter_no_capture": warm_ms,
            "step2_slab_cells_per_s": slab_cells,
            "requests": {r: {"recovery": packed[r][1],
                             "step2_ms_per_iter": rates[r][0],
                             "step2_cells_per_s": rates[r][1],
                             "wall_s": ends[r]["request_end"].get(
                                 "wall_seconds"),
                             "queue_wait_s": ends[r]["request_start"].get(
                                 "queue_wait_seconds"),
                             "ckpt_bytes": ends[r]["ckpt_bytes"]}
                         for r in packed}}
        batched_launches = launches
        del worker, coord, probe

        stats, wall, peak = sres["stats"], sres["wall"], sres["peak"]
        print(f"[serve serial] ServeWorker(max_batch=1), in a process beside "
              f"the earlier phases (its own store), drained "
              f"{stats['processed']} requests in {wall:.2f} s: "
              f"{json.dumps(stats['by_status'])}; peak device memory "
              f"{peak} bytes")
        rec["serial_store"] = _store_block(serial, rids[:SERVE_SERIAL],
                                           "serial", doc=sres["status"])
        srates = {}
        for rid in rids[:SERVE_SERIAL]:
            ok = serial.status(rid).get("status") == "ok"
            check(ok, f"[serve serial] {rid} ends done/ok")
            if not ok or rid not in packed:
                continue
            out_s, events = _served(serial, rid)
            srates[rid] = _step2_rate(events)
            print(f"  {rid} phases: {_top_phases(events)}")
            out_p, rec_p = packed[rid]
            same = float(((out_p["model_cn_state"] == out_s["model_cn_state"])
                          & (out_p["model_rep_state"]
                             == out_s["model_rep_state"])).mean())
            rec_s = _recovery(out_s)
            print(f"  {rid}: step 2 {srates[rid][0]:.3f} ms/iteration, "
                  f"{srates[rid][1]:.1f} cells/s; packed vs serial: "
                  f"{same:.4%} of bins decode alike, tau r "
                  f"{rec_p['tau_r']:.4f} / {rec_s['tau_r']:.4f}; outputs "
                  f"bit-identical: {out_p.equals(out_s)}")
            check(same >= SERVE_AGREE, f"[serve] {rid}: packed and serial "
                  f"decode {same:.4%} of bins alike >= {SERVE_AGREE:.0%}")
            check(rec_p["tau_r"] >= rec_s["tau_r"] - 0.01,
                  f"[serve] {rid}: packed tau r {rec_p['tau_r']:.4f} >= "
                  f"serial {rec_s['tau_r']:.4f} - 0.01")
            rec.setdefault("serial", {})[rid] = {
                "recovery": rec_s, "agree": same,
                "bit_identical": bool(out_p.equals(out_s)),
                "step2_ms_per_iter": srates[rid][0],
                "step2_cells_per_s": srates[rid][1]}
        rec["serial_wall_s"], rec["serial_peak_bytes"] = wall, peak
        tau0 = packed[rids[0]][1]["tau_r"] if rids[0] in packed \
            else float("nan")
        check(tau0 >= default_ref["tau_r"] - 0.01,
              f"[serve] {rids[0]} (the default cell's frames) packed tau r "
              f"{tau0:.4f} >= the default cell's {default_ref['tau_r']:.4f} "
              "- 0.01")
        # the first life as the second one reads it: every compile event's
        # key hash of the serial worker's requests (the store it read),
        # and the solo run of the first request's data
        hashes = set()
        for rid in rids[:SERVE_SERIAL]:
            path = serial.results_dir(rid) / "run.jsonl"
            if path.exists():
                hashes |= {e["key_hash"] for e in _compile_events(path)}
        solo = serial.status(rids[0]).get("status") == "ok"
        first = {"hashes": hashes,
                 "output": _served(serial, rids[0])[0] if solo else None,
                 "serial_wall": _request_wall(serial, rids[0]),
                 "batched_wall": ends.get(rids[0], {}).get(
                     "request_end", {}).get("wall_seconds")}
        return batched_launches, second, first
    except BaseException:
        early.close()
        spool.close()
        raise


def check_lanes(dev, results) -> None:
    """The block-axis kernels at the slab's shape (W lanes of 1024 x 8192,
    P = 13, each lane its own operands and lambda): every lane of one
    launch equals a solo launch on its operands bit for bit, the plain
    versions within ``TOL`` (and ``TOL_FLAT`` under a flat prior), and
    Adam's lane axis with one parked lane (live = 0) bit for bit; timed
    at W = 2 and 4 with the bound of the W lanes' bytes and operations."""
    import torch
    from scdna_replication_tools_tpu_torch.ops import adam_kernel as ak
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
    C, L = 1024, 8192
    gen = torch.Generator(device=dev)
    for name in LANES:
        results.setdefault(name, {"max_abs_err": 0.0})
    for W in (SERVE_WIDTH, 2):
        gen.manual_seed(SEED + W)
        lanes = [kernel_inputs(C, L, gen, dev) for _ in range(W)]
        for x in lanes:
            x.pop("log_pi")
        x = {k: torch.stack([ln[k] for ln in lanes]) for k in lanes[0]
             if k != "lamb"}
        del lanes
        torch.cuda.empty_cache()
        scal = torch.stack([ek.scalars(torch.tensor(
            0.6 + 0.05 * b, dtype=torch.float32, device=dev))
            for b in range(W)])
        args = (x["reads"], x["mu"], x["pi_t"], x["phi"], scal)
        label = f"W={W} x {C}x{L}"
        print(f"[lanes] {label}, P = {P}")
        for sparse in (False, True):
            prior = dict(eta_idx=x["eidx"], eta_w=x["ew"]) if sparse \
                else dict(etas_t=x["etas_t"])
            for flat in ((False, True) if W == SERVE_WIDTH else (False,)):
                pr = flat_prior(prior) if flat else prior
                _lanes_pair(results, args, pr, x["g"], sparse, flat, label)
            _time_lanes(results, args, prior, x["g"], sparse, W)
            torch.cuda.empty_cache()
        del x, args
        torch.cuda.empty_cache()
        shape = (W, P, C, L)
        p, g = (torch.randn(shape, generator=gen, device=dev)
                for _ in range(2))
        m = 0.1 * torch.randn(shape, generator=gen, device=dev)
        v = 0.1 * torch.rand(shape, generator=gen, device=dev)
        const = torch.tensor([[0.05 * (b + 1), 0.8, 0.99] for b in range(W)],
                             dtype=torch.float32, device=dev)
        count = torch.tensor([3 + 50 * b for b in range(W)],
                             dtype=torch.int32, device=dev)
        live = torch.tensor([b != 1 for b in range(W)], device=dev)
        scal_a = ak.adam_scalars(const, count, live)
        got = ak.adam_update(p, g, m, v, scal_a, 0.8, 0.99)
        ref = ak.adam_update_plain(p, g, m, v, scal_a, 0.8, 0.99)
        solo = all(torch.equal(a[b], c) for b in range(W)
                   for a, c in zip(got, ak.adam_update(
                       p[b], g[b], m[b], v[b], scal_a[b], 0.8, 0.99)))
        parked = all(torch.equal(a[1], c[1]) for a, c in zip(got, (p, m, v)))
        plain = all(torch.equal(a, c) for a, c in zip(got, ref))
        torch.cuda.synchronize()
        check(solo, f"adam_lanes {label}: every lane equals a solo launch "
              "with its scalar row bit for bit")
        check(parked, f"adam_lanes {label}: the parked lane (live = 0) "
              "writes param, m and v through bit for bit")
        check(plain, f"adam_lanes {label}: equals the plain lane-axis "
              "version bit for bit")
        entry = results["adam_lanes"]
        entry["max_abs_err"] = max(entry["max_abs_err"], max(
            amax(a - c) for a, c in zip(got, ref)))
        moved = nbytes(p, g, m, v) + nbytes(*got)
        del got, ref
        b_ms, b_by, _ = bound(moved, ADAM_OPS * p.numel())
        t = {"ms": time_ms(lambda: ak.adam_update(
                 p, g, m, v, scal_a, 0.8, 0.99)),
             "ms_single": time_single_ms(lambda: ak.adam_update(
                 p, g, m, v, scal_a, 0.8, 0.99)),
             "plain_ms": time_ms(lambda: ak.adam_update_plain(
                 p, g, m, v, scal_a, 0.8, 0.99), reps=5, warmup=1),
             "bound_ms": b_ms, "bound_by": b_by, "bytes": moved}
        # the library's counterpart (used nowhere in the port): one
        # torch._fused_adam_ over the W lanes' tensors, a step tensor per
        # lane and one learning rate (it takes no rate per lane), on
        # copies of the same operands
        lp, lm, lv = p.clone(), m.clone(), v.clone()
        steps = [torch.tensor(float(count[b]), device=dev)
                 for b in range(W)]

        def lib():
            torch._fused_adam_(
                [lp[b] for b in range(W)], [g[b] for b in range(W)],
                [lm[b] for b in range(W)], [lv[b] for b in range(W)], [],
                steps, lr=0.05, beta1=0.8, beta2=0.99, weight_decay=0.0,
                eps=1e-8, amsgrad=False, maximize=False)
        t.update(library_ms=time_ms(lib), library_ms_single=time_single_ms(
            lib), library="torch._fused_adam_ over the lane tensors")
        del lp, lm, lv
        entry.setdefault("by_width", {})[W] = t
        if W == SERVE_WIDTH:
            entry.update(t)
        print(f"  adam_lanes {tuple(shape)}: kernel {t['ms']:.4f} ms, "
              f"single-call {t['ms_single']:.4f} ms, plain "
              f"{t['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}); "
              f"torch._fused_adam_ over the {W} lane tensors (a step per "
              f"lane, one learning rate) {t['library_ms']:.4f} ms, single "
              f"{t['library_ms_single']:.4f} ms")
        del p, g, m, v
        torch.cuda.empty_cache()


def _lanes_pair(results, args, prior, g, sparse, flat, label) -> None:
    """One block-axis pair against solo launches (bit for bit) and the
    batched plain versions (``TOL``/``TOL_FLAT`` per lane)."""
    import torch
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
    kind = "sparse" if sparse else "dense"
    out_k, lse_k = ek.fused_fwd(*args, **prior)
    got = ek.fused_bwd(*args, lse_k, g, **prior)
    tol, tag = (TOL_FLAT, "flat prior") if flat else (TOL, "prior")
    solo_ok = True
    fwd_errs, bwd_errs = {}, {}
    for b in range(args[0].shape[0]):
        lane = tuple(a[b] for a in args)
        lp = {k: v[b] for k, v in prior.items()}
        o, s = ek.fused_fwd(*lane, **lp)
        d = ek.fused_bwd(*lane, s, g[b], **lp)
        solo_ok &= all(torch.equal(a, c) for a, c in zip(
            (out_k[b], lse_k[b]) + tuple(t[b] for t in got), (o, s) + d))
        del o, s, d
        fwd, bwd = fused_errors(lane, lp, g[b], flat)
        for errs, acc in ((fwd, fwd_errs), (bwd, bwd_errs)):
            for part, e in errs.items():
                old = acc.get(part, (0.0, 0.0))
                acc[part] = (max(old[0], e[0]), max(old[1], e[1]))
    torch.cuda.synchronize()
    check(solo_ok, f"fused_*_{kind}_lanes {label}, {tag}: every lane equals "
          "a solo launch on its operands bit for bit")
    report(results, f"fused_fwd_{kind}_lanes", fwd_errs, tol,
           f"{label}, {tag} (per lane, plain)")
    report(results, f"fused_bwd_{kind}_lanes", bwd_errs, tol,
           f"{label}, {tag} (per lane, plain)")


def _time_lanes(results, args, prior, g, sparse, W) -> None:
    """Both block-axis kernels of one prior at W lanes: kernel and plain
    times, and the bound of the lanes' bytes, float32 operations and SFU
    instructions (each lane's own shift census)."""
    from scdna_replication_tools_tpu_torch.ops import enum_kernel as ek
    kind = "sparse" if sparse else "dense"
    _, lse = ek.fused_fwd(*args, **prior)
    bargs = args + (lse, g)
    censuses = [shift_census(args[0][b], args[1][b], args[4][b][2], P)
                for b in range(W)]
    for part, fk, fp, ins in (
            ("fwd", lambda: ek.fused_fwd(*args, **prior),
             lambda: ek.fused_fwd_plain_batched(*args, **prior),
             args + tuple(prior.values())),
            ("bwd", lambda: ek.fused_bwd(*bargs, **prior),
             lambda: ek.fused_bwd_plain_batched(*bargs, **prior),
             bargs + tuple(prior.values()))):
        name = f"fused_{part}_{kind}_lanes"
        solo = f"fused_{part}_{kind}"
        outs = fk()
        moved = nbytes(*ins, *outs)
        del outs
        ops = sum(enum_ops(solo, P, c) for c in censuses)
        mufu = sum(mufu_ops(solo, P, c) for c in censuses)
        b_ms, b_by, b_term = bound(moved, ops, mufu)
        t = {"ms": time_ms(fk), "ms_single": time_single_ms(fk),
             "plain_ms": time_ms(fp, reps=3, warmup=1), "bound_ms": b_ms,
             "bound_by": b_by, "bound_term": b_term, "bytes": moved,
             "ops": ops, "mufu": mufu, "library_ms": None,
             "shift_warp_share": sum(c["taken"] for c in censuses)
             / sum(c["warps"] for c in censuses)}
        entry = results[name]
        entry.setdefault("by_width", {})[W] = t
        if W == SERVE_WIDTH:
            entry.update(t)
        print(f"  {name} W={W}: kernel {t['ms']:.4f} ms, single-call "
              f"{t['ms_single']:.4f} ms, plain {t['plain_ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_term}); {moved} bytes, {ops} float32 "
              f"operations, {mufu} SFU instructions")


# ---------------------------------------------------------------------------
# the [readers] phase: the port's run-log readers on this run's own logs
# ---------------------------------------------------------------------------

# an import hook that refuses ``jax`` and the JAX package
JAX_HOOK = """
import importlib.abc, sys
class _RefuseJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in ('jax', 'jaxlib',
                                  'scdna_replication_tools_tpu'):
            raise ImportError(f'{name}: blocked, the port imports no JAX')
        return None
sys.meta_path.insert(0, _RefuseJax())
"""
# ``python -c BLOCK_JAX MODULE ARGS...`` runs ``python -m MODULE ARGS...``
# behind the hook (from the repository's root)
BLOCK_JAX = JAX_HOOK + """
import runpy
sys.argv = sys.argv[1:]
runpy.run_module(sys.argv[0], run_name='__main__', alter_sys=True)
"""
READER_TOOLS = ("pert_report", "pert_trace", "pert_meter", "pert_fleet")
# the sections pert_report leaves as a placeholder when the log lacks
# their events (tests/test_torch_runlog.py checks the first six on a CPU
# log, which has no compile event)
REPORT_PLACEHOLDERS = ("_no phase events_", "_no fit_end events_",
                       "_no model-health events", "_no control_decision",
                       "_no rescue events", "_no metrics_snapshot",
                       "_no compile events_")
CONSERVATION_TOL = 0.01   # pert_meter's, billed = effective + waste


def _reader(tool: str, *args) -> dict:
    """``python -m <the port>.tools.<tool> ARGS`` behind :data:`BLOCK_JAX`:
    its exit code, output and seconds."""
    t0 = time.perf_counter()
    try:
        run = subprocess.run([sys.executable, "-c", BLOCK_JAX,
                              f"{PKG}.tools.{tool}", *map(str, args)],
                             capture_output=True, text=True, cwd=str(REPO),
                             timeout=300)
        rc, out, err = run.returncode, run.stdout, run.stderr
    except subprocess.TimeoutExpired as exc:
        rc, out, err = None, "", f"timed out after {exc.timeout} s"
    return {"argv": [tool, *map(str, args)], "rc": rc, "out": out,
            "err": err, "s": time.perf_counter() - t0}


class ReadersPhase:
    """The [readers] phase (module docstring): the port's ``pert_report``,
    ``pert_trace``, ``pert_meter`` and ``pert_fleet`` run as a user runs
    them, each command a ``python -m`` subprocess behind the hook that
    refuses JAX, on this run's own full-width logs.  Four threads run
    the four tools' chains beside the last phases (they wait on their
    subprocesses, so they hold no lock the card's work needs);
    :meth:`finish` joins them and checks every result."""

    def __init__(self, default_log: Path, graphs_log: Path,
                 profiled_log: Path, profile_dir: Path, spool: Path,
                 out: Path = REPO / "chiprun_out"):
        import threading

        self.paths = {"default": default_log, "graphs": graphs_log,
                      "profiled": profiled_log, "profile_dir": profile_dir,
                      "spool": spool, "report": out / "default_run_report.md",
                      "compare": out / "default_vs_graphs.md",
                      "trace": out / "graphs_profiled_trace.json",
                      "index": out / "fleet_index.json",
                      "baseline": out / "fleet_baseline_default.json",
                      "regress": out / "fleet_regress_graphs.md"}
        p = self.paths
        # four chains of at most four commands, each tool's --help at
        # the end of one (the readers import no torch, so most commands
        # take well under a second)
        self.chains = {
            "report": [("pert_report", p["default"], "--out", p["report"]),
                       ("pert_report", "--compare", p["default"],
                        p["graphs"], "--out", p["compare"]),
                       ("pert_report", "--help"), ("pert_fleet", "--help")],
            "trace": [("pert_trace", "export", "--perfetto", "--profile-dir",
                       p["profile_dir"], "--out", p["trace"],
                       p["profiled"]),
                      ("pert_trace", "validate", p["trace"]),
                      ("pert_trace", "waterfall", "--spool", p["spool"]),
                      ("pert_trace", "--help")],
            "meter": [("pert_meter", "report", p["spool"], "--check"),
                      ("pert_meter", "attribution", p["spool"], "--check",
                       "--json"),
                      ("pert_meter", "--help")],
            "fleet": [("pert_fleet", "index", "--roots", out, "--out",
                       p["index"]),
                      ("pert_fleet", "query", "--index", p["index"],
                       "--format", "json"),
                      ("pert_fleet", "regress", "--run", p["default"],
                       "--write-baseline", p["baseline"]),
                      ("pert_fleet", "regress", "--run", p["graphs"],
                       "--baseline", p["baseline"], "--out", p["regress"])],
        }
        self.results: dict = {}
        self.t0 = time.perf_counter()
        self.threads = [threading.Thread(target=self._chain, args=(k,),
                                         daemon=True) for k in self.chains]
        for t in self.threads:
            t.start()

    def _chain(self, key: str) -> None:
        self.results[key] = [_reader(*cmd) for cmd in self.chains[key]]

    def finish(self, record, serve_rids) -> None:
        from scdna_replication_tools_tpu_torch.tools import pert_fleet
        from scdna_replication_tools_tpu_torch.tools import pert_trace

        for t in self.threads:
            t.join()
        tag = "[readers]"
        wall = time.perf_counter() - self.t0
        res, p = self.results, self.paths
        runs = [r for chain in res.values() for r in chain]
        print(f"{tag} {len(runs)} commands in {wall:.1f} s beside the last "
              "phases (" + ", ".join(f"{r['argv'][0]} {r['argv'][1]} "
                                     f"{r['s']:.1f} s" for r in runs) + ")")
        for r in runs:
            check(r["rc"] == 0 or r["argv"][:2] == ["pert_fleet", "regress"]
                  and "--baseline" in r["argv"],
                  f"{tag} python -m {PKG}.tools.{' '.join(r['argv'])} exits "
                  f"0 with jax and the JAX package blocked (rc {r['rc']}; "
                  f"{r['err'].strip()[-600:]})")
        rec = record.setdefault("readers", {
            "wall_s": wall, "commands": [{k: r[k] for k in ("argv", "rc", "s")}
                                         for r in runs]})

        # report and compare
        text = p["report"].read_text() if p["report"].exists() else ""
        left = [s for s in REPORT_PLACEHOLDERS if s in text]
        check(bool(text) and not left and "## Compiled programs" in text,
              f"{tag} pert_report renders phase 6's log to "
              f"{p['report'].name} ({len(text)} characters) with every "
              f"section filled, ## Compiled programs among them "
              f"(placeholders left: {left})")
        diff = p["compare"].read_text() if p["compare"].exists() else ""
        check("## Metrics (B - A)" in diff
              and "_no metrics in either run_" not in diff,
              f"{tag} pert_report --compare phase 6's log and [graphs]'s: "
              f"a metrics-compare section ({len(diff)} characters)")

        # the Perfetto trace with the profiled run's ranges
        try:
            doc = json.loads(p["trace"].read_text())
        except (OSError, ValueError):
            doc = {}
        tracks = [e for e in doc.get("traceEvents", [])
                  if e.get("ph") == "C"
                  and e.get("name") == "pert_xla_scope_seconds"]
        track = tracks[0]["args"] if len(tracks) == 1 else {}
        slices = sum(1 for e in doc.get("traceEvents", [])
                     if e.get("ph") == "X")
        print(f"{tag} pert_trace export --profile-dir: {slices} slices, "
              f"pert_xla_scope_seconds {json.dumps(track)}")
        check(pert_trace.validate_trace(doc) == [] and slices > 0,
              f"{tag} the exported trace is valid ({slices} slices)")
        for scope in GRAPH_SCOPES:
            keys = [k for k in track if k.endswith(scope)]
            check(keys and all(track[k] > 0 for k in keys),
                  f"{tag} the counter track holds {scope} ({keys}) > 0")
        gauges = record.get("graphs", {}).get("profiled", {}).get("gauges")
        check(track == gauges, f"{tag} the counter track equals run_end's "
              f"pert_xla_scope_seconds gauges of the profiled run")

        # the serving drain's waterfall and cost
        waterfall = self._json(res["trace"][2]).get("requests") or {}
        for rid, row in sorted(waterfall.items()):
            print(f"  waterfall {rid}: " + ", ".join(
                f"{k} {row.get(k)}" for k in
                (*pert_trace.WATERFALL_COMPONENTS, "total_seconds",
                 "fit_attributed", "slab_avg_occupancy")))
        check(sorted(waterfall) == sorted(serve_rids) and all(
            set(pert_trace.WATERFALL_COMPONENTS) <= set(row)
            and row["fit"] > 0 for row in waterfall.values()),
              f"{tag} pert_trace waterfall --spool: every request of the "
              f"drain ({sorted(waterfall)}), every component of "
              f"{pert_trace.WATERFALL_COMPONENTS}, fit > 0")
        attr = self._json(res["meter"][1])
        meter = attr.get("meter") or {}
        gap = attr.get("conservation_gap_max")
        print(f"{tag} pert_meter attribution: {attr.get('requests')} "
              f"requests, billed {meter.get('billed_device_seconds')} "
              f"device-s, effective {meter.get('effective_device_seconds')}"
              f", waste {json.dumps(meter.get('waste_seconds'))}, goodput "
              f"{meter.get('goodput_cell_iters_per_device_second')}; the "
              f"largest conservation gap {gap}")
        check(attr.get("conservation_ok") is True and gap is not None
              and gap <= CONSERVATION_TOL
              and meter.get("billed_device_seconds", 0) > 0,
              f"{tag} every ledger of the drain conserves (gap {gap} <= "
              f"{CONSERVATION_TOL})")
        rec.update(waterfall=waterfall, meter=meter, gap=gap, track=track)

        # the fleet
        query = self._json(res["fleet"][1], default=[])
        files = sorted(r.get("file") for r in query)
        print(f"{tag} pert_fleet index over chiprun_out/: {len(files)} "
              f"runs {files}")
        check({p["default"].name, p["graphs"].name} <= set(files),
              f"{tag} pert_fleet query lists phase 6's and [graphs]'s runs")
        try:
            baseline = json.loads(p["baseline"].read_text())
            result = pert_fleet.compare_to_baseline(
                baseline, pert_fleet.run_record(p["graphs"]))
        except (OSError, ValueError) as exc:
            result = {"rows": [], "regressions": [], "error": repr(exc)}
        rc = res["fleet"][3]["rc"]
        for row in result["rows"]:
            print(f"  regress {row['metric']}: baseline {row['baseline']}, "
                  f"graphed {row['run']}, {row['verdict']}")
        want = 1 if result["regressions"] else 0
        print(f"{tag} pert_fleet regress [graphs]'s run against phase 6's "
              f"baseline: exit {rc}, {len(result['regressions'])} gated "
              "regression(s) (eager and graphed are different runs: no "
              "pass is required)")
        check(result["rows"] and rc == want,
              f"{tag} regress exits {rc}, the code its verdicts imply "
              f"({want})")
        rec.update(fleet_files=files, regress_rc=rc,
                   regress={r["metric"]: r["verdict"]
                            for r in result["rows"]})

    @staticmethod
    def _json(run, default=None):
        try:
            return json.loads(run["out"])
        except ValueError:
            return {} if default is None else default


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (REPO / PKG / "csrc").is_dir():
        print(f"chip_smoke: {PKG}/ is missing next to this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    dev = torch.device("cuda", 0)
    record: dict = {"timeline": {}}
    t_start = time.perf_counter()

    def mark(phase: str) -> None:
        at = time.perf_counter() - t_start
        record["timeline"][phase] = at
        host_memory.after = phase
        print(f"[timeline] {phase} done at {at:.1f} s")

    # phase 11's requests are written by four processes meanwhile
    spool = ServeSpool()
    host_memory = HostMemory(t_start)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() \
        else "unknown"
    clock = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=60)
    try:
        sm_mhz = float(clock.stdout.split()[0])
    except (IndexError, ValueError):
        print(f"chip_smoke: nvidia-smi gave no SM clock: {clock.stdout!r} "
              f"{clock.stderr!r}", file=sys.stderr)
        return 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    global MUFU_PER_S
    MUFU_PER_S = sms * MUFU_PER_SM_PER_CLOCK * sm_mhz * 1e6
    print(f"[card] {card}; max SM clock {sm_mhz:g} MHz, {sms} SMs (SFU "
          f"{MUFU_PER_S:.4g}/s); torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    record.update(card=card, sm_clock_mhz=sm_mhz, sms=sms,
                  mufu_per_s=MUFU_PER_S)

    from scdna_replication_tools_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    info = _cuda.build()
    build_s = time.perf_counter() - t0
    print(f"[build] nvcc sm_90a, {len(info)} sources in {build_s:.1f} s")
    for name, meta in info.items():
        regs = [ln.strip() for ln in meta["log"].splitlines()
                if "registers" in ln or "spill" in ln]
        print(f"  {name}: " + (" | ".join(regs[:8]) or meta["log"][:200]))
    record["build_s"] = build_s
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sass = record["sass"] = sass_report(info, out_dir)
    mark("build")

    results = compare_kernels(dev, record)
    mark("kernels")

    t0 = time.perf_counter()
    frames = simulate_frames()
    print(f"[main] simulated {CELLS} S + {G1_CELLS} G1 cells x {LOCI} loci, "
          f"{CLONES} clones ({sum(len(f) for f in frames)} long-form rows) "
          f"in {time.perf_counter() - t0:.1f} s; depth cut: "
          f"max_iter={MAX_ITER} (steps 1 and 3: {MAX_ITER // 2}), "
          "min_iter=100, except the default path (its default budgets, "
          "2000 and 1000, under the controller)")
    by_path: dict = {}
    by_path["categorical"], scrt = main_path(dev, record, frames,
                                             "categorical")
    check_main_path_shapes(dev, scrt, results, "categorical")
    profile_steps(dev, scrt, record, "categorical")
    reference = record["main_categorical"]
    # each run's device state goes before the next run, so that each
    # path's peak memory is its own
    del scrt
    torch.cuda.empty_cache()
    mark("categorical")

    by_path["default"], scrt = main_path(dev, record, frames, "default",
                                         reference)
    check_sync_free_chunk(dev, scrt, record)
    profile_steps(dev, scrt, record, "default", steps=("step2", "step3"))
    durable_ref = durable_reference(scrt)
    graphs_ref = graphs_reference(scrt)
    analysis_in = analysis_input(scrt.outputs[0], scrt.outputs[2])
    del scrt
    torch.cuda.empty_cache()
    mark("default")

    by_path["graphed"], graphs_child = graphs_phase(dev, record, frames,
                                                    graphs_ref)
    del graphs_ref
    mark("graphs")
    # phase 11's pair and its first and second worker lives run beside
    # phases 7-10 (the [graphs] run's timings are phase 6's like for like)
    early = EarlyServing(spool)
    analysis_tail = HostTail(card, "analysis", analysis_in,
                             record["main_default"]["phases_s"]["load"])
    del analysis_in

    by_path["durable"] = durable_runs(dev, record, frames, durable_ref)
    del durable_ref
    mark("durable")

    by_path["binary"], scrt = main_path(dev, record, frames, "binary",
                                        reference)
    check_main_path_shapes(dev, scrt, results, "binary")
    profile_steps(dev, scrt, record, "binary", steps=("step2", "step3"))
    del scrt
    torch.cuda.empty_cache()
    mark("binary")

    by_path["rescue"], scrt = main_path(dev, record, frames, "rescue",
                                        reference)
    if scrt.mirror_rescue_fit is not None:
        check_rescue_scoring(dev, scrt, results)
    del scrt
    torch.cuda.empty_cache()
    mark("rescue")

    by_path["unlabelled"] = unlabelled(dev, record, frames, card, results)
    torch.cuda.empty_cache()
    mark("unlabelled")

    analysis_tail.finish(record)
    mark("analysis")
    tail = HostTail(card, "levels")
    sharded = ShardedPhase(frames, MUFU_PER_S)
    by_path["serve"], second_life, first_life = serving(
        dev, record, record["main_default"], spool, early)
    sharded.drained.set()
    mark("serve")
    # the readers on this run's logs and the drain's spool, beside the
    # last phases; the spool goes when they are joined
    readers = ReadersPhase(
        out_dir / "default_run.jsonl", out_dir / "graphs_run.jsonl",
        out_dir / "graphs_profiled.jsonl",
        Path(record["graphs"]["profiled"]["profile_dir"]),
        spool.root / "batched")
    tail.finish(record)
    mark("unlabelled tail")
    sharded.finish(record, results, by_path)
    mark("sharded")
    # the second worker life started beside the earlier phases; its
    # spool goes when it is joined
    second_life.finish(record, first_life)
    early.close()
    del first_life
    mark("second life")
    check_lanes(dev, results)
    mark("lanes")
    readers.finish(record, [f.result() for f in spool.futures
                            if f.done() and f.exception() is None])
    spool.close()
    mark("readers")
    graphs_child.finish(record)
    mark("graphs child")
    host_memory.report(record)

    # launches of each kernel summed over the paths' runs (each read
    # from zero just before its run, just after it), by path beside it
    paths_of = {name: {p: (sum(v for k, v in counts.items()
                               if k.startswith("enum_bwd_"))
                           if name == "enum_bwd" else counts[name])
                       for p, counts in by_path.items()}
                for name in TPU_KERNEL}
    launches = {name: sum(v.values()) for name, v in paths_of.items()}
    results["enum_bwd"]["launch_paths"] = {
        p: by_path["rescue"][f"enum_bwd_{p}"]
        for p in ("staged", "per_thread")}

    kernels = [{
        "name": name, "route": "cuda", "source": SOURCE[name],
        "replaces": TPU_KERNEL[name], "launches": launches[name],
        "max_abs_err": results[name]["max_abs_err"],
        "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"],
        "bound_ms": results[name]["bound_ms"],
        "bound_by": results[name]["bound_by"],
        "library_ms": results[name]["library_ms"],
        "ms_single": results[name]["ms_single"],
        "launches_by_path": paths_of[name],
        "main_ms": {label: t["ms"] for label, t in
                    results[name].get("main", {}).items()},
        **({"launch_paths": results[name]["launch_paths"]}
           if "launch_paths" in results[name] else {}),
        **({"by_width": {w: {k: t.get(k) for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
                         for w, t in results[name]["by_width"].items()}}
           if "by_width" in results[name] else {}),
    } for name in TPU_KERNEL]
    for name in TPU_KERNEL:
        results[name]["sass"] = sass.get(SASS_FUNCTION[name])
    record["failures"] = FAILURES
    (out_dir / "chip_smoke.json").write_text(json.dumps(record, indent=1,
                                                        default=float))
    print(card)
    print(json.dumps({"kernels": kernels}))
    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed: {FAILURES}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
