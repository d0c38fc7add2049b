"""Typed configuration: the fields of the port's slice.

Port of ``scdna_replication_tools_tpu/config.py``: :class:`ColumnConfig`
whole, and the :class:`PertConfig` fields the three-step fit, the mirror
rescue, the adaptive controller, the model-health QC, the run log, span
tracing, the durable runs, sharded fits and serving read.  The JAX
config's other knobs (the compiled-program caches, the elastic mesh
rung) belong to modules not yet ported; ``api.scRT`` refuses them by
name instead of carrying dead fields here, and :data:`UNPORTED_FIELDS`
holds each at the JAX default that refusal pins it to.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# PertConfig fields left out of the config hash (obs.runlog.
# _config_digest), the JAX package's tuple: pure observability or pure
# per-request identity, so two runs that differ only in where their log,
# textfile and heartbeats land hash equal.  The checkpoint manifest
# stamps the tuple (``hash_excludes``)
NON_HASH_FIELDS = (
    "telemetry_path",       # where THIS run's RunLog lands
    "metrics_textfile",     # where the Prometheus textfile lands
    "request_id",           # per-request identity (serve fleet index)
    "trace_spans",          # tracing on/off is pure observability
    "trace_parent",         # per-request trace handoff
    "slab_width",           # serving-slab placement, not workload
    "executable_cache_dir",  # where executables persist, not which
    "heartbeat_dir",        # where live health heartbeats land
    "heartbeat_interval_seconds",  # heartbeat cadence
)

# The JAX PertConfig fields this package does not carry yet: name ->
# (the JAX default, the ROADMAP item that ports it).  ``api.scRT``
# refuses any other value of the refused ones, and the rest only act in
# features not ported, so every port run is a run at these values.  The
# config hash (obs.runlog._config_digest) hashes them beside the port's
# own fields: one setting hashes the same in both packages, which is
# what the checkpoint manifest's resume gate compares.
UNPORTED_FIELDS = {
    "profile_dir": (None, "A11b"),
    "elastic_mesh": (True, "A12"),
    "compile_cache_dir": ("auto", "A14"),
    "executable_cache_dir": (None, "A14"),
    # one Adam path (the CUDA kernel, its plain version on the CPU):
    # JAX's backend-specific values have no counterpart
    "fused_adam": ("auto", "none"),
}


@dataclasses.dataclass(frozen=True)
class ColumnConfig:
    """Column-name mapping for long-form scWGS DataFrames
    (reference: infer_scRT.py:26-31)."""

    input_col: str = "reads"
    gc_col: str = "gc"
    rt_prior_col: Optional[str] = "mcf7rt"
    clone_col: Optional[str] = "clone_id"
    cell_col: str = "cell_id"
    library_col: str = "library_id"
    chr_col: str = "chr"
    start_col: str = "start"
    cn_state_col: str = "state"
    assign_col: str = "copy"
    ploidy_col: str = "ploidy"
    rv_col: str = "rt_value"
    rs_col: str = "rt_state"
    frac_rt_col: str = "frac_rt"
    rpm_gc_norm_col: str = "rpm_gc_norm"
    temp_rt_col: str = "temp_rt"
    seg_col: str = "changepoint_segments"
    thresh_col: str = "binary_thresh"


@dataclasses.dataclass(frozen=True)
class PertConfig:
    """Hyper-parameters of the PERT model and its fixed-budget fits
    (reference: pert_model.py:37-130); same names and defaults as the
    JAX ``PertConfig``."""

    P: int = 13          # number of integer CN states, values 0..P-1
    K: int = 4           # max polynomial degree of the GC bias curve
    J: int = 5           # G1 cells per S cell in the composite CN prior
    upsilon: int = 6     # alpha+beta total for the tau Beta prior

    cn_prior_method: str = "g1_composite"
    cn_prior_weight: float = 1e6
    # condition rho on the RT-prior column instead of learning it
    rho_from_rt_prior: bool = False

    learning_rate: float = 0.05
    adam_b1: float = 0.8
    adam_b2: float = 0.99
    max_iter: int = 2000
    min_iter: int = 100
    rel_tol: float = 1e-6
    max_iter_step1: Optional[int] = None   # default: max_iter // 2
    min_iter_step1: Optional[int] = None   # default: min_iter // 2
    max_iter_step3: Optional[int] = None
    min_iter_step3: Optional[int] = None
    run_step3: bool = True
    # seeds the controller's re-seed draws and the posterior-predictive
    # check's replicates
    seed: int = 0

    # shape-bucket padding: pad cells / loci up to at least this many
    # masked entries (None keeps the exact shapes)
    pad_cells_to: Optional[int] = None
    pad_loci_to: Optional[int] = None
    # sharded fits (parallel/): the cells split over num_shards ranks
    # (None or 0: every rank of the process group) and the loci over
    # loci_shards (the long-genome regime); a grid of more than one
    # rank runs inside an initialised process group of exactly
    # num_shards x loci_shards ranks (parallel.init_distributed)
    num_shards: Optional[int] = 1
    loci_shards: int = 1
    # cells per chunk of the bin log-likelihood: the fused kernels run
    # once per chunk (the cells are padded to a multiple); None takes
    # every cell in one launch
    cell_chunk: Optional[int] = None
    # genome-smoothed CN decode: Viterbi with this self-transition
    # probability (models/hmm.py); None keeps the independent per-bin
    # argmax of the reference
    cn_hmm_self_prob: Optional[float] = None
    # compact one-hot CN priors to (eta_idx, eta_w) planes (the sparse
    # kernel); the composite prior always stays dense
    sparse_etas: bool = True
    # pi encoding of steps 2 and 3: 'auto' (categorical, P planes) or
    # 'binary' (the independent-binary encoding, Kb = ceil(log2 P)
    # planes, arXiv 2206.00093); the JAX config's backend-specific values
    # ('pallas', 'binary_xla', ...) have no meaning here
    enum_impl: str = "auto"
    # stored dtype of the pi parameter's Adam moments: 'float32' or
    # 'bfloat16' (the arithmetic stays float32)
    optimizer_state_dtype: str = "float32"
    # post-step-2 mirror rescue (JAX config.py:429-456): cells whose
    # fitted tau lies outside [mirror_tau_lo, mirror_tau_hi] are re-fit
    # from the mirrored initialisation (tau' = 1 - tau) with every global
    # site conditioned, and each keeps the fit with the higher per-cell
    # log-joint; at most mirror_max_cells candidates, the most
    # boundary-extreme first.  False is the reference-faithful trajectory
    mirror_rescue: bool = True
    mirror_tau_lo: float = 0.1
    mirror_tau_hi: float = 0.9
    mirror_max_iter: int = 400
    mirror_min_iter: int = 50
    mirror_max_cells: int = 256

    # in-fit diagnostics sampling stride (infer/svi.py ring buffer):
    # every K iterations the fit records loss and the global grad/param
    # norms on the device (last 64 samples kept); the chunk length of
    # the controlled fit; 0 disables it (and the controller)
    fit_diag_every: int = 25
    # model-health QC: posterior-entropy maps, the posterior-predictive
    # check and the scRT.cell_qc() table
    qc: bool = True
    # a bin is low-confidence above this normalized CN entropy
    qc_entropy_thresh: float = 0.5
    # a cell is 'high_entropy' above this fraction of low-confidence bins
    qc_frac_thresh: float = 0.25
    # replicate datasets per cell of the posterior-predictive check
    qc_ppc_replicates: int = 8
    # a cell is 'ppc_outlier' above this replicate z-score
    qc_ppc_z: float = 5.0
    # convergence-doctor thresholds (obs/doctor.py)
    doctor_window: int = 16
    doctor_slope_tol: float = 1e-4
    doctor_var_tol: float = 1e-3
    doctor_grad_ratio: float = 0.1
    # structured run log (obs/runlog.py): 'auto' writes one JSONL per
    # run under the repository's .pert_runs/ (the newest 50 kept); a
    # path names the file (or a directory, which gets a timestamped
    # file); None/'none'/'off' disables.  tools/pert_report.py renders it
    telemetry_path: Optional[str] = "auto"
    # Prometheus text exposition of the run's metrics registry
    # (obs/metrics.py), rewritten atomically at every phase-boundary
    # snapshot; None disables the file (the registry runs either way)
    metrics_textfile: Optional[str] = None
    # adaptive fit controller (obs/controller.py); inert when
    # min_iter >= max_iter or fit_diag_every == 0
    controller: bool = True
    # total extra iterations one fit may be granted; None = max_iter // 2
    controller_max_extra_iters: Optional[int] = None
    controller_extend_step: int = 50
    controller_max_reseeds: int = 1
    controller_reseed_scale: float = 0.02
    controller_nan_lr_factor: float = 0.1
    controller_stop_patience: int = 50
    controller_stop_ftol: float = 3e-3
    # rescue gate: a boundary-tau candidate within this distance of 0/1
    # is suspect (else the QC entropy signal decides)
    controller_rescue_extreme_tau: float = 0.02

    # --- durable runs (infer/checkpoint.py, infer/manifest.py,
    # utils/faults.py) ---
    # write step checkpoints (and in-fit ones, see checkpoint_every)
    # into this directory, with the resume ledger manifest.json beside
    # them; None disables the whole durable layer
    checkpoint_dir: Optional[str] = None
    # against an existing checkpoint_dir: 'auto' restores completed
    # steps and resumes in-flight fits only when the manifest's data
    # fingerprint matches this run's inputs (a config difference, e.g. a
    # grown budget, is noted and allowed); 'force' restores regardless;
    # 'off' ignores and quarantines existing checkpoints
    resume: str = "auto"
    # in-fit checkpoint cadence in controller chunks (fit_diag_every
    # iterations each): params, Adam state, the loss prefix and the
    # controller's ledger, so a killed fit resumes mid-budget on the
    # uninterrupted trajectory; 0 keeps the step-end saves and the
    # emergency save on the way out of an exception
    checkpoint_every: int = 4
    # deterministic fault-injection plan (utils/faults.py), e.g.
    # 'preempt@step2/chunk#3,corrupt@step2/save'; None leaves every
    # injection site inert (the PERT_FAULTS environment variable is the
    # fallback).  Chaos testing only
    faults: Optional[str] = None
    # bounded exponential backoff of transient failures: retries per
    # step fit and the base delay (doubled per retry, capped at 30 s)
    retry_max_attempts: int = 2
    retry_backoff_seconds: float = 0.5
    # watchdog deadlines in seconds (None disables): a step's compile
    # phase (the kernel libraries' builds and loads) or a fit chunk
    # (its launches and its host read) that outlasts its deadline
    # raises WatchdogTimeout, which aborts with a resumable checkpoint
    watchdog_compile_seconds: Optional[float] = None
    watchdog_chunk_seconds: Optional[float] = None
    # live run-health heartbeat (obs/heartbeat.py): 'auto' writes
    # health/host_0.json inside checkpoint_dir when one is set and
    # nothing otherwise; a path names the directory; None/'off' disables
    heartbeat_dir: Optional[str] = "auto"
    # seconds between heartbeat writes (fault-ladder events write at once)
    heartbeat_interval_seconds: float = 15.0
    # serving identity (serve/worker.py): the request id folded into
    # run_start and the cost ledger's scope, and the width of the slab
    # this run was one lane of
    request_id: Optional[str] = None
    slab_width: Optional[int] = None
    # causal span tracing (obs/spans.py): the run's span tree in its log;
    # trace_parent continues a serving worker's request span
    # ('<trace_id>:<span_id>')
    trace_spans: bool = False
    trace_parent: Optional[str] = None

    def __post_init__(self):
        if self.enum_impl not in ("auto", "binary"):
            raise ValueError(
                f"enum_impl={self.enum_impl!r}: the port takes 'auto' "
                "(categorical) or 'binary' (the independent-binary "
                "encoding), each through the CUDA kernels on the GPU and "
                "their plain versions on the CPU")
        if self.optimizer_state_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"optimizer_state_dtype={self.optimizer_state_dtype!r}: "
                "expected 'float32' or 'bfloat16'")

    @property
    def binary_pi(self) -> bool:
        return self.enum_impl == "binary"

    def resolved_iters(self) -> dict:
        """Step 1/3 budgets default to half of step 2's
        (pert_model.py:104-120)."""
        half = lambda v, d: v if v is not None else d // 2  # noqa: E731
        return dict(
            max_iter=self.max_iter,
            min_iter=self.min_iter,
            max_iter_step1=half(self.max_iter_step1, self.max_iter),
            min_iter_step1=half(self.min_iter_step1, self.min_iter),
            max_iter_step3=half(self.max_iter_step3, self.max_iter),
            min_iter_step3=half(self.min_iter_step3, self.min_iter),
        )
