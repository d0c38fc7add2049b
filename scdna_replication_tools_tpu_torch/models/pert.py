"""The PERT graphical model as a MAP + enumeration objective in PyTorch.

Port of ``models/pert.py``.  With AutoDelta point estimates the reference's
ELBO is the log-joint at the point estimates with the two discrete sites
(CN state, replication state) summed out, so the loss is

    -[ sum_{cell, locus} logsumexp_{cn, rep}(log pi + log Bern(rep | phi)
                                             + log NB(reads | delta))
       + log-priors of the continuous sites ]

Step 1 observes cn/rep (plain ops); steps 2 and 3 go through the fused
enumeration (``ops/enum_kernel.py``: the CUDA kernels on the card, their
plain versions on the CPU), dense or sparse by the CN prior's encoding.
Arrays are (cells, loci); the pi parameter is state-major throughout
(``layout.py``): ``pi_logits`` (P, cells, loci) under the categorical
encoding, ``pi_bin_logits`` (Kb, cells, loci) under the independent-binary
one (``spec.binary_pi``, arXiv 2206.00093).  Site-type semantics follow the JAX
module (and the reference): lambda and beta_stds are params without a
prior, tau is a param when t_init is given, conditioned sites still add
their log-prob.

Sharded fits (``mesh``, a ``parallel.mesh.RankMesh``): the batch and the
per-cell parameters are this rank's block (its cells slice and loci
tile).  The reductions over loci (the u prior's read means and ploidies,
the per-cell objective) sum over the rank's row, and :func:`log_joint`
returns this rank's share of the total: the global priors on rank 0
only, the per-cell priors on the first rank of each row, the bins of the
rank's own tile, so the sum over ranks counts every term once.  The
fused kernels run on the rank's block, with no collective inside.

The decode and the posterior-predictive check run one pass per slab of
cells (:func:`_decode_slab`, :func:`_ppc_slab`).  With a compiled-program
store current on the thread (``infer/aotcache.run_scope``) a pass on the
card replays its slab's CUDA graphs instead (JAX's ``decode_slab`` and
``ppc`` programs, ``infer/svi.resolve_slab_program``), bit-equal to the
eager pass; on the CPU and on a sharded run the passes stay eager.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from scdna_replication_tools_tpu_torch.layout import cells_major, state_major
from scdna_replication_tools_tpu_torch.ops.dists import (
    bernoulli_log_prob,
    beta_log_prob,
    gamma_log_prob,
    nb_log_prob,
    nb_sample,
    normal_log_prob,
    seed_of,
    seeded_generator,
)
from scdna_replication_tools_tpu_torch.ops.enum_kernel import (
    binary_code_matrix,
    binary_code_width,
    enum_loglik,
    enum_loglik_fused,
    enum_loglik_fused_binary,
    enum_loglik_fused_sparse,
    enum_loglik_fused_sparse_binary,
)
from scdna_replication_tools_tpu_torch.ops.gc import gc_rate
from scdna_replication_tools_tpu_torch.utils.profiling import scope
from scdna_replication_tools_tpu_torch.ops.transforms import (
    from_interval,
    from_positive,
    from_unit_interval,
    to_interval,
    to_positive,
    to_unit_interval,
)

LAMB_LO, LAMB_HI = 0.001, 0.999   # reference: pert_model.py:557
PHI_LO, PHI_HI = 0.001, 0.999     # reference: pert_model.py:621-623


@dataclasses.dataclass(frozen=True)
class PertModelSpec:
    """Static model configuration (the JAX spec's fields of this slice).

    ``tau_mode``: 'param' (t_init given), 'beta_prior' or
    'beta_default' (reference: pert_model.py:580-585).  ``step1``
    observes cn/rep; ``sparse_etas`` selects the one-hot prior planes
    (eta_idx, eta_w) over the dense etas tensor; ``binary_pi`` the
    independent-binary pi encoding (the JAX spec's ``enum_impl``
    'binary_*' values): Kb = ceil(log2 P) logit planes ``pi_bin_logits``
    masked to the P valid states, instead of the P-plane ``pi_logits``.
    ``cell_chunk`` evaluates the bin log-likelihood in chunks of that
    many cells (the runner pads the cells to a multiple of it).
    """

    P: int = 13
    K: int = 4
    L: int = 1
    tau_mode: str = "param"
    step1: bool = False
    cond_beta_means: bool = False
    cond_rho: bool = False
    cond_a: bool = False
    fixed_lamb: bool = False
    sparse_etas: bool = False
    binary_pi: bool = False
    cell_chunk: Optional[int] = None

    def record(self) -> dict:
        """The fields, for the record of a decode or PPC program, whose
        key holds the spec (``infer/svi.py``)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_record(cls, kwargs: dict) -> "PertModelSpec":
        return cls(**kwargs)


class PertBatch:
    """Device inputs of one model fit.

    reads (cells, loci) float32; libs (cells,) int64; gamma_feats
    (loci, K+1); mask (cells,) float32 (1 = real cell); loci_mask
    (loci,) or None; etas (cells, loci, P) or None; eta_idx / eta_w
    (cells, loci) for the sparse prior; cn_obs / rep_obs (cells, loci)
    for step 1; t_alpha / t_beta (cells,) for tau_mode='beta_prior'.

    Fit-constant terms (the state-major etas, the Dirichlet normaliser,
    the per-cell read means and ploidies) are computed once per batch
    and kept in ``cache``: the JAX fit gets the same from XLA hoisting
    them out of its compiled loop.
    """

    def __init__(self, reads, libs, gamma_feats, mask, etas=None,
                 cn_obs=None, rep_obs=None, t_alpha=None, t_beta=None,
                 loci_mask=None, eta_idx=None, eta_w=None):
        self.reads = reads
        self.libs = libs
        self.gamma_feats = gamma_feats
        self.mask = mask
        self.etas = etas
        self.cn_obs = cn_obs
        self.rep_obs = rep_obs
        self.t_alpha = t_alpha
        self.t_beta = t_beta
        self.loci_mask = loci_mask
        self.eta_idx = eta_idx
        self.eta_w = eta_w
        self.cache: dict = {}

    FIELDS = ("reads", "libs", "gamma_feats", "mask", "etas", "cn_obs",
              "rep_obs", "t_alpha", "t_beta", "loci_mask", "eta_idx",
              "eta_w")

    def cached(self, key: str, fn):
        if key not in self.cache:
            self.cache[key] = fn()
        return self.cache[key]

    def slab_state(self) -> dict:
        """The batch as ``{field: tensor}`` (fields that are None left
        out) plus ``{'cache': {key: tensor}}``: what the serving slab
        stacks lane by lane (``infer/svi.py``).  Once the state-major
        ``etas_t`` is cached the cells-major ``etas`` is left out too:
        the objective reads only the cached copy (``prime_cache``)."""
        skip = ("etas",) if "etas_t" in self.cache else ()
        state = {k: getattr(self, k) for k in self.FIELDS
                 if getattr(self, k) is not None and k not in skip}
        state["cache"] = dict(self.cache)
        return state

    @classmethod
    def from_slab_state(cls, state: dict) -> "PertBatch":
        """The batch :meth:`slab_state` describes (one lane's view inside
        the slab's ``torch.func.vmap``), its cache included."""
        fields = dict(state)
        cache = fields.pop("cache", {})
        batch = cls(**fields)
        batch.cache = dict(cache)
        return batch

    def effective_loci_mask(self) -> torch.Tensor:
        """(loci,) float mask; all-ones when loci_mask is None."""
        if self.loci_mask is not None:
            return self.loci_mask
        return self.cached("ones_loci", lambda: torch.ones(
            (self.reads.shape[1],), dtype=torch.float32,
            device=self.reads.device))

    def etas_or_ones(self, P: int) -> torch.Tensor:
        if self.etas is not None:
            return self.etas
        return torch.ones(self.reads.shape + (P,), dtype=torch.float32,
                          device=self.reads.device)


# ---------------------------------------------------------------------------
# parameter initialisation
# ---------------------------------------------------------------------------

def init_params(spec: PertModelSpec, batch: PertBatch, fixed: dict,
                t_init=None, mesh=None) -> dict:
    """Initial unconstrained parameters: AutoDelta's init-at-prior-median
    for sample sites and the explicit inits of the param sites
    (reference: pert_model.py:542, 557, 561-562, 583); the pi parameter
    starts at the prior mean (categorical) or at its binary counterpart
    (:func:`_init_binary_pi`).  With ``mesh`` the batch, ``t_init`` and
    the result are this rank's block."""
    dev = batch.reads.device
    f32 = dict(dtype=torch.float32, device=dev)
    num_cells, num_loci = batch.reads.shape
    Kp1 = spec.K + 1
    params: dict = {}

    if not spec.cond_a:
        params["a_raw"] = from_positive(8.3917, device=dev)
    if not spec.fixed_lamb:
        params["lamb_raw"] = from_interval(0.1, LAMB_LO, LAMB_HI, device=dev)
    if not spec.cond_beta_means:
        params["beta_means"] = torch.zeros((spec.L, Kp1), **f32)
    params["beta_stds_raw"] = from_positive(
        torch.logspace(0.0, -spec.K, Kp1, **f32).repeat(spec.L, 1))
    if not spec.cond_rho:
        params["rho_raw"] = torch.full(
            (num_loci,), float(from_unit_interval(0.5)), **f32)

    if spec.tau_mode == "param":
        t0 = torch.as_tensor(t_init, **f32) if t_init is not None \
            else torch.full((num_cells,), 0.5, **f32)
        params["tau_raw"] = from_unit_interval(
            torch.clamp(t0, 1e-4, 1.0 - 1e-4))
    elif spec.tau_mode == "beta_prior":
        mean = batch.t_alpha / (batch.t_alpha + batch.t_beta)
        params["tau_raw"] = from_unit_interval(
            torch.clamp(mean, 1e-4, 1.0 - 1e-4))
    else:
        params["tau_raw"] = torch.full(
            (num_cells,), float(from_unit_interval(0.5)), **f32)

    # u at the prior median u_guess evaluated at the initial tau
    tau0 = to_unit_interval(params["tau_raw"])
    ploidies0 = _cell_ploidies(spec, batch, mesh)
    u_guess0 = _loci_mean(batch.reads, batch.effective_loci_mask(), mesh) \
        / ((1.0 + tau0) * ploidies0)
    params["u"] = u_guess0.to(torch.float32)

    beta_means0 = fixed["beta_means"] if spec.cond_beta_means \
        else params["beta_means"]
    params["betas"] = torch.as_tensor(beta_means0, **f32)[batch.libs] \
        .contiguous()

    if spec.binary_pi:
        params["pi_bin_logits"] = _init_binary_pi(spec, batch)
    elif not spec.step1 and batch.etas is not None:
        pi0 = batch.etas / torch.sum(batch.etas, dim=-1, keepdim=True)
        params["pi_logits"] = state_major(
            torch.log(torch.clamp(pi0, min=1e-30)))
    elif not spec.step1 and batch.eta_idx is not None:
        # pi0_s = (1 + [s == idx] * w) / (P + w), state-major directly
        sidx = torch.arange(spec.P, **f32)[:, None, None]
        params["pi_logits"] = (
            torch.where(sidx == batch.eta_idx[None],
                        torch.log1p(batch.eta_w)[None],
                        torch.zeros((), **f32))
            - torch.log(spec.P + batch.eta_w)[None]).contiguous()
    else:
        params["pi_logits"] = torch.zeros((spec.P, num_cells, num_loci),
                                          **f32)
    return {k: v.contiguous() for k, v in params.items()}


def _init_binary_pi(spec: PertModelSpec, batch: PertBatch) -> torch.Tensor:
    """(Kb, cells, loci) initial binary logit planes.  The encoding cannot
    hold an arbitrary simplex point, so the init targets the mode of the
    categorical init:

    * sparse one-hot prior: ``z_k = log1p(w) (2 bit_k(idx) - 1)``, whose
      masked softmax has its unique argmax at idx (w = 0 gives z = 0);
    * dense etas: the mean-field fit ``z_k = logit(q_k)`` of the per-bit
      marginals ``q_k = sum_s bit_k(s) pi0_s`` of the prior mean;
    * no prior (step 1, uniform): zeros.
    """
    dev = batch.reads.device
    num_cells, num_loci = batch.reads.shape
    Kb = binary_code_width(spec.P)
    if not spec.step1 and batch.eta_idx is not None:
        kk = torch.arange(Kb, dtype=torch.int32, device=dev)[:, None, None]
        idx = batch.eta_idx[None].to(torch.int32)
        bits = ((idx >> kk) & 1).to(torch.float32)
        return torch.log1p(batch.eta_w)[None] * (2.0 * bits - 1.0)
    if not spec.step1 and batch.etas is not None:
        B = torch.as_tensor(binary_code_matrix(spec.P), device=dev)
        pi0 = batch.etas / torch.sum(batch.etas, dim=-1, keepdim=True)
        q = torch.clamp(torch.einsum("clp,pk->clk", pi0, B), 1e-6, 1.0 - 1e-6)
        return state_major(torch.log(q) - torch.log1p(-q))
    return torch.zeros((Kb, num_cells, num_loci), dtype=torch.float32,
                       device=dev)


_CODE_MATRICES: dict = {}


def _code_matrix(P: int, device) -> torch.Tensor:
    """The (P, Kb) binary code matrix on ``device``, copied there once:
    a copy from host memory may not happen inside a CUDA graph's
    capture."""
    key = (P, str(device))
    if key not in _CODE_MATRICES:
        _CODE_MATRICES[key] = torch.as_tensor(binary_code_matrix(P),
                                              device=device)
    return _CODE_MATRICES[key]


def binary_log_pi(spec: PertModelSpec, zbin_t: torch.Tensor) -> torch.Tensor:
    """(cells, loci, P) log-softmax over the valid states of the (Kb,
    cells, loci) binary planes: only codes 0..P-1 are expanded."""
    B = _code_matrix(spec.P, zbin_t.device)
    logits = torch.einsum("kcl,pk->clp", zbin_t, B)
    return torch.log_softmax(logits, dim=-1)


def _loci_mean(x: torch.Tensor, lmask: torch.Tensor,
               mesh=None) -> torch.Tensor:
    """Mean over the loci axis restricted to real (unmasked) loci (with
    ``mesh``: over every rank of the row, so over the whole genome)."""
    num = torch.sum(x * lmask[None, :], dim=1)
    den = torch.sum(lmask)
    if mesh is not None and mesh.loci > 1:
        both = mesh.sum_loci(torch.cat([num, den.reshape(1)]))
        num, den = both[:-1], both[-1]
    return num / den


def _cell_ploidies(spec: PertModelSpec, batch: PertBatch,
                   mesh=None) -> torch.Tensor:
    """Per-cell ploidy guess of the u prior (reference:
    pert_model.py:589-600): mean argmax state of the prior, else 2."""
    if not spec.step1:
        if batch.etas is not None:
            cn_mode = torch.argmax(batch.etas, dim=-1).to(torch.float32)
            return _loci_mean(cn_mode, batch.effective_loci_mask(), mesh)
        if batch.eta_idx is not None:
            cn_mode = torch.where(batch.eta_w > 0.0, batch.eta_idx,
                                  torch.zeros_like(batch.eta_idx))
            return _loci_mean(cn_mode, batch.effective_loci_mask(), mesh)
    return torch.full((batch.reads.shape[0],), 2.0, dtype=torch.float32,
                      device=batch.reads.device)


# ---------------------------------------------------------------------------
# constrained views
# ---------------------------------------------------------------------------

def _sites(spec: PertModelSpec, params: dict, fixed: dict) -> dict:
    """Constrained values of every site except the pi simplex."""
    out = {}
    out["a"] = fixed["a"] if spec.cond_a else to_positive(params["a_raw"])
    out["lamb"] = fixed["lamb"] if spec.fixed_lamb \
        else to_interval(params["lamb_raw"], LAMB_LO, LAMB_HI)
    out["beta_means"] = fixed["beta_means"] if spec.cond_beta_means \
        else params["beta_means"]
    out["beta_stds"] = to_positive(params["beta_stds_raw"])
    out["rho"] = fixed["rho"] if spec.cond_rho \
        else to_unit_interval(params["rho_raw"])
    out["tau"] = to_unit_interval(params["tau_raw"])
    out["u"] = params["u"]
    out["betas"] = params["betas"]
    return out


def _log_pi(spec: PertModelSpec, params: dict) -> torch.Tensor:
    """(cells, loci, P) log-space simplex: log_softmax stays finite where
    log(softmax) would give -inf under the 1e6 prior concentrations."""
    if spec.binary_pi:
        return binary_log_pi(spec, params["pi_bin_logits"])
    return cells_major(torch.log_softmax(params["pi_logits"], dim=0))


def constrained(spec: PertModelSpec, params: dict, fixed: dict) -> dict:
    """Constrained-space values of every site, including the cells-major
    ``log_pi`` and ``pi``.  The fused training path never needs those
    two and uses :func:`_sites` instead."""
    out = _sites(spec, params, fixed)
    out["log_pi"] = _log_pi(spec, params)
    out["pi"] = torch.exp(out["log_pi"])
    return out


# ---------------------------------------------------------------------------
# log-joint
# ---------------------------------------------------------------------------

def _global_log_prior(c: dict) -> torch.Tensor:
    """Priors of the global sample sites: a ~ Gamma(2, 0.2), beta_means
    ~ Normal(0, 1); rho ~ Beta(1, 1) adds 0."""
    lp = torch.sum(gamma_log_prob(c["a"], 2.0, 0.2))
    lp = lp + torch.sum(normal_log_prob(c["beta_means"], 0.0, 1.0))
    return lp


def _per_cell_log_prior(spec: PertModelSpec, c: dict, batch: PertBatch,
                        reads_mean: torch.Tensor,
                        ploidies: torch.Tensor) -> torch.Tensor:
    """(cells,) prior terms for tau, u and betas."""
    tau, u, betas = c["tau"], c["u"], c["betas"]
    lp = torch.zeros_like(tau)
    if spec.tau_mode == "beta_prior":
        lp = lp + beta_log_prob(tau, batch.t_alpha, batch.t_beta)
    elif spec.tau_mode == "beta_default":
        lp = lp + beta_log_prob(tau, 1.5, 1.5)

    # denominator clamped away from 0 (a degenerate prior or a padded
    # cell would give u_guess = inf and NaN the loss)
    denom = torch.clamp((1.0 + tau) * ploidies, min=1e-6)
    u_guess = reads_mean / denom
    u_stdev = u_guess / 10.0
    lp = lp + normal_log_prob(u, u_guess, torch.clamp(u_stdev, min=1e-12))

    bm = c["beta_means"][batch.libs]
    bs = c["beta_stds"][batch.libs]
    lp = lp + torch.sum(normal_log_prob(betas, bm, bs), dim=-1)
    return lp


def _phi(c: dict) -> torch.Tensor:
    """(cells, loci) phi = sigmoid(a (tau - rho)) clamped to
    [0.001, 0.999] (reference: pert_model.py:616-623)."""
    t_diff = c["tau"][:, None] - c["rho"][None, :]
    phi = torch.sigmoid(c["a"] * t_diff)
    return torch.clamp(phi, PHI_LO, PHI_HI)


def _nb_pieces(c: dict):
    lamb = c["lamb"]
    return lamb, torch.log(lamb), torch.log1p(-lamb)


def _joint_logits(P, reads, u, omega, log_pi, phi, lamb, log_lamb,
                  log1m_lamb):
    """(cells, loci, P, 2) joint logits of the enumerated discrete sites:
    log pi[cn] + log Bern(rep | phi) + log NB(reads | delta(cn, rep))."""
    f32 = dict(dtype=torch.float32, device=reads.device)
    chi = torch.arange(P, **f32)[:, None] * \
        (1.0 + torch.arange(2, **f32))[None, :]
    theta = (u[:, None] * omega)[..., None, None] * chi
    delta = torch.clamp(theta * (1.0 - lamb) / lamb, min=1.0)
    # each (cells, loci, P, 2) term goes once the next is built: the
    # decode's peak memory, and a decode program's graph pool
    del theta
    nb = nb_log_prob(reads[..., None, None], delta, log_lamb, log1m_lamb)
    del delta
    bern = torch.stack([torch.log1p(-phi), torch.log(phi)], dim=-1)
    return log_pi[..., :, None] + bern[..., None, :] + nb


def _observed_bin_loglik(reads, u, omega, lp_cn, phi, cn_obs, rep_obs,
                         lamb, log_lamb, log1m_lamb):
    """(cells, loci) bin log-likelihood with cn/rep observed (step 1);
    ``lp_cn`` is log pi at each bin's observed state."""
    lp_rep = bernoulli_log_prob(rep_obs, phi)
    theta = u[:, None] * omega * cn_obs * (1.0 + rep_obs)
    delta = torch.clamp(theta * (1.0 - lamb) / lamb, min=1.0)
    lp_reads = nb_log_prob(reads, delta, log_lamb, log1m_lamb)
    return lp_cn + lp_rep + lp_reads


def _dirichlet_normaliser(P: int, batch: PertBatch,
                          sparse: bool) -> torch.Tensor:
    """(cells, loci) parameter-free Dirichlet normaliser
    ``lgamma(sum etas) - sum lgamma(etas)``.  Its two terms are ~1.3e7 at
    1e6 concentrations and cancel to ~1e2, so callers add it to the data
    term only after this difference is taken; the one-hot (sparse) form
    does the cancellation symbolically."""
    if sparse:
        return torch.lgamma(P + batch.eta_w) - torch.lgamma(1.0 + batch.eta_w)
    etas = batch.etas_or_ones(P)
    return (torch.lgamma(torch.sum(etas, dim=-1))
            - torch.sum(torch.lgamma(etas), dim=-1))


def _flat_dirichlet(P: int, batch: PertBatch) -> torch.Tensor:
    """(cells, loci) Dirichlet pi term of a batch without a prior (etas
    all ones): its data term is zero and its normaliser lgamma(P), the
    value :func:`_dirichlet_pi_term` gives there (lgamma of the float32
    sum of P ones, less P lgamma(1) = 0)."""
    return torch.lgamma(torch.full(batch.reads.shape, float(P),
                                   dtype=torch.float32,
                                   device=batch.reads.device))


def _dirichlet_pi_term(P: int, batch: PertBatch, log_pi: torch.Tensor,
                       sparse: bool) -> torch.Tensor:
    """(cells, loci) full Dirichlet pi term, data term + normaliser, from
    a materialised cells-major ``log_pi``."""
    if sparse:
        data = batch.eta_w * torch.gather(
            log_pi, -1, batch.eta_idx.to(torch.int64)[..., None])[..., 0]
    else:
        data = torch.sum((batch.etas_or_ones(P) - 1.0) * log_pi, dim=-1)
    return data + _dirichlet_normaliser(P, batch, sparse)


def _require_fixed_lamb(spec: PertModelSpec) -> None:
    if not spec.fixed_lamb:
        raise ValueError(
            "the fused enumeration requires fixed_lamb=True: its backward "
            "does not differentiate through lambda")


def _enum_bin_loglik(spec: PertModelSpec, reads, u, omega, log_pi, phi,
                     lamb) -> torch.Tensor:
    """(cells, loci) enumerated bin log-likelihood (states summed out)
    from a materialised cells-major ``log_pi``, without the Dirichlet
    term: the unfused ``enum_loglik`` (its kernel on the card, its plain
    version on the CPU)."""
    _require_fixed_lamb(spec)
    return enum_loglik(reads, u[:, None] * omega, log_pi, phi, lamb)


def prime_cache(spec: PertModelSpec, batch: PertBatch, mesh=None) -> dict:
    """Fill ``batch.cache`` with every fit-constant term :func:`log_joint`
    reads (the per-cell read means and ploidies, and for the fused path
    the Dirichlet normaliser and the state-major dense etas) and return
    it.  :func:`log_joint` reads them through here; the serving slab
    primes each lane's batch before it stacks the caches, so the batched
    objective computes none of them inside its ``torch.func.vmap``.
    With ``mesh`` the means over loci are the row's (a batch is one
    rank's block and is read with one mesh)."""
    lmask = batch.effective_loci_mask()
    batch.cached("reads_mean", lambda: _loci_mean(batch.reads, lmask, mesh))
    batch.cached("ploidies", lambda: _cell_ploidies(spec, batch, mesh))
    if spec.step1:
        return batch.cache
    if spec.sparse_etas:
        if batch.eta_idx is None or batch.eta_w is None:
            raise ValueError("spec.sparse_etas=True but the batch carries "
                             "no eta_idx/eta_w planes")
    elif batch.etas is None and batch.eta_idx is not None:
        raise ValueError(
            "batch carries the sparse eta_idx/eta_w encoding but "
            "spec.sparse_etas=False — the dense path would silently "
            "fit a uniform CN prior")
    batch.cached("dir_norm", lambda: _dirichlet_normaliser(
        spec.P, batch, sparse=spec.sparse_etas))
    if not spec.sparse_etas:
        # (chunks, P, chunk, loci): each chunk's state-major prior
        # contiguous, as the kernels take it (one chunk: a view), made
        # again when a spec with other chunks reads the batch
        etas_t = batch.cache.get("etas_t")
        nch = _chunking(spec, batch.reads.shape[0])[1]
        if etas_t is None or etas_t.shape[0] != nch:
            batch.cache["etas_t"] = _chunk_state_major(
                state_major(batch.etas_or_ones(spec.P)), spec)
    return batch.cache


def _chunk_state_major(x_t: torch.Tensor,
                       spec: PertModelSpec) -> torch.Tensor:
    """(P, cells, loci) -> (chunks, P, chunk, loci), contiguous."""
    P, cells, loci = x_t.shape
    ch, nch = _chunking(spec, cells)
    return x_t.reshape(P, nch, ch, loci).transpose(0, 1).contiguous()


def _chunking(spec: PertModelSpec, num_cells: int) -> tuple:
    """(chunk, number of chunks): all cells in one chunk unless
    ``spec.cell_chunk`` is set."""
    ch = spec.cell_chunk or num_cells
    if num_cells % ch:
        raise ValueError(f"cells={num_cells} not divisible by "
                         f"cell_chunk={ch}; pad first")
    return ch, num_cells // ch


def log_joint(spec: PertModelSpec, params: dict, fixed: dict,
              batch: PertBatch, mesh=None) -> torch.Tensor:
    """Total log-joint (the negative of the SVI loss), discretes summed
    out: the step-1 observed path, or the fused dense / sparse path.
    With ``mesh``: this rank's share of the total (module docstring)."""
    c = _sites(spec, params, fixed)
    lamb, log_lamb, log1m_lamb = _nb_pieces(c)
    mask = batch.mask
    lmask = batch.effective_loci_mask()
    bin_mask = mask[:, None] * lmask[None, :]
    cache = prime_cache(spec, batch, mesh)

    if mesh is None or mesh.owns_globals:
        lp = _global_log_prior(c)
    else:
        lp = torch.zeros((), dtype=torch.float32, device=mask.device)
    if mesh is None or mesh.owns_cells:
        lp = lp + torch.sum(_per_cell_log_prior(
            spec, c, batch, cache["reads_mean"], cache["ploidies"]) * mask)

    phi = _phi(c)
    omega = gc_rate(c["betas"], batch.gamma_feats)
    if spec.step1:
        cn_idx = batch.cn_obs.to(torch.int64)
        if batch.etas is None and not spec.binary_pi:
            # no CN prior (step 1 as the runner builds it): the Dirichlet
            # term is 0 * log_pi plus lgamma(P) in every bin, so the
            # all-ones etas and a cells-major log_pi are not built (each
            # 872 MB at a serving bucket's 2048 doubled G1 cells); for
            # finite logits the loss and gradients are the full terms'
            # bit for bit
            lp_pi = _flat_dirichlet(spec.P, batch)

            def lp_cn_of(pi_logits, cn):
                log_pi_t = torch.log_softmax(pi_logits, dim=0)
                return torch.gather(log_pi_t, 0, cn[None])[0]

            pi_param, state_major_pi = params["pi_logits"], True
        else:
            log_pi = _log_pi(spec, params)
            lp_pi = _dirichlet_pi_term(spec.P, batch, log_pi, sparse=False)

            def lp_cn_of(log_pi_rows, cn):
                return torch.gather(log_pi_rows, -1, cn[..., None])[..., 0]

            pi_param, state_major_pi = log_pi, False   # cells-major
        lp = lp + torch.sum(lp_pi * bin_mask)

        def bin_ll(rows, pi_rows):
            return _observed_bin_loglik(
                batch.reads[rows], c["u"][rows], omega[rows],
                lp_cn_of(pi_rows, cn_idx[rows]), phi[rows],
                batch.cn_obs[rows], batch.rep_obs[rows], lamb, log_lamb,
                log1m_lamb)
    else:
        # fused path: the kernel folds log_softmax and the Dirichlet data
        # term; only the parameter-free normaliser stays here
        _require_fixed_lamb(spec)
        mu = c["u"][:, None] * omega
        pi_param = params["pi_bin_logits" if spec.binary_pi
                          else "pi_logits"]
        state_major_pi = True
        lp = lp + torch.sum(cache["dir_norm"] * bin_mask)

        def bin_ll(rows, pi_rows, etas_rows=None):
            reads, mu_r, phi_r = batch.reads[rows], mu[rows], phi[rows]
            if spec.sparse_etas:
                eidx, ew = batch.eta_idx[rows], batch.eta_w[rows]
                if spec.binary_pi:
                    return enum_loglik_fused_sparse_binary(
                        reads, mu_r, pi_rows, phi_r, eidx, ew, lamb, spec.P)
                return enum_loglik_fused_sparse(reads, mu_r, pi_rows, phi_r,
                                                eidx, ew, lamb)
            if spec.binary_pi:
                return enum_loglik_fused_binary(reads, mu_r, pi_rows, phi_r,
                                                etas_rows, lamb, spec.P)
            return enum_loglik_fused(reads, mu_r, pi_rows, phi_r, etas_rows,
                                     lamb)

    # cell chunks (JAX: lax.map over the chunks, models/pert.py:857-900):
    # the fused entry points run once per chunk and the chunk sums add
    # up.  The state-major pi's chunks are not contiguous; torch.split
    # hands each one to .contiguous(), whose gradients autograd
    # concatenates back into the full plane.  One chunk is the whole
    # batch: a full slice is the tensor itself, and pi is not split (its
    # gradient would be copied)
    ch, nch = _chunking(spec, batch.reads.shape[0])
    pi_chunks = torch.split(pi_param, ch, dim=1 if state_major_pi else 0) \
        if nch > 1 else (pi_param,)
    sums = []
    for i in range(nch):
        rows = slice(i * ch, (i + 1) * ch)
        extra = () if spec.step1 or spec.sparse_etas \
            else (cache["etas_t"][i],)
        ll = bin_ll(rows, pi_chunks[i].contiguous(), *extra)
        sums.append(torch.sum(ll * bin_mask[rows]))
    return lp + torch.sum(torch.stack(sums))


def pert_loss(spec: PertModelSpec, params: dict, fixed: dict,
              batch: PertBatch, mesh=None) -> torch.Tensor:
    """SVI loss = -log_joint (point-mass posterior; reference:
    pert_model.py:742-758); with ``mesh`` this rank's share."""
    return -log_joint(spec, params, fixed, batch, mesh=mesh)


def per_cell_objective(spec: PertModelSpec, params: dict, fixed: dict,
                       batch: PertBatch, mesh=None) -> torch.Tensor:
    """(cells,) per-cell terms of the log-joint: the tau/u/betas priors,
    the full Dirichlet pi term and the enumerated bin log-likelihood,
    each summed over the real loci.  The global priors (a, beta_means)
    are left out: two parameter sets that share the conditioned globals
    have the same ones, which is what the mirror rescue compares
    (infer/runner.py).  The enumerated term goes through the unfused
    ``enum_loglik``; log_pi comes from either encoding.  With ``mesh``
    the cells are this rank's and the sums run over the whole row."""
    c = _sites(spec, params, fixed)
    lamb, log_lamb, log1m_lamb = _nb_pieces(c)
    lmask = batch.effective_loci_mask()
    reads_mean = _loci_mean(batch.reads, lmask, mesh)
    ploidies = _cell_ploidies(spec, batch, mesh)
    obj = _per_cell_log_prior(spec, c, batch, reads_mean, ploidies)
    if mesh is not None and not mesh.owns_cells:
        obj = torch.zeros_like(obj)

    log_pi = _log_pi(spec, params)
    lp_pi = _dirichlet_pi_term(spec.P, batch, log_pi,
                               sparse=batch.eta_idx is not None)
    obj = obj + torch.sum(lp_pi * lmask[None, :], dim=1)

    phi = _phi(c)
    omega = gc_rate(c["betas"], batch.gamma_feats)
    if spec.step1:
        lp_cn = torch.gather(log_pi, -1,
                             batch.cn_obs.to(torch.int64)[..., None])[..., 0]
        ll = _observed_bin_loglik(batch.reads, c["u"], omega, lp_cn, phi,
                                  batch.cn_obs, batch.rep_obs, lamb,
                                  log_lamb, log1m_lamb)
    else:
        ll = _enum_bin_loglik(spec, batch.reads, c["u"], omega, log_pi, phi,
                              lamb)
    obj = obj + torch.sum(ll * lmask[None, :], dim=1)
    return obj if mesh is None else mesh.sum_loci(obj)


# ---------------------------------------------------------------------------
# discrete decode (infer_discrete, temperature=0)
# ---------------------------------------------------------------------------

# per-cell parameters and the axis their cells live on (the pi planes are
# state-major, so their cells axis is 1); the rest are global or per-locus
_PER_CELL_PARAM_AXIS = {"tau_raw": 0, "u": 0, "betas": 0, "pi_logits": 1,
                        "pi_bin_logits": 1}

# target size of one decode slab's (chunk, loci, P, 2) joint tensor
_DECODE_SLAB_BYTES = 1 << 30


def model_joint_logits(spec: PertModelSpec, params: dict, fixed: dict,
                       batch: PertBatch) -> torch.Tensor:
    """(cells, loci, P, 2) joint logits of the fitted model (the
    constrained sites of :func:`constrained` less pi, which the joint
    does not read: a decode's peak memory is its slab's live set)."""
    c = _sites(spec, params, fixed)
    lamb, log_lamb, log1m_lamb = _nb_pieces(c)
    phi = _phi(c)
    omega = gc_rate(c["betas"], batch.gamma_feats)
    return _joint_logits(spec.P, batch.reads, c["u"], omega,
                         _log_pi(spec, params), phi, lamb, log_lamb,
                         log1m_lamb)


def slice_cells(params: dict, batch: PertBatch, idx) -> tuple:
    """(params, batch) restricted to the cell indices ``idx``."""
    idx = torch.as_tensor(idx, device=batch.reads.device)
    p = {k: (torch.index_select(v, _PER_CELL_PARAM_AXIS[k], idx)
             if k in _PER_CELL_PARAM_AXIS else v)
         for k, v in params.items()}

    def _take(x):
        return None if x is None else torch.index_select(x, 0, idx)

    b = PertBatch(
        reads=_take(batch.reads), libs=_take(batch.libs),
        gamma_feats=batch.gamma_feats, mask=_take(batch.mask),
        loci_mask=batch.loci_mask, etas=_take(batch.etas),
        eta_idx=_take(batch.eta_idx), eta_w=_take(batch.eta_w),
        cn_obs=_take(batch.cn_obs), rep_obs=_take(batch.rep_obs),
        t_alpha=_take(batch.t_alpha), t_beta=_take(batch.t_beta))
    return p, b


def _decode_slabs(spec: PertModelSpec, batch: PertBatch,
                  cell_chunk: Optional[int]) -> list:
    """Equal-length cell-index slabs keeping each joint tensor under
    ``_DECODE_SLAB_BYTES`` (the tail slab clamps to the last cell; the
    caller trims the duplicates).  ``[None]`` = one pass."""
    num_cells, num_loci = batch.reads.shape
    if cell_chunk is None:
        per_cell = num_loci * spec.P * 2 * 4
        cell_chunk = max(1, _DECODE_SLAB_BYTES // max(per_cell, 1))
    if cell_chunk >= num_cells:
        return [None]
    return [np.minimum(np.arange(i, i + cell_chunk), num_cells - 1)
            for i in range(0, num_cells, cell_chunk)]


def p_rep_marginal(joint: torch.Tensor) -> torch.Tensor:
    """(cells, loci) posterior marginal P(rep=1 | reads)."""
    P = joint.shape[-2]
    flat = joint.reshape(joint.shape[:-2] + (P * 2,))
    norm = torch.logsumexp(flat, dim=-1)
    return torch.exp(torch.logsumexp(joint[..., 1], dim=-1) - norm)


def _plogp_sum(log_p: torch.Tensor, dim: int) -> torch.Tensor:
    """-sum(p log p) along ``dim`` from log-probabilities, with the
    0 * -inf corner (an underflowed state) defined as 0."""
    term = torch.where(torch.isfinite(log_p), torch.exp(log_p) * log_p,
                       torch.zeros_like(log_p))
    return -torch.sum(term, dim=dim)


def entropy_from_joint(joint: torch.Tensor):
    """(cells, loci) posterior-confidence maps from the joint logits:
    the Shannon entropies of the per-bin CN and replication-state
    posterior marginals, normalized by log P and log 2 into [0, 1]
    (0 = certain, 1 = uniform)."""
    P = joint.shape[-2]
    flat = joint.reshape(joint.shape[:-2] + (P * 2,))
    log_z = torch.logsumexp(flat, dim=-1)
    log_post = joint - log_z[..., None, None]
    cn_ent = _plogp_sum(torch.logsumexp(log_post, dim=-1), -1) / math.log(P)
    rep_ent = _plogp_sum(torch.logsumexp(log_post, dim=-2), -1) \
        / math.log(2.0)
    # float32 rounding can leave the normalized entropy an epsilon
    # outside [0, 1]; the QC thresholds treat the bounds as exact
    return torch.clamp(cn_ent, 0.0, 1.0), torch.clamp(rep_ent, 0.0, 1.0)


def _pass_batch(batch: PertBatch) -> PertBatch:
    """The batch fields a decode or PPC pass reads (the reads, the GC
    features and the loci mask, made explicit) and the per-cell ones
    every batch has, so that a slab program's buffers and key hold
    nothing else (``infer/svi.py``)."""
    return PertBatch(reads=batch.reads, libs=batch.libs,
                     gamma_feats=batch.gamma_feats, mask=batch.mask,
                     loci_mask=batch.effective_loci_mask())


def _resolve_slab_program(tag: str, spec: PertModelSpec, dev, mesh,
                         static_kwargs: dict):
    """The run's store view for the slab passes of one decode or PPC
    call (JAX ``_resolve_slab_program``), or None: the passes run
    eagerly.  Lazy import: models/ stays importable without the infer
    layer."""
    from scdna_replication_tools_tpu_torch.infer.svi import (
        resolve_slab_program as resolve,
    )

    return resolve(tag, spec, dev, mesh, static_kwargs)


def _decode_joint(spec: PertModelSpec, params: dict, fixed: dict,
                  batch: PertBatch):
    """The decode's first stage: ``(joint, (cn_map, rep_map, p_rep))``,
    the slab's joint logits and its MAP planes and marginal."""
    joint = model_joint_logits(spec, params, fixed, batch)
    flat = joint.reshape(joint.shape[:-2] + (spec.P * 2,))
    best = torch.argmax(flat, dim=-1)
    return joint, ((best // 2).to(torch.int32), (best % 2).to(torch.int32),
                   p_rep_marginal(joint))


def _decode_slab(spec: PertModelSpec, params: dict, fixed: dict,
                 batch: PertBatch, want_entropy: bool = False):
    """One decode pass (JAX ``_decode_slab``): joint logits -> (cn, rep,
    p_rep) [+ (cn_entropy, rep_entropy) when ``want_entropy``, from the
    same joint tensor]."""
    with scope("pert/decode"):
        joint, out = _decode_joint(spec, params, fixed, batch)
        if want_entropy:
            with scope("pert/qc_entropy"):
                out = out + entropy_from_joint(joint)
    return out


@torch.no_grad()
def decode_discrete(spec: PertModelSpec, params: dict, fixed: dict,
                    batch: PertBatch, cell_chunk: Optional[int] = None,
                    want_entropy: bool = False, mesh=None):
    """MAP cn/rep per bin + marginal replication probability: the
    temperature-0 ``infer_discrete`` of the reference, an independent
    argmax over each bin's (P, 2) joint logits, in cell slabs, each one
    :func:`_decode_slab` pass or a replay of its program
    (:func:`_resolve_slab_program`; ``mesh`` marks a sharded run, whose
    passes stay eager).

    Returns (cn_map, rep_map, p_rep), each (cells, loci), on device;
    ``want_entropy=True`` appends the (cn_entropy, rep_entropy) maps of
    :func:`entropy_from_joint`, from the same joint tensor.
    """
    num_cells = batch.reads.shape[0]
    programs = _resolve_slab_program("decode_slab", spec, batch.reads.device,
                                    mesh, {"want_entropy": want_entropy})
    pb = _pass_batch(batch)
    outs = []
    for idx in _decode_slabs(spec, batch, cell_chunk):
        p, b = (params, pb) if idx is None else slice_cells(params, pb, idx)
        outs.append(_decode_slab(spec, p, fixed, b, want_entropy)
                    if programs is None else programs.run((p, fixed, b)))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[i] for o in outs], dim=0)[:num_cells]
                 for i in range(len(outs[0])))


def posterior_entropy(spec: PertModelSpec, params: dict, fixed: dict,
                      batch: PertBatch, cell_chunk: Optional[int] = None,
                      mesh=None):
    """(cn_entropy, rep_entropy) posterior-confidence maps alone."""
    out = decode_discrete(spec, params, fixed, batch, cell_chunk=cell_chunk,
                          want_entropy=True, mesh=mesh)
    return out[3], out[4]


def entropy_aggregates_from_planes(cn_ent, rep_ent, lmask,
                                   entropy_thresh: float,
                                   want_max: bool = False,
                                   mesh=None) -> dict:
    """Per-cell reduction of the (cells, loci) entropy planes over the
    real loci: the one copy of the aggregate math that the rescue gate
    (:func:`cell_entropy_aggregates`) and the QC table share (with
    ``mesh``: this rank's cells, reduced over the whole row)."""
    w = lmask[None, :]
    sums = torch.stack([torch.sum(cn_ent * w, dim=1),
                        torch.sum((cn_ent > entropy_thresh) * w, dim=1),
                        torch.sum(rep_ent * w, dim=1)])
    count = torch.sum(lmask)
    if mesh is not None and mesh.loci > 1:
        both = mesh.sum_loci(torch.cat([sums.reshape(-1),
                                        count.reshape(1)]))
        sums, count = both[:-1].reshape(sums.shape), both[-1]
    denom = torch.clamp(count, min=1.0)
    out = {
        "mean_cn_entropy": sums[0] / denom,
        "frac_low_conf": sums[1] / denom,
        "mean_rep_entropy": sums[2] / denom,
    }
    if want_max:
        out["max_cn_entropy"] = torch.max(
            torch.where(w > 0, cn_ent, torch.zeros_like(cn_ent)), dim=1).values
        if mesh is not None:
            mesh.all_reduce(out["max_cn_entropy"], ("loci",),
                            op=torch.distributed.ReduceOp.MAX)
    return out


def cell_entropy_aggregates(spec: PertModelSpec, params: dict, fixed: dict,
                            batch: PertBatch, entropy_thresh: float = 0.5,
                            cell_chunk: Optional[int] = None, mesh=None):
    """(mean_cn_entropy, frac_low_conf, mean_rep_entropy), each (cells,),
    over the real loci, on device: the QC table's aggregates, standalone
    for the controller's rescue gate."""
    cn_ent, rep_ent = posterior_entropy(spec, params, fixed, batch,
                                        cell_chunk=cell_chunk, mesh=mesh)
    agg = entropy_aggregates_from_planes(
        cn_ent, rep_ent, batch.effective_loci_mask(), entropy_thresh,
        mesh=mesh)
    return (agg["mean_cn_entropy"], agg["frac_low_conf"],
            agg["mean_rep_entropy"])


@torch.no_grad()
def decode_discrete_hmm(spec: PertModelSpec, params: dict, fixed: dict,
                        batch: PertBatch, restart, self_prob: float,
                        cell_chunk: Optional[int] = None,
                        want_entropy: bool = False, mesh=None):
    """Genome-smoothed MAP decode: Viterbi over the CN chain
    (``models.hmm``), in the cell slabs of :func:`decode_discrete` (the
    chain couples loci, not cells).  ``restart`` (loci,) is 1 where a
    chromosome starts, over the whole genome.  ``want_entropy=True``
    appends the entropy maps from the same per-slab joint tensor the
    Viterbi consumes.  ``mesh`` (a ``RankMesh`` that shards the loci):
    the batch is this rank's block, and the Viterbi runs on whole rows,
    its emissions gathered along the rank's loci row (``hmm_decode``);
    every output is this rank's block."""
    from scdna_replication_tools_tpu_torch.models.hmm import hmm_decode

    num_cells = batch.reads.shape[0]
    outs = []
    for idx in _decode_slabs(spec, batch, cell_chunk):
        p, b = (params, batch) if idx is None \
            else slice_cells(params, batch, idx)
        with scope("pert/decode"):
            joint = model_joint_logits(spec, p, fixed, b)
            decoded = hmm_decode(joint, restart, self_prob, mesh=mesh)
            if want_entropy:
                with scope("pert/qc_entropy"):
                    decoded = decoded + entropy_from_joint(joint)
        outs.append(decoded)
        del joint
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[i] for o in outs], dim=0)[:num_cells]
                 for i in range(len(outs[0])))


# ---------------------------------------------------------------------------
# posterior-predictive check (model-health QC)
# ---------------------------------------------------------------------------

def _ppc_model(spec: PertModelSpec, params: dict, fixed: dict,
               batch: PertBatch, cn_map: torch.Tensor,
               rep_map: torch.Tensor):
    """(delta, lamb, log_lamb, log1m_lamb) of the fitted NB observation
    model at the MAP discrete states."""
    c = _sites(spec, params, fixed)
    lamb, log_lamb, log1m_lamb = _nb_pieces(c)
    omega = gc_rate(c["betas"], batch.gamma_feats)
    theta = c["u"][:, None] * omega * cn_map.to(torch.float32) \
        * (1.0 + rep_map.to(torch.float32))
    delta = torch.clamp(theta * (1.0 - lamb) / lamb, min=1.0)
    return delta, lamb, log_lamb, log1m_lamb


def _ppc_slab(spec: PertModelSpec, params: dict, fixed: dict,
              batch: PertBatch, cn_map: torch.Tensor, rep_map: torch.Tensor,
              replicates: Optional[torch.Tensor] = None, *,
              num_replicates: int, generator=None, mesh=None):
    """One PPC pass (JAX ``_ppc_slab``): per-cell (observed deviance,
    z-score), the deviance D = -2 sum_l log NB(y_l | .) over real loci of
    the observed reads, standardised against the replicates' deviances.
    The ``num_replicates`` replicates are drawn here at the MAP states on
    ``generator`` (Gamma then Poisson, ``ops.dists.nb_sample``), unless
    ``replicates`` supplies them; with ``mesh`` the deviances sum over the
    row."""
    with scope("pert/ppc"):
        delta, lamb, log_lamb, log1m_lamb = _ppc_model(
            spec, params, fixed, batch, cn_map, rep_map)
        if replicates is None:
            replicates = nb_sample(delta, lamb, int(num_replicates),
                                   generator)
        lmask = batch.effective_loci_mask()

        def deviance(y):
            return -2.0 * torch.sum(
                nb_log_prob(y, delta, log_lamb, log1m_lamb) * lmask, dim=-1)

        obs = deviance(batch.reads)
        rep = deviance(replicates)
        if mesh is not None and mesh.loci > 1:
            both = mesh.sum_loci(torch.cat([obs[None], rep]))
            obs, rep = both[0], both[1:]
        z = (obs - torch.mean(rep, dim=0)) \
            / torch.clamp(torch.std(rep, dim=0, correction=0), min=1e-6)
    return obs, z


@torch.no_grad()
def ppc_discrepancy(spec: PertModelSpec, params: dict, fixed: dict,
                    batch: PertBatch, seed: int = 0,
                    num_replicates: int = 8,
                    cell_chunk: Optional[int] = None,
                    maps: Optional[tuple] = None,
                    replicates: Optional[torch.Tensor] = None, mesh=None):
    """Per-cell posterior-predictive discrepancy, cell-slabbed (JAX
    ``ppc_discrepancy``): ``(obs_deviance, ppc_z)``, each (cells,), on
    device, each slab one :func:`_ppc_slab` pass or a replay of its
    program (:func:`_resolve_slab_program`).  ``maps`` = (cn_map,
    rep_map) are the MAP states the replicates are drawn at (None
    decodes them here).  ``replicates`` ((num_replicates, cells, loci)
    read counts) supplies the draws; without it slab ``k`` draws its own
    from a generator seeded by ``(seed, k)`` (with ``mesh``: this rank's
    cells, the maps its block, and each rank's draws salted by its
    rank)."""
    num_cells = batch.reads.shape[0]
    dev = batch.reads.device
    if maps is None:
        cn_map, rep_map, _ = decode_discrete(spec, params, fixed, batch,
                                             cell_chunk=cell_chunk,
                                             mesh=mesh)
    else:
        cn_map, rep_map = (torch.tensor(np.asarray(m), device=dev)
                           for m in maps)
    if replicates is not None:
        replicates = torch.as_tensor(replicates, dtype=torch.float32,
                                     device=dev)
    programs = _resolve_slab_program("ppc", spec, dev, mesh,
                                    {"num_replicates": int(num_replicates)})
    pb = _pass_batch(batch)
    outs = []
    for si, idx in enumerate(_decode_slabs(spec, batch, cell_chunk)):
        p, b = (params, pb) if idx is None else slice_cells(params, pb, idx)
        sel = slice(None) if idx is None \
            else torch.as_tensor(idx, device=dev)
        operands = (p, fixed, b, cn_map[sel], rep_map[sel])
        salt = si if mesh is None else si * mesh.size + mesh.rank
        if replicates is not None:
            operands += (replicates[:, sel],)
        if programs is not None:
            outs.append(programs.run(operands, None if replicates is not None
                                     else seed_of(seed, salt)))
        else:
            outs.append(_ppc_slab(
                spec, *operands, num_replicates=num_replicates, mesh=mesh,
                generator=None if replicates is not None
                else seeded_generator(seed, salt, dev)))
    if len(outs) == 1:
        return outs[0]
    return tuple(torch.cat([o[i] for o in outs], dim=0)[:num_cells]
                 for i in range(2))
