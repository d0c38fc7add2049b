"""PERT bin enumeration: CUDA kernels and plain versions.

Port of ``ops/enum_kernel.py``: the fused entry points
(``enum_loglik_fused``, ``enum_loglik_fused_sparse`` and their
independent-binary twins ``enum_loglik_fused_binary`` and
``enum_loglik_fused_sparse_binary``) and the unfused ``enum_loglik``.
Per (cell, locus) bin the fused objective is

    logsumexp_{s, r} (lp_s + log Bern(r | phi) + nb(chi = s (1 + r)))
      + x log(lamb) - lgamma(x + 1) + sum_s (etas_s - 1) lp_s

with ``lp = log_softmax(pi_logits)`` over the P states (sparse prior:
the data term is ``eta_w * lp_{eta_idx}``).  Under the binary encoding
the pi parameter is Kb = ceil(log2 P) planes z_k and state s's logit is
the sum of the planes of its set bits, ``x_s = z[b0] + z[b1] + ...`` in
ascending bit order (``x_0 = 0``); the backward folds
``dz_k = sum_{s: bit_k(s) = 1} dpi_s`` in ascending s (the TPU kernel's
order of summation, which float32 parity rests on).  The unfused
``enum_loglik`` is the enumerated log-likelihood alone: it takes the
cells-major log-simplex ``log_pi`` as given (no softmax, no Dirichlet
term) and its backward emits ``dlog_pi`` itself.  The fused CUDA kernels
(``csrc/enum_fused.cu``) read the state-major ``(P | Kb, cells, loci)``
planes once, the unfused ones each bin's P consecutive cells-major
``log_pi`` floats (the backward writes each full block's contiguous
``dlog_pi`` span back with one bulk asynchronous copy); all keep the
per-state terms in registers and never materialise the ``(cells, loci,
P, 2)`` enumeration tensor.  The backward recomputes
from the inputs and the saved enumeration-only logsumexp (the unfused
one from the saved log-likelihood).

Beside them sit the plain PyTorch versions (:func:`fused_fwd_plain`,
the explicit :func:`fused_bwd_plain`, :func:`enum_fwd_plain` and
:func:`enum_bwd_plain`), which repeat the kernels' arithmetic operation
for operation (same Stirling series, same chi order).  The series' shift
for arguments below 8 is the one difference of form: the plain versions
evaluate it everywhere and select, as the TPU kernel does, while a warp
of the CUDA kernels evaluates it so only where one of its 32 bins has an
argument below 8, and otherwise takes the series alone, which is the
select's value there.  The wrappers
(:func:`fused_fwd`, :func:`fused_bwd`, :func:`enum_fwd`,
:func:`enum_bwd`) take the plain version for a CPU tensor and launch the
kernel for a CUDA tensor; there is no fallback between the two.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from scdna_replication_tools_tpu_torch.ops import _cuda

MAX_P = 16  # the kernels' register arrays (csrc/enum_fused.cu MAXP)
THREADS = 256  # bins per block (csrc/enum_fused.cu THREADS)

_HALF_LOG_2PI = 0.9189385332046727


def lgamma_ge1(z: torch.Tensor) -> torch.Tensor:
    """float32 log-Gamma for z >= 1: Stirling's series past 8, smaller
    arguments shifted up by 8 through the recurrence (the TPU kernel's
    ``_lgamma_ge1``; the product is taken at min(z, 8) so it cannot
    overflow)."""
    zs = torch.clamp(z, max=8.0)
    shift_prod = (zs * (zs + 1.0) * (zs + 2.0) * (zs + 3.0)
                  * (zs + 4.0) * (zs + 5.0) * (zs + 6.0) * (zs + 7.0))
    small = z < 8.0
    zz = torch.where(small, z + 8.0, z)
    inv = 1.0 / zz
    inv2 = inv * inv
    series = inv * (1.0 / 12.0 + inv2 * (-1.0 / 360.0 + inv2 * (1.0 / 1260.0)))
    st = (zz - 0.5) * torch.log(zz) - zz + _HALF_LOG_2PI + series
    return torch.where(small, st - torch.log(shift_prod), st)


def lgamma_digamma_ge1(z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lgamma(z), digamma(z)) for z >= 1 sharing the shift and the log
    (the TPU kernel's ``_lgamma_digamma_ge1``)."""
    zs = torch.clamp(z, max=8.0)
    t1, t2, t3 = zs + 1.0, zs + 2.0, zs + 3.0
    t4, t5, t6, t7 = zs + 4.0, zs + 5.0, zs + 6.0, zs + 7.0
    shift_prod = zs * t1 * t2 * t3 * t4 * t5 * t6 * t7
    shift_sum = (1.0 / zs + 1.0 / t1 + 1.0 / t2 + 1.0 / t3
                 + 1.0 / t4 + 1.0 / t5 + 1.0 / t6 + 1.0 / t7)
    small = z < 8.0
    zz = torch.where(small, z + 8.0, z)
    inv = 1.0 / zz
    inv2 = inv * inv
    logzz = torch.log(zz)
    series = inv * (1.0 / 12.0 + inv2 * (-1.0 / 360.0 + inv2 * (1.0 / 1260.0)))
    st = (zz - 0.5) * logzz - zz + _HALF_LOG_2PI + series
    lg = torch.where(small, st - torch.log(shift_prod), st)
    psi = (logzz - 0.5 * inv
           - inv2 * (1.0 / 12.0 + inv2 * (-1.0 / 120.0 + inv2 * (1.0 / 252.0))))
    psi = torch.where(small, psi - shift_sum, psi)
    return lg, psi


def chi_slots(P: int) -> List[Tuple[float, List[Tuple[int, int]]]]:
    """The distinct total-CN values chi = s * (1 + r) over the (P, 2)
    state product, each with the (s, rep) pairs that share it: the NB
    term depends on chi alone, so each distinct value is evaluated once
    (19 of the 26 pairs at P=13).  The kernels unroll the same order."""
    slots = []
    for chi in range(2 * P - 1):
        pairs = []
        if chi <= P - 1:
            pairs.append((chi, 0))
        if chi % 2 == 0 and chi // 2 <= P - 1:
            pairs.append((chi // 2, 1))
        if pairs:
            slots.append((float(chi), pairs))
    return slots


def scalars(lamb: torch.Tensor) -> torch.Tensor:
    """(3,) float32 device tensor [log lamb, log(1 - lamb), (1-lamb)/lamb]
    on lamb's device: the kernels read it from device memory, so a fit
    never syncs to hand lambda over."""
    lamb = torch.as_tensor(lamb, dtype=torch.float32).reshape(())
    return torch.stack([torch.log(lamb), torch.log1p(-lamb),
                        (1.0 - lamb) / lamb])


# ---------------------------------------------------------------------------
# independent-binary CN encoding (arXiv 2206.00093)
# ---------------------------------------------------------------------------

def binary_code_width(P: int) -> int:
    """Kb = ceil(log2 P): binary logit planes encoding P states."""
    return max(1, math.ceil(math.log2(max(P, 2))))


def state_codes(P: int) -> List[Tuple[int, ...]]:
    """Per-state tuples of set bit indices, ascending: state s -> the k
    with bit_k(s) = 1.  The kernels unroll the same table."""
    Kb = binary_code_width(P)
    return [tuple(k for k in range(Kb) if (s >> k) & 1) for s in range(P)]


def binary_code_matrix(P: int) -> np.ndarray:
    """(P, Kb) float32 bit matrix B with B[s, k] = bit_k(s)."""
    B = np.zeros((P, binary_code_width(P)), np.float32)
    for s, bits in enumerate(state_codes(P)):
        B[s, list(bits)] = 1.0
    return B


def planes_per_iter(P: int = 13, *, binary: bool = False,
                    sparse_etas: bool = True,
                    moment_dtype: str = "float32") -> int:
    """Analytic HBM traffic of one fused step-2 iteration in (cells x
    loci) float32 planes: the kernels' ``6 + 2 Kp + (4 | 2P) + 4 + 2 +
    Kp`` plus Adam's ``Kp (3 + 4 m)``, m = 0.5 for bfloat16 moments and
    Kp the pi planes (P, or Kb under the binary encoding)."""
    Kp = binary_code_width(P) if binary else P
    kernel = 6 + 2 * Kp + (4 if sparse_etas else 2 * P) + 4 + 2 + Kp
    mom = 0.5 if moment_dtype == "bfloat16" else 1.0
    return int(round(kernel + Kp * (3 + 4 * mom)))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _state_logits(pi_t: torch.Tensor,
                  binary_P: Optional[int]) -> List[torch.Tensor]:
    """Per-state unnormalised logit planes: the P planes of a categorical
    ``pi_t``, or, with ``binary_P``, each state's sum of its set bits' z
    planes in ascending bit order (state 0 has no set bit: logit 0)."""
    if binary_P is None:
        return [pi_t[s] for s in range(pi_t.shape[0])]
    xs = []
    for bits in state_codes(binary_P):
        if not bits:
            xs.append(torch.zeros_like(pi_t[0]))
            continue
        x = pi_t[bits[0]]
        for k in bits[1:]:
            x = x + pi_t[k]
        xs.append(x)
    return xs


def _log_softmax_planes(xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-state log-softmax planes, max-then-sum like the kernels."""
    m = xs[0]
    for x in xs[1:]:
        m = torch.maximum(m, x)
    z = torch.zeros_like(m)
    for x in xs:
        z = z + torch.exp(x - m)
    log_z = m + torch.log(z)
    return [x - log_z for x in xs]


def _nb_core(x, mu, chi, q, log1m_lamb):
    delta = torch.clamp(mu * (chi * q), min=1.0)
    return lgamma_ge1(x + delta) - lgamma_ge1(delta) + delta * log1m_lamb


def _enum_lse(x, mu, lp, bern, lgx1, log1m_lamb, q) -> torch.Tensor:
    """Two-pass logsumexp over the bin's (state, rep) pairs of
    ``lp_s + bern_r + nb(chi)``, one NB core per distinct chi (chi = 0
    reuses ``lgx1 = lgamma(x + 1)``): the kernels' ``enum_lse``."""
    slots = chi_slots(len(lp))
    nbs = [lgx1 + log1m_lamb if chi == 0.0
           else _nb_core(x, mu, chi, q, log1m_lamb) for chi, _ in slots]
    m = torch.full_like(x, -math.inf)
    for nb, (_, pairs) in zip(nbs, slots):
        for s, r in pairs:
            m = torch.maximum(m, lp[s] + bern[r] + nb)
    acc = torch.zeros_like(x)
    for nb, (_, pairs) in zip(nbs, slots):
        for s, r in pairs:
            acc = acc + torch.exp(lp[s] + bern[r] + nb - m)
    return m + torch.log(acc)


def _enum_sweep_bwd(x, mu, g, lse, lp, bern, dbern, lgx1, log1m_lamb, q,
                    dlp, tot=None):
    """The backward's chi sweep (the kernels' ``enum_sweep_bwd``): each
    (state, rep) pair's posterior weight ``g exp(lp_s + bern_r + nb -
    lse)`` is added to dmu, dphi, ``dlp[s]`` (in place) and, when given,
    ``tot``.  Returns (dmu, dphi, tot)."""
    dmu = torch.zeros_like(x)
    dphi = torch.zeros_like(x)
    for chi, pairs in chi_slots(len(lp)):
        if chi == 0.0:
            nb = lgx1 + log1m_lamb
            dmu_slot = None
        else:
            cq = chi * q
            delta = torch.clamp(mu * cq, min=1.0)
            lg_xd, psi_xd = lgamma_digamma_ge1(x + delta)
            lg_d, psi_d = lgamma_digamma_ge1(delta)
            nb = lg_xd - lg_d + delta * log1m_lamb
            ddelta = psi_xd - psi_d + log1m_lamb
            dmu_slot = ddelta * (mu * cq > 1.0).to(x.dtype) * cq
        for s, r in pairs:
            gw = g * torch.exp(lp[s] + bern[r] + nb - lse)
            if dmu_slot is not None:
                dmu = dmu + gw * dmu_slot
            dphi = dphi + gw * dbern[r]
            dlp[s] = dlp[s] + gw
            if tot is not None:
                tot = tot + gw
    return dmu, dphi, tot


def fused_fwd_plain(reads, mu, pi_t, phi, scal, etas_t=None, eta_idx=None,
                    eta_w=None, binary_P=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse), each (cells, loci): the kernels' forward as plain
    PyTorch ops.  ``etas_t`` (P, cells, loci) selects the dense prior,
    ``eta_idx``/``eta_w`` (cells, loci) the sparse one.  ``binary_P``
    (the number of states) marks ``pi_t`` as the (Kb, cells, loci)
    binary planes; None is the categorical (P, cells, loci) logits."""
    log_lamb, log1m_lamb, q = scal[0], scal[1], scal[2]
    x = reads
    bern = (torch.log1p(-phi), torch.log(phi))
    lp = _log_softmax_planes(_state_logits(pi_t, binary_P))
    P = len(lp)

    lp_acc = torch.zeros_like(x)
    for s in range(P):
        if etas_t is None:
            w = torch.where(eta_idx == float(s), eta_w,
                            torch.zeros_like(eta_w))
            lp_acc = lp_acc + w * lp[s]
        else:
            lp_acc = lp_acc + (etas_t[s] - 1.0) * lp[s]

    lgx1 = lgamma_ge1(x + 1.0)
    lse = _enum_lse(x, mu, lp, bern, lgx1, log1m_lamb, q)
    return lse + x * log_lamb - lgx1 + lp_acc, lse


def fused_bwd_plain(reads, mu, pi_t, phi, scal, lse, g, etas_t=None,
                    eta_idx=None, eta_w=None, binary_P=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dmu, dphi, dpi_t): the kernels' explicit backward as plain
    PyTorch ops (posterior weights against the saved ``lse``, the
    Dirichlet term's ``g * (etas - 1)`` and the softmax Jacobian; with
    ``binary_P``, dpi folded onto the Kb planes, (Kb, cells, loci))."""
    log1m_lamb, q = scal[1], scal[2]
    x = reads
    bern = (torch.log1p(-phi), torch.log(phi))
    dbern = (-1.0 / (1.0 - phi), 1.0 / phi)
    lp = _log_softmax_planes(_state_logits(pi_t, binary_P))
    P = len(lp)

    tot = torch.zeros_like(x)
    dlp = []
    for s in range(P):
        if etas_t is None:
            gew = g * eta_w
            dlp0 = torch.where(eta_idx == float(s), gew, torch.zeros_like(gew))
        else:
            dlp0 = g * (etas_t[s] - 1.0)
        dlp.append(dlp0)
        tot = tot + dlp0

    dmu, dphi, tot = _enum_sweep_bwd(x, mu, g, lse, lp, bern, dbern,
                                     lgamma_ge1(x + 1.0), log1m_lamb, q,
                                     dlp, tot)
    dpi = [dlp[s] - torch.exp(lp[s]) * tot for s in range(P)]
    if binary_P is None:
        return dmu, dphi, torch.stack(dpi)
    # chain through x_s = sum_{k in bits(s)} z_k, in ascending s
    dz = [torch.zeros_like(x) for _ in range(pi_t.shape[0])]
    for s, bits in enumerate(state_codes(P)):
        for k in bits:
            dz[k] = dz[k] + dpi[s]
    return dmu, dphi, torch.stack(dz)


def _states(log_pi: torch.Tensor) -> List[torch.Tensor]:
    return [log_pi[..., s] for s in range(log_pi.shape[-1])]


def enum_fwd_plain(reads, mu, log_pi, phi, scal) -> torch.Tensor:
    """(cells, loci) enumerated log-likelihood from the cells-major
    ``(cells, loci, P)`` log-simplex as given: the unfused kernel's
    forward as plain PyTorch ops (lse plus the hoisted
    ``x log(lamb) - lgamma(x + 1)``)."""
    log_lamb, log1m_lamb, q = scal[0], scal[1], scal[2]
    x = reads
    bern = (torch.log1p(-phi), torch.log(phi))
    lgx1 = lgamma_ge1(x + 1.0)
    lse = _enum_lse(x, mu, _states(log_pi), bern, lgx1, log1m_lamb, q)
    return lse + x * log_lamb - lgx1


def enum_bwd_plain(reads, mu, log_pi, phi, scal, ll, g
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dmu, dphi, dlog_pi): the unfused kernel's backward as plain
    PyTorch ops.  The posterior weights normalise against ``ll`` less
    the hoisted ``x log(lamb) - lgamma(x + 1)``; ``dlog_pi`` (cells,
    loci, P) is each state's weight sum (no softmax Jacobian: log_pi is
    the input)."""
    log_lamb, log1m_lamb, q = scal[0], scal[1], scal[2]
    x = reads
    lgx1 = lgamma_ge1(x + 1.0)
    ll_state = ll - (x * log_lamb - lgx1)
    bern = (torch.log1p(-phi), torch.log(phi))
    dbern = (-1.0 / (1.0 - phi), 1.0 / phi)
    dlp = [torch.zeros_like(x) for _ in range(log_pi.shape[-1])]
    dmu, dphi, _ = _enum_sweep_bwd(x, mu, g, ll_state, _states(log_pi),
                                   bern, dbern, lgx1, log1m_lamb, q, dlp)
    return dmu, dphi, torch.stack(dlp, dim=-1)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_bins(what, reads, mu, phi, scal, lse=None, g=None) -> None:
    if reads.ndim != 2 or any(t is not None and t.shape != reads.shape
                              for t in (mu, phi, lse, g)):
        raise ValueError(f"{what}: reads/mu/phi (and lse/g) must share one "
                         f"(cells, loci) shape; got {tuple(reads.shape)}, "
                         f"{tuple(mu.shape)}, {tuple(phi.shape)}")
    if scal.shape != (3,):
        raise ValueError(f"{what}: scal must be the (3,) tensor of "
                         f"scalars(lamb); got shape {tuple(scal.shape)}")


def _check_shapes(what, reads, mu, pi_t, phi, scal, etas_t, eta_idx, eta_w,
                  binary_P, lse=None, g=None):
    _check_bins(what, reads, mu, phi, scal, lse, g)
    if binary_P is not None:
        Kb = binary_code_width(binary_P)
        if pi_t.shape != (Kb,) + tuple(reads.shape):
            raise ValueError(
                f"{what} expects STATE-MAJOR binary logits of shape "
                f"(Kb={Kb},) + reads.shape = {(Kb,) + tuple(reads.shape)}; "
                f"got {tuple(pi_t.shape)} (Kb = ceil(log2 P) planes, see "
                "binary_code_width)")
        P = binary_P
    elif pi_t.ndim != 3 or pi_t.shape[1:] != reads.shape:
        raise ValueError(
            f"{what} expects STATE-MAJOR pi_logits_t of shape ('P',) + "
            f"{tuple(reads.shape)}; got {tuple(pi_t.shape)} (transpose "
            "cells-major tensors with layout.state_major)")
    else:
        P = pi_t.shape[0]
    if etas_t is not None:
        if etas_t.shape != (P,) + tuple(reads.shape):
            raise ValueError(f"{what} expects STATE-MAJOR etas_t of shape "
                             f"{(P,) + tuple(reads.shape)}; got "
                             f"{tuple(etas_t.shape)}")
    elif eta_idx is None or eta_w is None \
            or eta_idx.shape != reads.shape or eta_w.shape != reads.shape:
        raise ValueError(f"{what}: the sparse prior needs (cells, loci) "
                         "eta_idx and eta_w")
    if reads.device.type == "cuda" and P > MAX_P:
        raise ValueError(f"{what}: the kernel takes P <= {MAX_P}; got {P}")
    return P


def _kernel_key(kind: str, etas_t, binary_P, lanes=None) -> str:
    """The launch count's key: a launch with a lane axis (``lanes``, the
    serving slab's) counts apart from one fit's."""
    key = f"fused_{kind}_{'sparse' if etas_t is None else 'dense'}"
    key = key if binary_P is None else key + "_binary"
    return key if lanes is None else key + "_lanes"


def _lane(t: Optional[torch.Tensor], b: int) -> Optional[torch.Tensor]:
    return None if t is None else t[b]


def fused_fwd_plain_batched(reads, mu, pi_t, phi, scal, etas_t=None,
                            eta_idx=None, eta_w=None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse), each (W, cells, loci): :func:`fused_fwd_plain` of each
    lane of the (W, ...) operands (``scal`` (W, 3)), stacked."""
    outs = [fused_fwd_plain(reads[b], mu[b], pi_t[b], phi[b], scal[b],
                            _lane(etas_t, b), _lane(eta_idx, b),
                            _lane(eta_w, b)) for b in range(reads.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


def fused_bwd_plain_batched(reads, mu, pi_t, phi, scal, lse, g, etas_t=None,
                            eta_idx=None, eta_w=None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """(dmu, dphi, dpi_t) with a leading lane axis: :func:`fused_bwd_plain`
    of each lane, stacked."""
    outs = [fused_bwd_plain(reads[b], mu[b], pi_t[b], phi[b], scal[b],
                            lse[b], g[b], _lane(etas_t, b),
                            _lane(eta_idx, b), _lane(eta_w, b))
            for b in range(reads.shape[0])]
    return tuple(torch.stack([o[k] for o in outs]) for k in range(3))


def _lanes(what, reads, scal, binary_P, **lane_operands) -> Optional[int]:
    """W when ``scal`` is the (W, 3) stack of W fits' scalars (then every
    operand carries the lanes on its leading axis), None for one fit's
    (3,) scalars."""
    if scal.ndim != 2:
        return None
    if binary_P is not None:
        raise NotImplementedError(
            f"{what}: the batched (block-axis) form of the binary fused "
            "kernels is not ported (ROADMAP B1): no serving path reaches "
            "it, since enum_impl is not a requestable option")
    if reads.ndim != 3:
        raise ValueError(f"{what}: reads must be (W, cells, loci) with "
                         f"(W, 3) scalars; got {tuple(reads.shape)}")
    W = reads.shape[0]
    if scal.shape != (W, 3):
        raise ValueError(f"{what}: scal must be the (W, 3) stack of "
                         f"scalars(lamb); got {tuple(scal.shape)}")
    for key, t in lane_operands.items():
        if t is not None and (t.ndim < 1 or t.shape[0] != W):
            raise ValueError(f"{what}: {key} must carry the {W} lanes on "
                             f"its leading axis; got {tuple(t.shape)}")
    return W


def fused_fwd(reads, mu, pi_t, phi, scal, etas_t=None, eta_idx=None,
              eta_w=None, binary_P=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused forward ``(out, lse)``: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors.  ``binary_P``: see
    :func:`fused_fwd_plain`.  With ``scal`` (W, 3) every operand carries
    W stacked fits on its leading axis (the serving slab's block axis;
    categorical only) and one launch computes them all, each lane's
    outputs a one-fit launch's on its operands, bit for bit."""
    W = _lanes("fused_fwd", reads, scal, binary_P, mu=mu, pi_t=pi_t,
               phi=phi, etas_t=etas_t, eta_idx=eta_idx, eta_w=eta_w)
    one = (lambda t: t) if W is None else (lambda t: _lane(t, 0))
    P = _check_shapes("fused_fwd", one(reads), one(mu), one(pi_t), one(phi),
                      one(scal), one(etas_t), one(eta_idx), one(eta_w),
                      binary_P)
    _cuda.check_operands("fused_fwd", reads.device, reads=reads, mu=mu,
                         pi_t=pi_t, phi=phi, scal=scal, etas_t=etas_t,
                         eta_idx=eta_idx, eta_w=eta_w)
    if reads.device.type == "cpu":
        if W is not None:
            return fused_fwd_plain_batched(reads, mu, pi_t, phi, scal,
                                           etas_t, eta_idx, eta_w)
        return fused_fwd_plain(reads, mu, pi_t, phi, scal, etas_t, eta_idx,
                               eta_w, binary_P)
    lib = _cuda.library("enum_fused")
    out = torch.empty_like(reads)
    lse = torch.empty_like(reads)
    rc = lib.scrt_fused_fwd(
        _cuda.ptr(reads), _cuda.ptr(mu), _cuda.ptr(phi), _cuda.ptr(pi_t),
        _cuda.ptr(etas_t), _cuda.ptr(eta_idx), _cuda.ptr(eta_w),
        _cuda.ptr(scal), _cuda.ptr(out), _cuda.ptr(lse), one(reads).numel(),
        P, int(etas_t is None), int(binary_P is not None), W or 1,
        _cuda.stream_of(reads))
    _cuda.check(lib, rc, "fused_fwd")
    _cuda.count_launch(_kernel_key("fwd", etas_t, binary_P, W))
    return out, lse


def fused_bwd(reads, mu, pi_t, phi, scal, lse, g, etas_t=None, eta_idx=None,
              eta_w=None, binary_P=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused backward ``(dmu, dphi, dpi_t)``: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors.  ``binary_P``: see
    :func:`fused_bwd_plain`; a lane axis as :func:`fused_fwd`'s."""
    g = g.contiguous()
    W = _lanes("fused_bwd", reads, scal, binary_P, mu=mu, pi_t=pi_t,
               phi=phi, lse=lse, g=g, etas_t=etas_t, eta_idx=eta_idx,
               eta_w=eta_w)
    one = (lambda t: t) if W is None else (lambda t: _lane(t, 0))
    P = _check_shapes("fused_bwd", one(reads), one(mu), one(pi_t), one(phi),
                      one(scal), one(etas_t), one(eta_idx), one(eta_w),
                      binary_P, one(lse), one(g))
    _cuda.check_operands("fused_bwd", reads.device, reads=reads, mu=mu,
                         pi_t=pi_t, phi=phi, scal=scal, lse=lse, g=g,
                         etas_t=etas_t, eta_idx=eta_idx, eta_w=eta_w)
    if reads.device.type == "cpu":
        if W is not None:
            return fused_bwd_plain_batched(reads, mu, pi_t, phi, scal, lse,
                                           g, etas_t, eta_idx, eta_w)
        return fused_bwd_plain(reads, mu, pi_t, phi, scal, lse, g, etas_t,
                               eta_idx, eta_w, binary_P)
    lib = _cuda.library("enum_fused")
    dmu = torch.empty_like(reads)
    dphi = torch.empty_like(reads)
    dpi = torch.empty_like(pi_t)
    rc = lib.scrt_fused_bwd(
        _cuda.ptr(reads), _cuda.ptr(mu), _cuda.ptr(phi), _cuda.ptr(pi_t),
        _cuda.ptr(etas_t), _cuda.ptr(eta_idx), _cuda.ptr(eta_w),
        _cuda.ptr(scal), _cuda.ptr(lse), _cuda.ptr(g), _cuda.ptr(dmu),
        _cuda.ptr(dphi), _cuda.ptr(dpi), one(reads).numel(), P,
        int(etas_t is None), int(binary_P is not None), W or 1,
        _cuda.stream_of(reads))
    _cuda.check(lib, rc, "fused_bwd")
    _cuda.count_launch(_kernel_key("bwd", etas_t, binary_P, W))
    return dmu, dphi, dpi


def _check_unfused(what, reads, mu, log_pi, phi, scal, ll=None,
                   g=None) -> int:
    _check_bins(what, reads, mu, phi, scal, ll, g)
    if log_pi.ndim != 3 or log_pi.shape[:2] != reads.shape:
        raise ValueError(
            f"{what} expects CELLS-MAJOR log_pi of shape (cells, loci, P) = "
            f"{tuple(reads.shape) + ('P',)}; got {tuple(log_pi.shape)} "
            "(state-major input belongs to enum_loglik_fused)")
    P = log_pi.shape[-1]
    if reads.device.type == "cuda" and P > MAX_P:
        raise ValueError(f"{what}: the kernel takes P <= {MAX_P}; got {P}")
    return P


def enum_fwd(reads, mu, log_pi, phi, scal) -> torch.Tensor:
    """Unfused forward ``ll`` (cells, loci) from the cells-major
    log-simplex: the plain version for CPU tensors, the CUDA kernel for
    CUDA tensors."""
    P = _check_unfused("enum_fwd", reads, mu, log_pi, phi, scal)
    _cuda.check_operands("enum_fwd", reads.device, reads=reads, mu=mu,
                         log_pi=log_pi, phi=phi, scal=scal)
    if reads.device.type == "cpu":
        return enum_fwd_plain(reads, mu, log_pi, phi, scal)
    lib = _cuda.library("enum_fused")
    ll = torch.empty_like(reads)
    rc = lib.scrt_enum_fwd(
        _cuda.ptr(reads), _cuda.ptr(mu), _cuda.ptr(phi), _cuda.ptr(log_pi),
        _cuda.ptr(scal), _cuda.ptr(ll), reads.numel(), P,
        _cuda.stream_of(reads))
    _cuda.check(lib, rc, "enum_fwd")
    _cuda.count_launch("enum_fwd")
    return ll


def enum_bwd(reads, mu, log_pi, phi, scal, ll, g
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Unfused backward ``(dmu, dphi, dlog_pi)``, dlog_pi cells-major:
    the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors."""
    P = _check_unfused("enum_bwd", reads, mu, log_pi, phi, scal, ll, g)
    g = g.contiguous()
    _cuda.check_operands("enum_bwd", reads.device, reads=reads, mu=mu,
                         log_pi=log_pi, phi=phi, scal=scal, ll=ll, g=g)
    if reads.device.type == "cpu":
        return enum_bwd_plain(reads, mu, log_pi, phi, scal, ll, g)
    lib = _cuda.library("enum_fused")
    dmu = torch.empty_like(reads)
    dphi = torch.empty_like(reads)
    dlog_pi = torch.empty_like(log_pi)
    rc = lib.scrt_enum_bwd(
        _cuda.ptr(reads), _cuda.ptr(mu), _cuda.ptr(phi), _cuda.ptr(log_pi),
        _cuda.ptr(scal), _cuda.ptr(ll), _cuda.ptr(g), _cuda.ptr(dmu),
        _cuda.ptr(dphi), _cuda.ptr(dlog_pi), reads.numel(), P,
        _cuda.stream_of(reads))
    _cuda.check(lib, rc, "enum_bwd")
    # a launch with a full block stages that block's dlog_pi span
    _cuda.count_launch("enum_bwd_staged" if reads.numel() >= THREADS
                       else "enum_bwd_per_thread")
    return dmu, dphi, dlog_pi


def _zeros_if(needed: bool, t: Optional[torch.Tensor]):
    return torch.zeros_like(t) if needed and t is not None else None


def _lanes_first(info, in_dims, *operands):
    """The operands of a ``torch.func.vmap`` rule with the mapped axis
    moved to the front, contiguous; an operand that is not mapped (the
    same for every lane) is expanded over the ``info.batch_size`` lanes.
    None stays None."""
    out = []
    for t, d in zip(operands, in_dims):
        if t is None:
            out.append(None)
        elif d is None:
            out.append(t.unsqueeze(0).expand(
                (info.batch_size,) + tuple(t.shape)).contiguous())
        else:
            out.append(t.movedim(d, 0).contiguous())
    return out


class _FusedDense(torch.autograd.Function):
    """Dense-prior fused objective: ``(out, lse)``, lse not
    differentiable.  Cotangents for mu, the pi planes and phi; silent
    zeros for reads, etas_t and the lambda scalars.  Under
    ``torch.func.vmap`` (the serving slab's batched objective) the
    :meth:`vmap` rule applies it once to the W mapped fits stacked on a
    leading lane axis, one block-axis launch each way, as the Pallas
    call's batching rule does under ``jax.vmap``."""

    @staticmethod
    def forward(reads, mu, pi_t, phi, etas_t, scal, binary_P):
        return fused_fwd(reads, mu, pi_t, phi, scal, etas_t=etas_t,
                         binary_P=binary_P)

    @staticmethod
    def setup_context(ctx, inputs, output):
        reads, mu, pi_t, phi, etas_t, scal, binary_P = inputs
        ctx.save_for_backward(reads, mu, pi_t, phi, etas_t, scal, output[1])
        ctx.mark_non_differentiable(output[1])
        ctx.binary_P = binary_P

    @staticmethod
    def backward(ctx, g, _g_lse):
        reads, mu, pi_t, phi, etas_t, scal, lse = ctx.saved_tensors
        dmu, dphi, dpi = fused_bwd(reads, mu, pi_t, phi, scal, lse, g,
                                   etas_t=etas_t, binary_P=ctx.binary_P)
        need = ctx.needs_input_grad
        return (_zeros_if(need[0], reads), dmu, dpi, dphi,
                _zeros_if(need[4], etas_t), _zeros_if(need[5], scal), None)

    @staticmethod
    def vmap(info, in_dims, reads, mu, pi_t, phi, etas_t, scal, binary_P):
        ops = _lanes_first(info, in_dims[:6], reads, mu, pi_t, phi, etas_t,
                           scal)
        return _FusedDense.apply(*ops, binary_P), (0, 0)


class _FusedSparse(torch.autograd.Function):
    """Sparse-prior fused objective: ``(out, lse)``.  Cotangents for mu,
    the pi planes and phi; silent zeros for reads, eta_idx, eta_w and
    the lambda scalars; the :meth:`vmap` rule as :class:`_FusedDense`'s."""

    @staticmethod
    def forward(reads, mu, pi_t, phi, eta_idx, eta_w, scal, binary_P):
        return fused_fwd(reads, mu, pi_t, phi, scal, eta_idx=eta_idx,
                         eta_w=eta_w, binary_P=binary_P)

    @staticmethod
    def setup_context(ctx, inputs, output):
        reads, mu, pi_t, phi, eta_idx, eta_w, scal, binary_P = inputs
        ctx.save_for_backward(reads, mu, pi_t, phi, eta_idx, eta_w, scal,
                              output[1])
        ctx.mark_non_differentiable(output[1])
        ctx.binary_P = binary_P

    @staticmethod
    def backward(ctx, g, _g_lse):
        reads, mu, pi_t, phi, eta_idx, eta_w, scal, lse = ctx.saved_tensors
        dmu, dphi, dpi = fused_bwd(reads, mu, pi_t, phi, scal, lse, g,
                                   eta_idx=eta_idx, eta_w=eta_w,
                                   binary_P=ctx.binary_P)
        need = ctx.needs_input_grad
        return (_zeros_if(need[0], reads), dmu, dpi, dphi,
                _zeros_if(need[4], eta_idx), _zeros_if(need[5], eta_w),
                _zeros_if(need[6], scal), None)

    @staticmethod
    def vmap(info, in_dims, reads, mu, pi_t, phi, eta_idx, eta_w, scal,
             binary_P):
        ops = _lanes_first(info, in_dims[:7], reads, mu, pi_t, phi, eta_idx,
                           eta_w, scal)
        return _FusedSparse.apply(*ops, binary_P), (0, 0)


def enum_loglik_fused(reads, mu, pi_logits_t, phi, etas_t, lamb):
    """(cells, loci) fused objective with a dense prior;
    ``pi_logits_t``/``etas_t`` are STATE-MAJOR (P, cells, loci)."""
    return _FusedDense.apply(reads, mu, pi_logits_t, phi, etas_t,
                             scalars(lamb), None)[0]


def enum_loglik_fused_sparse(reads, mu, pi_logits_t, phi, eta_idx, eta_w,
                             lamb):
    """(cells, loci) fused objective with the one-hot prior encoding:
    ``eta_idx``/``eta_w`` are (cells, loci) float32, the index of each
    bin's non-unit state and its concentration minus one."""
    return _FusedSparse.apply(reads, mu, pi_logits_t, phi, eta_idx, eta_w,
                              scalars(lamb), None)[0]


def enum_loglik_fused_binary(reads, mu, zbin_t, phi, etas_t, lamb, P):
    """Fused objective with the independent-binary pi encoding and a
    dense prior: ``zbin_t`` is the (Kb, cells, loci) binary logit planes,
    ``etas_t`` (P, cells, loci); ``P`` is explicit because the parameter
    no longer carries it.  Cotangents for mu, zbin_t and phi."""
    return _FusedDense.apply(reads, mu, zbin_t, phi, etas_t, scalars(lamb),
                             int(P))[0]


def enum_loglik_fused_sparse_binary(reads, mu, zbin_t, phi, eta_idx, eta_w,
                                    lamb, P):
    """The binary encoding with the one-hot sparse prior: operands as
    :func:`enum_loglik_fused_sparse` with ``zbin_t`` the (Kb, cells,
    loci) binary planes and ``P`` explicit."""
    return _FusedSparse.apply(reads, mu, zbin_t, phi, eta_idx, eta_w,
                              scalars(lamb), int(P))[0]


class _EnumLoglik(torch.autograd.Function):
    """Unfused enumerated log-likelihood.  Cotangents for mu, log_pi and
    phi; silent zeros for reads and the lambda scalars."""

    @staticmethod
    def forward(ctx, reads, mu, log_pi, phi, scal):
        ll = enum_fwd(reads, mu, log_pi, phi, scal)
        ctx.save_for_backward(reads, mu, log_pi, phi, scal, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        reads, mu, log_pi, phi, scal, ll = ctx.saved_tensors
        dmu, dphi, dlog_pi = enum_bwd(reads, mu, log_pi, phi, scal, ll, g)
        need = ctx.needs_input_grad
        return (_zeros_if(need[0], reads), dmu, dlog_pi, dphi,
                _zeros_if(need[4], scal))


def enum_loglik(reads, mu, log_pi, phi, lamb):
    """(cells, loci) enumerated bin log-likelihood, states summed out.

    ``log_pi`` is the CELLS-MAJOR (cells, loci, P) log-simplex, which the
    kernels read as it lies; ``lamb`` a scalar.  Gradient contract (JAX
    ``enum_loglik``): cotangents for ``mu``, ``log_pi`` and ``phi``;
    ``reads`` and ``lamb`` get silent zeros."""
    return _EnumLoglik.apply(reads, mu, log_pi, phi, scalars(lamb))
