"""Fused enumerated PERT bin objective: CUDA kernels and plain versions.

Port of the fused entry points of ``ops/enum_kernel.py``
(``enum_loglik_fused`` and ``enum_loglik_fused_sparse``).  Per
(cell, locus) bin the objective is

    logsumexp_{s, r} (lp_s + log Bern(r | phi) + nb(chi = s (1 + r)))
      + x log(lamb) - lgamma(x + 1) + sum_s (etas_s - 1) lp_s

with ``lp = log_softmax(pi_logits)`` over the P states (sparse prior:
the data term is ``eta_w * lp_{eta_idx}``).  The CUDA kernels
(``csrc/enum_fused.cu``) read the state-major ``(P, cells, loci)``
logits once, keep the per-state terms in registers and never
materialise the ``(cells, loci, P, 2)`` enumeration tensor; the backward
recomputes from the inputs and the saved enumeration-only logsumexp.

Beside them sit the plain PyTorch versions, :func:`fused_fwd_plain` and
the explicit :func:`fused_bwd_plain`, which repeat the kernels'
arithmetic operation for operation (same Stirling series, same chi
order).  :func:`fused_fwd` / :func:`fused_bwd` take the plain version
for a CPU tensor and launch the kernel for a CUDA tensor; there is no
fallback between the two.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from scdna_replication_tools_tpu_torch.ops import _cuda

MAX_P = 16  # the kernels' register arrays (csrc/enum_fused.cu MAXP)

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
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _log_softmax_planes(pi_t: torch.Tensor) -> List[torch.Tensor]:
    """Per-state log-softmax planes, max-then-sum like the kernels."""
    P = pi_t.shape[0]
    m = pi_t[0]
    for s in range(1, P):
        m = torch.maximum(m, pi_t[s])
    z = torch.zeros_like(m)
    for s in range(P):
        z = z + torch.exp(pi_t[s] - m)
    log_z = m + torch.log(z)
    return [pi_t[s] - log_z for s in range(P)]


def _nb_core(x, mu, chi, q, log1m_lamb):
    delta = torch.clamp(mu * (chi * q), min=1.0)
    return lgamma_ge1(x + delta) - lgamma_ge1(delta) + delta * log1m_lamb


def fused_fwd_plain(reads, mu, pi_t, phi, scal, etas_t=None, eta_idx=None,
                    eta_w=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse), each (cells, loci): the kernels' forward as plain
    PyTorch ops.  ``etas_t`` (P, cells, loci) selects the dense prior,
    ``eta_idx``/``eta_w`` (cells, loci) the sparse one."""
    P = pi_t.shape[0]
    log_lamb, log1m_lamb, q = scal[0], scal[1], scal[2]
    x = reads
    bern = (torch.log1p(-phi), torch.log(phi))
    lp = _log_softmax_planes(pi_t)

    lp_acc = torch.zeros_like(x)
    for s in range(P):
        if etas_t is None:
            w = torch.where(eta_idx == float(s), eta_w,
                            torch.zeros_like(eta_w))
            lp_acc = lp_acc + w * lp[s]
        else:
            lp_acc = lp_acc + (etas_t[s] - 1.0) * lp[s]

    lgx1 = lgamma_ge1(x + 1.0)
    slots = chi_slots(P)
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
    lse = m + torch.log(acc)
    return lse + x * log_lamb - lgx1 + lp_acc, lse


def fused_bwd_plain(reads, mu, pi_t, phi, scal, lse, g, etas_t=None,
                    eta_idx=None, eta_w=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dmu, dphi, dpi_t): the kernels' explicit backward as plain
    PyTorch ops (posterior weights against the saved ``lse``, the
    Dirichlet term's ``g * (etas - 1)`` and the softmax Jacobian)."""
    P = pi_t.shape[0]
    log1m_lamb, q = scal[1], scal[2]
    x = reads
    bern = (torch.log1p(-phi), torch.log(phi))
    dbern = (-1.0 / (1.0 - phi), 1.0 / phi)
    lp = _log_softmax_planes(pi_t)

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

    dmu = torch.zeros_like(x)
    dphi = torch.zeros_like(x)
    for chi, pairs in chi_slots(P):
        if chi == 0.0:
            nb = lgamma_ge1(x + 1.0) + log1m_lamb
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
            tot = tot + gw
    dpi = torch.stack([dlp[s] - torch.exp(lp[s]) * tot for s in range(P)])
    return dmu, dphi, dpi


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _check_shapes(what, reads, mu, pi_t, phi, scal, etas_t, eta_idx, eta_w,
                  lse=None, g=None):
    if reads.ndim != 2 or any(t is not None and t.shape != reads.shape
                              for t in (mu, phi, lse, g)):
        raise ValueError(f"{what}: reads/mu/phi (and lse/g) must share one "
                         f"(cells, loci) shape; got {tuple(reads.shape)}, "
                         f"{tuple(mu.shape)}, {tuple(phi.shape)}")
    if scal.shape != (3,):
        raise ValueError(f"{what}: scal must be the (3,) tensor of "
                         f"scalars(lamb); got shape {tuple(scal.shape)}")
    if pi_t.ndim != 3 or pi_t.shape[1:] != reads.shape:
        raise ValueError(
            f"{what} expects STATE-MAJOR pi_logits_t of shape ('P',) + "
            f"{tuple(reads.shape)}; got {tuple(pi_t.shape)} (transpose "
            "cells-major tensors with layout.state_major)")
    if etas_t is not None:
        if etas_t.shape != pi_t.shape:
            raise ValueError(f"{what} expects STATE-MAJOR etas_t of shape "
                             f"{tuple(pi_t.shape)}; got {tuple(etas_t.shape)}")
    elif eta_idx is None or eta_w is None \
            or eta_idx.shape != reads.shape or eta_w.shape != reads.shape:
        raise ValueError(f"{what}: the sparse prior needs (cells, loci) "
                         "eta_idx and eta_w")


def _kernel_key(kind: str, etas_t) -> str:
    return f"fused_{kind}_{'sparse' if etas_t is None else 'dense'}"


def fused_fwd(reads, mu, pi_t, phi, scal, etas_t=None, eta_idx=None,
              eta_w=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused forward ``(out, lse)``: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors."""
    _check_shapes("fused_fwd", reads, mu, pi_t, phi, scal, etas_t, eta_idx,
                  eta_w)
    _cuda.check_operands("fused_fwd", reads.device, reads=reads, mu=mu,
                         pi_t=pi_t, phi=phi, scal=scal, etas_t=etas_t,
                         eta_idx=eta_idx, eta_w=eta_w)
    if reads.device.type == "cpu":
        return fused_fwd_plain(reads, mu, pi_t, phi, scal, etas_t, eta_idx,
                               eta_w)
    P = pi_t.shape[0]
    if P > MAX_P:
        raise ValueError(f"fused_fwd: the kernel takes P <= {MAX_P}; got {P}")
    lib = _cuda.library("enum_fused")
    out = torch.empty_like(reads)
    lse = torch.empty_like(reads)
    rc = lib.scrt_fused_fwd(
        _cuda.ptr(reads), _cuda.ptr(mu), _cuda.ptr(phi), _cuda.ptr(pi_t),
        _cuda.ptr(etas_t), _cuda.ptr(eta_idx), _cuda.ptr(eta_w),
        _cuda.ptr(scal), _cuda.ptr(out), _cuda.ptr(lse), reads.numel(), P,
        int(etas_t is None), _cuda.stream_of(reads))
    _cuda.check(lib, rc, "fused_fwd")
    _cuda.LAUNCHES[_kernel_key("fwd", etas_t)] += 1
    return out, lse


def fused_bwd(reads, mu, pi_t, phi, scal, lse, g, etas_t=None, eta_idx=None,
              eta_w=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused backward ``(dmu, dphi, dpi_t)``: the plain version for CPU
    tensors, the CUDA kernel for CUDA tensors."""
    _check_shapes("fused_bwd", reads, mu, pi_t, phi, scal, etas_t, eta_idx,
                  eta_w, lse, g)
    g = g.contiguous()
    _cuda.check_operands("fused_bwd", reads.device, reads=reads, mu=mu,
                         pi_t=pi_t, phi=phi, scal=scal, lse=lse, g=g,
                         etas_t=etas_t, eta_idx=eta_idx, eta_w=eta_w)
    if reads.device.type == "cpu":
        return fused_bwd_plain(reads, mu, pi_t, phi, scal, lse, g, etas_t,
                               eta_idx, eta_w)
    P = pi_t.shape[0]
    if P > MAX_P:
        raise ValueError(f"fused_bwd: the kernel takes P <= {MAX_P}; got {P}")
    lib = _cuda.library("enum_fused")
    dmu = torch.empty_like(reads)
    dphi = torch.empty_like(reads)
    dpi = torch.empty_like(pi_t)
    rc = lib.scrt_fused_bwd(
        _cuda.ptr(reads), _cuda.ptr(mu), _cuda.ptr(phi), _cuda.ptr(pi_t),
        _cuda.ptr(etas_t), _cuda.ptr(eta_idx), _cuda.ptr(eta_w),
        _cuda.ptr(scal), _cuda.ptr(lse), _cuda.ptr(g), _cuda.ptr(dmu),
        _cuda.ptr(dphi), _cuda.ptr(dpi), reads.numel(), P,
        int(etas_t is None), _cuda.stream_of(reads))
    _cuda.check(lib, rc, "fused_bwd")
    _cuda.LAUNCHES[_kernel_key("bwd", etas_t)] += 1
    return dmu, dphi, dpi


def _zeros_if(needed: bool, t: Optional[torch.Tensor]):
    return torch.zeros_like(t) if needed and t is not None else None


class _FusedDense(torch.autograd.Function):
    """Dense-prior fused objective.  Cotangents for mu, pi_logits_t and
    phi; silent zeros for reads, etas_t and the lambda scalars."""

    @staticmethod
    def forward(ctx, reads, mu, pi_t, phi, etas_t, scal):
        out, lse = fused_fwd(reads, mu, pi_t, phi, scal, etas_t=etas_t)
        ctx.save_for_backward(reads, mu, pi_t, phi, etas_t, scal, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        reads, mu, pi_t, phi, etas_t, scal, lse = ctx.saved_tensors
        dmu, dphi, dpi = fused_bwd(reads, mu, pi_t, phi, scal, lse, g,
                                   etas_t=etas_t)
        need = ctx.needs_input_grad
        return (_zeros_if(need[0], reads), dmu, dpi, dphi,
                _zeros_if(need[4], etas_t), _zeros_if(need[5], scal))


class _FusedSparse(torch.autograd.Function):
    """Sparse-prior fused objective.  Cotangents for mu, pi_logits_t and
    phi; silent zeros for reads, eta_idx, eta_w and the lambda scalars."""

    @staticmethod
    def forward(ctx, reads, mu, pi_t, phi, eta_idx, eta_w, scal):
        out, lse = fused_fwd(reads, mu, pi_t, phi, scal, eta_idx=eta_idx,
                             eta_w=eta_w)
        ctx.save_for_backward(reads, mu, pi_t, phi, eta_idx, eta_w, scal, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        reads, mu, pi_t, phi, eta_idx, eta_w, scal, lse = ctx.saved_tensors
        dmu, dphi, dpi = fused_bwd(reads, mu, pi_t, phi, scal, lse, g,
                                   eta_idx=eta_idx, eta_w=eta_w)
        need = ctx.needs_input_grad
        return (_zeros_if(need[0], reads), dmu, dpi, dphi,
                _zeros_if(need[4], eta_idx), _zeros_if(need[5], eta_w),
                _zeros_if(need[6], scal))


def enum_loglik_fused(reads, mu, pi_logits_t, phi, etas_t, lamb):
    """(cells, loci) fused objective with a dense prior;
    ``pi_logits_t``/``etas_t`` are STATE-MAJOR (P, cells, loci)."""
    return _FusedDense.apply(reads, mu, pi_logits_t, phi, etas_t,
                             scalars(lamb))


def enum_loglik_fused_sparse(reads, mu, pi_logits_t, phi, eta_idx, eta_w,
                             lamb):
    """(cells, loci) fused objective with the one-hot prior encoding:
    ``eta_idx``/``eta_w`` are (cells, loci) float32, the index of each
    bin's non-unit state and its concentration minus one."""
    return _FusedSparse.apply(reads, mu, pi_logits_t, phi, eta_idx, eta_w,
                              scalars(lamb))
