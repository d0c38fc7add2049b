"""Single-sweep Adam update: CUDA kernel and plain version.

Port of ``ops/adam_kernel.py``.  The math replicates optax's
``scale_by_adam`` + ``scale(-lr)`` term for term and in the same order
(moment EMA as ``(1-b) * g + b * m``, bias correction by division,
``eps`` outside the sqrt, update scaled by ``-lr`` then added), so the
trajectory tracks the JAX fits.  ``torch.optim.Adam`` factors the bias
correction differently and is not used.

The big (planes, cells, loci) pi parameter goes through
:func:`adam_update`: the CUDA kernel (``csrc/adam.cu``) for a CUDA
tensor, :func:`adam_update_plain` for a CPU tensor.  Every other leaf is
O(cells) or O(loci) and takes :func:`adam_update_plain` on any device,
as the JAX fit sends them through ``adam_update_xla``.  lr, the bias
corrections and the live gate ride in a (4,) device tensor
(:func:`adam_scalars`, from the per-fit :func:`adam_constants` and the
device step count), so no step needs a host value: ``live = 0`` (an
iteration after the fit stopped, launched before the host read the stop)
writes param, m and v through unchanged, bit for bit.  The pi parameter's moments may be stored in
bfloat16 (``optimizer_state_dtype='bfloat16'``): they are widened to
float32 for the arithmetic and the fresh ones narrowed back (round to
nearest even, as XLA's ``astype``), and the parameter update uses this
step's float32 moments.  Every other moment is float32.
"""

from __future__ import annotations

from typing import Tuple

import torch

from scdna_replication_tools_tpu_torch.ops import _cuda

ADAM_EPS = 1e-8

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def moment_torch_dtype(moment_dtype: str) -> torch.dtype:
    """torch dtype of the stored Adam moments ('float32'/'bfloat16')."""
    if moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"unknown optimizer_state_dtype {moment_dtype!r}; "
                         "expected 'float32' or 'bfloat16'")
    return _MOMENT_DTYPES[moment_dtype]


def adam_constants(lr: float, b1: float, b2: float, device
                   ) -> torch.Tensor:
    """(3,) float32 [lr, b1, b2] on ``device``, made once per fit (and
    again when the learning rate changes) by device fills: no host
    copy."""
    return torch.stack([torch.full((), float(x), dtype=torch.float32,
                                   device=device) for x in (lr, b1, b2)])


def adam_scalars(const: torch.Tensor, count: torch.Tensor,
                 live: torch.Tensor) -> torch.Tensor:
    """(4,) float32 [lr, 1 - b1^t, 1 - b2^t, live] on count's device:
    ``const`` from :func:`adam_constants`, ``count`` the step's
    INCREMENTED count t (optax's bias_correction), ``live`` 1 to apply
    the step and 0 to write every operand through unchanged."""
    c = count.to(torch.float32)
    bc1 = 1.0 - const[1] ** c
    bc2 = 1.0 - const[2] ** c
    return torch.stack([const[0], bc1, bc2, live.to(torch.float32)])


def adam_update_plain(param, grad, m, v, scal, b1: float, b2: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam sweep as plain PyTorch ops: ``(param', m', v')``, the
    moments returned in their stored dtype; with ``scal[3] == 0`` the
    inputs' values, bit for bit."""
    lr, bc1, bc2, live = scal[0], scal[1], scal[2], scal[3]
    g = grad
    m2 = (1.0 - b1) * g + b1 * m.to(torch.float32)
    v2 = (1.0 - b2) * (g * g) + b2 * v.to(torch.float32)
    update = (m2 / bc1) / (torch.sqrt(v2 / bc2) + ADAM_EPS)
    skip = live == 0.0
    return (torch.where(skip, param, param + (-lr) * update),
            torch.where(skip, m, m2.to(m.dtype)),
            torch.where(skip, v, v2.to(v.dtype)))


def adam_update(param, grad, m, v, scal, b1: float, b2: float,
                moment_dtype: str = "float32"
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Adam sweep of the pi parameter: the plain version for CPU tensors,
    the CUDA kernel for CUDA tensors (new output tensors either way).
    ``m``/``v`` are stored in ``moment_dtype``; everything else is
    float32."""
    mdt = moment_torch_dtype(moment_dtype)
    if not (param.shape == grad.shape == m.shape == v.shape):
        raise ValueError("adam_update: param/grad/m/v shapes differ: "
                         f"{tuple(param.shape)}, {tuple(grad.shape)}, "
                         f"{tuple(m.shape)}, {tuple(v.shape)}")
    if scal.shape != (4,):
        raise ValueError("adam_update: scal must be the (4,) [lr, bc1, bc2, "
                         f"live] tensor; got shape {tuple(scal.shape)}")
    grad = grad.contiguous()
    _cuda.check_operands("adam_update", param.device, {"m": mdt, "v": mdt},
                         param=param, grad=grad, m=m, v=v, scal=scal)
    if param.device.type == "cpu":
        return adam_update_plain(param, grad, m, v, scal, b1, b2)
    lib = _cuda.library("adam")
    p_out = torch.empty_like(param)
    m_out = torch.empty_like(m)
    v_out = torch.empty_like(v)
    rc = lib.scrt_adam(
        _cuda.ptr(p_out), _cuda.ptr(m_out), _cuda.ptr(v_out),
        _cuda.ptr(param), _cuda.ptr(grad), _cuda.ptr(m), _cuda.ptr(v),
        _cuda.ptr(scal), float(b1), 1.0 - b1, float(b2), 1.0 - b2,
        param.numel(), int(mdt == torch.bfloat16), _cuda.stream_of(param))
    _cuda.check(lib, rc, "adam_update")
    _cuda.LAUNCHES["adam_bf16" if mdt == torch.bfloat16 else "adam"] += 1
    return p_out, m_out, v_out
