"""Carry fit state across from the JAX package.

The JAX package's parameter pytrees, optax Adam state and conditioning
dicts, fetched to NumPy (``numpy.asarray`` on each leaf), become the
port's tensors here: same keys, the same state-major (P, cells, loci)
pi layout, float32 (bfloat16 Adam moments stay bfloat16).  The tests use
these to start both packages from the same point.  Nothing here imports
JAX: the inputs are duck-typed.
"""

from __future__ import annotations

import numpy as np
import torch

from scdna_replication_tools_tpu_torch.infer.svi import AdamState


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def params_from_jax(params: dict, device) -> dict:
    """``{name: array}`` -> ``{name: float32 tensor on device}``."""
    return {k: _f32(v, device) for k, v in params.items()}


def _moment(x, device) -> torch.Tensor:
    """An Adam moment leaf: float32, or bfloat16 where the JAX state
    stores it so (a NumPy array of the JAX package's bfloat16 dtype,
    which widens to float32 and narrows back exactly)."""
    t = _f32(x, device)
    if np.asarray(x).dtype.name == "bfloat16":
        return t.to(torch.bfloat16)
    return t


def opt_state_from_jax(opt_state, device) -> AdamState:
    """An optax ``adam`` state — the ``(ScaleByAdamState(count, mu, nu),
    EmptyState())`` tuple, or anything with ``count``/``mu``/``nu``
    attributes — as the port's :class:`AdamState`."""
    # the chain's state is a plain tuple whose first entry is the
    # ScaleByAdamState named tuple
    inner = opt_state[0] if type(opt_state) is tuple else opt_state
    return AdamState(
        count=torch.as_tensor(np.array(inner.count, dtype=np.int32),
                              device=device),
        mu={k: _moment(v, device) for k, v in dict(inner.mu).items()},
        nu={k: _moment(v, device) for k, v in dict(inner.nu).items()})


def fixed_from_jax(fixed: dict, device) -> dict:
    """The conditioning dict (beta_means, lamb, rho, a) as tensors."""
    return params_from_jax(fixed, device)
