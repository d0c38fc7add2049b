"""The tensor-layout convention (port of ``layout.py:41-50``).

``pi_logits`` is state-major ``(P, cells, loci)`` from ``init_params``
through the optimizer and the fused kernels, so each state plane is read
coalesced along loci.  ``etas`` sits cells-major ``(cells, loci, P)`` in
``PertBatch`` and is transposed once per fit; ``log_pi`` for the decode
is cells-major.  The mesh specs of the JAX module are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch


def state_major(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(cells, loci, P) -> (P, cells, loci), contiguous."""
    return None if x is None else x.permute(2, 0, 1).contiguous()


def cells_major(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(P, cells, loci) -> (cells, loci, P), contiguous."""
    return None if x is None else x.permute(1, 2, 0).contiguous()
