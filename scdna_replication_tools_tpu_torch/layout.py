"""The tensor-layout convention (port of ``layout.py``).

``pi_logits`` is state-major ``(P, cells, loci)`` from ``init_params``
through the optimizer and the fused kernels, so each state plane is read
coalesced along loci.  ``etas`` sits cells-major ``(cells, loci, P)`` in
``PertBatch`` and is transposed once per fit; ``log_pi`` for the decode
is cells-major.

:func:`param_layouts` is the JAX module's per-parameter layout record
for one device (no mesh), as a table: the checkpoint topology stamp
carries it, so a JAX resume of a file this package wrote reads the same
layouts it stamps itself.  The mesh specs behind it come with multi-GPU
runs (ROADMAP A12).
"""

from __future__ import annotations

import copy
from typing import Optional

import torch


def state_major(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(cells, loci, P) -> (P, cells, loci), contiguous."""
    return None if x is None else x.permute(2, 0, 1).contiguous()


def cells_major(x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """(P, cells, loci) -> (cells, loci, P), contiguous."""
    return None if x is None else x.permute(1, 2, 0).contiguous()


# parameter name -> (PartitionSpec as JSON with no loci axis, symbolic
# dims, index of the cells axis): JAX layout.param_specs(None) and
# layout._PARAM_DIMS
_PARAM_LAYOUTS = {
    "a_raw": ([], [], None),
    "lamb_raw": ([], [], None),
    "beta_means": ([], ["L", "K1"], None),
    "beta_stds_raw": ([], ["L", "K1"], None),
    "rho_raw": ([None], ["loci"], None),
    "tau_raw": (["cells"], ["cells"], 0),
    "u": (["cells"], ["cells"], 0),
    "betas": (["cells", None], ["cells", "K1"], 0),
    "pi_logits": ([None, "cells", None], ["P", "cells", "loci"], 1),
    "pi_bin_logits": ([None, "cells", None], ["Kb", "cells", "loci"], 1),
}


def param_layouts() -> dict:
    """``name -> {"spec", "dims", "cells_axis"}`` of every parameter on
    one device: JAX ``layout.param_layouts(None)``."""
    return {name: {"spec": copy.copy(spec), "dims": list(dims),
                   "cells_axis": axis}
            for name, (spec, dims, axis) in _PARAM_LAYOUTS.items()}
