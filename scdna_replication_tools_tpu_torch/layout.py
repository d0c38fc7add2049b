"""The tensor-layout convention (port of ``layout.py``).

``pi_logits`` is state-major ``(P, cells, loci)`` from ``init_params``
through the optimizer and the fused kernels, so each state plane is read
coalesced along loci.  ``etas`` sits cells-major ``(cells, loci, P)`` in
``PertBatch`` and is transposed once per fit; ``log_pi`` for the decode
is cells-major.

:func:`param_layouts` is the JAX module's per-parameter layout record:
the checkpoint topology stamp carries it, so a JAX resume of a file this
package wrote reads the same layouts it stamps itself.  The symbolic
dims of every batch field and parameter (``_BATCH_DIMS``,
``_PARAM_DIMS``) are also the sharding rules of a multi-rank fit
(``parallel/mesh.py``): the ``cells`` and ``loci`` axes are split over
the rank grid, every other axis stays whole.
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


CELLS_AXIS = "cells"
LOCI_AXIS = "loci"

# symbolic dims of every PertBatch field and parameter (JAX
# layout._BATCH_DIMS / _PARAM_DIMS): "cells" and "loci" are the axes a
# sharded fit splits, the others ("P", "Kb" states or planes, "K1" GC
# features, "L" libraries) stay whole on every rank
_BATCH_DIMS = {
    "reads": ("cells", "loci"),
    "libs": ("cells",),
    "gamma_feats": ("loci", "K1"),
    "mask": ("cells",),
    "etas": ("cells", "loci", "P"),
    "eta_idx": ("cells", "loci"),
    "eta_w": ("cells", "loci"),
    "cn_obs": ("cells", "loci"),
    "rep_obs": ("cells", "loci"),
    "t_alpha": ("cells",),
    "t_beta": ("cells",),
    "loci_mask": ("loci",),
}

_PARAM_DIMS = {
    "a_raw": (),
    "lamb_raw": (),
    "beta_means": ("L", "K1"),
    "beta_stds_raw": ("L", "K1"),
    "rho_raw": ("loci",),
    "tau_raw": ("cells",),
    "u": ("cells",),
    "betas": ("cells", "K1"),
    "pi_logits": ("P", "cells", "loci"),
    "pi_bin_logits": ("Kb", "cells", "loci"),
}


def param_dims(name: str) -> tuple:
    """Symbolic dims of parameter ``name``; ``()`` (replicated) for a
    name the table does not know, as JAX's checkpoint layer treats
    ad-hoc pytrees."""
    return _PARAM_DIMS.get(name, ())


def batch_dims(name: str) -> tuple:
    """Symbolic dims of ``PertBatch`` field ``name``."""
    return _BATCH_DIMS.get(name, ())


def param_cells_axis(name: str) -> Optional[int]:
    """Index of the cells axis of parameter ``name``, or None for a
    global (replicated) one: JAX ``layout.param_cells_axis``."""
    dims = param_dims(name)
    return dims.index(CELLS_AXIS) if CELLS_AXIS in dims else None


def batch_cells_axis(name: str) -> Optional[int]:
    """Index of the cells axis of ``PertBatch`` field ``name``, or None
    for a per-locus or global one: JAX ``layout.batch_cells_axis``."""
    dims = batch_dims(name)
    return dims.index(CELLS_AXIS) if CELLS_AXIS in dims else None


def param_specs(lx: Optional[str] = None) -> dict:
    """Parameter name -> its PartitionSpec as JSON (JAX
    ``spec_to_json(layout.param_specs(lx)[name])``): per-cell leaves on
    'cells', per-locus ones on ``lx`` (None: the loci axis is not
    sharded), globals replicated."""
    def spec(dims):
        if not dims:
            return []
        return [CELLS_AXIS if d == CELLS_AXIS else lx if d == LOCI_AXIS
                else None for d in dims]
    out = {name: spec(dims) for name, dims in _PARAM_DIMS.items()}
    # JAX's specs name the leading axes only: the trailing replicated
    # axis of the (L, K1) globals is left out
    out["beta_means"] = out["beta_stds_raw"] = []
    return out


def param_layouts(lx: Optional[str] = None) -> dict:
    """``name -> {"spec", "dims", "cells_axis"}`` of every parameter:
    JAX ``layout.param_layouts(lx)`` (``lx`` 'loci' on a mesh that shards
    the loci axis, None otherwise)."""
    specs = param_specs(lx)
    return {name: {"spec": copy.copy(specs[name]), "dims": list(dims),
                   "cells_axis": param_cells_axis(name)}
            for name, dims in _PARAM_DIMS.items()}
