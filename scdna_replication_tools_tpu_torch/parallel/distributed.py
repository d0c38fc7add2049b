"""Process groups and per-rank data (port of ``parallel/distributed.py``).

The JAX package runs a sharded fit as one SPMD program over every device
of every host.  Here a sharded fit is one process per rank of a
``torch.distributed`` group:

1. every rank calls :func:`init_distributed` once, with the backend it
   wants (NCCL with one GPU per rank; gloo where ranks share a card or
   run on the CPU), the rendezvous, the world size and its rank (or
   none of them under ``torchrun``, which sets them in the environment);
2. every rank builds the same ``scRT(num_shards=N, loci_shards=M)``
   from the full frames, as JAX's multi-process bridge loads the full
   batch on every host; the runner pads the cells to a multiple of the
   cell shards and each rank keeps its :class:`HostShard` (and, with
   ``loci_shards > 1``, its loci tile);
3. the fit sums the gradients of the replicated parameters across the
   ranks (``parallel.mesh.RankMesh``), and every rank ends with the same
   output frames.

A collective timeout is always set (:data:`DEFAULT_TIMEOUT_SECONDS`
unless the caller gives one), so a rank whose peer died ends its run
with an error in bounded time instead of hanging.  Without a group
everything here is the one-rank case: rank 0 of 1, no-op barriers.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from scdna_replication_tools_tpu_torch import layout

# the collective timeout of a group made here without one
DEFAULT_TIMEOUT_SECONDS = 600.0

_timeout: Optional[datetime.timedelta] = None


def init_distributed(backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     timeout: Optional[float] = None) -> int:
    """Initialise the default process group; returns the world size.

    ``backend`` is the caller's: ``'nccl'`` (one GPU per rank) or
    ``'gloo'`` (ranks sharing a card, or on the CPU); nothing chooses it
    for them.  ``init_method`` is the rendezvous (``'tcp://host:port'``,
    ``'file:///path'``, or None for ``torchrun``'s environment),
    ``timeout`` the collective timeout in seconds.  With no rendezvous,
    no world size above 1 and no ``WORLD_SIZE`` in the environment this
    is the one-process no-op (returns 1).  Idempotent: an initialised
    group is kept and its size returned.
    """
    global _timeout
    if dist.is_initialized():
        return dist.get_world_size()
    env_world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if init_method is None and (world_size or 1) <= 1 and env_world <= 1:
        return 1
    if backend is None:
        raise ValueError("init_distributed needs a backend: 'nccl' (one GPU "
                         "per rank) or 'gloo' (ranks sharing a card, or on "
                         "the CPU)")
    _timeout = datetime.timedelta(
        seconds=float(timeout if timeout is not None
                      else DEFAULT_TIMEOUT_SECONDS))
    kw = {}
    if world_size is not None:
        kw["world_size"] = int(world_size)
    if rank is not None:
        kw["rank"] = int(rank)
    dist.init_process_group(backend=backend,
                            init_method=init_method or "env://",
                            timeout=_timeout, **kw)
    return dist.get_world_size()


def collective_timeout() -> datetime.timedelta:
    """The default group's collective timeout (the subgroups take it
    too)."""
    return _timeout or datetime.timedelta(seconds=DEFAULT_TIMEOUT_SECONDS)


def process_rank_and_count() -> "tuple[int, int]":
    """``(rank, world size)`` of the default group, ``(0, 1)`` without
    one: the one probe that the manifest, the checkpoints, the fault
    scopes, the run log and the heartbeat share."""
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank()), int(dist.get_world_size())
    return 0, 1


def local_rank() -> int:
    """This process's rank among the ranks of its machine:
    ``LOCAL_RANK`` (``torchrun``), else the global rank."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return process_rank_and_count()[0]


def barrier(name: str) -> None:
    """Synchronisation point of every rank (no-op without a group).  The
    two-phase checkpoint commit stands on it: every rank writes its shard
    file before it, rank 0 commits the pointer after it.  ``name`` labels
    the rendezvous for a reader of the code; the group's timeout bounds
    it."""
    del name
    if process_rank_and_count()[1] > 1:
        dist.barrier()


def process_topology(mesh=None, device=None) -> dict:
    """JSON-able description of the run's topology (the checkpoint stamp's
    process and device half, JAX ``process_topology``'s keys): the rank
    and world size, the device count and kind of ``device`` (the CPU when
    None), and the mesh's axes (``parallel.mesh.mesh_topology``)."""
    from scdna_replication_tools_tpu_torch.parallel.mesh import mesh_topology

    rank, world = process_rank_and_count()
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        count = torch.cuda.device_count() * world
    else:
        kind, count = "cpu", world
    return {"process_count": int(world), "process_index": int(rank),
            "num_devices": int(count), "device_kind": str(kind),
            "mesh_axes": mesh_topology(mesh)}


@dataclasses.dataclass(frozen=True)
class HostShard:
    """This rank's slice ``lo:hi`` of the global cells axis: shard k of n
    owns ``k*(C/n) : (k+1)*(C/n)`` (pad the cells to a multiple of the
    cell shards first, ``data.loader.pad_cells``).  A view of
    ``RankMesh.cells_slice``, the rule the runner slices by."""

    num_global_cells: int
    lo: int
    hi: int

    @classmethod
    def for_this_process(cls, num_global_cells: int,
                         mesh=None) -> "HostShard":
        """The shard of this rank: its cells coordinate on ``mesh`` (the
        ranks of a row share one), or, without a mesh, its rank among
        the group's ranks (JAX's process index and count)."""
        if mesh is None:
            k, n = process_rank_and_count()
            mesh = _cells_mesh(n, k)
        s = mesh.cells_slice(num_global_cells)
        return cls(num_global_cells, s.start, s.stop)

    def mesh(self):
        """The one-axis grid of which this shard is a cells slice."""
        per = self.hi - self.lo
        return _cells_mesh(self.num_global_cells // per, self.lo // per)


def _cells_mesh(n: int, k: int):
    """Shard ``k`` of a grid of ``n`` cell shards and one loci shard (its
    slicing only; no collective runs on it)."""
    from scdna_replication_tools_tpu_torch.parallel.mesh import RankMesh

    return RankMesh(n, 1, k, [], [])


def slice_cells_axis(val, axis: int, shard: HostShard):
    """This shard's rows of one leaf along its cells axis (an array or a
    tensor)."""
    dims = ["cells" if i == axis else None for i in range(len(val.shape))]
    return shard.mesh().tile(val if torch.is_tensor(val)
                             else np.asarray(val), dims)


def slice_local_batch(batch, shard: HostShard):
    """This shard's cells rows of a full ``PertBatch`` (each field tiled
    by ``layout.batch_dims``, as the runner tiles its batch; per-locus
    fields kept)."""
    from scdna_replication_tools_tpu_torch.models.pert import PertBatch

    mesh = shard.mesh()
    return PertBatch(**{
        name: None if getattr(batch, name) is None
        else mesh.tile(getattr(batch, name), layout.batch_dims(name))
        for name in PertBatch.FIELDS})


def slice_local_params(params: dict, shard: HostShard) -> dict:
    """This shard's cells rows of a full parameter dict (each leaf tiled
    by ``layout.param_dims``, as the runner places its parameters; the
    globals passed through)."""
    mesh = shard.mesh()
    return {name: None if val is None
            else mesh.tile(val, layout.param_dims(name))
            for name, val in params.items()}
