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

The elastic rung (``infer/runner.py``, JAX's ``elastic_mesh``) re-forms
the group over the ranks that survived a loss, in the same run:

* every failing rank leaves the broken group (:func:`abandon_group`:
  its sockets close, so a peer still inside a collective fails at once
  instead of at the timeout) and meets the others at a numbered
  generation of a :class:`Rendezvous`, a ``FileStore`` under the run's
  checkpoint directory, which every rank of a sharded durable run
  shares: no rank's process holds it, so losing any rank, rank 0 and a
  ``tcp://`` master on it included, leaves it reachable;
* a rank that knows it is lost (it raised the loss itself, is being
  preempted, or failed in a way the rung does not take) marks itself
  so, and the meeting closes once every rank of the old group arrived
  or is marked.  A rank that fails declares itself alive before its
  emergency save, and is waited for until it arrives or marks itself;
  a rank that did neither (killed outright) is waited for
  :data:`RENDEZVOUS_SETTLE_SECONDS` after the last arrival.  The whole
  wait is bounded by the collective timeout.  The first survivor to
  close writes the roster, and every survivor reads that one roster; a
  rank that arrives after the close is refused
  (:class:`RendezvousClosed`);
* :func:`reform_group` makes the new default group of the first
  ``grid`` survivors in their old rank order (gloo or NCCL, the old
  group's backend, on the same device); survivors beyond the smaller
  grid hold no block and wait on a :class:`StandbyChannel` (a gloo
  group of every survivor beside the default one) for the frames that
  the new rank 0 sends when the run ends.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import pickle
import time
import uuid
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from scdna_replication_tools_tpu_torch import layout

# the collective timeout of a group made here without one
DEFAULT_TIMEOUT_SECONDS = 600.0
# how long a rendezvous of the elastic rung waits, after the last
# survivor arrived, for a rank that neither declared itself alive,
# arrived, nor was marked lost: a survivor declares itself as soon as its
# fit fails, and a peer's fit fails at its next collective once the
# failing ranks left the group (within one iteration of the fit)
RENDEZVOUS_SETTLE_SECONDS = 10.0
# a standby rank's wait for the frames of the smaller grid: the rest of
# the run, however long; a lost sender closes its socket at once
STANDBY_TIMEOUT = datetime.timedelta(days=7)

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


# ---------------------------------------------------------------------------
# the elastic rung: leaving a broken group, meeting, re-forming
# ---------------------------------------------------------------------------

def common_token(host_group=None) -> str:
    """A token every rank of the group shares (rank 0's, broadcast over
    ``host_group``, a gloo group beside an NCCL world): the name of the
    run's :class:`Rendezvous`, so that survivors of another run in the
    same checkpoint directory never meet this run's."""
    box = [uuid.uuid4().hex if process_rank_and_count()[0] == 0 else None]
    if process_rank_and_count()[1] > 1:
        dist.broadcast_object_list(box, src=0, group=host_group)
    return str(box[0])


def abandon_group() -> None:
    """Leave the default group and its subgroups (no-op without one).  A
    gloo group's sockets close only when its last reference goes: the
    caller drops its own (the ``RankMesh``, an exception's frames)
    first, and the collection here frees the groups, so that a peer
    blocked in a collective with this rank fails at once."""
    import gc

    if dist.is_available() and dist.is_initialized():
        try:
            dist.destroy_process_group()
        except Exception:  # noqa: BLE001 - a group broken by a lost
            # peer may fail to shut down cleanly; it is left either way
            pass
    gc.collect()


class RendezvousClosed(RuntimeError):
    """The elastic rung's meeting closed before this rank arrived: the
    survivors went on without it."""


class Rendezvous:
    """The meeting point of the elastic rung: a ``FileStore`` at
    ``<directory>/<token>.store``, created at first use, whose keys are
    scoped by generation (``g<n>/``).  See the module docstring."""

    def __init__(self, directory: str, token: str):
        self.path = os.path.join(directory, f"{token}.store")
        self._store = None

    @property
    def store(self):
        if self._store is None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            self._store = dist.FileStore(self.path, -1)
        return self._store

    def mark_lost(self, gen: int, rank: int, reason: str) -> None:
        """Record that ``rank`` leaves the run at generation ``gen``, so
        that the survivors need not wait for it."""
        self.store.set(f"g{gen}/lost/{rank}", reason[:200])
        self.store.add(f"g{gen}/lost", 1)

    def declare_alive(self, gen: int, rank: int) -> None:
        """Record that ``rank`` lives and will arrive at generation
        ``gen`` (or mark itself lost), however long it takes."""
        self.store.set(f"g{gen}/alive/{rank}", "1")

    def _awaited(self, p: str, world: int) -> list:
        """Ranks declared alive that neither arrived nor are lost."""
        s = self.store
        return [r for r in range(world)
                if s.check([f"{p}alive/{r}"])
                and not s.check([f"{p}kind/{r}"])
                and not s.check([f"{p}lost/{r}"])]

    def meet(self, gen: int, rank: int, world: int, kind: str,
             timeout: float, settle: Optional[float] = None) -> dict:
        """Arrive at generation ``gen`` as ``rank`` of the old group of
        ``world`` ranks, with the failure class ``kind`` this rank saw;
        returns the roster ``{rank: kind}`` of the survivors, the same
        on every survivor.  ``settle`` defaults to
        :data:`RENDEZVOUS_SETTLE_SECONDS`.  Raises
        :class:`RendezvousClosed` when the meeting closed before this rank
        arrived."""
        if settle is None:
            settle = RENDEZVOUS_SETTLE_SECONDS
        s, p = self.store, f"g{gen}/"
        s.set(f"{p}kind/{rank}", kind)
        s.add(f"{p}arrived", 1)
        t0 = last = polled = time.monotonic()
        seen = 0
        while not s.check([f"{p}roster"]):
            arrived, lost = s.add(f"{p}arrived", 0), s.add(f"{p}lost", 0)
            now = time.monotonic()
            if arrived != seen:
                seen, last = arrived, now
            settled = now - last >= settle and now - polled >= 0.25
            if settled:
                polled = now
            if arrived + lost >= world or now - t0 >= timeout \
                    or settled and not self._awaited(p, world):
                members = {r: s.get(f"{p}kind/{r}").decode()
                           for r in range(world)
                           if s.check([f"{p}kind/{r}"])}
                s.compare_set(f"{p}roster", "", json.dumps(members))
                break
            time.sleep(0.02)
        roster = {int(k): v for k, v in
                  json.loads(s.get(f"{p}roster")).items()}
        if rank not in roster:
            raise RendezvousClosed(
                f"elastic rendezvous generation {gen} closed before rank "
                f"{rank} arrived (roster {sorted(roster)}); this rank "
                "leaves the run")
        return roster


class StandbyChannel:
    """The survivors of a rung beyond the smaller grid (see the module
    docstring): a gloo group of every survivor, ranks in roster order,
    on which the new rank 0 sends one pickled result to each standby
    rank.  ``waiting`` says this rank is one of them."""

    def __init__(self, group, rank: int, grid_size: int, size: int):
        self.group = group
        self.rank = int(rank)
        self.grid_size = int(grid_size)
        self.size = int(size)

    @property
    def waiting(self) -> bool:
        return self.rank >= self.grid_size

    def send(self, obj) -> None:
        """Rank 0 of the grid: ``obj`` to every standby rank (no-op on
        the grid's other ranks)."""
        if self.rank != 0:
            return
        data = torch.frombuffer(bytearray(pickle.dumps(obj)),
                                dtype=torch.uint8)
        size = torch.tensor([data.numel()], dtype=torch.int64)
        for dst in range(self.grid_size, self.size):
            self.group.send([size], dst, 0).wait()
            self.group.send([data], dst, 1).wait()

    def receive(self):
        """A standby rank: the object rank 0 sends (waits for it)."""
        size = torch.zeros(1, dtype=torch.int64)
        self.group.recv([size], 0, 0).wait()
        data = torch.empty(int(size[0]), dtype=torch.uint8)
        self.group.recv([data], 0, 1).wait()
        return pickle.loads(data.numpy().tobytes())


def reform_group(rdzv: Rendezvous, gen: int, survivors: list, rank: int,
                 grid_size: int, backend: str):
    """Re-form the default group over ``survivors`` (old ranks, sorted)
    after the old one was left: the first ``grid_size`` join a new
    default group (none when the grid has one rank), in their old order;
    with more survivors than that, every survivor also joins a
    :class:`StandbyChannel`.  Returns ``(new rank, channel or None)``;
    raises when a survivor does not join within the collective
    timeout."""
    new_rank = survivors.index(rank)
    base = dist.PrefixStore(f"g{gen}/", rdzv.store)
    if new_rank < grid_size and grid_size > 1:
        dist.init_process_group(
            backend=backend, store=dist.PrefixStore("world/", base),
            rank=new_rank, world_size=grid_size,
            timeout=collective_timeout())
    channel = None
    if len(survivors) > grid_size:
        group = dist.ProcessGroupGloo(
            dist.PrefixStore("standby/", base), new_rank, len(survivors),
            STANDBY_TIMEOUT)
        channel = StandbyChannel(group, new_rank, grid_size,
                                 len(survivors))
    return new_rank, channel
