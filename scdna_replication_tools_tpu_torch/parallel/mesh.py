"""The rank grid of a sharded fit (port of ``parallel/mesh.py``).

The JAX package shards a fit over a ``jax.sharding.Mesh`` of devices
with the axes ``cells`` (and, for long genomes, ``loci``) and lets XLA
insert the collectives.  Here each rank is a process of a
``torch.distributed`` group and the mesh is a :class:`RankMesh`: the
ranks laid out row-major on a ``cells x loci`` grid, as JAX lays its
devices, with one subgroup per grid row (the ranks that share a cells
slice: sums over loci run there) and one per column (the ranks that
share a loci tile: sums over cells run there).

* each rank owns its cells slice (and loci tile) of the per-cell
  parameters outright: ``tau``, ``u``, ``betas`` and the state-major
  ``(P, cells, loci)`` pi planes; ``rho`` lives on the loci tiles;
* the global parameters are replicated, and the fit sums their gradients
  across the ranks before Adam (:meth:`RankMesh.reduce_grads`), so every
  replica takes the same step; a loci-sharded leaf such as ``rho`` sums
  over its column only, a cells-sharded one over its row only;
* the fused kernels run once per rank on that rank's rows, with no
  collective inside, as under JAX's ``shard_map``.

Device tensors are reduced in place (``all_reduce``: the gloo and NCCL
backends both take CUDA tensors); gathers go through host tensors on
gloo groups, so one code path serves both backends: the decoded
outputs' over every rank (:meth:`RankMesh.gather`) and the Viterbi
decode's emissions along a loci row (:meth:`RankMesh.gather_loci`).  The layout rules (which axis of which tensor is
sharded) are ``layout.py``'s, the same table the checkpoint stamp uses.

The elastic rung (``infer/runner.py``) shrinks a grid by
:func:`shrink_grid`, JAX ``shrink_mesh``'s rule over the ranks that
survived a loss instead of the devices the runtime reports, and the
runner makes the smaller grid on the re-formed group
(``parallel.distributed.reform_group``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from scdna_replication_tools_tpu_torch import layout
from scdna_replication_tools_tpu_torch.layout import CELLS_AXIS, LOCI_AXIS


class RankMesh:
    """The ``cells x loci`` grid of the ranks of the default process
    group (see the module docstring).  Made by :func:`make_mesh`, on every
    rank at once: it creates the row and column subgroups, which
    ``torch.distributed`` requires all ranks to create together."""

    def __init__(self, cells: int, loci: int, rank: int, row_groups: list,
                 col_groups: list, host_group=None, host_rows=None):
        self.cells = int(cells)
        self.loci = int(loci)
        self.rank = int(rank)
        self.cell_index, self.loci_index = divmod(self.rank, self.loci)
        self._row_groups = row_groups
        self._col_groups = col_groups
        self.host_group = host_group
        # the rows' gloo twins beside an NCCL world (None: the rows are
        # gloo groups themselves)
        self._host_rows = host_rows

    # -- the grid ---------------------------------------------------------

    @property
    def size(self) -> int:
        return self.cells * self.loci

    @property
    def shape(self) -> dict:
        """Axis name -> extent, JAX ``Mesh.shape``'s mapping."""
        return grid_topology(self.cells, self.loci)

    @property
    def owns_globals(self) -> bool:
        """Whether this rank counts the terms of the replicated sites
        (the global priors): rank 0 alone, so the sum over ranks counts
        them once."""
        return self.rank == 0

    @property
    def owns_cells(self) -> bool:
        """Whether this rank counts the per-cell terms of its cells slice
        (the tau, u and betas priors): the first rank of its row."""
        return self.loci_index == 0

    def coords(self, rank: int) -> tuple:
        return divmod(int(rank), self.loci)

    def cells_slice(self, num_cells: int) -> slice:
        """This rank's contiguous slice of a cells axis of ``num_cells``
        (a multiple of the cell shards)."""
        return _even_slice(num_cells, self.cells, self.cell_index, "cells")

    def loci_slice(self, num_loci: int) -> slice:
        return _even_slice(num_loci, self.loci, self.loci_index, "loci")

    def tile(self, x, dims: Sequence[str]):
        """This rank's block of ``x`` (an array or a tensor) whose axes
        are named by ``dims`` (``layout``'s symbolic dims: 'cells' and
        'loci' are sliced, every other axis kept whole; ``x`` itself
        when it has neither).  The one slicing rule of a sharded run: the
        runner's batch and parameters and ``parallel.distributed``'s
        ``HostShard`` views all cut by it."""
        if CELLS_AXIS not in dims and LOCI_AXIS not in dims:
            return x
        idx = []
        for d, n in zip(dims, x.shape):
            if d == CELLS_AXIS:
                idx.append(self.cells_slice(n))
            elif d == LOCI_AXIS:
                idx.append(self.loci_slice(n))
            else:
                idx.append(slice(None))
        return x[tuple(idx)]

    def box(self, dims: Sequence[str], local_shape: Sequence[int]):
        """(global box ``((lo, hi), ...)``, global shape) of this rank's
        block of a tensor with axes ``dims``, or None when the block is
        the whole tensor (no axis sharded on this grid)."""
        box, gshape, sharded = [], [], False
        for d, n in zip(dims, local_shape):
            k = {CELLS_AXIS: (self.cells, self.cell_index),
                 LOCI_AXIS: (self.loci, self.loci_index)}.get(d, (1, 0))
            box.append((k[1] * n, (k[1] + 1) * n))
            gshape.append(n * k[0])
            sharded = sharded or k[0] > 1
        return (tuple(box), tuple(gshape)) if sharded else None

    # -- collectives ------------------------------------------------------

    def _group(self, axes: frozenset):
        """(process group, size) of a sum over the named axes: the world
        for both, the row for 'loci', the column for 'cells'; size 1 means
        nothing to sum."""
        axes = frozenset(a for a in axes
                         if (a == CELLS_AXIS and self.cells > 1)
                         or (a == LOCI_AXIS and self.loci > 1))
        if not axes:
            return None, 1
        if axes == frozenset((CELLS_AXIS, LOCI_AXIS)) \
                or (CELLS_AXIS in axes and self.loci == 1) \
                or (LOCI_AXIS in axes and self.cells == 1):
            return dist.group.WORLD, self.size
        if axes == frozenset((LOCI_AXIS,)):
            return self._row_groups[self.cell_index], self.loci
        return self._col_groups[self.loci_index], self.cells

    def all_reduce(self, t: torch.Tensor, axes=(CELLS_AXIS, LOCI_AXIS),
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced in place over the ranks along ``axes`` (the
        default: every rank); returns it."""
        group, n = self._group(frozenset(axes))
        if n > 1:
            dist.all_reduce(t, op=op, group=group)
        return t

    def sum_loci(self, t: torch.Tensor) -> torch.Tensor:
        """A per-cell partial sum over this rank's loci tile, summed over
        the row: the sum over every locus."""
        return self.all_reduce(t, (LOCI_AXIS,))

    def replicated_axes(self, dims: Sequence[str]) -> frozenset:
        """The grid axes a tensor with ``dims`` is NOT sharded on: the
        ranks along them hold copies of the same block."""
        return frozenset(a for a in (CELLS_AXIS, LOCI_AXIS) if a not in dims)

    def sharded_axes(self, dims: Sequence[str]) -> frozenset:
        return frozenset(a for a in (CELLS_AXIS, LOCI_AXIS) if a in dims)

    def owns(self, dims: Sequence[str]) -> bool:
        """Whether this rank counts its block of a tensor with ``dims``
        once in a sum over every rank: the first rank along each axis
        the tensor is replicated on."""
        rep = self.replicated_axes(dims)
        return not ((CELLS_AXIS in rep and self.cell_index)
                    or (LOCI_AXIS in rep and self.loci_index))

    def reduce_grads(self, loss: torch.Tensor, grads: dict):
        """(global loss, gradients) from this rank's share: the loss
        summed over every rank, each gradient over the axes its parameter
        is replicated on (``layout.param_dims``), one ``all_reduce`` per
        group, each of one flat float32 buffer."""
        buckets: dict = {}
        for name in sorted(grads):
            axes = self.replicated_axes(layout.param_dims(name))
            buckets.setdefault(self._group(axes), []).append(name)
        world = self._group(frozenset((CELLS_AXIS, LOCI_AXIS)))
        buckets.setdefault(world, [])
        out = dict(grads)
        for (group, n), names in buckets.items():
            parts = [grads[k].reshape(-1).to(torch.float32) for k in names]
            if (group, n) == world:
                parts = [loss.reshape(1).to(torch.float32)] + parts
            if n == 1 or not parts:
                continue
            flat = torch.cat(parts)
            dist.all_reduce(flat, group=group)
            off = 0
            if (group, n) == world:
                loss = flat[0]
                off = 1
            for k in names:
                m = grads[k].numel()
                out[k] = flat[off:off + m].reshape(grads[k].shape) \
                    .to(grads[k].dtype)
                off += m
        return loss, out

    def sum_of_squares(self, *trees: dict) -> torch.Tensor:
        """(len(trees),) sums of squares of every leaf of each tree, each
        block counted once over the ranks (:meth:`owns`), summed over
        every rank; leaves in sorted-name order."""
        dev = next(iter(trees[0].values())).device
        sums = []
        for tree in trees:
            s = torch.zeros((), dtype=torch.float32, device=dev)
            for k in sorted(tree):
                if self.owns(layout.param_dims(k)):
                    s = s + torch.sum(tree[k] * tree[k])
            sums.append(s)
        return self.all_reduce(torch.stack(sums))

    def leaf_std(self, name: str, leaf: torch.Tensor) -> torch.Tensor:
        """The population standard deviation of the global leaf ``name``
        of which ``leaf`` is this rank's block (two passes: the global
        mean, then the mean squared deviation)."""
        axes = self.sharded_axes(layout.param_dims(name))
        n = self.all_reduce(torch.tensor(
            [float(leaf.numel())], dtype=torch.float64, device=leaf.device),
            axes)
        s = self.all_reduce(torch.sum(leaf.double()).reshape(1), axes)
        mean = (s / n).to(leaf.dtype)
        d = self.all_reduce(torch.sum(((leaf - mean) ** 2).double())
                            .reshape(1), axes)
        return torch.sqrt(d / n).reshape(()).to(leaf.dtype)

    def gather_loci(self, t: torch.Tensor) -> torch.Tensor:
        """The whole rows of which ``t`` (cells block, loci tile, ...) is
        this rank's tile, on ``t``'s device: the tiles of this rank's
        loci row gathered through host tensors (one ``all_gather`` on the
        row's gloo group) and joined along axis 1 in grid order.  Only
        the row's ranks exchange: a rank holds its cells block's rows,
        never the full grid."""
        if self.loci == 1:
            return t
        group, n = self._group(frozenset((LOCI_AXIS,)))
        if self._host_rows is not None:
            group = self._host_rows[self.cell_index] if self.cells > 1 \
                else self.host_group
        local = t.detach().cpu().contiguous()
        tiles = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(tiles, local, group=group)
        return torch.cat(tiles, dim=1).to(t.device)

    # -- host gathers -----------------------------------------------------

    def gather(self, x, dims: Sequence[str]) -> np.ndarray:
        """The global host array of which ``x`` (an array or a tensor) is
        this rank's block along ``dims`` (as :meth:`tile`): every rank's
        block through one host ``all_gather``, each placed at its grid
        position (copies along an axis the tensor is replicated on land
        on the same place).  Every rank returns the whole array."""
        local = x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)
        dtype = local.dtype
        t = torch.from_numpy(np.ascontiguousarray(
            local.view(np.uint8) if dtype == np.bool_ else local))
        blocks = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(blocks, t, group=self.host_group)
        gshape = [n * {CELLS_AXIS: self.cells, LOCI_AXIS: self.loci}
                  .get(d, 1) for d, n in zip(dims, local.shape)]
        out = np.empty(gshape, t.numpy().dtype)
        for r, block in enumerate(blocks):
            ci, li = self.coords(r)
            idx = []
            for d, n in zip(dims, local.shape):
                k = ci if d == CELLS_AXIS else li if d == LOCI_AXIS else None
                idx.append(slice(None) if k is None
                           else slice(k * n, (k + 1) * n))
            out[tuple(idx)] = block.numpy()
        return out.view(np.bool_) if dtype == np.bool_ else out


def _even_slice(n: int, parts: int, k: int, what: str) -> slice:
    if n % parts:
        raise ValueError(f"{what} axis of {n} does not divide over {parts} "
                         "shards; pad it first")
    per = n // parts
    return slice(k * per, (k + 1) * per)


def grid_shape(num_shards: Optional[int] = None,
               loci_shards: int = 1) -> Optional[tuple]:
    """``(cells, loci)`` of the rank grid that ``num_shards`` cell shards
    (None or 0: every rank, less ``loci_shards``) by ``loci_shards`` loci
    shards make on the default process group, or None for the one-rank
    grid of a run without a group.  The grid must cover the group
    exactly, and a grid of more than one rank needs an initialised group
    (``parallel.init_distributed``): a sharded run never falls back to
    one rank."""
    from scdna_replication_tools_tpu_torch.parallel import distributed

    loci_shards = int(loci_shards or 1)
    if loci_shards < 1 or (num_shards is not None and int(num_shards) < 0):
        raise ValueError(f"num_shards={num_shards!r} and loci_shards="
                         f"{loci_shards!r} must be non-negative counts")
    world = distributed.process_rank_and_count()[1]
    if not num_shards:
        if world % loci_shards:
            raise ValueError(f"loci_shards={loci_shards} does not divide "
                             f"the {world} ranks of the process group")
        num_shards = world // loci_shards
    cells = int(num_shards)
    if cells * loci_shards == 1 and world == 1:
        return None
    if not dist.is_initialized():
        raise ValueError(
            f"num_shards={cells} x loci_shards={loci_shards} needs a "
            "process group of that many ranks: call "
            "scdna_replication_tools_tpu_torch.parallel.init_distributed "
            "on every rank first (e.g. under torchrun)")
    if cells * loci_shards != world:
        raise ValueError(
            f"mesh needs {cells} x {loci_shards} = {cells * loci_shards} "
            f"ranks; the process group has {world}")
    return cells, loci_shards


def make_mesh(num_shards: Optional[int] = None,
              loci_shards: int = 1) -> Optional[RankMesh]:
    """The rank grid of :func:`grid_shape` on the default process group,
    None for the one-rank grid.  Every rank calls it (it creates the
    subgroups)."""
    from scdna_replication_tools_tpu_torch.parallel import distributed

    grid = grid_shape(num_shards, loci_shards)
    if grid is None:
        return None
    cells, loci_shards = grid
    rank = distributed.process_rank_and_count()[0]
    timeout = distributed.collective_timeout()
    # the row and column subgroups (a 1-D grid needs none: its sums
    # over one axis are over every rank)
    both = loci_shards > 1 and cells > 1
    rows = [dist.new_group([i * loci_shards + j for j in range(loci_shards)],
                           timeout=timeout) if both else None
            for i in range(cells)]
    cols = [dist.new_group([i * loci_shards + j for i in range(cells)],
                           timeout=timeout) if both else None
            for j in range(loci_shards)]
    host, host_rows = None, None
    if dist.get_backend() != "gloo":
        # host tensors ride gloo groups beside an NCCL world: the world's
        # and each row's
        host = dist.new_group(backend="gloo", timeout=timeout)
        host_rows = [dist.new_group(
            [i * loci_shards + j for j in range(loci_shards)],
            backend="gloo", timeout=timeout) if both else None
            for i in range(cells)]
    return RankMesh(cells, loci_shards, rank, rows, cols, host, host_rows)


def loci_axis(mesh: Optional[RankMesh]) -> Optional[str]:
    """'loci' when the mesh shards the loci axis, else None."""
    return LOCI_AXIS if mesh is not None and mesh.loci > 1 else None


def mesh_topology(mesh: Optional[RankMesh]) -> dict:
    """JSON-able axis-name -> extent description of a mesh (``{}`` for
    no mesh), JAX ``mesh_topology``'s dict for the same grid."""
    if mesh is None:
        return {}
    return grid_topology(mesh.cells, mesh.loci)


def grid_topology(cells: int, loci: int) -> dict:
    """:func:`mesh_topology` of a ``cells x loci`` grid, one rank
    included (``{'cells': 1}``, the axes of JAX's one-device mesh, where
    the port runs without a mesh)."""
    out = {CELLS_AXIS: int(cells)}
    if loci > 1:
        out[LOCI_AXIS] = int(loci)
    return out


def shrink_grid(cells: int, loci: int,
                survivors: int) -> Optional[tuple]:
    """One rung of the elastic ladder (JAX ``parallel/mesh.shrink_mesh``'s
    rule): ``(cells, loci)`` of the grid at half the cells extent, the
    loci extent kept while ``new_cells x loci`` ranks fit the
    ``survivors`` (JAX counts ``jax.devices()``; here the ranks left
    after a loss), else collapsed to 1; None when the grid is already
    minimal (1 x 1) and the ladder is exhausted."""
    cells, loci = int(cells), int(loci)
    if cells <= 1 and loci <= 1:
        return None
    new_cells = max(1, cells // 2)
    new_loci = loci
    if new_cells * new_loci > max(1, int(survivors)) or cells <= 1:
        new_loci = 1
    if (new_cells, new_loci) == (cells, loci):
        return None
    return new_cells, new_loci


def shrink_ladder(cells: int, loci: int, survivors: int) -> list:
    """The rungs :func:`shrink_grid` walks from a ``cells x loci`` grid
    until its ranks fit the ``survivors``: one rung in the common case,
    more when a halving still needs more ranks than are left; ``[]``
    when the first rung is already exhausted."""
    rungs = []
    grid = (int(cells), int(loci))
    while not rungs or grid[0] * grid[1] > max(1, int(survivors)):
        grid = shrink_grid(grid[0], grid[1], survivors)
        if grid is None:
            return []
        rungs.append(grid)
    return rungs
