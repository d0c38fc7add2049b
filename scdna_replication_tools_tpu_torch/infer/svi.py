"""MAP-SVI fit loop (port of ``infer/svi.py``'s ``fit_map``).

The per-iteration semantics are those of the JAX ``_fit_loop``
(reference: pert_model.py:748-758), in one copy on the device:

* value and gradient of the loss, then the Adam update, applied BEFORE
  the convergence test (the NaN iteration's update lands too);
* the loss history in a float32 device buffer of zeros;
* convergence once ``i >= min_iter`` and
  ``(max - min)(losses[i-w:i]) / |losses[0] - losses[i]| < rel_tol``
  with ``w = min(9, max_iter)`` (``_window_stat``);
* a NaN loss stops the fit;
* every ``diag_every``-th iteration records loss, global gradient norm
  and global parameter norm in a ring of ``DIAG_RING`` slots.

The host launches a chunk of iterations ``i0 .. stop-1`` without a
blocking read: the loss, the stop flags and the iteration count stay
device tensors, and an iteration launched after the fit stopped is
masked (the Adam kernel's live gate writes every parameter and moment
through, the loss history and the ring are left alone, the step count
does not move).  On the card the host also peeks, without waiting, at
the stop flags of the iterations the card has finished, and launches no
more of the chunk once one reports the stop.  The host reads one packed
device-to-host copy per chunk (the count, the flags, the loss history
and the ring), so a fit's trajectory and stop iteration are the JAX
loop's while the card never waits on the host inside a chunk.  A chunk
is ``diag_every`` iterations long, or ``HOST_READ_EVERY`` when the ring
is off.

With a controller policy (``obs/controller.py``) the host reads the
flight recorder between chunks and may early-stop, extend, re-seed or
retry a NaN-poisoned fit at a lower learning rate, as JAX's
``_fit_map_controlled`` / ``_chunk_loop`` do; the chunk boundaries are
also its durability points (checkpoints, the ``{tag}/chunk`` fault
site, the chunk watchdog, the emergency save and the heartbeat), and a
fit resumes from a checkpoint's Adam state, loss prefix and controller
ledger on the uninterrupted trajectory.  Adam is optax's (lr 0.05,
betas 0.8/0.99 by default): the pi parameter through the fused kernel
(``ops/adam_kernel.adam_update``), with its moments stored in
``moment_dtype`` (float32 or bfloat16), every other leaf through the same
math as plain ops with float32 moments.

With a compiled-program store current on the fit's thread
(``infer/aotcache.run_scope``: ``executable_cache_dir``), a fit on the
card replays CUDA graphs instead: each chunk's iterations run the
device-counter form of the iteration (:func:`_iteration_dev`, every
index a device tensor, as the JAX body is driven by its loop carry),
captured once per program (:class:`_ChunkProgram`: a diagnostic form
and a plain one, JAX's ``lax.cond`` branches) and replayed once per
iteration on static buffers that the chunk fills from its entry state
and copies out of at its end.  A sharded fit (its all-reduce stages
through the host) and a fit on the CPU run the host-integer form and
say so (``uncacheable``).  Each iteration or replay is the profiler
range ``pert/fit_step``.

A sharded fit (a loss function with a ``mesh``: ``parallel.mesh.
RankMesh``) runs this loop on every rank in lockstep: each iteration's
loss is this rank's share, and before Adam the loss is summed over every
rank and each gradient over the ranks its parameter is replicated on
(``RankMesh.reduce_grads``).  The loss history, the stop flags, the
ring and so every host read and controller verdict are then the same on
every rank; a rank that fails ends its peers' collectives, which raise
at the group's timeout at the latest.  The serving slab stays one rank.
"""

from __future__ import annotations

import dataclasses
import threading
import time
import weakref
from typing import Callable, Optional

import numpy as np
import torch

from scdna_replication_tools_tpu_torch import layout
from scdna_replication_tools_tpu_torch.device import resolve_device
from scdna_replication_tools_tpu_torch.infer import aotcache as _aotcache
from scdna_replication_tools_tpu_torch.infer import checkpoint as _ckpt
from scdna_replication_tools_tpu_torch.obs import controller as _controller
from scdna_replication_tools_tpu_torch.obs import doctor as _doctor
from scdna_replication_tools_tpu_torch.obs import heartbeat as _heartbeat
from scdna_replication_tools_tpu_torch.obs import meter as _meter
from scdna_replication_tools_tpu_torch.obs import runlog as _runlog
from scdna_replication_tools_tpu_torch.ops.adam_kernel import (
    adam_constants,
    adam_scalars,
    adam_update,
    adam_update_plain,
    moment_torch_dtype,
)
from scdna_replication_tools_tpu_torch.ops import _cuda
from scdna_replication_tools_tpu_torch.ops.dists import seeded_generator
from scdna_replication_tools_tpu_torch.utils import faults as _faults
from scdna_replication_tools_tpu_torch.utils import profiling as _profiling
from scdna_replication_tools_tpu_torch.utils.profiling import logger

# slots of the in-fit diagnostics ring (JAX svi.py:47)
DIAG_RING = 64
# iterations per host read of a fit without the diagnostics ring
HOST_READ_EVERY = 25


def pi_param_name(params: dict) -> Optional[str]:
    """The (planes, cells, loci) pi parameter's key: 'pi_bin_logits' under
    the binary encoding, 'pi_logits' under the categorical one, None for
    parameter dicts that carry neither."""
    for name in ("pi_bin_logits", "pi_logits"):
        if name in params:
            return name
    return None


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: step count (int32, on device) and the
    first / second moments, keyed like the parameters."""

    count: torch.Tensor
    mu: dict
    nu: dict


@dataclasses.dataclass
class FitResult:
    params: dict            # fitted unconstrained params (device tensors)
    losses: np.ndarray      # (num_iters,) float32 per-iteration losses
    num_iters: int
    converged: bool
    nan_abort: bool
    opt_state: Optional[AdamState] = None
    # {"fit": seconds, "ms_per_iter": per counted iteration,
    #  "dispatched": iterations launched (>= num_iters: a chunk's
    #  iterations after the stop are launched and masked, on the card
    #  only until the host sees the stop)}
    timings: dict = dataclasses.field(default_factory=dict)
    # the ring's samples (``_decode_diag``): "every", "iter", "loss",
    # "grad_norm", "param_norm"; None when diag_every == 0
    diagnostics: Optional[dict] = None
    # convergence-doctor class of the loss tail (obs/doctor.py) and the
    # full report behind it
    verdict: Optional[str] = None
    health: Optional[dict] = None
    # the controller's decisions, one dict each (empty without one)
    decisions: list = dataclasses.field(default_factory=list)
    # the final iteration budget (max_iter plus any extension)
    budget: Optional[int] = None
    # ``compile`` event payloads of the fit's programs (one per graph
    # form it replayed: "miss" when this fit captured it, "hit" when it
    # was in the store; one "uncacheable" for a fit the store cannot
    # serve); empty without a store
    programs: list = dataclasses.field(default_factory=list)


def make_opt_state(params: dict, moment_dtype: str = "float32") -> AdamState:
    """Fresh Adam state for ``params``: zero moments, count 0; the pi
    parameter's moments in ``moment_dtype``, the rest float32."""
    device = next(iter(params.values())).device
    pi = pi_param_name(params)
    dt = {pi: moment_torch_dtype(moment_dtype)}

    def zeros():
        return {k: torch.zeros_like(v, dtype=dt.get(k, torch.float32))
                for k, v in params.items()}
    return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                     mu=zeros(), nu=zeros())


def _adam_apply(params: dict, grads: dict, state: AdamState,
                const: torch.Tensor, live: torch.Tensor, b1: float,
                b2: float, moment_dtype: str, in_place: bool = False):
    """One Adam step of every leaf, gated by the device bool ``live``;
    the pi parameter takes the fused kernel with ``moment_dtype``
    moments (``in_place``: into its own planes), the rest the same math
    as plain ops."""
    scal = adam_scalars(const, state.count + 1, live)
    pi = pi_param_name(params)
    new_p, new_m, new_v = {}, {}, {}
    for k, p in params.items():
        args = (p, grads[k], state.mu[k], state.nu[k], scal, b1, b2)
        new_p[k], new_m[k], new_v[k] = (
            adam_update(*args, moment_dtype, in_place=in_place) if k == pi
            else adam_update_plain(*args))
    count = state.count + live.to(torch.int32)
    return new_p, AdamState(count=count, mu=new_m, nu=new_v)


def _global_norm(tree: dict) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of squares of every leaf,
    summed in the JAX pytree's (sorted-key) leaf order."""
    return torch.sqrt(sum(torch.sum(tree[k] * tree[k]) for k in sorted(tree)))


def _norms(grads: dict, params: dict, mesh=None) -> torch.Tensor:
    """(2,) global norms of the gradients and the parameters; with
    ``mesh`` over the whole sharded tree (each block counted once)."""
    if mesh is None:
        return torch.stack([_global_norm(grads), _global_norm(params)])
    return torch.sqrt(mesh.sum_of_squares(grads, params))


def _window_stat(losses, i: int, win: int):
    """max - min over losses[i-win:i] (numpy array or tensor, ``i`` a
    host index); the start clamps to [0, n - win] as lax.dynamic_slice
    does (unwritten tail values are zeros)."""
    start = min(max(i - win, 0), len(losses) - win)
    window = losses[start:start + win]
    return window.max() - window.min()


@dataclasses.dataclass(frozen=True)
class _Loop:
    """The per-fit constants of the iteration."""
    min_iter: int
    rel_tol: float
    win: int
    diag_every: int
    b1: float
    b2: float
    moment_dtype: str


@dataclasses.dataclass
class _Carry:
    """The device state of a fit between iterations: parameters, Adam
    state, loss history, diagnostics ring (or None), and the chunk's
    iteration count and stop flags (0-d device tensors)."""
    params: dict
    state: AdamState
    losses: torch.Tensor
    diag: Optional[torch.Tensor]
    i: Optional[torch.Tensor] = None
    done: Optional[torch.Tensor] = None
    converged: Optional[torch.Tensor] = None
    is_nan: Optional[torch.Tensor] = None


def _iteration(loss_fn: Callable, loss_args: tuple, c: _Carry, it: int,
               loop: _Loop, const: torch.Tensor,
               in_place: bool = False, mesh=None) -> _Carry:
    """Iteration ``it`` of the JAX ``_fit_loop`` body, gated by the
    device flag ``done``.  While the fit runs the device count equals
    the host index ``it``, so every slot index is a host integer.
    ``in_place`` steps the pi parameter and its moments in their own
    planes: only for a carry that this chunk made, which nothing else
    holds.  ``mesh``: the loss and gradients are summed over the ranks
    first (module docstring)."""
    live = torch.logical_not(c.done)
    leaves = {k: v.detach().requires_grad_(True) for k, v in c.params.items()}
    loss = loss_fn(leaves, *loss_args)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {k: (g if g is not None else torch.zeros_like(leaves[k]))
             for k, g in zip(leaves, grads)}
    with torch.no_grad():
        loss = loss.detach().to(torch.float32)
        if mesh is not None:
            loss, grads = mesh.reduce_grads(loss, grads)
        if loop.diag_every and it % loop.diag_every == 0:
            row = torch.cat([loss.reshape(1),
                             _norms(grads, c.params, mesh)])
            slot = (it // loop.diag_every) % DIAG_RING
            c.diag[slot] = torch.where(live, row, c.diag[slot])
        params, state = _adam_apply(c.params, grads, c.state, const, live,
                                    loop.b1, loop.b2, loop.moment_dtype,
                                    in_place)
        losses = c.losses
        losses[it] = torch.where(live, loss, losses[it])
        is_nan = torch.isnan(loss)
        stop = is_nan
        converged = c.converged
        if it >= loop.min_iter:
            denom = torch.abs(losses[0] - loss)
            conv = _window_stat(losses, it, loop.win) / denom < loop.rel_tol
            stop = torch.logical_or(is_nan, conv)
            converged = torch.logical_or(converged,
                                         torch.logical_and(live, conv))
        return _Carry(
            params=params, state=state, losses=losses, diag=c.diag,
            i=c.i + live.to(torch.int32),
            done=torch.logical_or(c.done, torch.logical_and(live, stop)),
            converged=converged,
            is_nan=torch.logical_or(c.is_nan,
                                    torch.logical_and(live, is_nan)))


class _StopProbe:
    """A lagged, non-blocking view of a chunk's ``done`` flag on the card:
    after each launched iteration its flag is copied into pinned host
    memory behind a CUDA event, and the host, before launching the next
    one, reads only the flags whose events have completed
    (``Event.query``, which never waits).  A chunk whose fit stopped
    then launches only the masked iterations already queued, not the
    rest of the chunk.  Made once per fit; each slot is reused only
    after the chunk's read has waited for the card."""

    def __init__(self, n: int):
        self.flags = torch.zeros((n,), dtype=torch.bool, pin_memory=True)
        self.events = [torch.cuda.Event() for _ in range(n)]
        self.seen = 0

    def post(self, k: int, done: torch.Tensor) -> None:
        self.flags[k].copy_(done, non_blocking=True)
        self.events[k].record()

    def stopped(self, k: int) -> bool:
        """Whether an iteration before position ``k`` that the card has
        finished left the fit stopped."""
        while self.seen < k and self.events[self.seen].query():
            if bool(self.flags[self.seen]):
                return True
            self.seen += 1
        return False


def _stop_probe(loss_fn: Callable, n: int, dev) -> Optional[_StopProbe]:
    """The chunk's stop probe on the card, or None: on the CPU, and in a
    sharded fit, whose ranks must launch the same iterations (each takes
    the collectives of :func:`_iteration`), so none may stop early on
    what its own card has reported."""
    if dev.type != "cuda" or getattr(loss_fn, "mesh", None) is not None:
        return None
    return _StopProbe(n)


def _iteration_dev(loss_fn: Callable, loss_args: tuple, s: _Carry,
                   loop: _Loop, const: torch.Tensor, diag_row: bool) -> None:
    """The iteration of :func:`_iteration` in place on ``s``, driven by
    the device count ``s.i`` as the JAX body is by its loop carry: the
    loss slot, the ring's slot and the ``min_iter`` test are device
    tensors (index writes and a ``where``), so one captured graph serves
    every iteration.  ``diag_row`` (the host knows ``it % diag_every``)
    records the ring's row: the diagnostic form.  Every value equals the
    host-integer form's, bit for bit; the pi parameter and its moments
    step in their own planes, every other leaf and flag is copied back
    into ``s``.  Not for a sharded fit."""
    live = torch.logical_not(s.done)
    leaves = {k: v.detach().requires_grad_(True) for k, v in s.params.items()}
    loss = loss_fn(leaves, *loss_args)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    grads = {k: (g if g is not None else torch.zeros_like(leaves[k]))
             for k, g in zip(leaves, grads)}
    with torch.no_grad():
        loss = loss.detach().to(torch.float32)
        i = s.i.to(torch.int64).reshape(1)
        if diag_row:
            row = torch.cat([loss.reshape(1), _norms(grads, s.params)])
            slot = torch.remainder(
                torch.div(i, loop.diag_every, rounding_mode="floor"),
                DIAG_RING)
            s.diag.index_copy_(0, slot, torch.where(
                live, row, s.diag.index_select(0, slot)[0])[None])
        params, state = _adam_apply(s.params, grads, s.state, const, live,
                                    loop.b1, loop.b2, loop.moment_dtype,
                                    in_place=True)
        for dst, src in ((s.params, params), (s.state.mu, state.mu),
                         (s.state.nu, state.nu)):
            for k, v in src.items():
                if v is not dst[k]:
                    dst[k].copy_(v)
        s.state.count.copy_(state.count)
        losses = s.losses
        losses.index_copy_(0, i, torch.where(
            live, loss, losses.index_select(0, i)[0]).reshape(1))
        is_nan = torch.isnan(loss)
        n = losses.shape[0]
        start = torch.clamp(i - loop.win, 0, n - loop.win)
        window = losses.index_select(
            0, start + torch.arange(loop.win, device=losses.device))
        denom = torch.abs(losses[0] - loss)
        conv = torch.logical_and(
            (window.max() - window.min()) / denom < loop.rel_tol,
            i[0] >= loop.min_iter)
        stop = torch.logical_or(is_nan, conv)
        converged = torch.logical_or(s.converged,
                                     torch.logical_and(live, conv))
        s.i.copy_(s.i + live.to(torch.int32))
        s.done.copy_(torch.logical_or(s.done, torch.logical_and(live, stop)))
        s.converged.copy_(converged)
        s.is_nan.copy_(torch.logical_or(s.is_nan,
                                        torch.logical_and(live, is_nan)))


def _fresh_flags(c: _Carry, i0: int) -> _Carry:
    """``c`` with the chunk's count at ``i0`` and cleared stop flags."""
    dev = c.losses.device
    flag = dict(dtype=torch.bool, device=dev)
    return dataclasses.replace(
        c, i=torch.full((), i0, dtype=torch.int32, device=dev),
        done=torch.zeros((), **flag), converged=torch.zeros((), **flag),
        is_nan=torch.zeros((), **flag))


def _form(loop: _Loop, it: int) -> str:
    """The graph form of iteration ``it``: 'diag' where it records the
    ring's row, else 'plain'."""
    return "diag" if loop.diag_every and it % loop.diag_every == 0 \
        else "plain"


def _clone_tree(tree):
    """A copy of ``tree`` (see :func:`_flatten`) with fresh tensors."""
    leaves: list = []
    skel = _flatten(tree, leaves)
    return _unflatten(skel, iter([t.clone() for t in leaves]))


# one capture at a time in the process: the launch counts of a capture
# are gathered process-wide (ops/_cuda.recording_launches)
_CAPTURE_LOCK = threading.Lock()
# eager iterations of each form before its capture, on the capture's
# stream and on the program's own buffers (reset by the chunk's entry
# copy): the lazy initialisations (cuBLAS handles and workspaces, the
# autograd engine's device thread) may not happen inside a capture
GRAPH_WARMUPS = 1
# device -> the one side stream of every warm-up and capture there
# (PyTorch keeps a cuBLAS workspace per stream that has run a matmul, so
# one stream for them all holds one)
_CAPTURE_STREAMS: dict = {}


def _capture_stream(dev) -> "torch.cuda.Stream":
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]


class _ChunkProgram:
    """The CUDA graphs of one chunk program (a program of the store,
    ``infer/aotcache.py``): static buffers of the carry, the loss
    arguments and ``const``, and one graph per form, each stepping the
    buffers in place by one iteration (:func:`_iteration_dev`).  The
    forms share the buffers and one memory pool.  A chunk copies its
    entry state in (:meth:`bind`), replays, and copies the state out
    (:meth:`snapshot`): what the chunk loop keeps (the best-loss
    parameters, checkpoints, the emergency save) never aliases a buffer
    that the next replay overwrites."""

    def __init__(self, loss_fn: Callable, loop: _Loop, carry: _Carry,
                 loss_args: tuple, const: torch.Tensor):
        self.loss_fn, self.loop = loss_fn, loop
        dev = carry.losses.device
        self.device = dev
        self.static = _fresh_flags(_Carry(
            params=_clone_tree(carry.params),
            state=_clone_tree(carry.state), losses=carry.losses.clone(),
            diag=None if carry.diag is None else carry.diag.clone()), 0)
        leaves: list = []
        self._arg_skel = _flatten(tuple(loss_args), leaves)
        self._arg_leaves = [t.clone() for t in leaves]
        self.args = _unflatten(self._arg_skel, iter(self._arg_leaves))
        self._bound: list = []
        self.const = const.clone()
        self.graphs: dict = {}
        self.counts: dict = {}
        self.pool = torch.cuda.graph_pool_handle()
        self.warmups = 0
        # chunks replaying it now (the store releases only idle ones),
        # and the device bytes of its buffers and pool
        self.busy = 0
        # one chunk at a time steps the buffers: a chunk of another fit
        # of the same key (a served request's, on its own thread) waits
        # for the lock on the host and for the last chunk's work (an
        # event on its stream) on the card
        self.lock = threading.Lock()
        self.last = None
        leaves = []
        _flatten((self.static, self._arg_leaves, self.const), leaves)
        self.nbytes = sum(t.numel() * t.element_size() for t in leaves)

    def capture(self, form: str) -> float:
        """Warm up and capture ``form``; returns the seconds it took.  A
        capture that fails raises, naming the form and what broke it."""
        dev = self.device
        t0 = time.perf_counter()

        def body():
            _iteration_dev(self.loss_fn, self.args, self.static, self.loop,
                           self.const, form == "diag")
        try:
            with _CAPTURE_LOCK:
                reserved = torch.cuda.memory_reserved(dev)
                side = _capture_stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    for _ in range(GRAPH_WARMUPS):
                        body()
                torch.cuda.current_stream(dev).wait_stream(side)
                self.warmups += GRAPH_WARMUPS
                graph = torch.cuda.CUDAGraph()
                with _cuda.recording_launches() as counts:
                    with torch.cuda.graph(graph, pool=self.pool, stream=side,
                                          capture_error_mode="thread_local"):
                        body()
                # the pool's growth (other threads' allocations in the
                # window count too: an estimate)
                self.nbytes += max(
                    torch.cuda.memory_reserved(dev) - reserved, 0)
        except Exception as exc:
            raise RuntimeError(
                f"CUDA graph capture of the {form} iteration failed "
                f"({type(exc).__name__}: {exc}); a fit that cannot be "
                "captured runs without executable_cache_dir") from exc
        leaves: list = []
        if _flatten(tuple(self.args), leaves) != self._arg_skel:
            raise RuntimeError(
                f"CUDA graph capture of the {form} iteration: the loss "
                "arguments grew a cached tensor during the warm-up (the "
                "loss function's prime() must fill every cache entry)")
        self.graphs[form], self.counts[form] = graph, dict(counts)
        return time.perf_counter() - t0

    def bind(self, c: _Carry, loss_args: tuple, const: torch.Tensor,
             i0: int) -> None:
        """Copy a chunk's entry state, its loss arguments (only when they
        are not the ones bound last) and ``const`` into the buffers."""
        s = self.static
        for dst, src in ((s.params, c.params), (s.state.mu, c.state.mu),
                         (s.state.nu, c.state.nu)):
            for k, v in src.items():
                dst[k].copy_(v)
        s.state.count.copy_(c.state.count)
        s.losses.copy_(c.losses)
        if s.diag is not None:
            s.diag.copy_(c.diag)
        s.i.fill_(i0)
        for flag in (s.done, s.converged, s.is_nan):
            flag.zero_()
        self.const.copy_(const)
        leaves: list = []
        if _flatten(tuple(loss_args), leaves) != self._arg_skel:
            raise ValueError("the chunk's loss arguments do not have the "
                             "program's structure")
        if len(leaves) != len(self._bound) or any(
                ref() is not t for ref, t in zip(self._bound, leaves)):
            for dst, src in zip(self._arg_leaves, leaves):
                dst.copy_(src)
            self._bound = [weakref.ref(t) for t in leaves]

    def after_last(self) -> None:
        """Order this chunk's work on the current stream after the last
        chunk's (which may have run on another thread's stream)."""
        if self.last is not None:
            torch.cuda.current_stream(self.device).wait_event(self.last)

    def mark_last(self) -> None:
        self.last = torch.cuda.Event()
        self.last.record(torch.cuda.current_stream(self.device))

    def replay(self, form: str) -> None:
        self.graphs[form].replay()
        _cuda.add_launches(self.counts[form])

    def snapshot(self) -> _Carry:
        """The buffers' state as fresh tensors."""
        return _clone_tree(self.static)

    def release(self) -> None:
        """Free the graphs, their pool and the buffers."""
        for graph in self.graphs.values():
            graph.reset()
        self.graphs.clear()
        self.static = self.args = self.const = None
        self._arg_leaves, self._bound = [], []


class _FitPrograms:
    """A fit's view of the run's store (``aotcache.current_scope()``,
    taken once per fit): resolves each chunk's program by the JAX key's
    components, captures a form at its first use, and keeps the fit's
    ``compile`` events (:attr:`events`)."""

    def __init__(self, scope, tag: str, loss_fn: Callable, loop: _Loop):
        self.scope, self.tag, self.loss_fn, self.loop = \
            scope, tag, loss_fn, loop
        self.events: list = []
        self._digest: Optional[str] = None
        self._key_text: Optional[str] = None
        self._seen: set = set()
        self._prog_id: Optional[int] = None
        self.captures = self.replays = self.warmups = 0

    @staticmethod
    def of(loss_fn: Callable, dev, tag: str, loop: _Loop):
        """The fit's programs, or None: without a store, and (after a
        one-time ``uncacheable`` event) for a fit on the CPU or a
        sharded one, whose all-reduce stages through the host."""
        scope = _aotcache.current_scope()
        if scope is None:
            return None
        progs = _FitPrograms(scope, tag, loss_fn, loop)
        if dev.type != "cuda" or getattr(loss_fn, "mesh", None) is not None:
            progs.events.append({
                "key_hash": "uncacheable", "label": f"{tag}:iteration",
                "tag": tag, "cache": "uncacheable",
                "reason": "sharded fit" if dev.type == "cuda" else
                f"fit on {dev.type}"})
            return _Uncacheable(progs)
        return progs

    def _key(self, c: _Carry, loss_args: tuple):
        loop = self.loop
        statics = (("min_iter", loop.min_iter), ("rel_tol", loop.rel_tol),
                   ("win", loop.win), ("diag_every", loop.diag_every),
                   ("b1", loop.b1), ("b2", loop.b2),
                   ("moment_dtype", loop.moment_dtype))
        sig = _abstract_sig((c.params, c.state, c.losses, c.diag,
                             tuple(loss_args)))
        return (self.tag, repr(self.loss_fn), statics, sig,
                self.scope.config_digest)

    def program(self, c: _Carry, loss_args: tuple, const: torch.Tensor,
                forms) -> _ChunkProgram:
        """The chunk's program in the store, made and the needed
        ``forms`` captured on first use, marked in use (the caller hands
        it back with ``store.done_with``)."""
        if self._digest is None:
            # the loss arguments' fit-constant caches, filled first, are
            # tensors of the key's signature and the program's buffers
            prime = getattr(self.loss_fn, "prime", None)
            if prime is not None:
                prime(*loss_args)
            key = self._key(c, loss_args)
            self._key_text = _aotcache.canonical_key_text(key)
            self._digest = _aotcache.key_digest(
                self._key_text,
                _aotcache.environment_facts(c.losses.device),
                self.scope.config_digest)
        store = self.scope.store
        prog = store.acquire(self._digest)
        if prog is None:
            prog = _ChunkProgram(self.loss_fn, self.loop, c, loss_args,
                                 const)
            store.put_program(self._digest, prog)
        if id(prog) != self._prog_id:
            # a program this fit has not used (a store that released
            # the fit's earlier one captures anew)
            self._prog_id, self._seen = id(prog), set()
        try:
            with prog.lock:
                self._capture(prog, forms, c.losses.device)
        except BaseException:
            store.done_with(prog)
            raise
        store.trim()
        return prog

    def _capture(self, prog: _ChunkProgram, forms, dev) -> None:
        for form in forms:
            if form in self._seen:
                continue
            self._seen.add(form)
            event = {"key_hash": _aotcache.key_digest(
                self._key_text + "|" + form,
                _aotcache.environment_facts(dev), self.scope.config_digest),
                "label": f"{self.tag}:{form}", "tag": self.tag}
            if form in prog.graphs:
                event["cache"] = "hit"
            else:
                warm = prog.warmups
                seconds = prog.capture(form)
                self.captures += 1
                self.warmups += prog.warmups - warm
                event.update(cache="miss",
                             compile_seconds=round(seconds, 4))
            self.events.append(event)


class _Uncacheable:
    """The programs of a fit the store cannot serve: only its event."""

    def __init__(self, progs: _FitPrograms):
        self.events = progs.events
        self.captures = self.replays = self.warmups = 0


def _launch_chunk(loss_fn: Callable, loss_args: tuple, c: _Carry, i0: int,
                  stop: int, loop: _Loop, const: torch.Tensor,
                  probe: Optional[_StopProbe] = None, programs=None,
                  form: str = "host"):
    """Launch iterations ``i0 .. stop-1`` from fresh stop flags, reading
    nothing back: no operation here waits on the device (a graph's
    capture, once per program, aside).  With a ``probe`` (CUDA) the
    launches end early once the card has reported the fit stopped.
    With ``programs`` (a :class:`_FitPrograms`) each iteration replays
    the chunk program's graph; ``form='device'`` runs the
    device-counter iteration eagerly (the graphs' arithmetic, for
    tests).  Returns the carry and the iterations launched."""
    if isinstance(programs, _FitPrograms):
        return _launch_chunk_graphed(loss_fn, loss_args, c, i0, stop, loop,
                                     const, probe, programs)
    c = _fresh_flags(c, i0)
    if probe is not None:
        probe.seen = 0
    mesh = getattr(loss_fn, "mesh", None)
    if form == "device":
        # the graphs' own buffers: the entry state stays as it was
        c = _clone_tree(c)
    for k, it in enumerate(range(i0, stop)):
        if probe is not None and probe.stopped(k):
            return c, k
        with _profiling.scope("pert/fit_step"):
            if form == "device":
                _iteration_dev(loss_fn, loss_args, c, loop, const,
                               _form(loop, it) == "diag")
            else:
                # the chunk's entry state stays as it was (the controlled
                # loop keeps it for its best-loss checkpoint and its
                # exact emergency save); the planes each later iteration
                # steps are the chunk's own, so they step in place: one
                # generation of the pi parameter and its moments fewer
                # on the card
                c = _iteration(loss_fn, loss_args, c, it, loop, const,
                               in_place=k > 0, mesh=mesh)
        if probe is not None:
            probe.post(k, c.done)
    return c, stop - i0


def _launch_chunk_graphed(loss_fn, loss_args, c: _Carry, i0: int, stop: int,
                          loop: _Loop, const, probe, programs: _FitPrograms):
    """:func:`_launch_chunk` by graph replays: the program (its forms
    captured at their first use), the entry state copied in, one replay
    per iteration, the state copied out."""
    forms = sorted({_form(loop, it) for it in range(i0, stop)})
    prog = programs.program(c, loss_args, const, forms)
    try:
        with prog.lock:
            prog.after_last()
            prog.bind(c, loss_args, const, i0)
            if probe is not None:
                probe.seen = 0
            launched = stop - i0
            for k, it in enumerate(range(i0, stop)):
                if probe is not None and probe.stopped(k):
                    launched = k
                    break
                with _profiling.scope("pert/fit_step"):
                    prog.replay(_form(loop, it))
                if probe is not None:
                    probe.post(k, prog.static.done)
            out = prog.snapshot()
            prog.mark_last()
        programs.replays += launched
        return out, launched
    finally:
        programs.scope.store.done_with(prog)


@dataclasses.dataclass
class _ChunkRead:
    i: int
    converged: bool
    is_nan: bool
    losses: np.ndarray          # losses[:stop]
    diag: Optional[np.ndarray]  # (DIAG_RING, 3) or None


def _read_chunk(c: _Carry, stop: int) -> _ChunkRead:
    """The chunk's one device-to-host copy: count, flags, the loss
    history up to ``stop`` and the ring, packed into one float32
    vector (the count is exact in float32 far beyond any budget)."""
    parts = [torch.stack([c.i.to(torch.float32),
                          c.converged.to(torch.float32),
                          c.is_nan.to(torch.float32)]), c.losses[:stop]]
    if c.diag is not None:
        parts.append(c.diag.reshape(-1))
    host = torch.cat(parts).cpu().numpy()
    diag = host[3 + stop:].reshape(DIAG_RING, 3) if c.diag is not None \
        else None
    return _ChunkRead(int(host[0]), bool(host[1]), bool(host[2]),
                      host[3:3 + stop].copy(), diag)


# ---------------------------------------------------------------------------
# the slab: one launch per iteration for W fits (continuous batching)
# ---------------------------------------------------------------------------
#
# ``_run_fit_chunk_slab`` is the chunk of ``_launch_chunk`` over a
# leading lane axis (JAX ``_run_fit_chunk_slab``, a ``jax.vmap`` of the
# chunk program): W same-shaped fits (the serving bucket ladder pads a
# rung's requests to one shape) advance together, each lane with its own
# parameters, Adam state, loss history, ring and loss arguments and its
# own ``i0``/``stop``/``min_iter``/``rel_tol``/learning rate.  Each
# iteration evaluates the objective of every lane in one
# ``torch.func.vmap`` of the solo objective (the fused enumeration's
# vmap rule launches the block-axis kernels once for all W lanes, as the
# Pallas call's batching rule does under ``jax.vmap``), takes the
# gradient of the lanes' summed losses (each lane's own gradient: the
# lanes share nothing) and steps every lane's pi parameter in one
# lane-axis Adam launch, with one row of [lr, bias corrections, live]
# per lane.  A lane is live at iteration k of the slab while k < stop -
# i0 and its fit has not stopped; a lane with ``stop == i0`` is parked:
# the live gate writes its parameters and moments through and its loss
# history and ring are left alone, bit for bit.  Lanes never exchange
# values, but a packed lane's reductions may order differently from a
# solo fit's, so packed lanes are held to a tolerance and only a group
# of one, which the coordinator sends through ``ChunkCall.solo``, is
# bit-identical with a serial fit.


def _flatten(tree, leaves: list):
    """Append ``tree``'s tensors to ``leaves`` (dicts by sorted key,
    tuples and lists in order, dataclasses field by field, objects with
    ``slab_state()``/``from_slab_state()`` through their state) and
    return the hashable skeleton that :func:`_unflatten` rebuilds it
    from; any other value (None, numbers, strings) is part of the
    skeleton."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return ("T",)
    if isinstance(tree, dict):
        return ("d", tuple((k, _flatten(tree[k], leaves))
                           for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return ("t" if isinstance(tree, tuple) else "l",
                tuple(_flatten(x, leaves) for x in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return ("c", type(tree), tuple(
            (f.name, _flatten(getattr(tree, f.name), leaves))
            for f in dataclasses.fields(tree)))
    if hasattr(tree, "slab_state"):
        return ("o", type(tree), _flatten(tree.slab_state(), leaves))
    return ("v", tree)


def _unflatten(skel, leaves):
    """The tree of ``skel`` with its tensors taken in order from the
    iterator ``leaves`` (see :func:`_flatten`)."""
    kind = skel[0]
    if kind == "T":
        return next(leaves)
    if kind == "d":
        return {k: _unflatten(sk, leaves) for k, sk in skel[1]}
    if kind in ("t", "l"):
        out = [_unflatten(sk, leaves) for sk in skel[1]]
        return tuple(out) if kind == "t" else out
    if kind == "c":
        return skel[1](**{k: _unflatten(sk, leaves) for k, sk in skel[2]})
    if kind == "o":
        return skel[1].from_slab_state(_unflatten(skel[2], leaves))
    return skel[1]


def _abstract_sig(tree):
    """The pack-compatibility key of a tree: its skeleton and each
    tensor's shape, dtype and device."""
    leaves: list = []
    skel = _flatten(tree, leaves)
    return skel, tuple((tuple(t.shape), t.dtype, str(t.device))
                       for t in leaves)


def slab_pack(blocks):
    """Stack per-lane trees (equal skeletons and shapes) along a new
    leading lane axis."""
    cols, skel = [], None
    for block in blocks:
        leaves: list = []
        skel = _flatten(block, leaves)
        cols.append(leaves)
    return _unflatten(skel, iter([torch.stack(col) for col in zip(*cols)]))


def slab_block(slab, index: int):
    """Lane ``index`` of a slab tree (the lane axis dropped; views)."""
    leaves: list = []
    skel = _flatten(slab, leaves)
    return _unflatten(skel, iter([t[index] for t in leaves]))


def slab_fill(slab, index: int, block):
    """A copy of ``slab`` with lane ``index`` replaced by ``block`` (the
    refill of a vacated lane); ``slab`` itself is left as it is."""
    leaves: list = []
    skel = _flatten(slab, leaves)
    fresh: list = []
    _flatten(block, fresh)
    out = []
    for t, b in zip(leaves, fresh):
        t = t.clone()
        t[index] = b
        out.append(t)
    return _unflatten(skel, iter(out))


def _lane_table(i0s, stops, min_iters, win, buf_len, diag_every, dev):
    """The slab's per-iteration, per-lane host facts as one (6, K, W)
    int64 device tensor made by one copy: the loss slot each lane writes
    at iteration k (clamped into the buffer for lanes past their stop),
    whether it is still within its chunk, whether it samples the ring and
    into which slot, whether the convergence test applies, and where its
    window starts."""
    W, K = len(i0s), max(max(s - i for i, s in zip(i0s, stops)), 0)
    tab = np.zeros((6, K, W), np.int64)
    for b, (i0, stop, mi) in enumerate(zip(i0s, stops, min_iters)):
        for k in range(K):
            it = i0 + k
            active = k < stop - i0
            tab[0, k, b] = min(it, buf_len - 1)
            tab[1, k, b] = active
            tab[2, k, b] = active and bool(diag_every) \
                and it % diag_every == 0
            tab[3, k, b] = (it // diag_every) % DIAG_RING if diag_every \
                else 0
            tab[4, k, b] = active and it >= mi
            tab[5, k, b] = min(max(it - win, 0), buf_len - win)
    return tab, torch.as_tensor(tab, device=dev)


def _run_fit_chunk_slab(loss_fn: Callable, params0: dict,
                        opt_state0: AdamState, losses0: torch.Tensor,
                        diag0: Optional[torch.Tensor], i0, stop, min_iter,
                        rel_tol, lr, loss_args: tuple, conv_window: int,
                        b1: float, b2: float, diag_every: int,
                        moment_dtype: str = "float32"):
    """Advance W stacked fits by one chunk each (see the section comment):
    lane b runs iterations ``i0[b] .. stop[b]-1`` from fresh stop flags.
    ``params0``/``opt_state0``/``losses0``/``diag0``/``loss_args`` carry
    the lanes on their leading axis (``slab_pack``), ``i0``, ``stop``,
    ``min_iter``, ``rel_tol`` and ``lr`` are per-lane host lists.  Reads
    nothing back (on the card the host peeks, without waiting, at whether
    every lane has stopped).  Returns ``(i, params, opt_state, losses,
    diag, converged, is_nan, launched)``: the per-lane (W,) iteration
    counts and flags and the stacked state as device tensors, and the
    slab iterations launched."""
    dev = losses0.device
    W, buf_len = losses0.shape
    i0, stop = [int(x) for x in i0], [int(x) for x in stop]
    tab_host, tab = _lane_table(i0, stop, [int(x) for x in min_iter],
                                conv_window, buf_len, diag_every, dev)
    K = tab_host.shape[1]
    ar = torch.arange(W, device=dev)
    win_off = torch.arange(conv_window, device=dev)
    tol = torch.as_tensor(np.asarray(rel_tol, np.float32), device=dev)
    const = torch.as_tensor(np.asarray(
        [[x, b1, b2] for x in lr], np.float32), device=dev)
    pi = pi_param_name(params0)
    keys = list(params0)
    arg_leaves: list = []
    arg_skel = _flatten(tuple(loss_args), arg_leaves)

    def lane_loss(p_leaves, a_leaves):
        args = _unflatten(arg_skel, iter(a_leaves))
        return loss_fn(dict(zip(keys, p_leaves)), *args)

    batched_loss = torch.func.vmap(lane_loss)
    flag = dict(dtype=torch.bool, device=dev)
    # the stacked state is this function's to replace: the first Adam
    # step frees the entry copies
    params, state = dict(params0), opt_state0
    del params0, opt_state0
    losses, diag = losses0, diag0
    i_dev = torch.as_tensor(np.asarray(i0, np.int32), device=dev)
    done = torch.as_tensor(np.asarray(
        [s <= i for i, s in zip(i0, stop)]), device=dev)
    converged = torch.zeros((W,), **flag)
    is_nan_f = torch.zeros((W,), **flag)
    probe = _StopProbe(K) if dev.type == "cuda" and K else None
    launched = 0
    for k in range(K):
        if probe is not None and probe.stopped(k):
            break
        live = torch.logical_and(tab[1, k].bool(), torch.logical_not(done))
        leaves = [params[key].detach().requires_grad_(True) for key in keys]
        loss = batched_loss(leaves, arg_leaves)
        grads = torch.autograd.grad(loss.sum(), leaves, allow_unused=True)
        with torch.no_grad():
            grads = {key: (g if g is not None else torch.zeros_like(x))
                     for key, x, g in zip(keys, leaves, grads)}
            loss = loss.detach().to(torch.float32)
            if diag is not None and tab_host[2, k].any():
                row = torch.stack([loss, _lane_norm(grads, W),
                                   _lane_norm(params, W)], dim=1)
                slot = tab[3, k]
                rec = torch.logical_and(live, tab[2, k].bool())
                diag[ar, slot] = torch.where(rec[:, None], row,
                                             diag[ar, slot])
            scal = adam_scalars(const, state.count + 1, live)
            new_p, new_m, new_v = {}, {}, {}
            for key in keys:
                args = (params[key], grads[key], state.mu[key],
                        state.nu[key], scal, b1, b2)
                # the pi parameter's stacked planes are this slab's own
                # copies: stepped in place, as no one else reads them
                new_p[key], new_m[key], new_v[key] = (
                    adam_update(*args, moment_dtype, in_place=True)
                    if key == pi else adam_update_plain(*args))
            state = AdamState(count=state.count + live.to(torch.int32),
                              mu=new_m, nu=new_v)
            params = new_p
            slot = tab[0, k]
            losses[ar, slot] = torch.where(live, loss, losses[ar, slot])
            nan = torch.isnan(loss)
            stop_now = nan
            if tab_host[4, k].any():
                window = losses[ar[:, None], tab[5, k][:, None] + win_off]
                stat = window.max(dim=1).values - window.min(dim=1).values
                conv = torch.logical_and(
                    stat / torch.abs(losses[:, 0] - loss) < tol,
                    tab[4, k].bool())
                stop_now = torch.logical_or(nan, conv)
                converged = torch.logical_or(
                    converged, torch.logical_and(live, conv))
            i_dev = i_dev + live.to(torch.int32)
            done = torch.logical_or(done, torch.logical_and(live, stop_now))
            is_nan_f = torch.logical_or(is_nan_f,
                                        torch.logical_and(live, nan))
        launched = k + 1
        if probe is not None:
            rest = tab[1, k + 1].bool() if k + 1 < K \
                else torch.zeros((W,), **flag)
            probe.post(k, torch.all(torch.logical_or(
                done, torch.logical_not(rest))))
    return (i_dev, params, state, losses, diag, converged, is_nan_f,
            launched)


def _lane_norm(tree: dict, W: int) -> torch.Tensor:
    """(W,) :func:`_global_norm` of each lane of a stacked tree."""
    return torch.sqrt(sum(torch.sum((tree[k] * tree[k]).reshape(W, -1),
                                    dim=1) for k in sorted(tree)))


_CHUNK_DISPATCHER_TLS = threading.local()


def set_chunk_dispatcher(dispatcher) -> None:
    """Install (None clears) this thread's chunk dispatcher (JAX
    ``set_chunk_dispatcher``): an object with ``dispatch(call:
    ChunkCall)``, which returns what ``call.solo(call.args)`` returns,
    and ``fit_begin()``/``fit_end()``, which the controlled loop calls
    around each fit so the dispatcher knows how many threads are
    fitting.  Thread-local: the serving worker's block threads opt in
    one by one, and nothing else ever sees a dispatcher."""
    _CHUNK_DISPATCHER_TLS.dispatcher = dispatcher


def get_chunk_dispatcher():
    """This thread's chunk dispatcher, or None (the default)."""
    return getattr(_CHUNK_DISPATCHER_TLS, "dispatcher", None)


@dataclasses.dataclass
class ChunkCall:
    """One chunk of a controlled fit, reified for a dispatcher (JAX
    ``ChunkCall``).

    ``args`` is ``(params, opt_state, losses, diag, i0, stop, min_iter,
    rel_tol, lr, loss_args)``: the chunk's state (tensors, and the
    ring), its host integers and floats, and the loss arguments.
    ``solo(args)`` runs it alone and returns ``(carry, launched,
    read)``; ``signature()`` is the pack-compatibility key: calls pack
    into one slab only when the loss function, the statics and every
    tensor's shape, dtype and device agree, and never when the loss
    function says it is not ``packable`` (then the key is the call's
    own, and the coordinator runs it alone).  ``meter`` is ``(ledger,
    context snapshot)`` taken on the lane's own thread, so the slab's
    leader books each lane's share into that lane's ledger (None:
    unmetered)."""

    loss_fn: Callable
    args: tuple
    static_kwargs: dict
    solo: Callable
    meter: Optional[tuple] = None

    def signature(self):
        if not getattr(self.loss_fn, "packable", True):
            return ("alone", id(self))
        try:
            lf = hash(self.loss_fn)
        except TypeError:
            lf = id(self.loss_fn)
        state = (self.args[0], self.args[1], self.args[2], self.args[3],
                 self.args[9])
        return (lf, tuple(sorted(self.static_kwargs.items())),
                _abstract_sig(state))


def dispatch_chunk_slab(calls, width: int, timings: Optional[dict] = None):
    """Advance every call's lane in one slab launch per iteration and
    read the host once; returns one ``(carry, launched, read)`` per call,
    in order (JAX ``dispatch_chunk_slab``).

    The slab runs at the power-of-two width at or above the live lane
    count (2, 4, 8, ...; ``width`` is the caller's cap), its vacancies
    parked copies of the lead lane (``stop == i0``, results dropped).
    The calls must share one ``ChunkCall.signature()``.  Each call's
    loss arguments are primed first (``loss_fn.prime``, when the loss
    function has one), so their caches stack with the rest."""
    W = 2
    while W < len(calls):
        W *= 2
    lead = calls[0]
    prime = getattr(lead.loss_fn, "prime", None)
    if prime is not None:
        for c in calls:
            prime(*c.args[9])
    lanes = [c.args for c in calls]
    lanes += [lead.args[:5] + (lead.args[4],) + lead.args[6:]] \
        * (W - len(calls))
    sk = dict(lead.static_kwargs)
    diag = None if lanes[0][3] is None \
        else slab_pack([a[3] for a in lanes])
    t0 = time.perf_counter()
    (i_dev, params, state, losses, diag, conv, nan,
     launched) = _run_fit_chunk_slab(
        lead.loss_fn, slab_pack([a[0] for a in lanes]),
        slab_pack([a[1] for a in lanes]), slab_pack([a[2] for a in lanes]),
        diag, [a[4] for a in lanes], [a[5] for a in lanes],
        [a[6] for a in lanes], [a[7] for a in lanes], [a[8] for a in lanes],
        slab_pack([tuple(a[9]) for a in lanes]), **sk)
    stop_max = max(a[5] for a in lanes[:len(calls)])
    parts = [torch.stack([i_dev.to(torch.float32), conv.to(torch.float32),
                          nan.to(torch.float32)], dim=1),
             losses[:, :stop_max]]
    if diag is not None:
        parts.append(diag.reshape(W, -1))
    host = torch.cat(parts, dim=1).cpu().numpy()
    if timings is not None:
        timings["slab_width"] = W
        timings["launched"] = launched
        timings["seconds"] = time.perf_counter() - t0
    out = []
    for b, call in enumerate(calls):
        stop_b = call.args[5]
        read = _ChunkRead(
            int(host[b, 0]), bool(host[b, 1]), bool(host[b, 2]),
            host[b, 3:3 + stop_b].copy(),
            host[b, 3 + stop_max:].reshape(DIAG_RING, 3).copy()
            if diag is not None else None)
        # views into the stacked outputs, as JAX's slab_block: a copy
        # per lane would double the stacked state at every boundary; a
        # lane's later chunks make new planes before they step any in
        # place, so no lane writes into another's
        carry = _Carry(
            params=slab_block(params, b), state=slab_block(state, b),
            losses=losses[b], diag=diag[b] if diag is not None else None)
        out.append((carry, min(launched, stop_b - call.args[4]), read))
    return out


def _decode_diag(diag: np.ndarray, num_iters: int, i0: int,
                 diag_every: int) -> dict:
    """Map ring slots back to the iterations they sampled (JAX
    ``_decode_diag``): the multiples of ``diag_every`` in ``[i0,
    num_iters)``, the last ``DIAG_RING`` of them, slot ``(iter //
    diag_every) % DIAG_RING`` each."""
    first = -(-i0 // diag_every) * diag_every  # ceil to a multiple
    sampled = list(range(first, num_iters, diag_every))
    kept = sampled[-DIAG_RING:]
    rows = [(it // diag_every) % DIAG_RING for it in kept]
    return {
        "every": diag_every,
        "iter": np.asarray(kept, np.int64),
        "loss": diag[rows, 0] if kept else np.zeros(0, np.float32),
        "grad_norm": diag[rows, 1] if kept else np.zeros(0, np.float32),
        "param_norm": diag[rows, 2] if kept else np.zeros(0, np.float32),
    }


def _diagnose(losses: np.ndarray, converged: bool, nan_abort: bool,
              diagnostics: Optional[dict],
              thresholds: Optional[dict]) -> dict:
    """Convergence-doctor report of one completed fit (JAX
    ``_diagnose``)."""
    grad = diagnostics["grad_norm"] if diagnostics is not None \
        and len(diagnostics.get("grad_norm", ())) else None
    return _doctor.diagnose_fit(
        losses, converged=converged, nan_abort=nan_abort,
        grad_norm_first=float(grad[0]) if grad is not None else None,
        grad_norm_last=float(grad[-1]) if grad is not None else None,
        **dict(thresholds or {}))


def _perturb_params(params: dict, scale: float, seed: int, salt: int,
                    noise: Optional[dict] = None, mesh=None) -> dict:
    """Re-seed perturbation around a checkpointed parameter dict (JAX
    ``_perturb_params``): each leaf plus ``scale * (std(leaf) + 1e-3)``
    times standard normal noise.  ``noise`` ({name: tensor of the global
    leaf's shape}) supplies the draws; by default they come from a host
    generator seeded by ``(seed, salt)``, one global leaf after another
    in sorted-key order, so the same run re-seeds the same way on any
    grid.  With ``mesh`` each leaf is this rank's block: the std is the
    global leaf's and the noise is tiled like the leaf (the global draws
    stay on the host)."""
    dev = next(iter(params.values())).device
    if noise is None:
        gen = seeded_generator(seed, salt, "cpu")
        noise = {}
        for k in sorted(params):
            shape = params[k].shape
            if mesh is not None:
                box = mesh.box(layout.param_dims(k), shape)
                shape = shape if box is None else box[1]
            noise[k] = torch.randn(shape, generator=gen,
                                   dtype=torch.float32)
    out = {}
    with torch.no_grad():
        for k, leaf in params.items():
            draw = noise[k] if mesh is None \
                else mesh.tile(noise[k], layout.param_dims(k))
            std = torch.std(leaf, correction=0) if mesh is None \
                else mesh.leaf_std(k, leaf)
            out[k] = leaf + scale * (std + 1e-3) * draw.to(leaf.device)
    return out


def _result(params, state, losses_np, n, converged, nan_abort, wall,
            dispatched, diag_np, diag_every, thresholds, decisions,
            budget, diag_i0: int = 0, programs=None) -> FitResult:
    losses = (losses_np[:n] if losses_np is not None
              else np.zeros(0, np.float32)).astype(np.float32)
    diagnostics = None
    if diag_every:
        diagnostics = _decode_diag(
            diag_np if diag_np is not None
            else np.zeros((DIAG_RING, 3), np.float32), n, diag_i0,
            diag_every)
    health = _diagnose(losses, converged, nan_abort, diagnostics,
                       thresholds)
    timings = {"fit": wall, "ms_per_iter": 1e3 * wall / max(n, 1),
               "dispatched": dispatched}
    if programs is not None:
        # graph captures (each after its warm-up iterations on the
        # program's own buffers) and replays
        timings.update(captures=programs.captures,
                       replays=programs.replays, warmups=programs.warmups)
    return FitResult(
        params={k: v.detach() for k, v in params.items()},
        losses=losses, num_iters=n, converged=converged,
        nan_abort=nan_abort, opt_state=state, timings=timings,
        diagnostics=diagnostics, verdict=health["verdict"], health=health,
        decisions=decisions, budget=int(budget),
        programs=list(programs.events) if programs is not None else [])


def _state_to(state: AdamState, dev) -> AdamState:
    """An Adam state (a checkpoint's, restored on any device) on ``dev``."""
    return AdamState(count=state.count.to(dev),
                     mu={k: v.to(dev) for k, v in state.mu.items()},
                     nu={k: v.to(dev) for k, v in state.nu.items()})


def _loss_buffer(length: int, losses_prefix, dev):
    """(float32 device loss history of ``length`` zeros with the prefix
    written in front, the prefix length)."""
    losses = torch.zeros((length,), dtype=torch.float32, device=dev)
    i0 = 0
    if losses_prefix is not None and len(losses_prefix) > 0:
        i0 = min(int(len(losses_prefix)), length)
        losses[:i0] = torch.as_tensor(
            np.asarray(losses_prefix[:i0], np.float32), device=dev)
    return losses, i0


def fit_map(loss_fn: Callable, params0: dict, loss_args: tuple = (),
            max_iter: int = 2000, min_iter: int = 100, rel_tol: float = 1e-6,
            learning_rate: float = 0.05, b1: float = 0.8, b2: float = 0.99,
            opt_state0: Optional[AdamState] = None,
            losses_prefix: Optional[np.ndarray] = None,
            device=None, moment_dtype: str = "float32",
            diag_every: int = 0, doctor_thresholds: Optional[dict] = None,
            controller=None, escalate_dir: Optional[str] = None,
            escalate_tag: str = "fit", checkpoint_every: int = 0,
            checkpoint_cb=None, resume_state: Optional[dict] = None,
            chunk_deadline: Optional[float] = None) -> FitResult:
    """Fit ``params`` by MAP ascent of ``-loss_fn`` with the reference's
    stop semantics, for at most ``max_iter`` iterations.

    ``loss_fn(params, *loss_args) -> scalar tensor``.  ``params0`` (a
    dict of float32 tensors, not modified) is copied to ``device`` (see
    ``device.resolve_device``: the GPU unless ``'cpu'`` is passed), where
    ``loss_args`` must already lie.  ``diag_every = K > 0`` records the
    ring every K iterations and reads the host every K;
    ``doctor_thresholds`` overrides the doctor's window/slope_tol/
    var_tol/grad_ratio.  ``controller`` (an
    ``obs.controller.ControllerPolicy``; needs ``diag_every > 0``) runs
    the adaptive chunk loop, whose decisions land on
    ``FitResult.decisions``.

    Resume (JAX ``fit_map``): pass a previous partial fit's Adam state
    as ``opt_state0`` and its losses as ``losses_prefix``; the fit
    continues from iteration ``len(losses_prefix)`` on the trajectory
    the uninterrupted fit would have taken (the loop is deterministic
    given params, Adam state and loss history).

    Durability (the controlled loop only, as in JAX):
    ``checkpoint_every = N`` calls ``checkpoint_cb`` every N completed
    chunks, and on any exception escaping the loop, with the state an
    exact mid-fit resume needs (params, Adam state, loss prefix and the
    controller's ledger, ``resume_state``'s keys); ``resume_state``
    restores that ledger; a NaN escalation saves the best-loss state as
    ``{escalate_tag}_nan`` under ``escalate_dir``; ``chunk_deadline``
    bounds each chunk's launches and read (``utils.faults.
    run_with_deadline``); the fault site ``{escalate_tag}/chunk`` fires
    at the top of every pass.
    """
    dev = resolve_device(device)
    # no copy: a chunk makes new planes before it steps any in place, so
    # the fit writes none of the tensors it is handed
    params = {k: v.detach().to(dev) for k, v in params0.items()}
    loop = _Loop(min_iter=int(min_iter), rel_tol=float(rel_tol),
                 win=min(9, int(max_iter)), diag_every=int(diag_every),
                 b1=float(b1), b2=float(b2), moment_dtype=moment_dtype)
    if controller is not None and diag_every:
        return _fit_map_controlled(
            loss_fn, params, opt_state0, loss_args, int(max_iter),
            float(learning_rate), loop, doctor_thresholds, controller,
            losses_prefix=losses_prefix, resume_state=resume_state,
            escalate_dir=escalate_dir, escalate_tag=escalate_tag,
            checkpoint_every=checkpoint_every, checkpoint_cb=checkpoint_cb,
            chunk_deadline=chunk_deadline)
    losses, i0 = _loss_buffer(int(max_iter), losses_prefix, dev)
    carry = _Carry(params, _start_state(params, opt_state0, loop), losses,
                   torch.zeros((DIAG_RING, 3), dtype=torch.float32,
                               device=dev) if diag_every else None)
    const = adam_constants(learning_rate, b1, b2, dev)
    every = loop.diag_every or HOST_READ_EVERY
    probe = _stop_probe(loss_fn, every, dev)
    programs = _FitPrograms.of(loss_fn, dev, "fit", loop)
    i_host, dispatched = i0, 0
    read = None
    t0 = time.perf_counter()
    while i_host < max_iter:
        stop = min(i_host + every, int(max_iter))
        carry, launched = _launch_chunk(loss_fn, loss_args, carry, i_host,
                                        stop, loop, const, probe, programs)
        dispatched += launched
        read = _read_chunk(carry, stop)
        i_host = read.i
        if read.converged or read.is_nan:
            break
    wall = time.perf_counter() - t0
    losses_np = read.losses if read else (
        np.asarray(losses_prefix[:i0], np.float32) if i0 else None)
    return _result(carry.params, carry.state, losses_np, i_host,
                   bool(read and read.converged), bool(read and read.is_nan),
                   wall, dispatched, read.diag if read else None,
                   loop.diag_every, doctor_thresholds, [], max_iter,
                   diag_i0=i0, programs=programs)


def _host_copy(tree):
    """Host copy of a tensor, a dict of tensors or an Adam state (NumPy
    passes through), or None when the copy fails: after a CUDA error the
    context is unusable and no device tensor can be read."""
    if tree is None:
        return None

    def one(x):
        return x.detach().cpu() if isinstance(x, torch.Tensor) \
            else np.asarray(x)
    try:
        if isinstance(tree, AdamState):
            return AdamState(count=one(tree.count),
                             mu={k: one(v) for k, v in tree.mu.items()},
                             nu={k: one(v) for k, v in tree.nu.items()})
        if isinstance(tree, dict):
            return {k: one(v) for k, v in tree.items()}
        return one(tree)
    except Exception:  # noqa: BLE001 — this IS the probe: None says the
        # state is unreadable, which the caller reports as inexact
        return None


def _emergency_save(checkpoint_cb, snap: dict) -> None:
    """Best-effort resumable save on the way out of an escaping
    exception, from the chunk loop's snapshot (JAX ``_emergency_save``).

    The port donates nothing, and a chunk writes only its loss buffer
    and ring in place, whose host copies from the last read the snapshot
    holds: after a host-side exception anywhere in the loop (a
    preemption, a watchdog timeout, a failed launch) the snapshot is the
    last chunk boundary's state and the save is exact.  After a CUDA
    error the context is unusable: the copies fail, and the save
    degrades as JAX's does after a mid-chunk failure — the best-loss
    params without Adam state (``exact=False``), or nothing when those
    cannot be read either."""
    if checkpoint_cb is None or not snap:
        return
    try:
        p_np = _host_copy(snap.get("params"))
        o_np = _host_copy(snap.get("opt_state"))
        i_host = int(snap.get("i_host", 0))
        best_it = int(snap.get("best_it", 0))
        l = snap.get("losses_np")
        l_np = np.asarray(l[:i_host]) if l is not None \
            else np.zeros(0, np.float32)
        live = p_np is not None
        if not live:
            p_np, o_np = _host_copy(snap.get("best_params")), None
            l_np = l_np[:best_it]
        if p_np is None:
            return
        # the ring's host copy belongs to the live state: a save rewound
        # to best_it restarts the ring there, so the doctor reads only
        # the resumed segment
        diag_np = snap.get("diag") if live else None
        state = {
            "reseeds": int(snap.get("reseeds", 0)),
            "extra_granted": int(snap.get("extra_granted", 0)),
            "nan_retries": int(snap.get("nan_retries", 0)),
            "lr": float(snap.get("lr", 0.0)),
            "budget": int(snap.get("budget", 0)),
            "stagnation_anchor": int(snap.get("stagnation_anchor", 0)),
            "prev_verdict": snap.get("prev_verdict"),
            "best_loss": float(snap.get("best_loss", float("inf"))),
            "best_it": best_it,
            "best_params": _host_copy(snap.get("best_params")),
            "diag": diag_np if diag_np is not None
            else np.zeros((DIAG_RING, 3), np.float32),
            "diag_i0": int(snap.get("diag_i0", 0))
            if diag_np is not None else int(len(l_np)),
        }
        # coordinated=False: a dying rank must not wait on peers that
        # may be mid-chunk or dead (a sharded save then writes only its
        # own shard, which stays invisible without a commit)
        checkpoint_cb(params=p_np, opt_state=o_np, losses=l_np,
                      num_iters=int(len(l_np)), state=state,
                      exact=o_np is not None, coordinated=False)
    except Exception as exc:  # noqa: BLE001 — the original abort must
        # surface, not a failed rescue save
        logger.warning("emergency checkpoint save failed: %s", exc)


def _save_escalation_checkpoint(escalate_dir, tag, params, losses,
                                num_iters: int, mesh=None) -> Optional[str]:
    """Persist the best-loss state of a NaN-escalated fit (diagnosable
    artifact for the post-mortem); best-effort — a failed save must not
    mask the escalation itself."""
    if not escalate_dir:
        return None
    try:
        return _ckpt.save_step(str(escalate_dir), f"{tag}_nan", params,
                               np.asarray(losses), num_iters=num_iters,
                               converged=False, nan_abort=True, mesh=mesh)
    except Exception as exc:  # noqa: BLE001 — telemetry-adjacent path
        logger.warning("NaN-escalation checkpoint save failed: %s", exc)
        return None


def _start_state(params: dict, opt_state0: Optional[AdamState],
                 loop: _Loop) -> AdamState:
    """A fit's first Adam state: a resumed one on the parameters' device,
    else zeros.  Only the carry holds it, so the first chunk's new planes
    replace it on the card."""
    dev = next(iter(params.values())).device
    return _state_to(opt_state0, dev) if opt_state0 is not None \
        else make_opt_state(params, loop.moment_dtype)


def _fit_map_controlled(loss_fn: Callable, params: dict,
                        opt_state0: Optional[AdamState],
                        loss_args: tuple, max_iter: int,
                        learning_rate: float, loop: _Loop,
                        doctor_thresholds: Optional[dict], policy,
                        losses_prefix=None,
                        resume_state: Optional[dict] = None,
                        escalate_dir: Optional[str] = None,
                        escalate_tag: str = "fit",
                        checkpoint_every: int = 0, checkpoint_cb=None,
                        chunk_deadline: Optional[float] = None
                        ) -> FitResult:
    """The adaptive chunk loop (JAX ``_fit_map_controlled`` and
    ``_chunk_loop``).

    Each chunk is ``diag_every`` iterations (fewer at a budget edge),
    then one host read.  Between chunks: the best-loss checkpoint at
    chunk granularity (the params that entered a chunk scored its first
    loss; they stay alive, one extra params copy); a NaN chunk asks the
    policy to escalate, and a retry restarts from the best checkpoint
    with fresh Adam state at ``nan_lr_factor`` times the learning rate;
    the reference's criterion ends the fit; otherwise the policy reads
    the loss tail and the ring's gradient norms and may early-stop
    (handing back the best checkpoint when the final state is worse),
    extend the budget, or re-seed from the best checkpoint.

    The chunk boundaries are the durability points (see :func:`fit_map`):
    at the top of a pass every carry is the last chunk's output and
    every decision on the completed chunks is applied, so a save there
    replays the uninterrupted run's remaining chunks and decisions.  The
    saves read that boundary's tensors (a later chunk makes new ones)
    and the host copies of its read; each heartbeat note follows a
    chunk's outcome, as do the ``fit/chunk`` span (with a tracer on the
    thread's run log) and, for a chunk run alone, its booking in the
    run's cost ledger.

    With a chunk dispatcher installed on the thread
    (:func:`set_chunk_dispatcher`, the serving worker's slab
    coordinator) every chunk goes to it as a :class:`ChunkCall`, and
    ``fit_begin``/``fit_end`` bracket the loop; the coordinator then
    books the chunks it packs, each lane its share."""
    dev = next(iter(params.values())).device
    every = loop.diag_every
    resume_state = dict(resume_state or {})
    # the loss buffer holds the larger of the configured and a resumed
    # (already extended) budget plus the full extension headroom
    buf_len = max(max_iter, int(resume_state.get("budget", 0))) \
        + max(int(policy.max_extra_iters), 0)
    losses, i0 = _loss_buffer(buf_len, losses_prefix, dev)
    # diag_i0 anchors the ring's slot -> iteration mapping: the fit's
    # start, or for a resumed fit with a restored ring the original
    # fit's, so the doctor reads the window an uninterrupted run would
    diag_host = np.zeros((DIAG_RING, 3), np.float32)
    diag_i0 = i0
    if resume_state.get("diag") is not None:
        diag_host = np.asarray(resume_state["diag"], np.float32)
        diag_i0 = int(resume_state.get("diag_i0", 0))
    carry = _Carry(params, _start_state(params, opt_state0, loop), losses,
                   torch.as_tensor(diag_host, device=dev).clone())
    lr_now = float(resume_state.get("lr", learning_rate))
    const = adam_constants(lr_now, loop.b1, loop.b2, dev)
    probe = _stop_probe(loss_fn, every, dev)
    i_host, dispatched = i0, 0
    budget = int(resume_state.get("budget", max_iter))
    decisions: list = []
    reseeds = int(resume_state.get("reseeds", 0))
    extra_granted = int(resume_state.get("extra_granted", 0))
    nan_retries = int(resume_state.get("nan_retries", 0))
    converged_flag = nan_flag = False
    best_loss = float(resume_state.get("best_loss", float("inf")))
    best_it = int(resume_state.get("best_it", i0))
    best_params = params
    if resume_state.get("best_params") is not None:
        best_params = _ckpt.restore_params(resume_state["best_params"], dev)
    prev_verdict = resume_state.get("prev_verdict") or None
    # iteration the current trajectory regime began at: 0 for a fresh
    # or resumed fit, bumped by reseed / NaN retry
    stagnation_anchor = int(resume_state.get("stagnation_anchor", 0))
    fault_site = f"{escalate_tag}/chunk"
    # the host copies of the last read (a resumed fit starts from its
    # restored prefix, so an abort before the first read does not
    # supersede the iteration-N checkpoint with a zero-iteration one)
    losses_np = None
    entry_losses = np.asarray(losses_prefix[:i0], np.float32) if i0 \
        else None
    snap: dict = {}
    chunks_done = 0
    chunk_t0 = chunk_t1 = 0.0
    # taken once per fit: the dispatcher seam and the run log are the
    # thread's, and a fit never changes engines midway
    dispatcher = get_chunk_dispatcher()
    run_log = _runlog.current()
    ledger = _meter.ledger_of(run_log)
    tracer = getattr(run_log, "tracer", None)
    static_kwargs = dict(conv_window=loop.win, b1=loop.b1, b2=loop.b2,
                         diag_every=every, moment_dtype=loop.moment_dtype)
    # the run's store, taken once per fit too: a chunk may run on the
    # watchdog's thread or a slab coordinator's
    programs = _FitPrograms.of(loss_fn, dev, "chunk", loop)

    def _note(entry_it, i_now, action, verdict=None):
        """One chunk outcome into the heartbeat (a no-op without one),
        the run's cost ledger (a chunk run alone; the slab coordinator
        books packed ones) and the ``fit/chunk`` span."""
        _heartbeat.note_chunk(
            step=escalate_tag, chunk=chunks_done, iteration=int(i_now),
            budget=int(budget), wall_seconds=chunk_t1 - chunk_t0,
            iters=int(i_now) - int(entry_it), action=str(action),
            verdict=verdict)
        if dispatcher is None and ledger is not None:
            # a NaN rewind books i_now below the step's high-water mark,
            # which the ledger counts as retry_refit
            ledger.book_chunk(entry_it=int(entry_it), end_it=int(i_now),
                              wall_seconds=chunk_t1 - chunk_t0)
        if tracer is not None:
            attrs = dict(chunk=chunks_done, iter_start=int(entry_it),
                         iter_end=int(i_now), action=str(action))
            if verdict:
                attrs["verdict"] = str(verdict)
            tracer.record_span("fit/chunk", chunk_t0, chunk_t1, **attrs)

    def _ledger():
        return {"reseeds": reseeds, "extra_granted": extra_granted,
                "nan_retries": nan_retries, "lr": lr_now, "budget": budget,
                "stagnation_anchor": stagnation_anchor,
                "prev_verdict": prev_verdict, "best_loss": best_loss,
                "best_it": best_it, "best_params": best_params,
                "diag": diag_host, "diag_i0": diag_i0}

    t0 = time.perf_counter()
    if dispatcher is not None:
        # the loss arguments' fit-constant caches, filled now, are part
        # of every chunk's pack signature
        prime = getattr(loss_fn, "prime", None)
        if prime is not None:
            prime(*loss_args)
        dispatcher.fit_begin()
    try:
        while i_host < budget:
            snap.update(params=carry.params, opt_state=carry.state,
                        losses_np=losses_np if losses_np is not None
                        else entry_losses, i_host=i_host, **_ledger())
            # periodic durability point, at the top of the pass (saving
            # before the decisions on the last chunk would make the
            # resumed run skip one and diverge); the cadence counts
            # dispatched chunks, so saving never perturbs the fit
            if checkpoint_cb is not None and checkpoint_every \
                    and chunks_done and losses_np is not None \
                    and chunks_done % int(checkpoint_every) == 0:
                checkpoint_cb(params=carry.params, opt_state=carry.state,
                              losses=losses_np[:i_host], num_iters=i_host,
                              state=_ledger(), exact=True)
            # every carry is a live chunk output here, so a simulated
            # preemption aborts with exactly-resumable state
            poison = _faults.point(fault_site) == "nan"
            entry_params, entry_it = carry.params, i_host
            stop = min(i_host + every, budget)

            def _solo(args, const=const):
                c = _Carry(args[0], args[1], args[2], args[3])
                c, launched = _launch_chunk(loss_fn, loss_args, c, args[4],
                                            args[5], loop, const, probe,
                                            programs)
                # the read waits for the card INSIDE the deadline: a
                # stalled chunk is the hang the watchdog exists for
                return c, launched, _read_chunk(c, args[5])

            def _dispatch(c=carry, i=i_host, stop=stop, lr=lr_now):
                args = (c.params, c.state, c.losses, c.diag, i, stop,
                        loop.min_iter, loop.rel_tol, lr, loss_args)
                if dispatcher is None:
                    return _solo(args)
                return dispatcher.dispatch(ChunkCall(
                    loss_fn=loss_fn, args=args, static_kwargs=static_kwargs,
                    solo=_solo,
                    meter=(ledger, ledger.ctx_snapshot())
                    if ledger is not None else None))

            chunk_t0 = time.time()
            carry, launched, read = _faults.run_with_deadline(
                _dispatch, chunk_deadline, f"{escalate_tag} fit chunk",
                device=dev)
            chunk_t1 = time.time()
            dispatched += launched
            chunks_done += 1
            i_host = read.i
            losses_np, diag_host = read.losses, read.diag
            converged_flag, nan_flag = read.converged, read.is_nan
            if poison:
                # the injected-NaN fault: poison the chunk's last loss
                # so everything downstream of detection (escalation,
                # diagnosable checkpoint, reduced-LR retry, rewind) is
                # the real machinery
                losses_np[max(i_host - 1, 0)] = np.nan
                nan_flag = True
            traj = losses_np[:i_host]
            entry_loss = float(losses_np[entry_it])
            if entry_it < i_host and np.isfinite(entry_loss) \
                    and entry_loss < best_loss:
                best_loss, best_params, best_it = entry_loss, entry_params, \
                    entry_it

            if nan_flag:
                decision = dict(_controller.decide(
                    policy, losses=traj, it=i_host, budget=budget,
                    min_iter=loop.min_iter, nan=True,
                    nan_retries_done=nan_retries))
                prev_verdict = None
                # the artifact is self-consistent: best_params belong to
                # iteration best_it, so it records THAT prefix
                ckpt_path = _save_escalation_checkpoint(
                    escalate_dir, escalate_tag, best_params,
                    traj[:best_it], num_iters=best_it,
                    mesh=getattr(loss_fn, "mesh", None))
                if ckpt_path:
                    decision["detail"] = (decision.get("detail", "")
                                          + f"; checkpoint saved to "
                                            f"{ckpt_path}")
                decisions.append(decision)
                _note(entry_it, i_host, decision.get("action", "escalate"),
                      verdict="nan")
                if decision.get("outcome") != "retry":
                    break
                nan_retries += 1
                lr_now = lr_now * float(policy.nan_lr_factor)
                const = adam_constants(lr_now, loop.b1, loop.b2, dev)
                carry = dataclasses.replace(
                    carry, params=best_params,
                    state=make_opt_state(best_params, loop.moment_dtype))
                # redo from the checkpointed iteration: the poisoned
                # entries beyond it are overwritten as the retry re-runs
                i_host = stagnation_anchor = best_it
                nan_flag = False
                continue

            if converged_flag:
                _note(entry_it, i_host, "converged")
                break  # the reference's own rel-tol criterion fired

            d = _decode_diag(diag_host, i_host, diag_i0, every)
            grad = d["grad_norm"] if len(d["iter"]) else None
            decision, prev_verdict = _controller.evaluate(
                policy, losses=traj, it=i_host, budget=budget,
                min_iter=loop.min_iter,
                grad_norm_first=float(grad[0]) if grad is not None else None,
                grad_norm_last=float(grad[-1]) if grad is not None else None,
                exhausted=i_host >= budget, reseeds_done=reseeds,
                extra_granted=extra_granted, prev_verdict=prev_verdict,
                stagnation_start=stagnation_anchor)
            if decision is None:
                _note(entry_it, i_host, "continue", verdict=prev_verdict)
                continue
            action = decision["action"]
            _note(entry_it, i_host, action,
                  verdict=(decision.get("trigger") or {}).get("verdict"))
            if action == "early_stop":
                if best_loss < float(traj[-1]):
                    carry = dataclasses.replace(carry, params=best_params)
                    decision["detail"] = (
                        f"restored the best-loss checkpoint (iter {best_it}"
                        f", loss {best_loss:.6g}) — the final state was "
                        f"worse (loss {float(traj[-1]):.6g})")
                converged_flag = True
                decisions.append(decision)
                break
            decisions.append(decision)
            if action == "extend":
                grant = int(decision["iters_granted"])
                budget += grant
                extra_granted += grant
            elif action == "reseed":
                reseeds += 1
                new_params = _perturb_params(
                    best_params, policy.reseed_scale, policy.seed, reseeds,
                    mesh=getattr(loss_fn, "mesh", None))
                carry = dataclasses.replace(
                    carry, params=new_params,
                    state=make_opt_state(new_params, loop.moment_dtype))
                # a new trajectory regime: instability must re-prove
                # itself and the stagnation stop measures the restart on
                # its own
                prev_verdict = None
                stagnation_anchor = i_host
    except BaseException:
        _emergency_save(checkpoint_cb, snap)
        raise
    finally:
        if dispatcher is not None:
            dispatcher.fit_end()
    wall = time.perf_counter() - t0
    if losses_np is None and entry_losses is not None:
        losses_np = entry_losses
    return _result(carry.params, carry.state, losses_np, i_host,
                   converged_flag, nan_flag, wall, dispatched, diag_host,
                   every, doctor_thresholds, decisions, budget,
                   diag_i0=diag_i0, programs=programs)
