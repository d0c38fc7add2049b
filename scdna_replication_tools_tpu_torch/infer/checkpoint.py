"""Checkpointing of fitted parameters + optimizer state (port of
``infer/checkpoint.py``, single-process format v4).

After each step, and every ``checkpoint_every`` chunks inside a
controlled fit, the runner persists the fitted (unconstrained)
parameters, the Adam state, the loss history, a small meta record
(iterations run, converged flag, topology stamp) and, in a fit, the
controller's resume state, as one flat ``.npz``.  The file is the JAX
package's, key for key and dtype for dtype, so either package loads what
the other wrote and a partial step resumes there:

* ``param.<name>`` float32 arrays (``pi_logits`` state-major, format
  v2); ``losses``; ``meta.format_version`` / ``num_iters`` /
  ``converged`` / ``nan_abort`` / ``topology`` (a JSON string) /
  ``opt_moment_dtype``;
* ``opt.N``: the Adam state in the order optax flattens
  ``(ScaleByAdamState(count, mu, nu), EmptyState())`` — ``opt.0`` the
  int32 step count, then every ``mu`` leaf by sorted parameter name,
  then every ``nu`` leaf the same way;
* bfloat16 leaves (the pi moments under
  ``optimizer_state_dtype='bfloat16'``) as their uint16 bit views with a
  ``leafdtype.<key>`` sidecar saying ``bfloat16`` (npz has no
  bfloat16): the writer takes ``Tensor.view`` to int16, the reader
  ``numpy.view`` back, bit for bit both ways;
* ``extra.ctrl.*`` / ``extra.best.*``: the controller's resume state
  (:func:`pack_controller_state`).

Durability contract (restart-critical state, so every write is
paranoid):

* **atomic commit** — the npz is serialised in memory and written to a
  temp file in the same directory, then ``os.replace``d into place, so a
  preemption mid-write never leaves a torn file under the canonical
  name;
* **integrity footer** — 48 trailing bytes (magic ``PERTCK01`` + payload
  length + sha256 of the payload) after the zip payload (the zip EOCD
  scan tolerates trailing data).  :func:`load_step` verifies length and
  digest before parsing anything, so truncation or corruption surfaces
  as a typed :class:`CheckpointCorrupt` naming the file;
* **bounded retention** — each save rotates the previous good file to
  ``pert_<step>.prev.npz`` first; a corrupt newest checkpoint, or a
  canonical file that a crash between rotation and commit left missing,
  falls back to that predecessor.

Resume semantics (``runner.PertInference._load_resumable``): a COMPLETED
step (converged, NaN-aborted, or out of budget) is restored as-is and
not refit; a PARTIAL step resumes from the saved iteration with the Adam
moments and the controller's state intact, so the resumed trajectory is
the uninterrupted run's, bit for bit.

Loaded arrays are NumPy, except bfloat16 leaves, which come back as CPU
``torch.bfloat16`` tensors (NumPy itself has no bfloat16 dtype);
:func:`restore_opt_state` rebuilds the port's
``AdamState`` on a device from them.

Sharded runs (more than one rank, ``parallel.mesh.RankMesh``) save as
the JAX package's multi-process runs do, a **two-phase commit**: every
rank writes its block of each sharded leaf (``range.<key>`` /
``gshape.<key>`` sidecars give its box in the global array; replicated
leaves are whole) to ``pert_<step>.s<seq>.p<k>of<n>.npz``, then a
barrier, then rank 0 commits the generation pointer
``pert_<step>.commit.json`` (with the previous generation's files as a
fallback).  Shards without a commit pointing at them are invisible, so a
kill anywhere in the window leaves the previous complete generation.  An
emergency save on the way out of an exception writes its shard only
(``coordinate=False``): a dying rank cannot ask its peers to meet.
:func:`load_step` merges a committed generation into full host arrays,
whoever wrote it, and the runner slices them for its own grid: a
generation written on two ranks resumes on one and the reverse, in
either package.
"""

from __future__ import annotations

import glob
import hashlib
import io
import json
import os
import re
import struct
from typing import Optional

import numpy as np
import torch

from scdna_replication_tools_tpu_torch import layout
from scdna_replication_tools_tpu_torch.infer.manifest import atomic_write_bytes
from scdna_replication_tools_tpu_torch.utils import faults as _faults
from scdna_replication_tools_tpu_torch.utils.profiling import logger

# Format history (the JAX package's):
#   v4  topology stamp (meta.topology) in every save; multi-process saves
#       write per-host shard files plus a commit pointer
#   v3  integrity footer; optional ctrl.* / best.* extras
#   v2  pi_logits stored STATE-MAJOR (P, cells, loci)
#   v1  (never stamped) pi_logits cells-major — or, for some snapshots,
#       state-major without a stamp: an unstamped 3-D pi_logits is
#       ambiguous and load_step refuses it rather than guess
CHECKPOINT_FORMAT_VERSION = 4

# integrity footer: magic(8) + little-endian payload length(8) + sha256(32)
_FOOTER_MAGIC = b"PERTCK01"
_FOOTER_LEN = len(_FOOTER_MAGIC) + 8 + 32


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file failed integrity verification or parsing.

    Carries the offending ``path`` so operators (and the run-log event
    the runner emits) can name the artifact to delete or investigate.
    """

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason


def _step_path(checkpoint_dir: str, step: str) -> str:
    return os.path.join(checkpoint_dir, f"pert_{step}.npz")


def _prev_path(path: str) -> str:
    root, ext = os.path.splitext(path)
    return f"{root}.prev{ext}"


def _commit_path(checkpoint_dir: str, step: str) -> str:
    return os.path.join(checkpoint_dir, f"pert_{step}.commit.json")


# ---------------------------------------------------------------------------
# topology stamp + host views
# ---------------------------------------------------------------------------


def topology_stamp(device=None, mesh=None) -> dict:
    """JSON-able record of the save-time topology, with the JAX package's
    keys: process count/index, the device count and kind of ``device``
    (the CPU when None), the mesh's axes (``{}`` without one) and every
    parameter's layout (``layout.param_layouts``).  A resume compares
    ``mesh_axes`` and ``process_count`` with its own to tell a
    same-geometry restore from a resharding one."""
    from scdna_replication_tools_tpu_torch.parallel.distributed import (
        process_topology,
    )
    from scdna_replication_tools_tpu_torch.parallel.mesh import loci_axis

    stamp = {"format": 1}
    stamp.update(process_topology(mesh, device))
    stamp["param_layouts"] = layout.param_layouts(loci_axis(mesh))
    return stamp


def _shard_path(checkpoint_dir: str, step: str, seq: int, k: int,
                n: int) -> str:
    return os.path.join(checkpoint_dir,
                        f"pert_{step}.s{seq}.p{k}of{n}.npz")


def _device_of(*trees) -> Optional[torch.device]:
    """The device of the first tensor leaf of ``trees`` (dicts), or None."""
    for tree in trees:
        for leaf in (tree or {}).values():
            if isinstance(leaf, torch.Tensor):
                return leaf.device
    return None


def opt_leaves(opt_state) -> list:
    """The Adam state's leaves in optax's flattening order: the count,
    then ``mu`` by sorted parameter name, then ``nu`` the same way."""
    return ([opt_state.count]
            + [opt_state.mu[k] for k in sorted(opt_state.mu)]
            + [opt_state.nu[k] for k in sorted(opt_state.nu)])


def _flat_add(flat: dict, key: str, leaf, dims=(), mesh=None) -> None:
    """Record one leaf under ``key`` as a host array: a tensor takes one
    copy to the host, and a bfloat16 tensor is stored as its uint16 bit
    view with a ``leafdtype.`` sidecar (npz has no bfloat16).  With
    ``mesh`` a leaf of symbolic ``dims`` that the grid shards is this
    rank's block, recorded with its global box and shape."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[key] = t.contiguous().view(torch.int16).numpy() \
                .view(np.uint16)
            flat[f"leafdtype.{key}"] = np.asarray("bfloat16")
        else:
            flat[key] = t.numpy()
    else:
        flat[key] = np.asarray(leaf)
    placed = mesh.box(dims, flat[key].shape) if mesh is not None else None
    if placed is not None:
        flat[f"range.{key}"] = np.asarray(placed[0], np.int64)
        flat[f"gshape.{key}"] = np.asarray(placed[1], np.int64)


def _encode_payload(flat: dict) -> bytes:
    """npz bytes + integrity footer: serialised in memory so the footer
    hashes exactly the bytes that land on disk."""
    buf = io.BytesIO()
    np.savez(buf, **flat)
    payload = buf.getvalue()
    footer = (_FOOTER_MAGIC + struct.pack("<Q", len(payload))
              + hashlib.sha256(payload).digest())
    return payload + footer


def save_step(checkpoint_dir: str, step: str, params: dict,
              losses, extra: Optional[dict] = None, opt_state=None,
              num_iters: Optional[int] = None, converged: bool = True,
              nan_abort: bool = False, mesh=None,
              coordinate: bool = True) -> str:
    """Persist one step's state; returns the path written.

    ``params``/``extra`` leaves may be tensors on any device or NumPy
    arrays; ``opt_state`` is an ``infer.svi.AdamState``.  One rank: the
    previous good ``pert_<step>.npz`` is rotated to ``.prev`` first, the
    new one committed atomically with its integrity footer, and the
    ``{step}/save`` fault site fires after the commit (``corrupt``
    truncates the new file).  Several ranks (``mesh``, this rank's
    blocks): the two-phase commit of the module docstring, or with
    ``coordinate=False`` its first phase alone.
    """
    from scdna_replication_tools_tpu_torch.parallel.distributed import (
        process_rank_and_count,
    )

    os.makedirs(checkpoint_dir, exist_ok=True)
    kproc, nproc = process_rank_and_count()
    flat: dict = {}
    for k, v in params.items():
        _flat_add(flat, f"param.{k}", v, layout.param_dims(k), mesh)
    flat["losses"] = np.asarray(losses)
    flat["meta.format_version"] = np.asarray(CHECKPOINT_FORMAT_VERSION)
    flat["meta.num_iters"] = np.asarray(
        num_iters if num_iters is not None else len(losses))
    flat["meta.converged"] = np.asarray(bool(converged))
    flat["meta.nan_abort"] = np.asarray(bool(nan_abort))
    flat["meta.topology"] = np.asarray(json.dumps(
        topology_stamp(_device_of(params), mesh)))
    if opt_state is not None:
        # the summary meta.opt_moment_dtype is what the runner's resume
        # gate compares against the configured dtype
        moment_dtype = "float32"
        names = [None] + sorted(opt_state.mu) + sorted(opt_state.nu)
        for i, leaf in enumerate(opt_leaves(opt_state)):
            _flat_add(flat, f"opt.{i}", leaf, layout.param_dims(names[i])
                      if names[i] else (), mesh)
            if f"leafdtype.opt.{i}" in flat:
                moment_dtype = "bfloat16"
        flat["meta.opt_moment_dtype"] = np.asarray(moment_dtype)
    for k, v in (extra or {}).items():
        dims = layout.param_dims(k[len("best."):]) \
            if k.startswith("best.") else ()
        _flat_add(flat, f"extra.{k}", v, dims, mesh)
    if nproc > 1:
        return _save_step_multiprocess(checkpoint_dir, step, flat, nproc,
                                       kproc, mesh, _device_of(params),
                                       coordinate=coordinate)

    # atomic commit with retention — rotate the previous good file aside
    # BEFORE replacing it, so a corrupt new file (partial write + crash,
    # or the injected corruption fault) always leaves a fallback
    path = _step_path(checkpoint_dir, step)
    blob = _encode_payload(flat)
    if os.path.exists(path):
        try:
            os.replace(path, _prev_path(path))
        except OSError as exc:
            logger.warning("checkpoint retention: could not rotate %s "
                           "(%s)", path, exc)
    atomic_write_bytes(path, blob)
    # a fresh single-file save supersedes any sharded generation a
    # multi-process run committed for this step: retire its pointer
    commit = _commit_path(checkpoint_dir, step)
    if os.path.exists(commit):
        try:
            os.replace(commit, commit + ".superseded")
        except OSError as exc:
            logger.warning("could not retire superseded sharded "
                           "checkpoint commit %s (%s)", commit, exc)
    if _faults.point(f"{step}/save") == "corrupt":
        _faults.corrupt_file(path)
    return path


def _read_commit(checkpoint_dir: str, step: str) -> Optional[dict]:
    """The step's sharded-generation commit pointer, or None."""
    path = _commit_path(checkpoint_dir, step)
    try:
        with open(path) as fh:
            doc = json.load(fh)
        if not isinstance(doc, dict) or "files" not in doc:
            raise ValueError("not a checkpoint commit document")
        return doc
    except FileNotFoundError:
        return None
    except (OSError, ValueError) as exc:
        logger.warning("checkpoint commit %s is unreadable (%s) — the "
                       "sharded generation it pointed at is not "
                       "loadable", path, exc)
        return None


def _save_step_multiprocess(checkpoint_dir: str, step: str, flat: dict,
                            nproc: int, kproc: int, mesh=None, device=None,
                            coordinate: bool = True) -> str:
    """Phase 1: every rank atomically writes its shard file.  Barrier.
    Phase 2: rank 0 atomically commits the generation pointer, retires
    a single file a one-rank attempt left, and drops generations older
    than the previous one; a last barrier, so a rank that saves again
    at once sees this generation's seq.  ``coordinate=False``: phase 1
    only (JAX ``_save_step_multiprocess``)."""
    from scdna_replication_tools_tpu_torch.parallel.distributed import (
        barrier,
    )

    prev_doc = _read_commit(checkpoint_dir, step)
    seq = int(prev_doc["seq"]) + 1 if prev_doc else 1
    path = _shard_path(checkpoint_dir, step, seq, kproc, nproc)
    atomic_write_bytes(path, _encode_payload(flat))
    if _faults.point(f"{step}/save") == "corrupt":
        _faults.corrupt_file(path)
    if not coordinate:
        logger.warning(
            "emergency (uncoordinated) checkpoint save for %s: wrote this "
            "rank's shard %s but did NOT commit — the generation stays "
            "invisible; resume uses the last committed one", step,
            os.path.basename(path))
        return path
    barrier(f"pert-ckpt/{step}/s{seq}/written")
    if kproc == 0:
        doc = {
            "format": 1,
            "seq": seq,
            "process_count": nproc,
            "files": [os.path.basename(
                _shard_path(checkpoint_dir, step, seq, j, nproc))
                for j in range(nproc)],
            "topology": topology_stamp(device, mesh),
        }
        if prev_doc:
            doc["prev"] = {"seq": int(prev_doc["seq"]),
                           "files": list(prev_doc["files"])}
        atomic_write_bytes(_commit_path(checkpoint_dir, step),
                           json.dumps(doc, indent=1).encode())
        stale_single = _step_path(checkpoint_dir, step)
        if os.path.exists(stale_single):
            try:
                os.replace(stale_single, stale_single + ".superseded")
            except OSError as exc:
                logger.warning("could not retire superseded single-file "
                               "checkpoint %s (%s)", stale_single, exc)
        keep = {seq} | ({int(prev_doc["seq"])} if prev_doc else set())
        for old in glob.glob(os.path.join(
                checkpoint_dir, f"pert_{step}.s*.p*of*.npz")):
            m = re.search(r"\.s(\d+)\.p\d+of\d+\.npz$", old)
            if m and int(m.group(1)) not in keep:
                try:
                    os.unlink(old)
                except OSError:
                    pass
    barrier(f"pert-ckpt/{step}/s{seq}/committed")
    return path


def quarantine_stale(checkpoint_dir: str) -> int:
    """Rename every ``pert_*.npz`` (and retained ``.prev``, and any
    sharded-generation commit pointer) aside to ``*.stale`` — called
    when the resume ledger is voided (fingerprint mismatch under
    ``resume='auto'``, or ``resume='off'``).  Resetting the ledger alone
    is not enough: once the NEW identity lands in the manifest a later
    run would fingerprint-verify and restore params fitted to OTHER
    data.  Renaming (not deleting) keeps the forensic artifact while
    guaranteeing no loader reads it; returns the count moved."""
    moved = 0
    try:
        stale = glob.glob(os.path.join(checkpoint_dir, "pert_*.npz")) \
            + glob.glob(os.path.join(checkpoint_dir, "pert_*.commit.json"))
        for path in stale:
            try:
                os.replace(path, path + ".stale")
                moved += 1
            except OSError as exc:
                logger.warning("could not quarantine stale checkpoint "
                               "%s (%s)", path, exc)
    except OSError as exc:
        logger.warning("stale-checkpoint quarantine failed in %s (%s)",
                       checkpoint_dir, exc)
    if moved:
        logger.warning("quarantined %d stale checkpoint file(s) in %s "
                       "(renamed to *.stale)", moved, checkpoint_dir)
    return moved


def _verify_and_read(path: str) -> dict:
    """Verify the integrity footer and parse the npz into a dict; raises
    :class:`CheckpointCorrupt` on any failure.  Pre-v3 files (no footer)
    parse unverified."""
    try:
        with open(path, "rb") as fh:
            blob = fh.read()
    except OSError as exc:
        raise CheckpointCorrupt(path, f"unreadable ({exc})")
    if len(blob) >= _FOOTER_LEN \
            and blob[-_FOOTER_LEN:-_FOOTER_LEN + len(_FOOTER_MAGIC)] \
            == _FOOTER_MAGIC:
        footer = blob[-_FOOTER_LEN:]
        (length,) = struct.unpack(
            "<Q", footer[len(_FOOTER_MAGIC):len(_FOOTER_MAGIC) + 8])
        payload = blob[:-_FOOTER_LEN]
        if len(payload) != length:
            raise CheckpointCorrupt(
                path, f"truncated: footer records {length} payload "
                      f"bytes, file has {len(payload)}")
        if hashlib.sha256(payload).digest() != footer[-32:]:
            raise CheckpointCorrupt(path, "sha256 mismatch (bit rot or "
                                          "partial overwrite)")
    else:
        payload = blob   # pre-v3: no footer to verify
    try:
        with np.load(io.BytesIO(payload)) as data:
            return {k: data[k] for k in data.files}
    except Exception as exc:  # noqa: BLE001 — zipfile/ValueError/pickle
        # zoo: the typed error IS this except block's purpose
        raise CheckpointCorrupt(
            path, f"unparseable npz ({type(exc).__name__}: {exc})")


def _merge_generation(flats: list) -> dict:
    """One flat checkpoint mapping from a generation's shard files (JAX
    ``_merge_generation``): a leaf without a ``range.`` sidecar is the
    same in every file (the first copy wins); a sharded one is placed
    block by block at its recorded box in a zero array of its global
    shape (blocks that copies of one box wrote land on the same place)."""
    merged: dict = {}
    keys = list(dict.fromkeys(k for flat in flats for k in flat))
    for key in keys:
        if key.startswith("range.") or key.startswith("gshape."):
            continue
        range_key = f"range.{key}"
        if not any(range_key in flat for flat in flats):
            merged[key] = next(flat[key] for flat in flats if key in flat)
            continue
        out = None
        for flat in flats:
            if key not in flat:
                continue
            block = flat[key]
            if range_key not in flat:
                out = np.array(block)
                break
            box = np.asarray(flat[range_key])
            if out is None:
                gshape = tuple(int(v) for v in flat[f"gshape.{key}"])
                out = np.zeros(gshape, block.dtype)
            out[tuple(slice(int(lo), int(hi)) for lo, hi in box)] = block
        merged[key] = out
    return merged


def _load_sharded(checkpoint_dir: str, step: str, doc: dict):
    """Load and merge one committed sharded generation, falling back to
    the retained previous generation when a file of the committed one
    fails verification (JAX ``_load_sharded``)."""
    def read_gen(files):
        return [_verify_and_read(os.path.join(checkpoint_dir, name))
                for name in files]

    try:
        flats = read_gen(doc["files"])
    except CheckpointCorrupt as exc:
        prev = doc.get("prev")
        if not prev:
            raise
        logger.warning("%s — falling back to the retained previous "
                       "sharded generation (seq %s)", exc, prev.get("seq"))
        try:
            flats = read_gen(prev["files"])
        except CheckpointCorrupt:
            raise exc from None   # report the NEWEST generation
    return _unpack(_commit_path(checkpoint_dir, step),
                   _merge_generation(flats))


def load_step(checkpoint_dir: str, step: str):
    """Returns (params, losses, extra), or None if no checkpoint exists.

    ``extra`` carries the ``meta.*`` record (with the parsed
    ``meta.topology`` stamp), any ``opt.N`` optimizer leaves (rebuild the
    state with :func:`restore_opt_state`) and any ``ctrl.*``/``best.*``
    controller resume state.  A corrupt newest file falls back to the
    retained ``.prev`` checkpoint (with a warning), as does a canonical
    file that is missing beside its ``.prev``; when no fallback survives
    verification either, raises :class:`CheckpointCorrupt` for the
    NEWEST file — the caller decides whether a fresh refit is
    acceptable.  A step committed as a sharded generation is merged into
    full arrays, whatever grid wrote it; when a single file and a
    committed generation are both there, the newer wins (the single file
    on an mtime tie: JAX ``load_step``'s rule).
    """
    path = _step_path(checkpoint_dir, step)
    doc = _read_commit(checkpoint_dir, step)
    if doc is not None and os.path.exists(path):
        try:
            if os.path.getmtime(path) >= os.path.getmtime(
                    _commit_path(checkpoint_dir, step)):
                doc = None
        except OSError:
            doc = None
    if doc is not None:
        return _load_sharded(checkpoint_dir, step, doc)
    if not os.path.exists(path):
        prev = _prev_path(path)
        if os.path.exists(prev):
            # rotate-then-write crash window: the canonical file was
            # rotated aside but the replacement never committed — the
            # retained predecessor is the newest durable state
            logger.warning(
                "checkpoint %s is missing but its retained predecessor "
                "exists (crash between rotation and commit?) — "
                "restoring %s", path, prev)
            return _unpack(prev, _verify_and_read(prev))
        return None
    try:
        data = _verify_and_read(path)
    except CheckpointCorrupt as exc:
        prev = _prev_path(path)
        if not os.path.exists(prev):
            raise
        logger.warning("%s — falling back to the retained previous "
                       "checkpoint %s", exc, prev)
        try:
            data = _verify_and_read(prev)
        except CheckpointCorrupt:
            raise exc from None   # report the NEWEST file
    return _unpack(path, data)


def _bfloat16(bits: np.ndarray) -> torch.Tensor:
    """A uint16 bit view as the CPU bfloat16 tensor it stores."""
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)) \
        .view(torch.bfloat16)


def _unpack(path: str, data: dict):
    """(params, losses, extra) from a verified flat mapping."""
    params = {k[len("param."):]: data[k] for k in data
              if k.startswith("param.")}
    extra = {k[len("extra."):]: data[k] for k in data
             if k.startswith("extra.")}
    for k in data:
        if k.startswith("meta.") or k.startswith("opt."):
            extra[k] = data[k]
    # bfloat16 leaves: uint16 bit views back to bfloat16 (``optdtype.``
    # is the pre-v4 spelling of the same sidecar)
    for k in data:
        if not (k.startswith("optdtype.") or k.startswith("leafdtype.")):
            continue
        if str(data[k]) != "bfloat16":
            continue
        target = "opt." + k[len("optdtype."):] \
            if k.startswith("optdtype.") else k[len("leafdtype."):]
        if target.startswith("param."):
            name = target[len("param."):]
            if name in params:
                params[name] = _bfloat16(params[name])
        elif target.startswith("extra."):
            name = target[len("extra."):]
            if name in extra:
                extra[name] = _bfloat16(extra[name])
        elif target in extra:
            extra[target] = _bfloat16(extra[target])
    if "meta.topology" in extra:
        try:
            extra["meta.topology"] = json.loads(str(extra["meta.topology"]))
        except (TypeError, ValueError):
            extra["meta.topology"] = None
    version = int(extra.get("meta.format_version", 1))
    if version < 2 and "pi_logits" in params \
            and np.ndim(params["pi_logits"]) == 3:
        raise ValueError(
            f"{path} has no format_version stamp: its pi_logits layout is "
            "ambiguous (pre-v2 checkpoints exist in BOTH cells-major and "
            "state-major orientations) and restoring a transposed tensor "
            "would silently corrupt training — delete the stale "
            "checkpoint file and refit")
    return params, data["losses"], extra


def _to_device(leaf, device, dtype=None) -> torch.Tensor:
    t = leaf if isinstance(leaf, torch.Tensor) \
        else torch.from_numpy(np.array(leaf))
    return t.to(device=device, dtype=dtype or t.dtype)


def restore_params(params: dict, device) -> dict:
    """Loaded parameters as float32 tensors on ``device``."""
    return {k: _to_device(v, device, torch.float32)
            for k, v in params.items()}


def restore_opt_state(extra: dict, params: dict, device=None):
    """The port's ``AdamState`` on ``device`` from the flat ``opt.N``
    leaves (see the module docstring for the order), or None when the
    checkpoint holds no optimizer state.  Moments keep their stored
    dtype (bfloat16 for a bf16-moment save), the count is int32."""
    from scdna_replication_tools_tpu_torch.infer.svi import AdamState

    opt_keys = sorted((k for k in extra if k.startswith("opt.")),
                      key=lambda k: int(k.split(".", 1)[1]))
    if not opt_keys:
        return None
    names = sorted(params)
    if len(opt_keys) != 1 + 2 * len(names):
        raise ValueError(
            f"checkpoint holds {len(opt_keys)} optimizer leaves; an Adam "
            f"state over {names} has {1 + 2 * len(names)}")
    leaves = [extra[k] for k in opt_keys]
    dev = torch.device(device) if device is not None else torch.device("cpu")
    n = len(names)
    return AdamState(
        count=_to_device(np.asarray(leaves[0], np.int32), dev),
        mu={k: _to_device(leaves[1 + i], dev) for i, k in enumerate(names)},
        nu={k: _to_device(leaves[1 + n + i], dev)
            for i, k in enumerate(names)})


def restore_controller_state(extra: dict) -> Optional[dict]:
    """The controlled fit's resume state from a checkpoint's ``ctrl.*``
    / ``best.*`` extras, or None when the checkpoint holds none
    (``infer/svi.py``'s ``resume_state`` contract — the fields that make
    a mid-fit resume reproduce the uninterrupted decision trail)."""
    if "ctrl.format" not in extra:
        return None
    state = {
        "reseeds": int(extra["ctrl.reseeds"]),
        "extra_granted": int(extra["ctrl.extra_granted"]),
        "nan_retries": int(extra["ctrl.nan_retries"]),
        "lr": float(extra["ctrl.lr"]),
        "budget": int(extra["ctrl.budget"]),
        "stagnation_anchor": int(extra["ctrl.stagnation_anchor"]),
        "prev_verdict": str(extra["ctrl.prev_verdict"]) or None,
        "best_loss": float(extra["ctrl.best_loss"]),
        "best_it": int(extra["ctrl.best_it"]),
        "diag": np.asarray(extra["ctrl.diag"]),
        "diag_i0": int(extra["ctrl.diag_i0"]),
    }
    best = {k[len("best."):]: v for k, v in extra.items()
            if k.startswith("best.")}
    if best:
        state["best_params"] = best
    else:
        # an inexact emergency save may have lost the best-loss params; a
        # finite best_loss without its params would make the early-stop
        # restore hand back the WRONG state — drop the record and let the
        # resumed segment re-establish its best
        state["best_loss"] = float("inf")
        state["best_it"] = 0
    return state


def pack_controller_state(state: dict) -> dict:
    """Flatten a controlled fit's state dict into the ``extra`` keys
    :func:`restore_controller_state` reads back (tensor leaves go to the
    host in :func:`save_step`)."""
    out = {
        "ctrl.format": 1,
        "ctrl.reseeds": int(state["reseeds"]),
        "ctrl.extra_granted": int(state["extra_granted"]),
        "ctrl.nan_retries": int(state["nan_retries"]),
        "ctrl.lr": float(state["lr"]),
        "ctrl.budget": int(state["budget"]),
        "ctrl.stagnation_anchor": int(state["stagnation_anchor"]),
        "ctrl.prev_verdict": state.get("prev_verdict") or "",
        "ctrl.best_loss": float(state["best_loss"]),
        "ctrl.best_it": int(state["best_it"]),
        "ctrl.diag": state["diag"],
        "ctrl.diag_i0": int(state["diag_i0"]),
    }
    for k, v in (state.get("best_params") or {}).items():
        out[f"best.{k}"] = v
    return out
