"""Durable run manifest: the resume ledger of a checkpointed run (port of
``infer/manifest.py``).

A pile of ``pert_step*.npz`` files answers neither of the questions a
resuming process must ask: *do these checkpoints belong to THIS
workload* (same data, same experiment — restoring params fitted to
different inputs is silent corruption, not a resume), and *how far did
the previous attempt get*.  The manifest is the small JSON ledger that
answers both:

* one ``manifest.json`` per checkpoint directory, committed atomically
  (write-temp + ``os.replace`` — a preemption mid-write leaves the
  previous complete manifest, never a torn one);
* identity: the config hash (``obs.runlog._config_digest``, which hashes
  the JAX package's field set, so both packages stamp one hash for one
  setting) and a **data fingerprint** over the input arrays, equal bit
  for bit to the JAX package's on the same frames;
* progress: per-step status (``in_flight`` / ``complete``), iteration
  counts, checkpoint filenames and timestamps, plus the run-log paths of
  every attempt that touched the directory.

Resume policy (``PertConfig.resume``, ``infer/runner.py``): ``auto``
restores only when the data fingerprint matches (a config mismatch —
e.g. a grown iteration budget — is legitimate and only noted);
``force`` restores regardless; ``off`` ignores existing state.

Sharded runs (JAX's multi-host contract, over the ranks of a
``torch.distributed`` group): every rank digests what it loaded,
:func:`all_host_fingerprints` all-gathers the digests and
:func:`combined_fingerprint` dedupes them (every rank loads the full
frames, so the identity is the one-rank run's and a checkpoint written
on two ranks verifies on one); :func:`consensus_ok` makes the resume
verdict the same on every rank (any rank's refusal refuses everywhere);
rank 0 alone writes the file, the others keep their ledger in memory.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Optional, Tuple

import numpy as np

from scdna_replication_tools_tpu_torch.config import NON_HASH_FIELDS
from scdna_replication_tools_tpu_torch.utils.fileio import (  # noqa: F401
    # re-export: checkpoint.py imports the atomic-commit primitive here
    atomic_write_bytes,
)
from scdna_replication_tools_tpu_torch.utils.profiling import logger

MANIFEST_VERSION = 1
MANIFEST_NAME = "manifest.json"

# strided-subsample budget of the data fingerprint: hashing every byte
# of a 1M-cell read matrix would cost seconds per run; shape + dtype +
# a deterministic stride of <= _FP_SAMPLES elements + the exact total
# sum catches every realistic corruption/swap while staying O(ms)
_FP_SAMPLES = 65536


def data_fingerprint(*arrays, samples: int = _FP_SAMPLES) -> str:
    """Deterministic content digest of the input arrays (order matters).

    Hashes, per array: shape, dtype, a fixed-stride subsample of the
    flattened values and the float64 total sum.  Deterministic across
    processes and platforms (little-endian bytes), cheap at the
    million-cell scale, and sensitive to any global edit (the sum) or
    any localized edit that touches a sampled element.  The arrays are
    NumPy (the loader's host arrays), so the digest equals the JAX
    package's on the same frames.
    """
    digest = hashlib.sha256()
    for arr in arrays:
        if arr is None:
            digest.update(b"<none>")
            continue
        a = np.asarray(arr)
        digest.update(str(a.shape).encode())
        digest.update(str(a.dtype).encode())
        flat = a.reshape(-1)
        if flat.size:
            stride = max(1, flat.size // samples)
            sub = np.ascontiguousarray(flat[::stride])
            digest.update(sub.astype("<f8", copy=False).tobytes()
                          if sub.dtype.kind == "f"
                          else sub.astype("<i8", copy=False).tobytes()
                          if sub.dtype.kind in "iub"
                          else str(sub.tolist()).encode())
            if flat.dtype.kind in "fiub":
                digest.update(repr(float(flat.astype(np.float64).sum()))
                              .encode())
    return digest.hexdigest()[:16]


def _host_group(mesh):
    return mesh.host_group if mesh is not None else None


def all_host_fingerprints(local_fp: str, mesh=None) -> dict:
    """``{rank: fingerprint}`` over every rank (``{0: local_fp}`` with
    one): an all-gather of each rank's 16-character digest, so every
    rank returns the same map (host tensors, on ``mesh``'s host group
    when it has one)."""
    import torch
    import torch.distributed as dist

    from scdna_replication_tools_tpu_torch.parallel.distributed import (
        process_rank_and_count,
    )

    _, nproc = process_rank_and_count()
    if nproc <= 1:
        return {0: str(local_fp)}
    buf = torch.from_numpy(np.frombuffer(
        str(local_fp).encode("ascii").ljust(64), np.uint8).copy())
    out = [torch.empty_like(buf) for _ in range(nproc)]
    dist.all_gather(out, buf, group=_host_group(mesh))
    return {k: bytes(t.numpy()).decode("ascii").strip()
            for k, t in enumerate(out)}


def consensus_ok(local_ok: bool, mesh=None) -> bool:
    """AND of a per-rank verdict over every rank (the verdict itself
    with one): a split resume verdict would desynchronise the lockstep
    fit at its first collective, so any rank's refusal refuses
    everywhere — a spurious refit, never a wrong restore."""
    import torch
    import torch.distributed as dist

    from scdna_replication_tools_tpu_torch.parallel.distributed import (
        process_rank_and_count,
    )

    if process_rank_and_count()[1] <= 1:
        return bool(local_ok)
    flag = torch.tensor([1 if local_ok else 0], dtype=torch.int32)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=_host_group(mesh))
    return bool(flag.item())


def combined_fingerprint(host_fps: dict) -> str:
    """The canonical data fingerprint of ``{process_index: fingerprint}``:
    the per-host digests deduplicated, then (only when they genuinely
    differ) hashed in rank order.  With one process, or every host
    loading the same batch, it IS the local fingerprint."""
    vals = [str(host_fps[k]) for k in sorted(host_fps)]
    if len(set(vals)) == 1:
        return vals[0]
    return hashlib.sha256("|".join(vals).encode()).hexdigest()[:16]


class RunManifest:
    """The per-checkpoint-directory resume ledger (see module docstring).

    Every mutation saves atomically; load failures degrade to an empty
    manifest (a corrupt/missing ledger must not block a run — it only
    forfeits resume verification, which the runner reports).
    """

    def __init__(self, directory, doc: Optional[dict] = None):
        self.directory = str(directory)
        self.path = os.path.join(self.directory, MANIFEST_NAME)
        self.doc = doc if doc is not None else self._empty()

    @staticmethod
    def _empty() -> dict:
        return {"manifest_version": MANIFEST_VERSION, "runs": [],
                "steps": {}}

    @classmethod
    def load(cls, directory) -> "RunManifest":
        path = os.path.join(str(directory), MANIFEST_NAME)
        try:
            with open(path) as fh:
                doc = json.load(fh)
            if not isinstance(doc, dict) or "steps" not in doc:
                raise ValueError("not a manifest document")
        except FileNotFoundError:
            doc = None
        except (OSError, ValueError) as exc:
            logger.warning(
                "checkpoint manifest %s is unreadable (%s) — resume "
                "verification unavailable for this directory", path, exc)
            doc = None
        return cls(directory, doc)

    # -- identity ---------------------------------------------------------

    def match(self, config_hash: Optional[str],
              fingerprint: Optional[str],
              host_fingerprint: Optional[str] = None,
              process_index: Optional[int] = None) -> Tuple[bool, str]:
        """(data_ok, reason) against the manifest's recorded identity.

        ``data_ok`` is the resume gate: True only when the recorded data
        fingerprint exists and matches.  The reason string also reports
        a config-hash drift (informational — budgets legitimately grow
        between a partial run and its resume).

        ``host_fingerprint``/``process_index`` arm the per-host
        fallback: when the combined digest drifted but this rank's own
        data digests what the same rank recorded, on as many ranks as
        recorded them, this rank's data is verified.
        """
        recorded_fp = self.doc.get("data_fingerprint")
        recorded_cfg = self.doc.get("config_hash")
        if recorded_fp is None:
            return False, "no recorded data fingerprint (legacy or " \
                          "fresh checkpoint directory)"
        if fingerprint != recorded_fp:
            hosts = self.doc.get("host_fingerprints") or {}
            recorded_n = int(self.doc.get("fingerprint_process_count",
                                          len(hosts)) or len(hosts))
            from scdna_replication_tools_tpu_torch.parallel.distributed \
                import process_rank_and_count

            same_shape = process_rank_and_count()[1] == recorded_n
            if same_shape and host_fingerprint is not None \
                    and process_index is not None \
                    and hosts.get(str(int(process_index))) \
                    == str(host_fingerprint):
                return True, (f"per-host data fingerprint verified for "
                              f"process {int(process_index)} (combined "
                              f"digest drifted: manifest {recorded_fp}, "
                              f"current {fingerprint})")
            return False, (f"data fingerprint mismatch (manifest "
                           f"{recorded_fp}, current {fingerprint}) — "
                           f"checkpoints belong to different input data")
        if config_hash is not None and recorded_cfg is not None \
                and config_hash != recorded_cfg:
            return True, (f"data verified; config hash differs (manifest "
                          f"{recorded_cfg}, current {config_hash}) — "
                          f"e.g. a changed budget; resuming the same data")
        return True, "data fingerprint verified"

    def begin_run(self, config_hash: Optional[str],
                  fingerprint: Optional[str],
                  run_log_path: Optional[str] = None,
                  reset_steps: bool = False,
                  host_fingerprints: Optional[dict] = None) -> None:
        """Record this attempt's identity (and its run-log path) in the
        ledger; ``reset_steps`` drops the step statuses (the fingerprint
        changed — the old checkpoints are not resumable state);
        ``host_fingerprints`` (several ranks) records the per-rank map
        behind the combined digest for ``match``'s per-host fallback."""
        if reset_steps:
            self.doc["steps"] = {}
        self.doc["manifest_version"] = MANIFEST_VERSION
        self.doc["config_hash"] = config_hash
        # which fields the hash does NOT cover (config.NON_HASH_FIELDS):
        # a future reader comparing hashes across code versions can tell
        # whether the exclusion contract itself changed between runs
        self.doc["hash_excludes"] = sorted(NON_HASH_FIELDS)
        self.doc["data_fingerprint"] = fingerprint
        if host_fingerprints is not None and len(host_fingerprints) > 1:
            self.doc["host_fingerprints"] = {
                str(int(k)): str(v)
                for k, v in sorted(host_fingerprints.items())}
            self.doc["fingerprint_process_count"] = len(host_fingerprints)
        else:
            self.doc.pop("host_fingerprints", None)
            self.doc.pop("fingerprint_process_count", None)
        runs = self.doc.setdefault("runs", [])
        runs.append({"started_unix": round(time.time(), 3),
                     "pid": os.getpid(),
                     "run_log": run_log_path,
                     "config_hash": config_hash})
        del runs[:-20]   # bounded: the last 20 attempts are plenty
        self.save()

    def note_run_log(self, run_log_path: Optional[str]) -> None:
        """Record the run-log path of this attempt once its log exists
        (a runner driven without the facade opens its log in ``run``,
        after ``begin_run``)."""
        runs = self.doc.get("runs") or []
        if runs and run_log_path and runs[-1].get("run_log") is None:
            runs[-1]["run_log"] = run_log_path
            self.save()

    # -- step ledger ------------------------------------------------------

    def step(self, name: str) -> Optional[dict]:
        return self.doc.get("steps", {}).get(name)

    def update_step(self, name: str, status: str,
                    num_iters: Optional[int] = None,
                    checkpoint: Optional[str] = None,
                    **extra) -> None:
        entry = self.doc.setdefault("steps", {}).setdefault(name, {})
        entry["status"] = status
        entry["updated_unix"] = round(time.time(), 3)
        if num_iters is not None:
            entry["num_iters"] = int(num_iters)
        if checkpoint is not None:
            entry["checkpoint"] = str(checkpoint)
        entry.update(extra)
        self.save()

    # -- persistence ------------------------------------------------------

    def save(self) -> None:
        """Atomic commit; never raises (a read-only checkpoint mount
        degrades to an unverifiable-but-working run, mirroring the run
        log's never-abort discipline).  Rank 0 only in a sharded run:
        every rank keeps its ledger current in memory, one commits the
        shared file."""
        from scdna_replication_tools_tpu_torch.parallel.distributed import (
            process_rank_and_count,
        )

        if process_rank_and_count()[0] != 0:
            return
        try:
            blob = json.dumps(self.doc, indent=1, sort_keys=True)
            atomic_write_bytes(self.path, blob.encode())
        except (OSError, TypeError, ValueError) as exc:
            logger.warning("could not write checkpoint manifest %s (%s)",
                           self.path, exc)
