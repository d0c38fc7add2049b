"""The compiled-program store (port of ``infer/aotcache.py``).

The JAX store keeps each fit chunk's compiled XLA executable, in RAM
and serialized on disk.  The port's counterparts of those programs live
in two layers:

* **RAM: the captured CUDA graphs.**  A fit chunk of the port replays
  one ``torch.cuda.CUDAGraph`` per iteration (``infer/svi.py``); the
  graph, its static buffers and its memory pool are a program of this
  store, keyed by the JAX key's components (:data:`KEY_COMPONENTS`).  A
  CUDA graph cannot leave its process, so this layer does not persist:
  every process captures its own, once per program.
* **Disk: the kernel libraries the graphs launch.**  Each library that
  ``ops/_cuda.py`` builds is saved under the store's directory as one
  atomic record (the ``.so`` bytes and the facts it was built for: the
  source digest, the nvcc flags, the nvcc, torch and CUDA versions, the
  device kind and the compute capability), so a fresh process on the
  same directory loads every library without running nvcc.

Key contract: a digest is a SHA-256 over the canonical key text, the
environment facts and the behavioural config digest (the config hash
over the complement of ``config.NON_HASH_FIELDS``, less
``config.AOT_EXECUTION_ONLY_FIELDS``).  The facts are checked again at
load: a version or device mismatch is a miss, and the entry stays.  A
record that does not read back (truncated, corrupt, a payload whose
digest differs) is renamed ``*.bad`` and misses, so its library is
built again.  The directory is LRU-by-mtime capped at ``max_entries``.

Scope: the JAX store switches itself on for the whole process.  The
port's is scoped to a run (:func:`run_scope`, entered by
``PertInference.run``), or to a serving worker's life
(:func:`activate`): when the scope ends, the store's graphs, static
buffers and pools are freed.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import json
import os
import pickle
import re
import subprocess
import threading
import time
import weakref
from typing import Optional

from scdna_replication_tools_tpu_torch.utils.fileio import atomic_write_bytes
from scdna_replication_tools_tpu_torch.utils.profiling import logger

SCHEMA = "pert-torch-lib/v1"

# The canonical key components, in digest order (JAX's tuple, with
# torch, CUDA and the device in the places of jax, jaxlib and the
# backend; "form" tells a chunk's diagnostic iteration from its plain
# one, JAX's lax.cond branches, which one XLA program holds)
KEY_COMPONENTS = (
    "program-tag",           # "fit" / "chunk" (svi's chunk loops)
    "loss-structure",        # repr of the hashable loss callable
    "optimizer-statics",     # min_iter, rel_tol, window, ring, betas, dtype
    "abstract-signature",    # skeleton + shape/dtype/device of each tensor
    "config-digest",         # PertConfig hash, see the module docstring
    "form",                  # "diag" / "plain"
    "torch-version",
    "cuda-version",
    "device-kind",           # torch.cuda.get_device_name
    "compute-capability",
)

_ADDR = re.compile(r"0x[0-9a-fA-F]+")

# files the store owns: <digest>.pertexec (live) / *.pertexec.bad
# (quarantined, invisible to probes and eviction counts)
_SUFFIX = ".pertexec"


def canonical_key_text(key) -> str:
    """Cross-process-canonical text of a program key: its repr with
    memory addresses scrubbed."""
    return _ADDR.sub("0xADDR", repr(key))


_NVCC_VERSION: dict = {}


def nvcc_version() -> str:
    """The last line of ``nvcc --version`` (its release and build), or
    'none' without nvcc; asked once per process."""
    if "v" not in _NVCC_VERSION:
        from scdna_replication_tools_tpu_torch.ops import _cuda

        try:
            out = subprocess.run([_cuda._nvcc(), "--version"],
                                 capture_output=True, text=True,
                                 timeout=60).stdout
            lines = [ln for ln in out.splitlines() if ln.strip()]
            _NVCC_VERSION["v"] = lines[-1].strip() if lines else "unknown"
        except (RuntimeError, OSError, subprocess.SubprocessError):
            _NVCC_VERSION["v"] = "none"
    return _NVCC_VERSION["v"]


def environment_facts(device=None, with_nvcc: bool = False) -> dict:
    """The facts baked into every digest and checked again at load: the
    torch and CUDA versions, the device's kind and compute capability
    (the CPU's: 'cpu'), and with ``with_nvcc`` the nvcc release."""
    import torch

    dev = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device())
        if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type == "cuda":
        kind = torch.cuda.get_device_name(dev)
        cc = "%d.%d" % torch.cuda.get_device_capability(dev)
    else:
        kind, cc = "cpu", "none"
    facts = {"torch_version": torch.__version__,
             "cuda_version": str(torch.version.cuda),
             "device_kind": kind, "compute_capability": cc}
    if with_nvcc:
        facts["nvcc_version"] = nvcc_version()
    return facts


def key_digest(key_text: str, env: Optional[dict] = None,
               config_digest: Optional[str] = None) -> str:
    """The cross-process-stable digest: SHA-256 over the canonical key
    text, the environment facts and the behavioural config digest."""
    if env is None:
        env = environment_facts()
    blob = json.dumps({"key": key_text, "env": env,
                       "config": config_digest}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:32]


def program_config_digest(config) -> str:
    """The config digest in the program keys (JAX
    ``PertInference.__init__``): the config hash over the complement of
    ``NON_HASH_FIELDS`` less ``AOT_EXECUTION_ONLY_FIELDS``, which name
    where host-side artifacts land (a serving worker moves
    ``checkpoint_dir`` per request)."""
    from scdna_replication_tools_tpu_torch.config import (
        AOT_EXECUTION_ONLY_FIELDS,
        NON_HASH_FIELDS,
    )

    fields = {k: v for k, v in dataclasses.asdict(config).items()
              if k not in NON_HASH_FIELDS
              and k not in AOT_EXECUTION_ONLY_FIELDS}
    blob = json.dumps(fields, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def signature_shapes(key, cap: int = 12) -> list:
    """Distinct tensor shapes of a program key's abstract signature, for
    the warm-up's bucket matching (a bucket's padded (cells, loci) are
    the trailing dims of the big per-bin tensors)."""
    shapes = []
    try:
        for leaf_sig in key[3][1]:
            shp = leaf_sig[0]
            if isinstance(shp, tuple) and shp not in shapes:
                shapes.append(shp)
                if len(shapes) >= cap:
                    break
    except (IndexError, TypeError):
        pass
    return [list(s) for s in shapes]


_LIVE_STORES: "weakref.WeakSet" = weakref.WeakSet()


class ExecutableStore:
    """One directory of library records and, in RAM, the captured
    programs.

    The disk side's mutating paths are best-effort: a failed save or
    eviction logs and returns, a record that does not read back is
    quarantined and misses.  Thread-safe: a serving worker's request
    threads probe it while the warm-up preloads."""

    def __init__(self, root: str, max_entries: int = 64,
                 max_programs: int = 16,
                 max_program_bytes: Optional[int] = None):
        self.root = os.path.abspath(root)
        self.max_entries = max_entries
        self.max_programs = max_programs
        # device bytes the programs may hold together (their buffers and
        # pools, ``prog.nbytes``); None: no cap.  Past either cap the
        # least recently used programs that no chunk is replaying are
        # released
        self.max_program_bytes = max_program_bytes
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.RLock()
        # digest -> (payload, meta, seconds): records the warm-up read
        # ahead of traffic, consumed by the first load
        self._preloaded: dict = {}
        # digest -> a captured program (``release()`` frees it), most
        # recently used last
        self._programs: "collections.OrderedDict" = collections.OrderedDict()
        self.closed = False
        _LIVE_STORES.add(self)

    def path(self, digest: str) -> str:
        return os.path.join(self.root, digest + _SUFFIX)

    # -- the RAM layer: captured programs ------------------------------

    def acquire(self, digest: str):
        """The program of ``digest`` marked in use (``prog.busy``; pair
        with :meth:`done_with`), or None."""
        with self._lock:
            prog = self._programs.get(digest)
            if prog is not None:
                self._programs.move_to_end(digest)
                prog.busy += 1
            return prog

    def done_with(self, prog) -> None:
        with self._lock:
            prog.busy -= 1

    def put_program(self, digest: str, prog) -> None:
        """Keep ``prog``, in use by its maker (``busy`` 1)."""
        with self._lock:
            if self.closed:
                raise RuntimeError(f"executable store {self.root} is closed")
            prog.busy = 1
            self._programs[digest] = prog
            self._programs.move_to_end(digest)

    def trim(self) -> None:
        """Release the least recently used programs not in use while the
        store holds more than ``max_programs`` or ``max_program_bytes``."""
        victims = []
        with self._lock:
            def over():
                nbytes = sum(p.nbytes for p in self._programs.values())
                return len(self._programs) > self.max_programs or (
                    self.max_program_bytes is not None
                    and nbytes > self.max_program_bytes)
            for digest in list(self._programs):
                if not over():
                    break
                if self._programs[digest].busy == 0:
                    victims.append(self._programs.pop(digest))
        for prog in victims:
            prog.release()

    def program_count(self) -> int:
        with self._lock:
            return len(self._programs)

    def program_bytes(self) -> int:
        with self._lock:
            return sum(p.nbytes for p in self._programs.values())

    def close(self) -> None:
        """Release every program (its graph, static buffers and pool) and
        the cuBLAS workspaces of the streams their captures ran on, and
        drop the preloaded records; the directory stays."""
        with self._lock:
            progs = list(self._programs.values())
            self._programs.clear()
            self._preloaded.clear()
            self.closed = True
        for prog in progs:
            prog.release()
        if progs:
            _clear_cublas_workspaces()

    # -- the disk layer: library records -------------------------------

    def save(self, digest: str, key_text: str, payload: bytes,
             stats: Optional[dict] = None, meta: Optional[dict] = None,
             env: Optional[dict] = None) -> tuple:
        """Write ``payload`` under ``digest`` (atomic; best-effort).
        Returns ``(landed, reason)``: ``(True, "saved")`` or ``(False,
        "error")``."""
        try:
            record = {
                "schema": SCHEMA,
                "key": key_text,
                "env": dict(env if env is not None
                            else environment_facts(with_nvcc=True)),
                "meta": dict(meta or {}),
                "stats": dict(stats or {}),
                "payload": bytes(payload),
                "payload_sha256": hashlib.sha256(payload).hexdigest(),
            }
            record["meta"].setdefault("created", time.time())
            atomic_write_bytes(self.path(digest), pickle.dumps(record))
            self._evict()
            return True, "saved"
        except Exception as exc:  # noqa: BLE001 — never fail the run
            logger.debug("aotcache: save skipped for %s: %s", digest, exc)
            return False, "error"

    def _evict(self) -> None:
        """LRU by mtime: loads touch their entry."""
        try:
            entries = sorted((os.path.getmtime(p), p) for p in self._paths())
            while len(entries) > self.max_entries:
                _, victim = entries.pop(0)
                os.remove(victim)
                logger.debug("aotcache: evicted %s",
                             os.path.basename(victim))
        except OSError as exc:
            logger.debug("aotcache: eviction skipped: %s", exc)

    def _paths(self) -> list:
        return [os.path.join(self.root, n) for n in os.listdir(self.root)
                if n.endswith(_SUFFIX)]

    def load(self, digest: str, env: Optional[dict] = None):
        """``(payload, meta, seconds)`` or None.  A preloaded record is
        served from RAM; an environment mismatch (against ``env``, by
        default this process's facts) is a miss and the record stays; a
        record that does not read back is quarantined to ``*.bad``."""
        with self._lock:
            pre = self._preloaded.pop(digest, None)
        if pre is not None:
            return pre
        return self._load_from_disk(digest, env)

    def _read(self, path: str) -> dict:
        with open(path, "rb") as fh:
            record = pickle.loads(fh.read())
        if not isinstance(record, dict) or record.get("schema") != SCHEMA:
            raise ValueError("not a record of schema " + SCHEMA)
        payload = record.get("payload")
        if not isinstance(payload, bytes) or hashlib.sha256(
                payload).hexdigest() != record.get("payload_sha256"):
            raise ValueError("payload digest mismatch")
        return record

    def _load_from_disk(self, digest: str, env: Optional[dict] = None):
        path = self.path(digest)
        if not os.path.exists(path):
            return None
        t0 = time.perf_counter()
        try:
            record = self._read(path)
        except Exception as exc:  # noqa: BLE001 — _quarantine logs it
            self._quarantine(path, exc)
            return None
        if not self._env_ok(record.get("env", {}), env):
            return None  # an honest miss: another toolchain or card
        try:
            os.utime(path)  # LRU touch
        except OSError:
            pass
        return record["payload"], dict(record.get("meta") or {}), \
            time.perf_counter() - t0

    def _env_ok(self, stored: dict, here: Optional[dict]) -> bool:
        if here is None:
            here = environment_facts(with_nvcc="nvcc_version" in stored)
        for field in sorted(set(stored) | set(here)):
            if stored.get(field) != here.get(field):
                logger.debug("aotcache: env mismatch on %s: %r != %r",
                             field, stored.get(field), here.get(field))
                return False
        return True

    def _quarantine(self, path: str, exc: Exception) -> None:
        logger.warning("aotcache: quarantining corrupt entry %s (%s)",
                       os.path.basename(path), exc)
        try:
            os.replace(path, path + ".bad")
        except OSError:
            pass

    # -- warm-up side ----------------------------------------------------

    def entries(self) -> list:
        """[{digest, meta, mtime}] of every live record (a record that
        does not read back is quarantined)."""
        out = []
        for path in self._paths():
            digest = os.path.basename(path)[:-len(_SUFFIX)]
            try:
                record = self._read(path)
                out.append({"digest": digest,
                            "meta": dict(record.get("meta") or {}),
                            "mtime": os.path.getmtime(path)})
            except Exception as exc:  # noqa: BLE001 — _quarantine logs it
                self._quarantine(path, exc)
        return out

    def preload(self, digest: str) -> bool:
        """Read a record ahead of traffic; the first load of its digest
        takes it without touching the disk."""
        with self._lock:
            if digest in self._preloaded:
                return True
        loaded = self._load_from_disk(digest)
        if loaded is None:
            return False
        with self._lock:
            self._preloaded[digest] = loaded
        return True

    def preloaded_count(self) -> int:
        with self._lock:
            return len(self._preloaded)


def _clear_cublas_workspaces() -> None:
    """Free the per-stream cuBLAS workspaces PyTorch keeps (one per
    stream that ran a matmul: the captures' side stream's among them),
    once the card is idle; a process without CUDA has none."""
    import torch

    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is not None and torch.cuda.is_available() \
            and torch.cuda.is_initialized():
        torch.cuda.synchronize()
        clear()


def live_program_count() -> int:
    """Programs held by every store not yet closed (0 after each run's
    scope has ended, in a process without a worker's store)."""
    return sum(s.program_count() for s in list(_LIVE_STORES)
               if not s.closed)


# -- the process-wide store (a serving worker's, for its life) ---------

_ACTIVE: Optional[ExecutableStore] = None
_ACTIVATE_LOCK = threading.Lock()


def activate(root: Optional[str],
             max_program_bytes: Optional[int] = None
             ) -> Optional[ExecutableStore]:
    """Install (or keep, on the same directory) the process-wide store; a
    ``root`` of None/'none' deactivates.  Returns the active store."""
    global _ACTIVE
    with _ACTIVATE_LOCK:
        if not root or str(root).lower() == "none":
            old, _ACTIVE = _ACTIVE, None
        else:
            root = os.path.abspath(str(root))
            if _ACTIVE is not None and _ACTIVE.root == root \
                    and not _ACTIVE.closed:
                return _ACTIVE
            old, _ACTIVE = _ACTIVE, ExecutableStore(
                root, max_program_bytes=max_program_bytes)
    if old is not None:
        old.close()
    return _ACTIVE


def active_store() -> Optional[ExecutableStore]:
    return _ACTIVE


def deactivate() -> None:
    """Close and remove the process-wide store."""
    activate(None)


# -- a run's scope -------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scope:
    """What a fit resolves its programs in: the store and the run's
    config digest."""
    store: ExecutableStore
    config_digest: Optional[str]


_TLS = threading.local()


def current_scope() -> Optional[Scope]:
    """This thread's run scope, or None (no store: eager fits)."""
    return getattr(_TLS, "scope", None)


@contextlib.contextmanager
def run_scope(root: Optional[str], config_digest: Optional[str] = None):
    """The store of one run, current on this thread inside the block:
    the process-wide store when it is on ``root`` (a serving worker's),
    else a store of the run's own, closed when the block exits (an
    exception included), which frees its graphs, buffers and pools.
    ``root`` None/'none': no store."""
    if not root or str(root).lower() == "none":
        yield None
        return
    root = os.path.abspath(str(root))
    shared = _ACTIVE
    owned = shared is None or shared.root != root or shared.closed
    store = ExecutableStore(root) if owned else shared
    prev = current_scope()
    _TLS.scope = Scope(store, config_digest)
    try:
        yield _TLS.scope
    finally:
        _TLS.scope = prev
        if owned:
            store.close()
