"""Build, load and launch-count the port's CUDA kernels.

Each source under ``csrc/`` is compiled at first use by ``nvcc`` (the
host C++ sources of ``HOST_SOURCES`` by the host's ``c++``) into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``.  Libraries are named by a hash
of their source and flags, so an edited source rebuilds and an unchanged
one loads from the build directory, with the compiler's log (ptxas's
registers, shared memory and spills) kept beside it.  :func:`build`
starts one ``nvcc`` per source, all at once.

``LAUNCHES`` counts kernel launches per entry point (the unfused
backward's per store path): each wrapper adds one where it launches its
kernel (:func:`count_launch`) and nowhere else, so a run can show that
its main path went through the kernels.  A call made while its stream
is being captured into a CUDA graph launches nothing: its count goes to
the capture (:func:`recording_launches`), and each replay of the graph
adds the graph's counts (:func:`add_launches`).

A library's build or load is the port's counterpart of the JAX
package's program compile: :func:`load_event` loads a library and
describes that as a ``compile`` event (``cache: "miss"`` with the nvcc
seconds, ``"disk_hit"`` with the load seconds of a library built
before, or ``"hit"`` when the process had it loaded already).  The
build directory is ``compile_cache_dir``'s (:func:`configure_build_dir`:
``'auto'`` the package's ``_build/``, a path, or None for a directory
of this process's own).  With a compiled-program store
(``infer/aotcache.py``) a library not yet loaded is taken from the
store's record first (``disk_hit``), and a library built or found here
is saved there.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import hashlib
import os
import shutil
import tempfile
import subprocess
import threading
import time
import uuid
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
SOURCES = {"enum_fused": "enum_fused.cu", "adam": "adam.cu"}
# host C++ libraries of the port (no CUDA), built the same way by the
# host compiler: the changepoint sweep and the loader's pivot;
# -ffp-contract=off: the segment sweep's exact-division costs must round
# as its NumPy oracle's do, tie for tie
HOST_SOURCES = {"segment": "segment.cpp", "pivot": "pivot.cpp"}
HOST_FLAGS = ("-O3", "-ffp-contract=off", "-std=c++17", "-shared", "-fPIC",
              "-pthread")

_P = ctypes.c_void_p
_F32P = ctypes.POINTER(ctypes.c_float)
_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SIGNATURES = {
    "enum_fused": {
        # reads, mu, phi, pi, etas, eidx, ew, scal, out, lse, n, P,
        # sparse, binary, lanes, stream
        "scrt_fused_fwd": [_P] * 10 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [_P],
        # reads, mu, phi, pi, etas, eidx, ew, scal, lse, g, dmu, dphi,
        # dpi, n, P, sparse, binary, lanes, stream
        "scrt_fused_bwd": [_P] * 13 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [_P],
        # reads, mu, phi, log_pi, scal, ll, n, P, stream
        "scrt_enum_fwd": [_P] * 6 + [ctypes.c_longlong, ctypes.c_int, _P],
        # reads, mu, phi, log_pi, scal, ll, g, dmu, dphi, dlog_pi, n, P,
        # stream
        "scrt_enum_bwd": [_P] * 10 + [ctypes.c_longlong, ctypes.c_int, _P],
    },
    "adam": {
        # p_out, m_out, v_out, p, g, m, v, scal, b1, 1-b1, b2, 1-b2, n,
        # lanes, bf16_moments, stream
        "scrt_adam": [_P] * 8 + [ctypes.c_float] * 4
        + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, _P],
    },
    "segment": {
        # Y, row_len, n_rows, n_loci, n_bkps, min_size, out, n_threads
        "batch_bkps_f64": [_F64P, _I64P, ctypes.c_int64, ctypes.c_int64,
                           ctypes.c_int32, ctypes.c_int32, _I64P,
                           ctypes.c_int32],
    },
    "pivot": {
        # cell_codes, locus_codes, values, n, out, n_loci, n_threads
        "scatter_pivot_f32": [_I32P, _I32P, _F64P, ctypes.c_int64, _F32P,
                              ctypes.c_int64, ctypes.c_int32],
        # mat, cell_codes, locus_codes, n, n_loci, out, n_threads
        "gather_melt_f32": [_F32P, _I32P, _I32P, ctypes.c_int64,
                            ctypes.c_int64, _F32P, ctypes.c_int32],
    },
}

LAUNCHES: Dict[str, int] = {
    "enum_fwd": 0,
    # the unfused backward by its store path: a launch with a full block
    # stages that block's dlog_pi span through shared memory, one without
    # stores per thread
    "enum_bwd_staged": 0,
    "enum_bwd_per_thread": 0,
    "fused_fwd_dense": 0,
    "fused_bwd_dense": 0,
    "fused_fwd_sparse": 0,
    "fused_bwd_sparse": 0,
    "fused_fwd_dense_binary": 0,
    "fused_bwd_dense_binary": 0,
    "fused_fwd_sparse_binary": 0,
    "fused_bwd_sparse_binary": 0,
    "adam": 0,
    "adam_bf16": 0,
    # launches with a lane axis (the serving slab's W stacked fits)
    "fused_fwd_dense_lanes": 0,
    "fused_bwd_dense_lanes": 0,
    "fused_fwd_sparse_lanes": 0,
    "fused_bwd_sparse_lanes": 0,
    "adam_lanes": 0,
    "adam_bf16_lanes": 0,
}

# name -> {"seconds", "path", "log", "key_hash", "cache"} of the last
# build ("miss") or of a library found built ("disk_hit"), and
# "load_seconds" once the library is loaded
BUILD_INFO: Dict[str, dict] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
# one builder or loader at a time in this process: the serving worker's
# request threads reach an unbuilt library together
_BUILD_LOCK = threading.RLock()


def reset_launches() -> None:
    for key in LAUNCHES:
        LAUNCHES[key] = 0


# the counts of the capture in progress (one at a time: svi's captures
# hold a lock), or None
_CAPTURE_COUNTS: Optional[Dict[str, int]] = None


def count_launch(key: str) -> None:
    """One launch of ``key``'s kernel: into ``LAUNCHES``, or, when the
    calling thread's stream is being captured into a CUDA graph (the
    capturing thread, or the autograd thread running a captured
    backward on that stream), into the capture's counts."""
    counts = _CAPTURE_COUNTS
    if counts is not None and torch.cuda.is_current_stream_capturing():
        counts[key] = counts.get(key, 0) + 1
    else:
        LAUNCHES[key] += 1


@contextlib.contextmanager
def recording_launches():
    """The counts of the wrappers called on a capturing stream inside the
    block (a dict, filled when the block exits)."""
    global _CAPTURE_COUNTS
    counts: Dict[str, int] = {}
    _CAPTURE_COUNTS = counts
    try:
        yield counts
    finally:
        _CAPTURE_COUNTS = None


def add_launches(counts: Dict[str, int]) -> None:
    """Count the launches of one replay of a graph that recorded
    ``counts``."""
    for key, n in counts.items():
        LAUNCHES[key] += n


# compile_cache_dir's build directory (configure_build_dir): None is
# BUILD_DIR ('auto'), read when a build starts
_BUILD_DIR = {"dir": None, "setting": "auto"}
_TMP_BUILD_DIR: Dict[str, Path] = {}


def configure_build_dir(value="auto") -> Path:
    """Point the builds of libraries not yet loaded at ``value``
    (``compile_cache_dir``): 'auto' is the package's ``_build/``, None
    or 'none' a temporary directory of this process (made once, removed
    at exit), any other value that path.  Returns the directory."""
    with _BUILD_LOCK:
        setting = "none" if value is None or str(value).lower() == "none" \
            else str(value)
        if setting == "auto":
            path = None
        elif setting == "none":
            if "dir" not in _TMP_BUILD_DIR:
                _TMP_BUILD_DIR["dir"] = Path(
                    tempfile.mkdtemp(prefix="pert_build_"))
                atexit.register(shutil.rmtree, str(_TMP_BUILD_DIR["dir"]),
                                True)
            path = _TMP_BUILD_DIR["dir"]
        else:
            path = Path(setting).resolve()
        _BUILD_DIR.update(dir=path, setting=setting)
        return build_dir()


@contextlib.contextmanager
def build_dir_scope(value="auto"):
    """:func:`configure_build_dir` for the block (a run's), then the
    setting before it again."""
    with _BUILD_LOCK:
        before = dict(_BUILD_DIR)
        configure_build_dir(value)
    try:
        yield build_dir()
    finally:
        with _BUILD_LOCK:
            _BUILD_DIR.update(before)


def build_dir() -> Path:
    """The build directory in use (``BUILD_DIR`` under 'auto')."""
    return _BUILD_DIR["dir"] or BUILD_DIR


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc" if home else None,
                  shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built at first use")


def _source(name: str) -> str:
    return SOURCES.get(name) or HOST_SOURCES[name]


def _flags(name: str) -> tuple:
    return NVCC_FLAGS if name in SOURCES else HOST_FLAGS


def _compiler(name: str) -> str:
    return _nvcc() if name in SOURCES else (shutil.which("c++") or "g++")


def _target(name: str) -> Path:
    src = (CSRC_DIR / _source(name)).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()) \
        .hexdigest()[:16]
    return build_dir() / f"lib{name}-{digest}.so"


def _key_hash(lib: Path) -> str:
    """The build's hash (of source and flags), from the library's name."""
    return lib.stem.rsplit("-", 1)[1]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: the CUDA ones) in parallel,
    one compiler each (``nvcc``, or the host's ``c++`` for
    ``HOST_SOURCES``); sources whose library is already built are
    skipped.  Returns ``BUILD_INFO`` for the names; raises with the
    compiler's output on failure.
    Thread-safe; each build writes a temporary file of its own, so
    builders in other processes never collide either."""
    with _BUILD_LOCK:
        return _build(list(names or SOURCES))


def _build(names) -> Dict[str, dict]:
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            out = _target(name)
            if out.exists():
                log = out.with_suffix(".log")
                BUILD_INFO[name] = {
                    "seconds": 0.0, "path": str(out),
                    "log": log.read_text() if log.exists() else "cached",
                    "key_hash": _key_hash(out), "cache": "disk_hit"}
                continue
            tmp = out.with_name(
                f"{out.name}.{os.getpid()}-{uuid.uuid4().hex}.tmp")
            cmd = [_compiler(name), *_flags(name), "-o", str(tmp),
                   str(CSRC_DIR / _source(name))]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{_source(name)}: {proc.args[0]} exited "
                              f"{proc.returncode}\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                                "path": str(out), "log": log,
                                "key_hash": _key_hash(out), "cache": "miss"}
        if errors:
            raise RuntimeError("library build failed:\n"
                               + "\n".join(errors))
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return {name: BUILD_INFO[name] for name in names}


def library(name: str, store=None) -> ctypes.CDLL:
    """The loaded library ``name`` (a kernel library, or a host one of
    ``HOST_SOURCES``), built on first use (once, when several threads
    ask for it together).  With ``store`` (an ``aotcache.
    ExecutableStore``) a kernel library comes from the store's record
    when it has one, and one built or found here is saved there.  A
    failed build raises: there is no fallback."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        cached = store is not None and name in SOURCES
        if not (cached and _from_store(name, store)) \
                and (name not in BUILD_INFO
                     or Path(BUILD_INFO[name]["path"]).parent
                     != build_dir()):
            _build([name])
        info = BUILD_INFO[name]
        if cached and info["cache"] != "store":
            _to_store(name, store)
        t0 = time.perf_counter()
        lib = ctypes.CDLL(info["path"])
        cuda = name in SOURCES
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int if cuda else None
        if cuda:
            lib.scrt_error_string.argtypes = [ctypes.c_int]
            lib.scrt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        info["load_seconds"] = time.perf_counter() - t0
    return lib


def load_event(name: str, store=None) -> dict:
    """Load library ``name`` (built on first use; see :func:`library`
    for ``store``) and return the payload of its ``compile`` event:
    ``miss`` with the nvcc seconds or ``disk_hit`` with the load seconds
    (with the store's read) when this call loaded it, ``hit`` when it
    was loaded already (then saved to ``store`` if the store lacks it)."""
    with _BUILD_LOCK:
        loaded = name in _LIBS
        if store is None:
            library(name)
        else:
            library(name, store)
        info = BUILD_INFO[name]
        if loaded and store is not None:
            _to_store(name, store)
    event = {"key_hash": info["key_hash"], "label": SOURCES[name],
             "tag": "kernel_library"}
    if loaded:
        event.update(cache="hit", compile_seconds=0.0)
    elif info["cache"] == "miss":
        event.update(cache="miss", compile_seconds=round(info["seconds"], 4))
    else:
        event.update(cache="disk_hit", deserialize_seconds=round(
            info.get("read_seconds", 0.0) + info["load_seconds"], 6))
    return event


def store_digest(name: str) -> tuple:
    """(digest, key text, environment facts) of kernel library
    ``name``'s record in a compiled-program store: its source digest
    and nvcc flags, checked against the nvcc, torch and CUDA versions,
    the device kind and the compute capability."""
    from scdna_replication_tools_tpu_torch.infer import aotcache

    src = hashlib.sha256((CSRC_DIR / _source(name)).read_bytes()).hexdigest()
    key_text = f"kernel_library:{name}:{src}:{' '.join(_flags(name))}"
    env = aotcache.environment_facts(with_nvcc=True)
    return aotcache.key_digest(key_text, env), key_text, env


def _from_store(name: str, store) -> bool:
    """Take library ``name`` from ``store``'s record into the build
    directory; False on a miss (no record, another environment, or a
    record quarantined as unreadable)."""
    digest, _, env = store_digest(name)
    got = store.load(digest, env)
    if got is None:
        return False
    payload, meta, read_s = got
    out = _target(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}-{uuid.uuid4().hex}.tmp")
    tmp.write_bytes(payload)
    os.replace(tmp, out)
    BUILD_INFO[name] = {"seconds": 0.0, "path": str(out),
                        "log": meta.get("log", "from the store"),
                        "key_hash": _key_hash(out), "cache": "store",
                        "read_seconds": read_s, "digest": digest}
    return True


def _to_store(name: str, store) -> None:
    """Save library ``name`` (built or found here) to ``store`` unless it
    holds a record of it already."""
    digest, key_text, env = store_digest(name)
    if os.path.exists(store.path(digest)):
        return
    info = BUILD_INFO[name]
    store.save(digest, key_text, Path(info["path"]).read_bytes(),
               stats={"build_seconds": info["seconds"]},
               meta={"library": name, "log": info.get("log", ""),
                     "flags": list(_flags(name))}, env=env)


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.scrt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_of(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_operands(what: str, device: torch.device,
                   dtypes: Optional[Dict[str, torch.dtype]] = None,
                   **tensors) -> None:
    """Device, dtype and contiguity checks of a kernel's operands (run
    for the plain versions on the CPU too, so a CPU run catches what the
    kernel would refuse).  ``device`` must be the CPU (plain version) or
    a CUDA device (kernel): nothing else has a path.  Every operand is
    float32 unless ``dtypes`` names another dtype for it."""
    dtypes = dtypes or {}
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: tensors must lie on the CPU (plain "
                         f"version) or a CUDA device (kernel); got {device}")
    for key, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: {key} is on {t.device}, expected "
                             f"{device}")
        want = dtypes.get(key, torch.float32)
        if t.dtype != want:
            raise ValueError(f"{what}: {key} has dtype {t.dtype}, expected "
                             f"{want}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {key} must be contiguous")
