"""Build, load and launch-count the port's CUDA kernels.

Each source under ``csrc/`` is compiled at first use by ``nvcc`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds), loaded with ``ctypes``.  Libraries are named by a hash
of their source and flags, so an edited source rebuilds and an unchanged
one loads from the build directory, with the compiler's log (ptxas's
registers, shared memory and spills) kept beside it.  :func:`build`
starts one ``nvcc`` per source, all at once.

``LAUNCHES`` counts kernel launches per entry point (the unfused
backward's per store path): each wrapper adds one where it launches its
kernel and nowhere else, so a run can show that its main path went
through the kernels.

A library's build or load is the port's counterpart of the JAX
package's program compile: :func:`load_event` loads a library and
describes that as a ``compile`` event (``cache: "miss"`` with the nvcc
seconds, ``"disk_hit"`` with the load seconds of a library built
before, or ``"hit"`` when the process had it loaded already).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
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

_P = ctypes.c_void_p
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


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc" if home else None,
                  shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built at first use")


def _target(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()) \
        .hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _key_hash(lib: Path) -> str:
    """The build's hash (of source and flags), from the library's name."""
    return lib.stem.rsplit("-", 1)[1]


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named sources (default: all) in parallel, one ``nvcc``
    each; sources whose library is already built are skipped.  Returns
    ``BUILD_INFO`` for the names; raises with nvcc's output on failure.
    Thread-safe; each build writes a temporary file of its own, so
    builders in other processes never collide either."""
    with _BUILD_LOCK:
        return _build(list(names or SOURCES))


def _build(names) -> Dict[str, dict]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / SOURCES[name])]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        errors = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{SOURCES[name]}: nvcc exited "
                              f"{proc.returncode}\n{log}")
                continue
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)
            BUILD_INFO[name] = {"seconds": time.perf_counter() - t0,
                                "path": str(out), "log": log,
                                "key_hash": _key_hash(out), "cache": "miss"}
        if errors:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(errors))
    finally:
        for proc, tmp, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if tmp.exists():
                tmp.unlink()
    return {name: BUILD_INFO[name] for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use (once, when
    several threads ask for it together)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _BUILD_LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        if name not in BUILD_INFO:
            _build([name])
        info = BUILD_INFO[name]
        t0 = time.perf_counter()
        lib = ctypes.CDLL(info["path"])
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.scrt_error_string.argtypes = [ctypes.c_int]
        lib.scrt_error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
        info["load_seconds"] = time.perf_counter() - t0
    return lib


def load_event(name: str) -> dict:
    """Load library ``name`` (built on first use) and return the payload
    of its ``compile`` event: ``miss`` with the nvcc seconds or
    ``disk_hit`` with the load seconds when this call loaded it, ``hit``
    when it was loaded already."""
    with _BUILD_LOCK:
        loaded = name in _LIBS
        library(name)
        info = BUILD_INFO[name]
    event = {"key_hash": info["key_hash"], "label": SOURCES[name],
             "tag": "kernel_library"}
    if loaded:
        event.update(cache="hit", compile_seconds=0.0)
    elif info["cache"] == "miss":
        event.update(cache="miss", compile_seconds=round(info["seconds"], 4))
    else:
        event.update(cache="disk_hit",
                     deserialize_seconds=round(info["load_seconds"], 6))
    return event


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
