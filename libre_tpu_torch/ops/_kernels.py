"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exports one ``extern "C"`` launcher that takes
device pointers, scalars and a stream, launches its kernel on that
stream and returns ``cudaGetLastError()``.  At first use the source is
compiled with ``nvcc`` into a shared library under ``_build/`` (named by
a hash of the source, the shared ``csrc/*.cuh`` headers and the flags,
so an edit to any of them rebuilds) and loaded with ``ctypes``.  The
build writes a temporary file and renames it into place, so concurrent
processes never load a half-written library.

Nothing here runs at import: the CPU-only tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List

import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# --fmad=false: no FMA contraction, so every sample rounds as the plain
# PyTorch version does.  The sweep's gradient jumps where a sample's
# density crosses a TF texel whose slope changes, the alpha clamp or the
# [0, 1] clamp; a contracted rounding moved samples across them and put
# 5e-3 relative errors into single voxels of the backward (5.6e-7 without).
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# Launcher argument types, in order; every launcher ends with the stream.
SIGNATURES: Dict[str, List] = {
    "post_sweep": [_P] * 14 + [_I] * 6 + [_F] * 7 + [_I, _P],
    "store_grid_bwd": [_P] * 16 + [_I] * 6 + [_F] * 7 + [_P],
    "exact_march": [_P] * 9 + [_I] * 9 + [_F] * 8 + [_I, _P],
    "exact_march_bwd": [_P] * 8 + [_I] * 9 + [_F] * 8 + [_I, _P],
    "pre_sweep": [_P] * 9 + [_I] * 5 + [_F] * 7 + [_I, _P],
    "probe_take": [_P] * 4 + [_I] * 4 + [_P],
    "probe_take_along": [_P] * 3 + [_I] * 7 + [_P],
    "probe_tf_nearest": [_P] * 3 + [_I] * 3 + [_F, _I, _P],
    "probe_tf_linear": [_P] * 3 + [_I] * 4 + [_P],
    "adam_update": [_P] * 4 + [_I] * 2 + [_F] * 7 + [_P],
    "tf_lookup": [_P] * 6 + [_L, _I, _P],
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    digest = hashlib.sha256()
    for path in [SRC_DIR / f"{name}.cu", *sorted(SRC_DIR.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    digest = digest.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load(name: str) -> ctypes.CDLL:
    """The bound library of kernel ``name``, building it at first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            fn = getattr(lib, name)
            fn.argtypes = SIGNATURES[name]
            fn.restype = ctypes.c_int
            _libs[name] = lib
        return lib


def build_all() -> Dict[str, float]:
    """Build every kernel, one ``nvcc`` per source all started together,
    then bind them; returns the build seconds per kernel."""

    def timed_build(name):
        t0 = time.perf_counter()
        build(name)
        return time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=len(SIGNATURES)) as pool:
        futures = {name: pool.submit(timed_build, name) for name in SIGNATURES}
        secs = {name: f.result() for name, f in futures.items()}
    for name in SIGNATURES:
        load(name)
    return secs


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current CUDA stream.  Tensor
    arguments pass as device pointers, the rest as the launcher's
    scalars; raises if the launch was refused."""
    fn = getattr(load(name), name)
    stream = torch.cuda.current_stream().cuda_stream
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    err = fn(*cargs, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
