"""ctypes bindings for the native brick IO library (native/brickio.cpp).

Builds ``native/libbrickio.so`` on first use if the toolchain is present;
callers fall back to the pure-Python mmap+zlib path when unavailable (the
reference's single-threaded UVFDataSource::getData behavior)."""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Sequence

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libbrickio.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _NATIVE_DIR, "-s"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, building it if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB_PATH) and not _build():
            return None
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            return None
        u64p = ctypes.POINTER(ctypes.c_uint64)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ltpu_read_bricks.restype = ctypes.c_int
        lib.ltpu_read_bricks.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, u64p, u64p,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_int,
        ]
        lib.ltpu_compress_bricks.restype = ctypes.c_int
        lib.ltpu_compress_bricks.argtypes = [
            u8p, ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            u8p, ctypes.c_uint64, u64p, ctypes.c_int,
        ]
        lib.ltpu_compress_bound.restype = ctypes.c_uint64
        lib.ltpu_compress_bound.argtypes = [ctypes.c_uint64]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


def read_bricks(
    path: str,
    blob_base: int,
    offsets: Sequence[int],
    nbytes: Sequence[int],
    raw_nbytes: int,
    compressed: bool,
    n_threads: int = 4,
) -> np.ndarray:
    """Batch-read ``len(offsets)`` bricks → (n, raw_nbytes) uint8 array."""
    lib = load()
    if lib is None:
        raise RuntimeError("native brickio unavailable")
    n = len(offsets)
    off = np.ascontiguousarray(offsets, np.uint64)
    nb = np.ascontiguousarray(nbytes, np.uint64)
    out = np.empty((n, raw_nbytes), np.uint8)
    rc = lib.ltpu_read_bricks(
        path.encode(),
        blob_base,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        nb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        raw_nbytes,
        1 if compressed else 0,
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads,
    )
    if rc != 0:
        raise IOError(f"native brick read failed (code {rc}) for {path}")
    return out


def compress_bricks(
    bricks_raw: np.ndarray, level: int = 1, n_threads: int = 4
) -> list:
    """Deflate a (n, raw_nbytes) uint8 array → list of compressed blobs."""
    lib = load()
    if lib is None:
        raise RuntimeError("native brickio unavailable")
    bricks_raw = np.ascontiguousarray(bricks_raw, np.uint8)
    n, raw_nbytes = bricks_raw.shape
    bound = int(lib.ltpu_compress_bound(raw_nbytes))
    out = np.empty((n, bound), np.uint8)
    sizes = np.zeros(n, np.uint64)
    rc = lib.ltpu_compress_bricks(
        bricks_raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        raw_nbytes,
        n,
        level,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        bound,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        n_threads,
    )
    if rc != 0:
        raise IOError(f"native brick compress failed (code {rc})")
    return [out[i, : int(sizes[i])].tobytes() for i in range(n)]
