"""Image grab encoding: float RGBA render output → PNG/JPEG bytes/files.

Reference: the libjpeg-turbo FrameGrabber (livre/eq/FrameGrabber.cpp:
50-106, tjCompress2 of the BGRA readback) feeding GRAB_IMAGE events and
the HTTP ImageJPEG endpoint (communicator.cpp:228-229).  Pillow stands in
for libjpeg-turbo; a dependency-free zlib PNG encoder is kept as fallback.
"""

from __future__ import annotations

import struct
import zlib
from typing import Optional

import numpy as np


def to_uint8(img: np.ndarray, flip: bool = True) -> np.ndarray:
    """Float [0,1] (H, W, C) render output → uint8, top-down row order.

    The renderer produces GL bottom-up rows (ops/rays.py); image files are
    top-down, hence the default flip.
    """
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if flip:
        img = img[::-1]
    return np.ascontiguousarray(img)


def encode_png(img: np.ndarray, flip: bool = True) -> bytes:
    """Minimal zlib PNG encoder (RGB/RGBA/gray), no dependencies."""
    arr = to_uint8(img, flip)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]

    raw = b"".join(b"\x00" + arr[i].tobytes() for i in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


def encode_jpeg(img: np.ndarray, quality: int = 90, flip: bool = True) -> bytes:
    """JPEG bytes via Pillow (alpha dropped — JPEG has none)."""
    import io

    from PIL import Image

    arr = to_uint8(img, flip)
    if arr.ndim == 3 and arr.shape[-1] == 4:
        arr = arr[..., :3]
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def write_image(path: str, img: np.ndarray, flip: bool = True) -> None:
    """Write by extension (.png / .jpg / .jpeg)."""
    lower = path.lower()
    if lower.endswith(".png"):
        data = encode_png(img, flip)
    elif lower.endswith((".jpg", ".jpeg")):
        data = encode_jpeg(img, flip=flip)
    else:
        raise ValueError(f"unsupported image extension: {path}")
    with open(path, "wb") as f:
        f.write(data)


def read_image(path: str) -> np.ndarray:
    """Minimal PNG reader for files written by :func:`encode_png`
    (8-bit, non-interlaced, filter-0 rows) — round-trip verification
    helper for app-level tests; not a general decoder."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos = 8
    idat = b""
    w = h = color_type = None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, color_type, _c, _f, inter = struct.unpack(
                ">IIBBBBB", body
            )
            if depth != 8 or inter != 0:
                raise ValueError("only 8-bit non-interlaced supported")
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
    c = {0: 1, 2: 3, 4: 2, 6: 4}[color_type]
    raw = zlib.decompress(idat)
    stride = w * c + 1
    out = np.empty((h, w * c), np.uint8)
    for i in range(h):
        row = raw[i * stride : (i + 1) * stride]
        if row[0] != 0:
            raise ValueError("only filter-0 rows supported")
        out[i] = np.frombuffer(row[1:], np.uint8)
    return out.reshape(h, w, c)
