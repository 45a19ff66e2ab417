"""Bricked octree LOD store: ``lod://file.lod`` — the UVF-format equivalent.

Reference behavior: datasources/uvf/UVFDataSource.cpp — a bricked
multi-resolution file with a table of contents, per-brick mmap reads and
optional zlib decompression (UVFDataSource.cpp:249-301), octree depth and
brick metadata from the file header (UVFDataSource.cpp:59-152).

This is a fresh single-file format (not UVF): a JSON header + TOC followed
by raw or zlib-deflated brick blobs.  Bricks are stored *padded* with ghost
voxels so each is self-contained for (tri)linear sampling — the reference's
overlap design (VolumeInformation.h:63-66).  ``build_lod_store`` converts a
dense volume (or a raw/NRRD datasource) into this format, building the LOD
pyramid by 2× box-filter downsampling.

Layout:
    bytes 0..7    magic b"LTPULOD1"
    bytes 8..15   little-endian uint64 header length H
    bytes 16..16+H  JSON header (metadata + toc: {node_id: [offset, nbytes,
                    raw_nbytes]}) — offsets relative to the blob section
    rest          brick blobs
"""

from __future__ import annotations

import json
import math
import os
import zlib
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from libre_tpu_torch.core.lodnode import LODNode
from libre_tpu_torch.core.nodeid import NodeId, RootNode
from libre_tpu_torch.core.volume_info import DataType, VolumeInformation, fill_regular_volume_info
from libre_tpu_torch.data.datasource import DataSourcePlugin, ParsedURI, register_datasource
from libre_tpu_torch.ops.reference import BrickSet

MAGIC = b"LTPULOD1"


def _downsample2(vol: np.ndarray) -> np.ndarray:
    """2× box-filter downsample of a (Z, Y, X) volume (pads odd extents)."""
    z, y, x = vol.shape
    pz, py, px = (z + 1) // 2 * 2, (y + 1) // 2 * 2, (x + 1) // 2 * 2
    if (pz, py, px) != (z, y, x):
        vol = np.pad(vol, ((0, pz - z), (0, py - y), (0, px - x)), mode="edge")
    v = vol.astype(np.float64)
    v = v.reshape(pz // 2, 2, py // 2, 2, px // 2, 2).mean(axis=(1, 3, 5))
    return v.astype(vol.dtype) if not np.issubdtype(vol.dtype, np.floating) else v.astype(
        vol.dtype
    )


def _padded_range(lo: int, block: int, overlap: int, dim: int) -> np.ndarray:
    """The voxel indices of one axis of a padded brick whose interior starts
    at ``lo``: ``overlap`` ghost voxels each side, clamped at the volume
    border (edge padding) so ghost voxels are always defined."""
    return np.clip(np.arange(lo - overlap, lo + block + overlap), 0, dim - 1)


def _extract_padded_brick(
    vol: np.ndarray, voxel_lo: Tuple[int, int, int], block: Tuple[int, int, int],
    overlap: Tuple[int, int, int],
) -> np.ndarray:
    """Copy a padded brick out of a (Z, Y, X) level volume, clamping at the
    volume border (edge padding) so ghost voxels are always defined."""
    ox, oy, oz = overlap
    bx, by, bz = block
    x0, y0, z0 = voxel_lo
    zdim, ydim, xdim = vol.shape
    zi = _padded_range(z0, bz, oz, zdim)
    yi = _padded_range(y0, by, oy, ydim)
    xi = _padded_range(x0, bx, ox, xdim)
    return vol[np.ix_(zi, yi, xi)]


def brick_volume(volume_zyx, block_size: int, overlap: int = 2, device=None) -> BrickSet:
    """Brick a (Z, Y, X) volume into a :class:`BrickSet` of padded bricks,
    the store's layout at one level: interiors of ``block_size``³ voxels,
    each with ``overlap`` ghost voxels a side (:func:`_extract_padded_brick`'s
    extraction, clamped at the border), in x-major, then y, then z order.
    World boxes are the interiors' in the volume's box (its longest axis
    spans 1, centred on the origin, as ``LODStoreDataSource``'s); texture
    insets place the interior in its padded brick.

    ``volume_zyx`` is a numpy array or a tensor, whose bricks are cut on
    its own device in one gather; the set lands on ``device`` (default:
    the tensor's device, or the CPU).  Every extent must be a multiple of
    ``block_size``."""
    dims = tuple(int(d) for d in volume_zyx.shape)
    if len(dims) != 3 or any(d % block_size for d in dims):
        raise ValueError(f"brick_volume: a (Z, Y, X) volume whose extents are multiples of "
                         f"{block_size}, got {dims}")
    counts_zyx = [d // block_size for d in dims]
    order = [(bx, by, bz) for bx in range(counts_zyx[2]) for by in range(counts_zyx[1])
             for bz in range(counts_zyx[0])]

    def ranges(axis, coord):  # (B, padded) voxel indices along one axis
        return np.stack([_padded_range(c[coord] * block_size, block_size, overlap, dims[axis])
                         for c in order])

    zi, yi, xi = ranges(0, 2), ranges(1, 1), ranges(2, 0)
    index = (zi[:, :, None, None], yi[:, None, :, None], xi[:, None, None, :])
    if isinstance(volume_zyx, torch.Tensor):
        src = volume_zyx.device
        data = volume_zyx[tuple(torch.from_numpy(i).to(src) for i in index)]
        device = src if device is None else device
    else:
        data = torch.from_numpy(np.ascontiguousarray(np.asarray(volume_zyx)[index]))
        device = "cpu" if device is None else device
    scale = max(dims)
    half = np.float32(dims[::-1]) / scale / 2
    lo = np.float32(order) * block_size
    pdim = block_size + 2 * overlap

    def rows(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)

    n = len(order)
    return BrickSet(
        data=data.to(device).contiguous(),
        world_min=rows(lo / scale - half),
        world_max=rows((lo + block_size) / scale - half),
        tex_min=rows(np.full((n, 3), overlap / pdim, np.float32)),
        tex_max=rows(np.full((n, 3), (overlap + block_size) / pdim, np.float32)),
    )


def build_lod_store(
    volume_zyx: np.ndarray,
    path: str,
    block_size: int = 32,
    overlap: int = 2,
    compress: bool = True,
    data_type: Optional[DataType] = None,
) -> VolumeInformation:
    """Convert a dense (Z, Y, X) volume into a bricked LOD file.

    Levels follow the reference's flat-octree convention
    (fillRegularVolumeInfo): level ``depth-1`` is full resolution, level 0
    the coarsest; level L-1 is a 2× downsample of level L.
    """
    volume_zyx = np.ascontiguousarray(volume_zyx)
    if data_type is None:
        data_type = DataType.from_string(str(volume_zyx.dtype))

    info = VolumeInformation()
    z, y, x = volume_zyx.shape
    info.voxels = (x, y, z)
    info.overlap = (overlap,) * 3
    info.maximum_block_size = (block_size + 2 * overlap,) * 3
    info.data_type = data_type
    fill_regular_volume_info(info)
    depth = info.root_node.depth

    # Build the level pyramid: pyramid[level], level depth-1 == native res.
    pyramid = {depth - 1: volume_zyx}
    for level in range(depth - 2, -1, -1):
        pyramid[level] = _downsample2(pyramid[level + 1])

    toc: Dict[str, list] = {}
    blobs = []
    offset = 0
    block3 = (block_size,) * 3
    for level in range(depth):
        vol = pyramid[level]
        zdim, ydim, xdim = vol.shape
        nb = (
            math.ceil(xdim / block_size),
            math.ceil(ydim / block_size),
            math.ceil(zdim / block_size),
        )
        for px in range(nb[0]):
            for py in range(nb[1]):
                for pz in range(nb[2]):
                    node = NodeId.from_coords(level, (px, py, pz))
                    brick = _extract_padded_brick(
                        vol,
                        (px * block_size, py * block_size, pz * block_size),
                        block3,
                        info.overlap,
                    )
                    rawb = np.ascontiguousarray(brick).tobytes()
                    blob = zlib.compress(rawb, 1) if compress else rawb
                    toc[str(node.id)] = [offset, len(blob), len(rawb)]
                    blobs.append(blob)
                    offset += len(blob)

    header = {
        "voxels": list(info.voxels),
        "block_size": block_size,
        "overlap": overlap,
        "dtype": data_type.value,
        "depth": depth,
        "root_block_count": list(info.root_node.block_count),
        "compressed": compress,
        "toc": toc,
    }
    hdr = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(len(hdr).to_bytes(8, "little"))
        f.write(hdr)
        for blob in blobs:
            f.write(blob)
    return info


@register_datasource
class LODStoreDataSource(DataSourcePlugin):
    """Out-of-core bricked octree reader (UVFDataSource.cpp equivalent)."""

    def __init__(self, uri: ParsedURI):
        super().__init__()
        path = uri.path
        with open(path, "rb") as f:
            if f.read(8) != MAGIC:
                raise ValueError(f"{path}: not a libre_tpu LOD store")
            hlen = int.from_bytes(f.read(8), "little")
            header = json.loads(f.read(hlen))
        self._blob_base = 16 + hlen
        self._path = path
        self._mmap = np.memmap(path, dtype=np.uint8, mode="r")
        self._toc = {int(k): v for k, v in header["toc"].items()}
        self._compressed = header["compressed"]

        info = self.volume_info
        info.voxels = tuple(header["voxels"])
        info.overlap = (header["overlap"],) * 3
        info.maximum_block_size = (header["block_size"] + 2 * header["overlap"],) * 3
        info.data_type = DataType.from_string(header["dtype"])
        info.root_node = RootNode(header["depth"], header["root_block_count"])
        info.world_space_per_voxel = 1.0 / float(max(info.voxels))
        info.world_size = tuple(v * info.world_space_per_voxel for v in info.voxels)
        info.frame_range = (0, 1)

    @staticmethod
    def handles(uri: ParsedURI) -> bool:
        return uri.scheme == "lod" or uri.path.endswith(".lod")

    def has_brick(self, node_id: NodeId) -> bool:
        return node_id.id in self._toc

    def get_data(self, lod_node: LODNode) -> np.ndarray:
        entry = self._toc.get(lod_node.node_id.id)
        if entry is None:
            raise KeyError(f"brick {lod_node.node_id} not in store")
        offset, nbytes, raw_nbytes = entry
        start = self._blob_base + offset
        buf = bytes(self._mmap[start : start + nbytes])
        if self._compressed:
            buf = zlib.decompress(buf)
        padded = self.volume_info.maximum_block_size
        arr = np.frombuffer(buf, dtype=self.volume_info.data_type.numpy_dtype)
        return arr.reshape(padded[2], padded[1], padded[0])

    def get_data_batch(self, lod_nodes) -> list:
        """Parallel batch read through the native mmap+zlib reader
        (native/brickio.cpp; the multithreaded analog of the 4-thread
        upload sharding, GLRenderUploadFilter.cpp:79-107).  Falls back to
        serial Python reads if the native library is unavailable."""
        from libre_tpu_torch.data import native_io

        if not lod_nodes:
            return []
        entries = []
        for n in lod_nodes:
            e = self._toc.get(n.node_id.id)
            if e is None:
                raise KeyError(f"brick {n.node_id} not in store")
            entries.append(e)
        raw_sizes = {e[2] for e in entries}
        if not native_io.available() or len(raw_sizes) != 1:
            return [self.get_data(n) for n in lod_nodes]
        raw_nbytes = raw_sizes.pop()
        out = native_io.read_bricks(
            self._path,
            self._blob_base,
            [e[0] for e in entries],
            [e[1] for e in entries],
            raw_nbytes,
            self._compressed,
        )
        padded = self.volume_info.maximum_block_size
        dtype = self.volume_info.data_type.numpy_dtype
        return [
            out[i].view(dtype).reshape(padded[2], padded[1], padded[0])
            for i in range(len(lod_nodes))
        ]
