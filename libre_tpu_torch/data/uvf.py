"""UVF (ImageVis3D / Tuvok) bricked-octree reader: ``uvf://file.uvf``.

Reference: datasources/uvf/UVFDataSource.cpp — Livre reads UVF v5 files
through Tuvok: the extended-octree TOC block provides per-brick offsets
into the file, bricks are mmap-read and zlib-decompressed
(UVFDataSource.cpp:203-301), the LOD-tree depth comes from walking the
brick layout until a dimension collapses to one brick
(UVFDataSource.cpp:77-90), and Livre tree levels invert Tuvok LOD
indices (UVFDataSource.cpp:303-381).

This is a from-scratch parser of the UVF v5 container (no Tuvok): the
byte layout below was reverse-engineered against the reference's own
test fixture (tests/uvf/mouse_reduced.uvf) and validated by the golden
values in tests/uvf/uvf.cpp plus cross-brick ghost-voxel consistency.

Container layout (little-endian; offsets verified on the fixture):

    global header:  b"UVF-DATA" | u8 is_big_endian | u64 version(5) |
                    u64 checksum_semantics | u64 checksum_len |
                    checksum bytes | u64 offset_to_first_block
    data blocks:    u64 id_len | id | u64 semantics | u64 compression |
                    u64 next  — ``next`` is relative to the END of the
                    global header (UVFDataSource.cpp:178-181 recomputes
                    exactly this base)
    TOC block (semantics 9) payload = extended octree:
                    u32 component_type | u64 component_count | u8 flag |
                    3×u64 volume_size | 3×f64 aspect | 3×u64 brick_size |
                    u32 overlap | u32 eo_version | u64 payload_size |
                    u32 (unknown) | table of contents | brick blobs
    ToC entry (36B): u64 offset (relative to the block payload start) |
                    u64 length | u32 compression (0 none, 1 zlib) |
                    u64 uncompressed_length | 2×u32 atlas size

Brick semantics (validated): LOD L dims = ceil-halving of the volume;
bricks tile the LOD in inner blocks of ``brick_size - 2*overlap`` voxels,
x-fastest; every stored brick carries the full 2-voxel overlap on ALL
sides (edge-replicated at volume borders), so a brick's byte count is
``prod(min(inner, dims - pos*inner) + 2*overlap)``.  Bricks are ordered
finest LOD first.

Divergence from the reference: edge bricks are returned padded to
``maximum_block_size`` by edge replication (the reference returns their
native smaller extent) — interior voxels are identical and the uniform
shape feeds the HBM brick atlas directly.
"""

from __future__ import annotations

import struct
import zlib
from typing import List, Tuple

import numpy as np

from libre_tpu_torch.core.lodnode import LODNode
from libre_tpu_torch.core.nodeid import NodeId, RootNode
from libre_tpu_torch.core.volume_info import DataType, VolumeInformation
from libre_tpu_torch.data.datasource import (
    DataSourcePlugin,
    ParsedURI,
    register_datasource,
)

MAGIC = b"UVF-DATA"
BS_TOC_BLOCK = 9
_CT_NONE, _CT_ZLIB = 0, 1

# Tuvok ExtendedOctree COMPONENT_TYPE order (0 = uint8 verified on the
# fixture; the rest follow the enum).
_COMPONENT_TYPES = (
    "uint8", "uint16", "uint32", "uint64",
    "int8", "int16", "int32", "int64",
    "float32", "float64",
)


class _TocBlock:
    """One extended-octree TOC block (= one timestep)."""

    def __init__(self, raw: memoryview, payload_start: int):
        self.base = payload_start
        off = payload_start
        (comp_type,) = struct.unpack_from("<I", raw, off); off += 4
        (self.component_count,) = struct.unpack_from("<Q", raw, off); off += 8
        off += 1  # flag byte (precomputed-normals)
        self.volume = struct.unpack_from("<3Q", raw, off); off += 24
        self.aspect = struct.unpack_from("<3d", raw, off); off += 24
        self.brick_size = struct.unpack_from("<3Q", raw, off); off += 24
        (self.overlap,) = struct.unpack_from("<I", raw, off); off += 4
        (self.eo_version,) = struct.unpack_from("<I", raw, off); off += 4
        (self.payload_size,) = struct.unpack_from("<Q", raw, off); off += 8
        off += 4  # unknown u32 (value 4 on the fixture)
        if comp_type >= len(_COMPONENT_TYPES):
            raise ValueError(f"UVF: unknown component type {comp_type}")
        self.dtype = DataType.from_string(_COMPONENT_TYPES[comp_type])

        inner = tuple(b - 2 * self.overlap for b in self.brick_size)
        if any(i <= 0 for i in inner):
            raise ValueError("UVF: overlap >= brick size")
        # LOD pyramid: ceil-halving until every dim fits one inner block.
        self.lod_dims: List[Tuple[int, int, int]] = []
        self.lod_layout: List[Tuple[int, int, int]] = []
        dims = tuple(int(v) for v in self.volume)
        while True:
            layout = tuple(-(-d // i) for d, i in zip(dims, inner))
            self.lod_dims.append(dims)
            self.lod_layout.append(layout)
            if all(d <= i for d, i in zip(dims, inner)):
                break
            dims = tuple((d + 1) // 2 for d in dims)
        self.inner = inner

        n_bricks = sum(nx * ny * nz for nx, ny, nz in self.lod_layout)
        self.toc = []
        for i in range(n_bricks):
            o, l = struct.unpack_from("<QQ", raw, off)
            (c,) = struct.unpack_from("<I", raw, off + 16)
            (v,) = struct.unpack_from("<Q", raw, off + 20)
            self.toc.append((o, l, c, v))
            off += 36
        # first-brick offset must land past the ToC (layout sanity)
        if self.toc and payload_start + self.toc[0][0] < off:
            raise ValueError("UVF: ToC overlaps brick data — bad layout")
        # LOD-major, x-fastest brick numbering: base index per LOD.
        self.lod_first = []
        acc = 0
        for nx, ny, nz in self.lod_layout:
            self.lod_first.append(acc)
            acc += nx * ny * nz

    def brick_dims(self, lod: int, pos) -> Tuple[int, int, int]:
        """Stored brick extent (x, y, z) incl. overlap on all sides."""
        dims = self.lod_dims[lod]
        return tuple(
            min(self.inner[i], dims[i] - pos[i] * self.inner[i])
            + 2 * self.overlap
            for i in range(3)
        )

    def entry(self, lod: int, pos):
        nx, ny, _ = self.lod_layout[lod]
        idx = self.lod_first[lod] + pos[0] + pos[1] * nx + pos[2] * nx * ny
        return self.toc[idx]


@register_datasource
class UVFDataSource(DataSourcePlugin):
    """Out-of-core UVF v5 reader (UVFDataSource.cpp equivalent)."""

    def __init__(self, uri: ParsedURI):
        super().__init__()
        self._path = uri.path
        self._mmap = np.memmap(self._path, dtype=np.uint8, mode="r")
        raw = memoryview(self._mmap)
        if bytes(raw[:8]) != MAGIC:
            raise ValueError(f"{self._path}: not a UVF file")
        off = 8
        big_endian = raw[off]; off += 1
        if big_endian:
            raise ValueError("UVF: big-endian files are not supported")
        (version,) = struct.unpack_from("<Q", raw, off); off += 8
        if version != 5:
            raise ValueError(f"UVF: unsupported version {version} (only 5)")
        off += 8  # checksum semantics
        (cs_len,) = struct.unpack_from("<Q", raw, off); off += 8
        off += cs_len
        (off_first,) = struct.unpack_from("<Q", raw, off); off += 8
        data_base = off + off_first  # blocks' `next` offsets are relative

        # Walk the data-block chain, collecting TOC blocks (one per
        # timestep, UVFDataSource.cpp:160-173).
        self._tocs: List[_TocBlock] = []
        pos = data_base
        while pos + 8 <= len(raw):
            (id_len,) = struct.unpack_from("<Q", raw, pos)
            hdr_end = pos + 8 + id_len + 24
            if id_len > 4096 or hdr_end > len(raw):
                break
            semantics, _compression, next_rel = struct.unpack_from(
                "<3Q", raw, pos + 8 + id_len
            )
            if semantics == BS_TOC_BLOCK:
                self._tocs.append(_TocBlock(raw, hdr_end))
            if next_rel == 0:
                break
            pos = data_base + next_rel
        if not self._tocs:
            raise ValueError(f"{self._path}: no TOC block found")
        toc = self._tocs[0]

        # Livre depth: walk coarser layouts until a dimension collapses
        # to a single brick (UVFDataSource.cpp:77-86).
        depth = 1
        n_lods = len(toc.lod_layout)
        while depth < n_lods and all(
            n > 1 for n in toc.lod_layout[depth]
        ):
            depth += 1
        root_layout = toc.lod_layout[depth - 1]

        info = self.volume_info
        info.voxels = tuple(int(v) for v in toc.volume)
        info.overlap = (toc.overlap,) * 3
        info.maximum_block_size = tuple(int(b) for b in toc.brick_size)
        info.data_type = toc.dtype
        info.component_count = int(toc.component_count)
        info.root_node = RootNode(depth, root_layout)
        info.world_space_per_voxel = 1.0 / float(max(info.voxels))
        info.world_size = tuple(
            v * info.world_space_per_voxel for v in info.voxels
        )
        info.frame_range = (0, len(self._tocs))

    @staticmethod
    def handles(uri: ParsedURI) -> bool:
        return uri.scheme == "uvf" or uri.path.endswith(".uvf")

    # ------------------------------------------------------------- nodes
    def _tuvok_lod(self, level: int) -> int:
        """Livre tree level → Tuvok LOD (UVFDataSource.cpp:380-383)."""
        return self.volume_info.root_node.depth - level - 1

    def internal_node_to_lod_node(self, node_id: NodeId) -> LODNode:
        toc = self._tocs[0]
        lod = self._tuvok_lod(node_id.level)
        pos = node_id.position
        layout = toc.lod_layout[lod]
        if any(p >= n for p, n in zip(pos, layout)):
            # the UVF brick grid is a subset of the perfect octree
            # (UVFDataSource.cpp:311-318): out-of-grid child ⇒ invalid
            return LODNode(
                node_id=node_id,
                block_size=(0, 0, 0),
                world_box_min=(0.0, 0.0, 0.0),
                world_box_max=(0.0, 0.0, 0.0),
            )
        dims = toc.lod_dims[lod]
        inner = toc.inner
        lo = tuple(p * i for p, i in zip(pos, inner))
        hi = tuple(min(l + i, d) for l, i, d in zip(lo, inner, dims))
        ws = np.asarray(self.volume_info.world_size, np.float32)
        half = ws * np.float32(0.5)
        dims_f = np.asarray(dims, np.float32)
        box_min = ws * np.asarray(lo, np.float32) / dims_f - half
        box_max = ws * np.asarray(hi, np.float32) / dims_f - half
        return LODNode(
            node_id=node_id,
            block_size=tuple(h - l for l, h in zip(lo, hi)),
            world_box_min=tuple(float(x) for x in box_min),
            world_box_max=tuple(float(x) for x in box_max),
        )

    def get_data_batch(self, lod_nodes):
        """Parallel UVF batch read through the native mmap+zlib pool
        (native/brickio.cpp) — the Tuvok-reader analog of the 4-thread
        upload sharding.  Interior bricks (uniform raw size, uniform
        compression, one ToC) batch natively; edge/odd bricks fall back
        to the serial reader."""
        from libre_tpu_torch.data import native_io

        if not lod_nodes or not native_io.available():
            return [self.get_data(n) for n in lod_nodes]
        info = self.volume_info
        metas = []
        for n in lod_nodes:
            node_id = n.node_id
            ts = min(node_id.time_step, len(self._tocs) - 1)
            toc = self._tocs[ts]
            lod = self._tuvok_lod(node_id.level)
            pos = node_id.position
            layout = toc.lod_layout[lod]
            if any(p < 0 or p >= g for p, g in zip(pos, layout)):
                metas.append(None)  # serial path raises loudly
                continue
            metas.append(
                (toc, lod, pos) + toc.entry(lod, pos)
            )  # (+ offset, length, compression, raw_len)
        groups = {}
        for i, m in enumerate(metas):
            if m is None:
                continue
            toc, lod, pos, off, ln, comp, raw = m
            if comp not in (_CT_NONE, _CT_ZLIB):
                continue
            groups.setdefault((id(toc), comp, raw), []).append(i)
        out = [None] * len(lod_nodes)
        for (tid, comp, raw), idxs in groups.items():
            if len(idxs) < 2:
                continue
            toc = metas[idxs[0]][0]
            blobs = native_io.read_bricks(
                self._path,
                toc.base,
                [metas[i][3] for i in idxs],
                [metas[i][4] for i in idxs],
                raw,
                comp == _CT_ZLIB,
            )
            for j, i in enumerate(idxs):
                _toc, lod, pos = metas[i][:3]
                dx, dy, dz = _toc.brick_dims(lod, pos)
                arr = blobs[j].view(info.data_type.numpy_dtype).reshape(
                    dz, dy, dx
                )
                mx, my, mz = info.maximum_block_size
                if (dx, dy, dz) != (mx, my, mz):
                    arr = np.pad(
                        arr,
                        ((0, mz - dz), (0, my - dy), (0, mx - dx)),
                        mode="edge",
                    )
                out[i] = arr
        for i, n in enumerate(lod_nodes):
            if out[i] is None:
                out[i] = self.get_data(n)
        return out

    # -------------------------------------------------------------- data
    def get_data(self, lod_node: LODNode) -> np.ndarray:
        info = self.volume_info
        node_id = lod_node.node_id
        ts = min(node_id.time_step, len(self._tocs) - 1)
        toc = self._tocs[ts]
        lod = self._tuvok_lod(node_id.level)
        pos = node_id.position
        layout = toc.lod_layout[lod]
        if any(p < 0 or p >= n for p, n in zip(pos, layout)):
            # Out-of-grid child of a non-octree subset: the flat ToC
            # index would silently land in another LOD's entries
            # (UVFDataSource.cpp:311-318 marks these invalid).
            raise ValueError(
                f"UVF: node {node_id} outside the LOD {lod} brick grid "
                f"{layout}"
            )
        offset, length, compression, raw_len = toc.entry(lod, pos)
        start = toc.base + offset
        blob = bytes(self._mmap[start : start + length])
        if compression == _CT_ZLIB:
            blob = zlib.decompress(blob)
        elif compression != _CT_NONE:
            raise ValueError(f"UVF: unsupported brick compression {compression}")
        if len(blob) != raw_len:
            raise ValueError(
                f"UVF: brick {node_id} size {len(blob)} != ToC {raw_len}"
            )
        dx, dy, dz = toc.brick_dims(lod, pos)
        arr = np.frombuffer(blob, dtype=info.data_type.numpy_dtype)
        arr = arr.reshape(dz, dy, dx)
        # pad edge bricks to the uniform atlas shape (edge replication)
        mx, my, mz = info.maximum_block_size
        if (dx, dy, dz) != (mx, my, mz):
            arr = np.pad(
                arr,
                ((0, mz - dz), (0, my - dy), (0, mx - dx)),
                mode="edge",
            )
        return arr
