"""Raw / NRRD file data source: ``raw://path#X,Y,Z,dtype`` or ``raw://file.nrrd``.

Reference: datasources/raw/RawDataSource.cpp (mmap-backed single brick:
tree depth 1, zero overlap, max block size == volume size) with a vendored
NRRD header parser (raw/nrrd/nrrd.hxx).  Here the NRRD parser is a small
native-format reader supporting raw and gzip encodings.
"""

from __future__ import annotations

import gzip
import os
from typing import Dict, Tuple

import numpy as np

from libre_tpu_torch.core.lodnode import LODNode
from libre_tpu_torch.core.volume_info import (
    DataType,
    VolumeInformation,
)
from libre_tpu_torch.core.nodeid import RootNode
from libre_tpu_torch.data.datasource import DataSourcePlugin, ParsedURI, register_datasource

_NRRD_TYPES = {
    "signed char": DataType.INT8,
    "int8": DataType.INT8,
    "int8_t": DataType.INT8,
    "uchar": DataType.UINT8,
    "unsigned char": DataType.UINT8,
    "uint8": DataType.UINT8,
    "uint8_t": DataType.UINT8,
    "short": DataType.INT16,
    "short int": DataType.INT16,
    "signed short": DataType.INT16,
    "int16": DataType.INT16,
    "int16_t": DataType.INT16,
    "ushort": DataType.UINT16,
    "unsigned short": DataType.UINT16,
    "uint16": DataType.UINT16,
    "uint16_t": DataType.UINT16,
    "int": DataType.INT32,
    "signed int": DataType.INT32,
    "int32": DataType.INT32,
    "int32_t": DataType.INT32,
    "uint": DataType.UINT32,
    "unsigned int": DataType.UINT32,
    "uint32": DataType.UINT32,
    "uint32_t": DataType.UINT32,
    "float": DataType.FLOAT,
}


def parse_nrrd_header(path: str) -> Tuple[Dict[str, str], int]:
    """Parse a NRRD header; returns (fields, data_offset)."""
    fields: Dict[str, str] = {}
    with open(path, "rb") as f:
        magic = f.readline()
        if not magic.startswith(b"NRRD"):
            raise ValueError(f"{path}: not a NRRD file")
        offset = len(magic)
        while True:
            line = f.readline()
            offset += len(line)
            if not line or line in (b"\n", b"\r\n"):
                break
            text = line.decode("ascii", "replace").strip()
            if text.startswith("#"):
                continue
            for sep in (": ", ":=", ":"):
                if sep in text:
                    key, _, value = text.partition(sep)
                    fields[key.strip().lower()] = value.strip()
                    break
    return fields, offset


def load_nrrd(path: str) -> Tuple[np.ndarray, Dict[str, str]]:
    """Load a NRRD volume as an array shaped (Z, Y, X) (x fastest)."""
    fields, offset = parse_nrrd_header(path)
    dtype = _NRRD_TYPES[fields["type"]].numpy_dtype
    sizes = [int(s) for s in fields["sizes"].split()]
    if int(fields.get("dimension", len(sizes))) != len(sizes):
        raise ValueError(f"{path}: inconsistent dimension/sizes")
    if len(sizes) != 3:
        raise ValueError(f"{path}: only 3-D NRRD supported, got sizes {sizes}")
    endian = fields.get("endian", "little")
    if endian == "big" and dtype.itemsize > 1:
        dtype = dtype.newbyteorder(">")
    encoding = fields.get("encoding", "raw")

    datafile = fields.get("data file") or fields.get("datafile")
    if datafile:
        data_path = os.path.join(os.path.dirname(path), datafile)
        data_offset = 0
    else:
        data_path = path
        data_offset = offset

    count = int(np.prod(sizes))
    if encoding in ("raw",):
        data = np.memmap(data_path, dtype=dtype, mode="r", offset=data_offset)[:count]
    elif encoding in ("gzip", "gz"):
        with open(data_path, "rb") as f:
            f.seek(data_offset)
            buf = gzip.decompress(f.read())
        data = np.frombuffer(buf, dtype=dtype, count=count)
    else:
        raise ValueError(f"{path}: unsupported NRRD encoding {encoding!r}")

    # NRRD sizes list the fastest axis first: sizes = (X, Y, Z).
    x, y, z = sizes
    return data.reshape(z, y, x), fields


@register_datasource
class RawDataSource(DataSourcePlugin):
    """Whole-volume single-brick source (RawDataSource.cpp:78-129)."""

    def __init__(self, uri: ParsedURI):
        super().__init__()
        path = uri.path
        info = self.volume_info

        if path.endswith(".nrrd"):
            self._data, fields = load_nrrd(path)
            info.data_type = _NRRD_TYPES[fields["type"]]
            z, y, x = self._data.shape
            info.voxels = (x, y, z)
        else:
            params = [p for p in uri.fragment.split(",") if p]
            if len(params) < 4:
                raise ValueError(
                    "raw:// URIs need a '#X,Y,Z,dtype' fragment, got "
                    f"{uri.raw!r}"
                )
            info.voxels = tuple(int(p) for p in params[:3])
            info.data_type = DataType.from_string(params[3])
            x, y, z = info.voxels
            self._data = np.memmap(path, dtype=info.data_type.numpy_dtype, mode="r")[
                : x * y * z
            ].reshape(z, y, x)

        # Single brick covering the whole volume: depth-1 tree, no overlap
        # (RawDataSource.cpp:78-88).
        info.overlap = (0, 0, 0)
        info.maximum_block_size = info.voxels
        info.world_space_per_voxel = 1.0 / float(max(info.voxels))
        info.world_size = tuple(v * info.world_space_per_voxel for v in info.voxels)
        info.root_node = RootNode(1, (1, 1, 1))
        info.frame_range = (0, 1)

    @staticmethod
    def handles(uri: ParsedURI) -> bool:
        return uri.scheme == "raw" or (
            uri.scheme in ("", "file") and uri.path.endswith((".nrrd", ".raw"))
        )

    def get_data(self, lod_node: LODNode) -> np.ndarray:
        return np.asarray(self._data)
