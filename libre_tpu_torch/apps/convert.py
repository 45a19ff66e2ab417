"""Volume converter: raw / NRRD / procedural volume → bricked LOD store.

The reference ships UVF files produced by external Tuvok tooling
(datasources/uvf); this is the in-framework equivalent for the ``lod://``
store — build the LOD pyramid + padded bricks once, then render
out-of-core.

    python -m libre_tpu_torch.apps.convert --volume raw://vol.raw#256,256,256,uint8 \\
        --output vol.lod --block-size 32 --overlap 2
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    from libre_tpu_torch.data.datasource import DataSource, load_plugins
    from libre_tpu_torch.data.lod_store import build_lod_store

    p = argparse.ArgumentParser(description="Convert a volume to a LOD store")
    p.add_argument("--volume", required=True, help="source URI (raw://, mem://, .nrrd)")
    p.add_argument("--output", required=True, help="output .lod path")
    p.add_argument("--block-size", type=int, default=32)
    p.add_argument("--overlap", type=int, default=2)
    p.add_argument("--no-compress", action="store_true")
    args = p.parse_args(argv)

    load_plugins()
    ds = DataSource(args.volume)
    info = ds.volume_info
    root = info.root_node

    # Reassemble the full-resolution volume from the source's bricks.
    t0 = time.perf_counter()
    level = root.depth - 1
    vx, vy, vz = info.voxels
    dtype = info.data_type.numpy_dtype
    volume = np.zeros((vz, vy, vx), dtype)
    bx, by, bz = info.block_size
    ox, oy, oz = info.overlap
    from libre_tpu_torch.core.nodeid import NodeId

    nbx, nby, nbz = (max(1, -(-vx // bx)), max(1, -(-vy // by)), max(1, -(-vz // bz)))
    for px in range(nbx):
        for py in range(nby):
            for pz in range(nbz):
                node = NodeId.from_coords(level, (px, py, pz))
                brick = ds.get_data(node)
                core = brick[
                    oz : brick.shape[0] - oz or None,
                    oy : brick.shape[1] - oy or None,
                    ox : brick.shape[2] - ox or None,
                ]
                z0, y0, x0 = pz * bz, py * by, px * bx
                ze = min(z0 + core.shape[0], vz)
                ye = min(y0 + core.shape[1], vy)
                xe = min(x0 + core.shape[2], vx)
                volume[z0:ze, y0:ye, x0:xe] = core[: ze - z0, : ye - y0, : xe - x0]

    print(f"read source volume {info.voxels} in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out_info = build_lod_store(
        volume,
        args.output,
        block_size=args.block_size,
        overlap=args.overlap,
        compress=not args.no_compress,
    )
    print(
        f"wrote {args.output}: depth {out_info.root_node.depth}, "
        f"block {args.block_size}+2x{args.overlap} overlap, "
        f"in {time.perf_counter() - t0:.1f} s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
