"""Multi-device decomposition (``libre_tpu.parallel``): sort-first (ray
rows) and sort-last (brick and plane ranges) over a ``(ray, brick)``
device mesh driven by one process, with the collectives as explicit
moves between shards.

The reference's Equalizer/Collage distributed layer (livre/eq/, SURVEY.md
§2.8, §2.12): screen-space and data-range decompositions become mesh
axes; image compositing becomes an ordered over-reduce along the brick
axis; the process lifecycle and frame-state sync become
``torch.distributed`` (``parallel/distributed.py``).
"""

from libre_tpu_torch.parallel.bricked_sharded import (
    build_sharded_slabs,
    render_store_grid_sharded,
)
from libre_tpu_torch.parallel.compositing import fold_over, over
from libre_tpu_torch.parallel.mesh import make_mesh
from libre_tpu_torch.parallel.render import (
    render_rays_sharded,
    shard_bricks_front_to_back,
)

__all__ = [
    "make_mesh",
    "over",
    "fold_over",
    "render_rays_sharded",
    "shard_bricks_front_to_back",
    "build_sharded_slabs",
    "render_store_grid_sharded",
]
