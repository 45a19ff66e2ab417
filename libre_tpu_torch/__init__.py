"""libre_tpu_torch — the PyTorch + CUDA port of libre_tpu.

The package mirrors ``libre_tpu``'s layout (``core/``, ``data/``,
``ops/``, ``render/``, ``train/``, ``apps/``, ``utils/``) and keeps its
module and function names, so each counterpart is easy to find.  It
imports ``torch`` and never ``jax``, and nothing of ``libre_tpu``: the
numpy host layer it needs (octree, LOD selection, frustum, caches,
configuration, datasources, image files) is copied into ``core/``,
``data/`` and ``utils/``.

Implemented slices (every module of ``libre_tpu`` has its counterpart;
the README's port section says how each runs):

* rendering, bricked: ``render_cli`` → ``RenderEngine.render_bricked``
  (in core, or out of core in slab passes; synchronous or with async
  uploads; one view or a multi-view wall, ``render_wall``) → the
  post-classification sweep kernel (``csrc/post_sweep.cu``, f32 or its
  bf16-resample instance) → screen warp → image;
* rendering, exact (the ``xla`` and ``pallas-exact`` renderers):
  ``render_cli`` → ``RenderEngine.render`` (synchronous multipass) → the
  exact per-ray march kernel (``csrc/exact_march.cu``, a TF of any size)
  → image;
* rendering, dense (the ``shearwarp`` renderer):
  ``RenderEngine.render_shearwarp`` → the pre-classified sweep kernel
  (``csrc/pre_sweep.cu``) → warp → image;
* training: the store trainer (``train.fit``: ``post_sweep.cu`` forward,
  ``csrc/store_grid_bwd.cu`` backward), the exact trainers over one brick
  and over a brick set (``csrc/exact_march_bwd.cu`` backward), the dense
  trainer (plain PyTorch through autograd) and ``models.VolumeScene``;
* the interactive service and apps (``apps/serve``, the steering server
  and client, ``batch``, ``convert``), per-brick histograms, the
  benchmark scripts and gather probes (``benchmarks/``, the probe kernels
  ``csrc/probe_*.cu``), ``entry``;
* the multi-device layer ``parallel/``: a (ray × brick) mesh of devices,
  the engine's sharded frame, the sharded trainers, ``torch.distributed``.

The package-level names are ``libre_tpu``'s: the octree node id, the
volume information and the LOD node of ``core/``.

Kernels are compiled with ``nvcc`` at first use (``ops/_kernels.py``); on
a CPU tensor each kernel's wrapper runs its plain PyTorch version.
"""

from libre_tpu_torch.core.lodnode import LODNode
from libre_tpu_torch.core.nodeid import NodeId, RootNode
from libre_tpu_torch.core.volume_info import (
    DataType,
    VolumeInformation,
    fill_regular_volume_info,
)

__all__ = [
    "NodeId",
    "RootNode",
    "DataType",
    "VolumeInformation",
    "fill_regular_volume_info",
    "LODNode",
]
