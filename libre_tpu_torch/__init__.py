"""libre_tpu_torch — the PyTorch + CUDA port of libre_tpu.

The package mirrors ``libre_tpu``'s layout (``core/``, ``data/``,
``ops/``, ``render/``, ``train/``, ``apps/``, ``utils/``) and keeps its
module and function names, so each counterpart is easy to find.  It
imports ``torch`` and never ``jax``, and nothing of ``libre_tpu``: the
numpy host layer it needs (octree, LOD selection, frustum, caches,
configuration, datasources, image files) is copied into ``core/``,
``data/`` and ``utils/``.

Implemented slices:

* rendering, bricked: ``render_cli`` → ``RenderEngine.render_bricked``
  (in-core, single-store branch) → the post-classification sweep kernel
  (``csrc/post_sweep.cu``) → screen warp → image;
* training: ``train.fit`` → per view ``render_store_grid_diff`` (the sweep
  kernel forward, the recompute-backward kernel ``csrc/store_grid_bwd.cu``
  backward) → MSE → ``torch.optim`` → clamp and SENTINEL pinning;
* rendering, exact (the ``xla`` and ``pallas-exact`` renderers):
  ``render_cli`` → ``RenderEngine.render`` (synchronous multipass) → the
  exact per-ray march kernel (``csrc/exact_march.cu``) → image.

The rest (the dense renderer, out of core, the exact and dense trainers,
``models.VolumeScene``, the service and apps, the benchmark scripts,
``entry``, and the multi-device layer ``parallel/`` with the engine's
sharded frame and the sharded trainers) is listed in the README's port
section; ROADMAP.md says what is left.

Kernels are compiled with ``nvcc`` at first use (``ops/_kernels.py``); on
a CPU tensor each kernel's wrapper runs its plain PyTorch version.
"""
