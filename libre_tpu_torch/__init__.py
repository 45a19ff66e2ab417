"""libre_tpu_torch — the PyTorch + CUDA port of libre_tpu.

The package mirrors ``libre_tpu``'s layout (``ops/``, ``render/``,
``apps/``) and keeps its module and function names, so each counterpart
is easy to find.  It imports ``torch`` and never ``jax``: from
``libre_tpu`` it uses only the jax-free host layer (``core.cache``,
``core.config``, ``core.frame_utils``, ``core.frustum``,
``core.select_visibles`` and the modules they import, ``data.*`` and
``utils.image``).

Implemented slice: ``render_cli`` → ``RenderEngine.render_bricked``
(in-core, single-store branch) → the post-classification sweep kernel
(``csrc/post_sweep.cu``) → screen warp → image.  Kernels are compiled
with ``nvcc`` at first use (``ops/_kernels.py``); on a CPU tensor each
kernel's wrapper runs its plain PyTorch version.
"""
