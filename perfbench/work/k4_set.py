"""K4's set instance (``libre_tpu_torch/csrc/exact_march_bwd.cu``,
``kSet = true``), the recompute backward of one view through a set of f32
bricks.

Bytes: the set read and its gradient written (each voxel of every brick
once), 16 floats a ray (the ray pack, the forward's output and the
cotangent), the TF read and, with the TF gradient, written.  Operations:
211 per trilinear sample with the TF gradient (``k4.py``'s count, 18 of
them the TF gradient's), and 27 per slab test: the set instance tests
every brick on every ray (a reciprocal, six products and six differences
of the slab, its min and max folds, and the ownership compares)."""

from perfbench.work.k4 import OPS_PER_SAMPLE, TF_OPS_PER_SAMPLE

OPS_PER_SLAB_TEST = 27


def bytes_ops(*, voxels: int, samples: int, n_rays: int, n_bricks: int, n_tf: int,
              diff_tf: bool):
    """``voxels``: the set's voxels (bricks × padded voxels a brick)."""
    ops = (samples * (OPS_PER_SAMPLE - (0 if diff_tf else TF_OPS_PER_SAMPLE))
           + n_rays * n_bricks * OPS_PER_SLAB_TEST)
    return 2 * voxels * 4 + n_rays * 16 * 4 + (1 + int(diff_tf)) * n_tf * 16, ops
