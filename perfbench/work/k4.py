"""K4, the exact trainer's recompute backward
(``libre_tpu_torch/csrc/exact_march_bwd.cu``) of one view through one
f32 brick.

Bytes: the volume read and its gradient written (each voxel once), 16
floats a ray (the ray pack, the forward's output and the cotangent), the
TF read and, with the TF gradient, written.  Operations: 211 per
trilinear sample with the TF gradient (K3's count without its casts and
composite, plus the recompute's backward), 18 of them the TF
gradient's."""

OPS_PER_SAMPLE = 211
TF_OPS_PER_SAMPLE = 18


def bytes_ops(*, voxels: int, samples: int, n_rays: int, n_tf: int, diff_tf: bool):
    ops = OPS_PER_SAMPLE - (0 if diff_tf else TF_OPS_PER_SAMPLE)
    return 2 * voxels * 4 + n_rays * 16 * 4 + (1 + int(diff_tf)) * n_tf * 16, samples * ops
