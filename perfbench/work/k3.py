"""K3, the exact march (``libre_tpu_torch/csrc/exact_march.cu``) of one
view through one f32 brick.

Bytes: the bricks some ray samples (their voxels once), 17 floats a
brick (box and slot), 16 floats a ray (the ray pack, carry in and out),
and the TF.  Operations: 114 per composited trilinear sample of an f32
brick (the 122 of a uint8 brick less its 8 casts)."""

OPS_PER_SAMPLE = 114


def bytes_ops(*, brick_voxels_used: int, n_bricks: int, samples: int, n_rays: int, n_tf: int):
    return (brick_voxels_used * 4 + n_bricks * 17 * 4 + n_rays * 16 * 4 + n_tf * 16,
            samples * OPS_PER_SAMPLE)
