"""K1, the post-classified sweep (``libre_tpu_torch/csrc/post_sweep.cu``)
over one view of a store.

Bytes: the store voxels the fetched samples' taps read (each once), the
per-ray operands and outputs (slopes' table, carry in and out, rgba and
transmittance out: 11 floats a ray), the TF, and 5 floats a plane.
Operations: 97 per fetched sample (the two lerps of the 2×2 taps of two
slices, the window and coverage tests, the TF lerp, the opacity
correction's ``powf`` and the composite)."""

OPS_PER_SAMPLE = 97


def bytes_ops(*, touched: int, samples: int, n_rays: int, k_planes: int, n_tf: int):
    return touched * 4 + n_rays * 11 * 4 + n_tf * 16 + k_planes * 5 * 4, samples * OPS_PER_SAMPLE
