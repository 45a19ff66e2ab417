"""K2, the store trainer's recompute backward
(``libre_tpu_torch/csrc/store_grid_bwd.cu``) over one view.

Bytes: the store voxels the samples' taps read and the same entries of
the store gradient written (each once), 15 floats a ray (the forward's
rgba and transmittance, the cotangent, the tables), the TF read and,
with the TF gradient, written, and 5 floats a plane.  Operations: 173
per sample in the window with the TF gradient, of which 18 are the TF
gradient's (a run's bin test, 1 − w, eight products and eight adds)."""

OPS_PER_SAMPLE = 173
TF_OPS_PER_SAMPLE = 18


def bytes_ops(*, touched: int, samples: int, n_rays: int, k_planes: int, n_tf: int,
              diff_tf: bool):
    ops = OPS_PER_SAMPLE - (0 if diff_tf else TF_OPS_PER_SAMPLE)
    return (2 * touched * 4 + n_rays * 15 * 4 + (1 + int(diff_tf)) * n_tf * 16
            + k_planes * 5 * 4), samples * ops
