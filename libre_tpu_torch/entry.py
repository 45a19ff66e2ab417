"""Entry point of the port (``__graft_entry__.entry``'s counterpart).

:func:`entry` returns ``(fn, example_args)``: the forward render of the
flagship path, the exact marcher (K3, ``csrc/exact_march.cu``) over a
single-brick 32³ volume, 128 samples per ray, into a 128² image
(BASELINE config 1), with its example inputs made from a seed.  The
multi-device dry run (``dryrun_multichip``) is ROADMAP M9.
"""

from __future__ import annotations

import math

import numpy as np
import torch

IMG, N_VOX, SPR = 128, 32, 128


def _camera(img, near=0.1, far=15.0):
    from libre_tpu_torch.core.frustum import look_at, perspective
    from libre_tpu_torch.ops.reference import Camera

    proj = perspective(50.0, 1.0, near, far)
    mv = look_at([0, 0, 1.0], [0, 0, 0], [0, 1, 0])
    return Camera(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, img, img),
        near=near,
    )


def entry(device="cuda"):
    """(fn, example_args): ``fn(volume (Z, Y, X) f32, tf (256, 4) f32)`` →
    the (H, W, 4) image, bottom-up rows, through ``exact.render_exact``
    (K3 on a CUDA tensor, its plain version on a CPU one); the example
    volume and TF lie on ``device``.

    The reference's example TF has 64 entries; the port's kernels read
    256-entry TFs (``transfer_function.TF_SIZE``), so the example is the
    256-entry default colormap, and ``fn`` takes no other size."""
    from libre_tpu_torch.ops import exact
    from libre_tpu_torch.ops.reference import RenderParams
    from libre_tpu_torch.ops.transfer_function import default_color_map

    cam = _camera(IMG)
    params = RenderParams(
        n_samples_per_ray=SPR,
        data_source_range=(0.0, 1.0),
        filter_mode="trilinear",
        max_steps_per_brick=int(math.ceil(math.sqrt(3.0) * SPR)) + 4,
    )

    def fn(volume, tf):
        return exact.render_exact(volume.contiguous(), tf.contiguous(), cam, params)

    rng = np.random.default_rng(0)
    example_args = (
        torch.from_numpy(rng.random((N_VOX,) * 3, dtype=np.float32)).to(device),
        torch.from_numpy(default_color_map()).to(device),
    )
    return fn, example_args
