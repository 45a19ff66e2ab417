"""Seeded operands and tolerances for holding the port's kernels against
their plain PyTorch versions (``chip_smoke.py`` and the CUDA tests)."""

from __future__ import annotations

import numpy as np
import torch

from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops.transfer_function import default_color_map

KERNEL_TOL_MAX = 2e-3  # one flip of the early-exit test moves a pixel ≤ 1 − 0.999
KERNEL_TOL_MEAN = 1e-5  # FMA contraction and powf rounding


def sweep_case(shape, seed, device):
    """Seeded sweep operands: a random (Na, Nc, Nb) density store with
    SENTINEL holes, a saturating TF, two clip planes, every 7th plane
    inactive; view as the tests/test_bricked.py scene (eye at a = 1.4,
    marching toward −a).  ``shape`` = (V, U, K, Na, Nc, Nb).

    Returns (store, tf, tables, clip, keyword arguments of post_sweep)."""
    v_size, u_size, k_planes, na, nc, nb = shape
    gen = torch.Generator(device=device).manual_seed(seed)
    store = torch.rand((na, nc, nb), generator=gen, device=device)
    holes = torch.rand(
        (na // 16 + 1, nc // 16 + 1, nb // 16 + 1), generator=gen, device=device
    ) < 0.15
    holes = holes.repeat_interleave(16, 0).repeat_interleave(16, 1)
    holes = holes.repeat_interleave(16, 2)[:na, :nc, :nb]
    store = torch.where(holes, swb.SENTINEL, store).contiguous()

    tf = default_color_map()
    tf[:, 3] = np.clip(8.0 * tf[:, 3], 0.0, 1.0)
    eye_a, eb, ec, sign = 1.4, 0.1, 0.05, -1.0
    a0, a1, wa, dl, _z, dz = swb.plane_tables(
        na=na, k_planes=k_planes, wa0=-0.5, wa1=0.5, eye_a=eye_a, sign=sign
    )
    u0, u1, v0, v1 = -0.45, 0.45, -0.4, 0.4
    du, dv = (u1 - u0) / (u_size - 1), (v1 - v0) / (v_size - 1)
    ug = u0 + du * np.arange(u_size, dtype=np.float32)
    vg = v0 + dv * np.arange(v_size, dtype=np.float32)
    corr = 32.0 * dz * np.sqrt(1.0 + ug[None, :] ** 2 + vg[:, None] ** 2)
    act = np.ones(k_planes, np.int32)
    act[::7] = 0
    clip_m, n_clip = swb.clip_matrix(
        np.float32([[1.0, 0.0, 0.0, 0.1], [0.0, -1.0, 0.5, 0.2]]), 2
    )

    def dev(a, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype).to(device)

    tables = swb.SweepTables(
        a0=dev(a0, torch.int32),
        a1=dev(a1, torch.int32),
        wa=dev(wa),
        dl=dev(dl),
        act=dev(act, torch.int32),
        view=dev(np.float32([u0, du, dv, eb, ec, v0, eye_a, 0.0])),
        corr=dev(corr),
        rgb_in=torch.zeros((v_size, u_size, 4), device=device),
        t_in=torch.ones((v_size, u_size), device=device),
    )
    kw = dict(n_clip=n_clip, wb=(-0.5, 0.5), wc=(-0.5, 0.5), early_exit=0.999)
    return store, dev(tf), tables, dev(clip_m), kw
