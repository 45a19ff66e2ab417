"""The exact raycast of one volume filling the global box, in plain
PyTorch: the semantics of Livre's per-ray loop (fragRaycast.glsl:113-215).

Per ray the samples t_n = tn_global + n·step with n ≥ the first sample
past the near plane and t_n in the box's (t0, t1]; per sample a trilinear
fetch (clamp to edge, texel centres at (i + 0.5)/dim), the linear TF
lookup of the clamped density, the opacity correction
1 − (1 − min(a, 1 − 1/256))^(max_spr / n_spr) and front-to-back
compositing while the alpha accumulated before the sample is at most the
early exit.  Rays go in blocks, samples in chunks folded into the carry
in closed form (the early-exit mask follows from the prefix
transmittance: alpha only grows), until no ray of the block can add a
sample.  With ``sinks`` the gathers of the
volume and the TF hang their gradients there (``sinks.py``), so a loss
built on the output gives the density and TF gradients by autograd.
``vdt`` is the type the values are computed in: float32, or bfloat16
for the precision control (geometry stays f32)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference.sinks import take
from perfbench.reference.views import intersect_box

ALPHA_CLAMP = 1.0 - 1.0 / 256.0
CHUNK = 32


def _prep(tex, dim):
    s = torch.clamp(tex * dim - 0.5, 0.0, dim - 1.0)
    i0f = torch.floor(s)
    i0 = i0f.long().clamp(0, dim - 1)
    return i0, torch.clamp(i0 + 1, max=dim - 1), s - i0f


def _exclusive_cumprod(x):
    cp = torch.cumprod(x, dim=1)
    return torch.cat([torch.ones_like(cp[:, :1]), cp[:, :-1]], dim=1)


def march_block(flat, dims, tf, rays: Dict, sl: slice, render: Dict, *, sinks=None,
                vdt=torch.float32, counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R_block, 4) rgba of rays ``sl`` through the (Z, Y, X) volume
    ``flat`` (flattened, in ``vdt``) of ``dims`` = (X, Y, Z), over the
    global box of ``render`` (a config's renderer settings with
    ``step``, ``alpha_correction``, ``early_exit``, ``max_steps``,
    ``range``, ``box``); ``counts`` (R,) int64, if given, gains the
    samples each ray composites."""
    bx, by, bz = dims
    dev = flat.device
    step, corr, early_exit = render["step"], render["alpha_correction"], render["early_exit"]
    lo_r, hi_r = render["range"]
    mult, add = 1.0 / (hi_r - lo_r), -lo_r / (hi_r - lo_r)
    eye = rays["eye"]
    eye_host = rays["eye_host"]
    dirs = rays["dirs"][sl]
    tnp, tng, n_start = rays["t_near_plane"][sl], rays["tn_global"][sl], rays["n_start"][sl]
    box_min, box_max = render["box"]
    t0, t1 = intersect_box(eye, dirs, box_min, box_max)
    lo = torch.where(rays["hit"][sl], t0, torch.full_like(t0, float("inf")))
    hi = t1
    n0 = torch.floor((torch.maximum(lo, tnp) - tng) / step)
    n0 = torch.where(torch.isfinite(n0), n0, torch.zeros_like(n0)).to(torch.int32) - 1
    n_start = n_start.to(torch.int32)
    # World → texture of the one brick filling the box: tex = p·s + o.
    s_xyz = [1.0 / (box_max[i] - box_min[i]) for i in range(3)]
    o_xyz = [0.0 - box_min[i] * s_xyz[i] for i in range(3)]
    k_base = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    n_tf = tf.shape[0]
    r = g = b = a = torch.zeros(dirs.shape[0], dtype=vdt, device=dev)
    for ci in range(-(-render["max_steps"] // CHUNK)):
        n = n0[:, None] + (ci * CHUNK + k_base)[None, :]
        t = tng[:, None] + n.to(torch.float32) * step
        # No ray adds a sample from here on: each is past its exit, or
        # its alpha is over the early exit (alpha only grows).
        if not bool((rays["hit"][sl] & (t[:, 0] <= hi) & (a <= early_exit)).any()):
            break
        valid = (t > lo[:, None]) & (t <= hi[:, None]) & (n >= n_start[:, None])
        if not bool(valid.any()):
            continue
        tex = [((eye_host[i] + dirs[:, i:i + 1] * t) * s_xyz[i] + o_xyz[i]) for i in range(3)]
        ix0, ix1, wx = _prep(tex[0], bx)
        iy0, iy1, wy = _prep(tex[1], by)
        iz0, iz1, wz = _prep(tex[2], bz)
        idx, wgt = [], []
        for ix, fx in ((ix0, 1.0 - wx), (ix1, wx)):
            for iy, fy in ((iy0, 1.0 - wy), (iy1, wy)):
                for iz, fz in ((iz0, 1.0 - wz), (iz1, wz)):
                    idx.append((iz * by + iy) * bx + ix)
                    wgt.append((fx * fy) * fz)
        vals = take(flat, torch.stack(idx).int(), sinks, "volume")
        raw = 0.0
        for k in range(8):
            raw = raw + vals[k] * wgt[k].to(vdt)
        density = torch.clamp(raw * mult + add, 0.0, 1.0)
        s = torch.clamp(torch.clamp(density, 0.0, 1.0) * n_tf - 0.5, 0.0, float(n_tf - 1))
        i0f = torch.floor(s)
        w = (s - i0f)[..., None]
        i0 = i0f.long()
        rows = (take(tf, i0, sinks, "tf") * (1.0 - w)
                + take(tf, torch.clamp(i0 + 1, max=n_tf - 1), sinks, "tf") * w)
        alpha = 1.0 - torch.pow(1.0 - torch.clamp(rows[..., 3], max=ALPHA_CLAMP), corr)
        alpha_v = alpha * valid.to(vdt)
        with torch.no_grad():
            before = a[:, None] + (1.0 - a[:, None]) * (1.0 - _exclusive_cumprod(1.0 - alpha_v))
            m = before <= early_exit
        alpha_eff = alpha_v * m.to(vdt)
        wts = alpha_eff * _exclusive_cumprod(1.0 - alpha_eff)
        one_minus_a = 1.0 - a
        r = r + one_minus_a * torch.sum(wts * rows[..., 0], dim=1)
        g = g + one_minus_a * torch.sum(wts * rows[..., 1], dim=1)
        b = b + one_minus_a * torch.sum(wts * rows[..., 2], dim=1)
        a = a + one_minus_a * (1.0 - torch.prod(1.0 - alpha_eff, dim=1))
        if counts is not None:
            counts[sl] += (valid & m).sum(dim=1)
    return torch.stack([r, g, b, a], dim=-1).float()


def render(volume, tf, rays: Dict, render_cfg: Dict, *, block: int, vdt=torch.float32,
           counts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, 4) rgba of every ray, no gradient, in blocks of ``block`` rays."""
    dims = tuple(reversed(volume.shape))
    flat = volume.reshape(-1).to(vdt)
    tf = tf.to(vdt)
    n_rays = rays["dirs"].shape[0]
    out = torch.empty((n_rays, 4), dtype=torch.float32, device=volume.device)
    with torch.no_grad():
        for r0 in range(0, n_rays, block):
            sl = slice(r0, min(r0 + block, n_rays))
            out[sl] = march_block(flat, dims, tf, rays, sl, render_cfg, vdt=vdt, counts=counts)
    return out


def loss_and_grads(volume, tf, rays: Dict, target, render_cfg: Dict, sinks, *, block: int,
                   vdt=torch.float32, keep=None) -> float:
    """The mean squared error of the render against ``target`` (R, 4),
    its gradients added into ``sinks`` block by block; ``keep`` (a ray
    slice) renders and averages over those rays only (the half-batch
    fault)."""
    dims = tuple(reversed(volume.shape))
    flat = volume.reshape(-1).to(vdt)
    tf = tf.to(vdt)
    n_rays = rays["dirs"].shape[0]
    lo, hi = (0, n_rays) if keep is None else (keep.start, keep.stop)
    denom = float((hi - lo) * 4)
    total = 0.0
    for r0 in range(lo, hi, block):
        sl = slice(r0, min(r0 + block, hi))
        out = march_block(flat, dims, tf, rays, sl, render_cfg, sinks=sinks, vdt=vdt)
        se = torch.sum((out - target[sl]) ** 2) / denom
        se.backward()
        total += float(se.detach())
    return total
