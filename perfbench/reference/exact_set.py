"""The exact raycast of a brick set, in plain PyTorch: a volume held as
padded bricks (the store's layout at its finest level), composited front
to back in the set's stored order, and the mesh trainer's first steps over
it.

The set: the (Z, Y, X) volume cut into bricks of ``block``³ interior
voxels, each with ``overlap`` ghost voxels a side copied from its
neighbours and clamped at the volume's border (Livre's overlap,
VolumeInformation.h:63-66), x-major, then y, then z; each brick's world
box is its interior's in the unit box, and its texture inset places the
interior in the padded brick.  The set is sorted once by the distance of
each brick's centre from a sort eye (stable: ties keep the cut's order).

Per ray and brick the samples are the global grid t_n = tn_global +
n·step with t_n in the brick box's slab interval (t0, t1] (half-open, so
a sample on a shared face belongs to one brick) and n ≥ the first sample
past the near plane; each is a trilinear fetch (clamp to edge, texel
centres at (i + 0.5)/dim) at the brick's texture coordinates tex = p·s +
o, s = (tex_max − tex_min)/(world_max − world_min), o = tex_min −
world_min·s, then ``exact.py``'s TF lookup and opacity correction.  Each
brick marches only the rays whose segment enters its box, from a zero
carry, in chunks of 32 samples folded in closed form; a ray's segments
are then folded in the set's order by the over operator.  With the early
exit off (the trainers') that is the serial front-to-back composite
exactly: over is associative.  With ``sinks`` the gathers hang their
gradients on the (B, P, P, P) stack, ghost copies as entries of their
own, and on the TF.  ``vdt`` is the type values are computed in
(float32, or bfloat16 for the precision control; geometry stays f32).
Matrix products do not occur, so TF32 has nothing to change."""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from perfbench.reference.exact import ALPHA_CLAMP, CHUNK, _exclusive_cumprod, _prep
from perfbench.reference.sinks import Sinks, take
from perfbench.reference.train import Adam, _norms


def _ranges(n_bricks: int, block: int, overlap: int, dim: int, device) -> torch.Tensor:
    """(n_bricks, block + 2·overlap) voxel indices along one axis, the
    ghost voxels clamped at the border."""
    lo = torch.arange(n_bricks, device=device)[:, None] * block
    return (lo + torch.arange(-overlap, block + overlap, device=device)[None]).clamp(0, dim - 1)


def brick_set(volume: torch.Tensor, block: int, overlap: int, sort_eye) -> Dict:
    """The padded bricks of the cubic (N, N, N) ``volume`` in their stored
    order: {"data" (B, P, P, P), "world_min", "world_max", "tex_min",
    "tex_max" (B, 3) f32} on the volume's device, sorted front to back
    from ``sort_eye`` (3 floats)."""
    n = volume.shape[0]
    if tuple(volume.shape) != (n, n, n) or n % block:
        raise ValueError(f"a cubic volume cut by {block}, got {tuple(volume.shape)}")
    dev, k = volume.device, n // block
    axis = _ranges(k, block, overlap, n, dev)
    bx, by, bz = torch.meshgrid(*(torch.arange(k, device=dev),) * 3, indexing="ij")
    bx, by, bz = bx.reshape(-1), by.reshape(-1), bz.reshape(-1)
    voxel = torch.stack([bx, by, bz], dim=1).to(torch.float32) * block
    lo, hi = voxel / n - 0.5, (voxel + block) / n - 0.5
    # The distance in f32 as ((dx² + dy²) + dz²), so that bricks at one
    # distance tie exactly and keep the cut's order.
    diff = (lo + hi) * 0.5 - torch.tensor(sort_eye, dtype=torch.float32, device=dev)
    sq = diff * diff
    order = torch.sort(torch.sqrt((sq[:, 0] + sq[:, 1]) + sq[:, 2]), stable=True).indices
    bx, by, bz = bx[order], by[order], bz[order]
    data = volume[axis[bz][:, :, None, None], axis[by][:, None, :, None],
                  axis[bx][:, None, None, :]]
    pdim = block + 2 * overlap
    inset = torch.full((k ** 3, 3), overlap / pdim, dtype=torch.float32, device=dev)
    return {"data": data.contiguous(), "world_min": lo[order], "world_max": hi[order],
            "tex_min": inset, "tex_max": inset + block / pdim}


def march_block(flat, pdim: int, tf, bricks: Dict, rays: Dict, sl: slice, render: Dict, *,
                sinks=None, vdt=torch.float32, counts: Optional[torch.Tensor] = None,
                used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R_block, 4) rgba of rays ``sl`` through the set whose padded
    bricks of ``pdim``³ voxels are ``flat`` (the (B, P, P, P) stack
    flattened, in ``vdt``), placed by ``bricks``' boxes, over the global
    box of ``render`` (``exact.py``'s settings; ``max_steps`` covers one
    brick); ``counts`` (R,) gains the samples each ray composites,
    ``used`` (B,) bool is set for each brick that composites one."""
    if render["early_exit"] <= 1.0:
        raise ValueError("the set's segments fold exactly only with the early exit off")
    dev = flat.device
    step, corr = render["step"], render["alpha_correction"]
    lo_r, hi_r = render["range"]
    mult, add = 1.0 / (hi_r - lo_r), -lo_r / (hi_r - lo_r)
    eye, eye_host = rays["eye"], rays["eye_host"]
    dirs, hit = rays["dirs"][sl], rays["hit"][sl]
    tnp, tng, n_start = rays["t_near_plane"][sl], rays["tn_global"][sl], rays["n_start"][sl]
    wmin, wmax = bricks["world_min"], bricks["world_max"]
    # Every brick's slab interval of every ray: (R, B).
    d = torch.where(dirs == 0.0, torch.full_like(dirs, 1e-10), dirs)
    inv = (1.0 / d)[:, None, :]
    t_bot, t_top = inv * (wmin[None] - eye), inv * (wmax[None] - eye)
    lo = torch.amax(torch.minimum(t_top, t_bot), dim=-1)
    lo = torch.where(hit[:, None], lo, torch.full_like(lo, float("inf")))
    hi = torch.amin(torch.maximum(t_top, t_bot), dim=-1)
    enter = lo < hi
    n_enter = enter.sum(dim=1)
    k_max = int(n_enter.max()) if n_enter.numel() else 0
    if k_max == 0:
        return torch.zeros((dirs.shape[0], 4), dtype=torch.float32, device=dev)
    # Each ray's bricks in the set's order, padded to k_max: (R, K).
    order = torch.argsort((~enter).to(torch.int8), dim=1, stable=True)[:, :k_max]
    real = torch.arange(k_max, device=dev)[None, :] < n_enter[:, None]
    lo_k, hi_k = torch.gather(lo, 1, order), torch.gather(hi, 1, order)
    n0 = torch.floor((torch.maximum(lo_k, tnp[:, None]) - tng[:, None]) / step)
    n0 = torch.where(torch.isfinite(n0), n0, torch.zeros_like(n0)).to(torch.int32) - 1
    scale = (bricks["tex_max"] - bricks["tex_min"]) / (wmax - wmin)
    offset = bricks["tex_min"] - wmin * scale
    s_k, o_k = scale[order], offset[order]  # (R, K, 3)
    base = order.to(torch.int64) * pdim ** 3
    k_base = torch.arange(CHUNK, dtype=torch.int32, device=dev)
    n_tf = tf.shape[0]
    r = g = b = a = torch.zeros(order.shape, dtype=vdt, device=dev)
    for ci in range(-(-render["max_steps"] // CHUNK)):
        n = n0[..., None] + (ci * CHUNK + k_base)
        t = tng[:, None, None] + n.to(torch.float32) * step
        valid = ((t > lo_k[..., None]) & (t <= hi_k[..., None])
                 & (n >= n_start[:, None, None].to(torch.int32)) & real[..., None])
        if not bool(valid.any()):
            continue
        taps = [_prep((eye_host[i] + dirs[:, i, None, None] * t) * s_k[..., i, None]
                      + o_k[..., i, None], pdim) for i in range(3)]
        (ix0, ix1, wx), (iy0, iy1, wy), (iz0, iz1, wz) = taps
        idx, wgt = [], []
        for ix, fx in ((ix0, 1.0 - wx), (ix1, wx)):
            for iy, fy in ((iy0, 1.0 - wy), (iy1, wy)):
                for iz, fz in ((iz0, 1.0 - wz), (iz1, wz)):
                    idx.append(base[..., None] + (iz * pdim + iy) * pdim + ix)
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
        wts = alpha_v * _exclusive_cumprod_last(1.0 - alpha_v)
        one_minus_a = 1.0 - a
        r = r + one_minus_a * torch.sum(wts * rows[..., 0], dim=-1)
        g = g + one_minus_a * torch.sum(wts * rows[..., 1], dim=-1)
        b = b + one_minus_a * torch.sum(wts * rows[..., 2], dim=-1)
        a = a + one_minus_a * (1.0 - torch.prod(1.0 - alpha_v, dim=-1))
        if counts is not None:
            counts[sl] += valid.sum(dim=(1, 2))
        if used is not None:
            used[order[valid.any(dim=-1)]] = True
    # Fold each ray's segments in the set's order: (rgb, a) over (rgb', a').
    before = _exclusive_cumprod(1.0 - a)
    return torch.stack([torch.sum(before * x, dim=1) for x in (r, g, b, a)], dim=-1).float()


def _exclusive_cumprod_last(x):
    """prod_{j<i} x_j along the last dim (1 at index 0)."""
    cp = torch.cumprod(x, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def render(bricks: Dict, tf, rays: Dict, render_cfg: Dict, *, block: int, vdt=torch.float32,
           counts: Optional[torch.Tensor] = None,
           used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(R, 4) rgba of every ray through the set, no gradient, in blocks
    of ``block`` rays."""
    flat, pdim = bricks["data"].reshape(-1).to(vdt), bricks["data"].shape[-1]
    tf = tf.to(vdt)
    n_rays = rays["dirs"].shape[0]
    out = torch.empty((n_rays, 4), dtype=torch.float32, device=flat.device)
    with torch.no_grad():
        for r0 in range(0, n_rays, block):
            sl = slice(r0, min(r0 + block, n_rays))
            out[sl] = march_block(flat, pdim, tf, bricks, rays, sl, render_cfg, vdt=vdt,
                                  counts=counts, used=used)
    return out


def loss_and_grads(data, tf, bricks: Dict, rays: Dict, target, render_cfg: Dict, sinks, *,
                   block: int, vdt=torch.float32, keep: Optional[int] = None) -> float:
    """The mean squared error of the set ``data`` (B, P, P, P), placed by
    ``bricks``' boxes, against ``target`` (R, 4), its gradients added into
    ``sinks`` block by block; ``keep`` renders and averages over the
    first ``keep`` rays only (the half-batch fault)."""
    flat, pdim = data.reshape(-1).to(vdt), data.shape[-1]
    tf = tf.to(vdt)
    n_rays = rays["dirs"].shape[0] if keep is None else keep
    denom = float(n_rays * 4)
    total = 0.0
    for r0 in range(0, n_rays, block):
        sl = slice(r0, min(r0 + block, n_rays))
        out = march_block(flat, pdim, tf, bricks, rays, sl, render_cfg, sinks=sinks, vdt=vdt)
        se = torch.sum((out - target[sl]) ** 2) / denom
        se.backward()
        total += float(se.detach())
    return total


def fit(truth, tf0, rays_by_pose: List[Dict], render_cfg: Dict, bricking: Dict, lr: float,
        steps: int, *, block: int, vdt=torch.float32, keep_share: float = 1.0) -> Dict:
    """``steps`` steps of the mesh trainer over the set of ``truth`` from
    a flat 0.5 density in every brick, step s on pose s − 1, against the
    targets this reference renders of the truth's set; ``bricking``
    {"block_size", "overlap", "sort_eye"}.  ``keep_share`` trains on that
    share of each view's rays, the first ones (the half-batch fault)."""
    truth_set = brick_set(truth, bricking["block_size"], bricking["overlap"],
                          bricking["sort_eye"])
    used = rays_by_pose[:steps]
    with torch.no_grad():
        targets = [render(truth_set, tf0, r, render_cfg, block=block, vdt=vdt) for r in used]
    leaves = {"density": torch.full_like(truth_set["data"], 0.5), "tf": tf0.clone()}
    del truth_set["data"]
    start = {k: v.clone() for k, v in leaves.items()}
    adam = Adam(leaves, lr)
    losses, first = [], None
    for rays, target in zip(used, targets):
        n_rays = rays["dirs"].shape[0]
        keep = None if keep_share >= 1.0 else int(math.floor(n_rays * keep_share))
        sinks = Sinks(leaves["density"].numel(), tf0.shape[0], truth.device)
        losses.append(loss_and_grads(leaves["density"], leaves["tf"], truth_set, rays, target,
                                     render_cfg, sinks, block=block, vdt=vdt, keep=keep))
        grads = {"density": sinks.volume.reshape(leaves["density"].shape), "tf": sinks.tf.float()}
        if first is None:
            first = _norms(grads)
        with torch.no_grad():
            adam.step(leaves, grads)
            leaves["tf"].clamp_(0.0, 1.0)
        del sinks, grads
    return {"losses": losses, "grad_norms": first,
            "change_norms": _norms({k: leaves[k] - start[k] for k in leaves})}
