"""The post-classified shear-warp render of a density store over a slope
grid, in plain PyTorch: what the store trainer renders per view. The
store is (Na, Nc, Nb), normalised density, the major axis first. A view
vector [wa0, wa1, eye_a, u0, du, dv, eb, ec, v0, sign, msr] fixes K
axis-aligned planes, front to back, at z_k = wa0 + (k + ½)·dz (toward
+A) or wa1 − (k + ½)·dz, dz = (wa1 − wa0)/K, and a (V, U) grid of slope
rays (u_g, v_g). Ray (v, u) meets plane k at xb = eb + u_g·(z_k −
eye_a), xc = ec + v_g·(z_k − eye_a); there the density is the store
lerped between the slices bracketing z_k, then bilinearly in (b, c) with
clamp to edge (texel centres at (i + ½)); a sample outside the [wb0,
wb1) × [wc0, wc1) window or on an uncovered voxel (< −0.5) is empty; its
colour is the linear 256-entry TF lookup of the clamped density, its
alpha opacity-corrected as 1 − (1 − min(a, 1 −
1/256))^(msr·dz·√(1+u²+v²)), and the samples are composited front to
back (the early exit off, as under training), a chunk of planes at a
time in closed form. With ``sinks`` the store's and the TF's gathers
hang their gradients there (``sinks.py``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from perfbench.reference.sinks import take

ALPHA_CLAMP = 1.0 - 1.0 / 256.0


def tables(vs: torch.Tensor, na: int, k_planes: int, v_size: int, u_size: int) -> Dict:
    """The planes' bracketing slices (a0, a1), axis weight, z − eye_a,
    and the rays' slopes and opacity-correction exponents, on ``vs``'s
    device, f32."""
    f32 = torch.float32
    dev = vs.device
    wa0, wa1, eye_a, u0, du, dv, _eb, _ec, v0, sign, msr = (vs[i] for i in range(11))
    k = torch.arange(k_planes, dtype=f32, device=dev)
    dz = (wa1 - wa0) / k_planes
    z = torch.where(sign > 0, wa0 + (k + 0.5) * dz, wa1 - (k + 0.5) * dz)
    sa = torch.clamp((z - wa0) / (wa1 - wa0) * na - 0.5, -0.5, na - 0.5)
    i0 = torch.floor(torch.clamp(sa, 0.0, float(na - 1)))
    ug = u0 + du * torch.arange(u_size, dtype=f32, device=dev)
    vg = v0 + dv * torch.arange(v_size, dtype=f32, device=dev)
    return {
        "a0": i0.long(), "a1": torch.clamp(i0 + 1.0, max=float(na - 1)).long(),
        "wa": torch.clamp(sa - i0, 0.0, 1.0), "dl": z - eye_a, "ug": ug, "vg": vg,
        "eb": vs[6], "ec": vs[7],
        "corr": msr * dz * torch.sqrt(1.0 + ug[None, :] ** 2 + vg[:, None] ** 2),
    }


def _taps(s, n: int):
    s = torch.clamp(s, -0.5, n - 0.5)
    i0f = torch.floor(torch.clamp(s, 0.0, float(n - 1)))
    i0 = i0f.long()
    return i0, torch.clamp(i0 + 1, max=n - 1), torch.clamp(s - i0f, 0.0, 1.0)


def planes(tab: Dict, ks: slice, shape, window: Dict):
    """Planes ``ks`` over the whole grid: the 8 flat store indices (2
    slices × 2×2 taps, (8, P, V, U) int32), the weights (wa (P, 1, 1),
    w_b (P, 1, U), w_c (P, V, 1)) and the (P, V, U) fetch mask of the
    window."""
    _na, nc, nb = shape
    (wb0, wb1), (wc0, wc1) = window["wb"], window["wc"]
    delta = tab["dl"][ks][:, None]
    xb = tab["eb"] + tab["ug"][None, :] * delta
    xc = tab["ec"] + tab["vg"][None, :] * delta
    ib0, ib1, w_b = _taps((xb - wb0) * (nb / (wb1 - wb0)) - 0.5, nb)
    ic0, ic1, w_c = _taps((xc - wc0) * (nc / (wc1 - wc0)) - 0.5, nc)
    lo = (tab["a0"][ks] * (nc * nb))[:, None, None]
    hi = (tab["a1"][ks] * (nc * nb))[:, None, None]
    offs = [ic[:, :, None] * nb + ib[:, None, :] for ic in (ic0, ic1) for ib in (ib0, ib1)]
    idx = torch.stack([lo + o for o in offs] + [hi + o for o in offs]).int()
    fetch = ((xc >= wc0) & (xc < wc1))[:, :, None] & ((xb >= wb0) & (xb < wb1))[:, None, :]
    return idx, (tab["wa"][ks][:, None, None], w_b[:, None, :], w_c[:, :, None]), fetch


def _exclusive_cumprod(x):
    cp = torch.cumprod(x, dim=0)
    return torch.cat([torch.ones_like(cp[:1]), cp[:-1]], dim=0)


def render(store_flat, shape, tf, tab: Dict, window: Dict, *, sinks=None,
           vdt=torch.float32, chunk: int = 32) -> torch.Tensor:
    """(V, U, 4) rgba of the grid over the store (flattened, in ``vdt``)
    of ``shape``: ``chunk`` planes at a time,
    each chunk folded into the carry in closed form (its samples'
    transmittance is the carry's times the exclusive product of
    1 − alpha before them)."""
    n_tf = tf.shape[0]
    v_rows = tab["vg"].shape[0]
    u_size = tab["ug"].shape[0]
    dev = store_flat.device
    rgb = torch.zeros((v_rows, u_size, 3), dtype=vdt, device=dev)
    t = torch.ones((v_rows, u_size), dtype=vdt, device=dev)
    corr = tab["corr"].to(vdt)
    k_planes = tab["a0"].shape[0]
    for k0 in range(0, k_planes, chunk):
        idx, (wa, w_b, w_c), fetch = planes(tab, slice(k0, min(k0 + chunk, k_planes)), shape,
                                            window)
        vals = take(store_flat, idx, sinks, "volume")
        wa = wa.to(vdt)
        lerp = [vals[i] * (1.0 - wa) + vals[i + 4] * wa for i in range(4)]
        w_b, w_c = w_b.to(vdt), w_c.to(vdt)
        s_c0 = lerp[0] * (1.0 - w_b) + lerp[1] * w_b
        s_c1 = lerp[2] * (1.0 - w_b) + lerp[3] * w_b
        dens = s_c0 * (1.0 - w_c) + s_c1 * w_c
        mask = (fetch & (dens > -0.5)).to(vdt)
        s = torch.clamp(torch.clamp(dens, 0.0, 1.0) * n_tf - 0.5, 0.0, float(n_tf - 1))
        i0f = torch.floor(s)
        w = (s - i0f)[..., None]
        i0 = i0f.long()
        rgba = (take(tf, i0, sinks, "tf") * (1.0 - w)
                + take(tf, torch.clamp(i0 + 1, max=n_tf - 1), sinks, "tf") * w)
        alpha = rgba[..., 3] * mask
        a_corr = 1.0 - torch.pow(1.0 - torch.clamp(alpha, max=ALPHA_CLAMP), corr)
        weight = a_corr * _exclusive_cumprod(1.0 - a_corr) * t
        rgb = rgb + torch.sum(weight[..., None] * rgba[..., :3], dim=0)
        t = t * torch.prod(1.0 - a_corr, dim=0)
    return torch.cat([rgb, (1.0 - t)[..., None]], dim=-1).float()


def count_work(tab: Dict, shape, window: Dict, touched: Optional[torch.Tensor] = None) -> int:
    """The samples a view fetches (planes × rays inside the window, the
    early exit off) and, into ``touched`` (a flat bool mask of the store),
    the voxels their taps read."""
    samples = 0
    for k in range(tab["a0"].shape[0]):
        idx, _w, fetch = planes(tab, slice(k, k + 1), shape, window)
        samples += int(fetch.sum())
        if touched is not None:
            touched[idx[:, fetch].long()] = True
    return samples
