"""The pre-classified shear-warp render of a dense volume over a slope
grid, in plain PyTorch, and the dense trainer's first steps over it: what
``ShearWarpProblem`` renders per view with classification "pre".

Classification: each voxel's RGBA is the linear lookup of a T-entry TF at
its density, normalised by the data range and clamped to [0, 1] (texel i
centred at (i + ½)/T, clamp to edge).  A camera fixes K planes and a
(V, U) grid of slope rays as ``shearwarp.py`` does for a store (its
``tables`` and ``planes`` are used unchanged, over the (A, C, B)
permutation of the (Z, Y, X) volume for the view's major axis), but for
the slopes: the dense trainer's grid spans the slopes of every
forward-marching pixel of the viewport, widened by the margin, with U
(and V) slopes evenly spaced from the low bound to the high one inclusive
as ``torch.linspace`` places them in f32.  At each plane each of the
four channels is lerped between the bracketing slices, then bilinearly in
(b, c) with clamp to edge; a sample outside the [wb0, wb1) × [wc0, wc1)
window is zero in all four channels.  Its alpha is clamped to 1 − 1/256
and opacity-corrected as 1 − (1 − a)^(msr·dz·√(1+u²+v²)), and the samples
are composited front to back (the early exit off, as under training), a
chunk of planes at a time in closed form.

Gradients: each view's gathers of the classified volume hang their
cotangents on an (N, 4) sink through ``sinks.take``; the views' sum is
carried back through the classification once, whose TF gathers hang
theirs on the TF's float64 sink (``sinks.take``) and whose density path
(elementwise) autograd differentiates.  ``vdt`` is the type values are
computed in (float32, or bfloat16 for the precision control; geometry
stays f32).  Matrix products do not occur; both TF32 flags are set off
while the reference works all the same, and restored after.

The grid matters to the bit: a sample whose in-plane point lies within
an ulp of the window's edge falls in or out with the slope's last bit.
With the store's placement, u0 + du·i (du rounded to f32 once), against
the program's ``linspace``, one (plane, row) of 256 samples fell on the
other side on 2 of 17 seeds at the cell's size, and the loss read 2.7e-6
apart against at most 1.6e-7 elsewhere.

Departures from the program, each of round-off size (the program's
``render_slope_grid`` against this file, at 24³ on the CPU up to 7e-7 in
a view's channels, ``tests/test_torch_dense_reference.py``):

* in-plane texel coordinates (x − w0)·(n/(w1 − w0)) against the
  program's (x − w0)/(w1 − w0)·n: equal in a unit box (w1 − w0 = 1);
* the resample as gathers and lerps against the program's dense two-tap
  matrix products (the zeros add exactly; on the card a product may fuse
  a multiply and an add, an f32 rounding of each tap's term);
* the composite a chunk of 32 planes at a time with a carried
  transmittance against the program's one closed form over all K planes
  (the exclusive products regroup: ~K ulps of the transmittance);
* the TF gradient summed in float64 (the program sums each gather's in
  f32 by ``bincount``): tens of millions of taps land in 256 texels.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import shearwarp
from perfbench.reference.shearwarp import ALPHA_CLAMP, _exclusive_cumprod
from perfbench.reference.sinks import Sinks, take
from perfbench.reference.train import Adam, _norms
from perfbench.reference.views import BC_AXES, _slopes, shearwarp_view

# The (A, C, B) permutation of a (Z, Y, X) volume for major world axis a.
PERM = {0: (2, 0, 1), 1: (1, 0, 2), 2: (0, 1, 2)}


class Float32Products:
    """Both TF32 flags off while inside (a float32 product computed in
    float32), the caller's settings restored on leaving."""

    def __enter__(self):
        self.saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
        return False


class ClassifiedSink:
    """The gradient accumulator of one view's gathers of the classified
    volume: ``rgba`` ((N, 4) f32, N voxels) and the anchor the gathers
    hang on."""

    def __init__(self, n_voxels: int, device):
        self.rgba = torch.zeros((n_voxels, 4), dtype=torch.float32, device=device)
        self.anchor = torch.zeros((), device=device, requires_grad=True)


def classify(volume, tf, data_range, *, sinks=None) -> torch.Tensor:
    """``volume.shape + (4,)``: the TF's linear lookup of each voxel's
    normalised, clamped density, in ``volume``'s and ``tf``'s type; with
    ``sinks`` the TF's gathers hang their gradient on ``sinks.tf``."""
    lo, hi = data_range
    n_tf = tf.shape[0]
    density = torch.clamp((volume - lo) / (hi - lo), 0.0, 1.0)
    s = torch.clamp(density * n_tf - 0.5, 0.0, float(n_tf - 1))
    i0f = torch.floor(s)
    w = (s - i0f)[..., None]
    i0 = i0f.long()
    return (take(tf, i0, sinks, "tf") * (1.0 - w)
            + take(tf, torch.clamp(i0 + 1, max=n_tf - 1), sinks, "tf") * w)


def slope_grid(cam: Dict, axis: int, sign: float, inter_size, margin: float, device):
    """(ug (U,), vg (V,)) f32 on ``device``: the slopes of every pixel of
    ``cam``'s viewport whose ray marches along ``sign`` on ``axis``, their
    bounds widened by ``margin`` of their span (and 1e-6), then evenly
    spaced from the low bound to the high one inclusive."""
    vx, vy, vw, vh = cam["viewport"]
    px = np.arange(vw, dtype=np.float32) + 0.5 + vx
    py = np.arange(vh, dtype=np.float32) + 0.5 + vy
    fx, fy = np.meshgrid(px, py, indexing="xy")
    u, v, d_a = _slopes(cam, axis, fx, fy)
    ok = np.sign(d_a) == sign
    uu, vv = u[ok], v[ok]
    du = (uu.max() - uu.min()) * margin + 1e-6
    dv = (vv.max() - vv.min()) * margin + 1e-6
    v_size, u_size = inter_size
    f32 = torch.float32
    return (torch.linspace(float(uu.min() - du), float(uu.max() + du), u_size, dtype=f32,
                           device=device),
            torch.linspace(float(vv.min() - dv), float(vv.max() + dv), v_size, dtype=f32,
                           device=device))


def view_geometry(cam: Dict, shape_zyx, geom: Dict, device):
    """(tables, window, (A, C, B) shape, major axis) of the view of
    ``cam`` over a (Z, Y, X) volume of ``shape_zyx``: ``geom`` holds
    "k_planes", "inter_size", "world_min", "world_max", "slope_margin" and
    "max_samples_per_ray"."""
    wmin, wmax = geom["world_min"], geom["world_max"]
    vs, axis, sign = shearwarp_view(cam, wmin, wmax, geom["inter_size"], geom["slope_margin"],
                                    float(geom["max_samples_per_ray"]))
    vs = torch.as_tensor(vs, device=device)
    shape = tuple(shape_zyx[i] for i in PERM[axis])
    v_size, u_size = geom["inter_size"]
    tab = shearwarp.tables(vs, shape[0], geom["k_planes"], v_size, u_size)
    ug, vg = slope_grid(cam, axis, sign, geom["inter_size"], geom["slope_margin"], device)
    dz = (vs[1] - vs[0]) / geom["k_planes"]
    tab.update(ug=ug, vg=vg, corr=vs[10] * dz * torch.sqrt(1.0 + ug[None, :] ** 2
                                                           + vg[:, None] ** 2))
    b, c = BC_AXES[axis]
    window = {"wb": (float(wmin[b]), float(wmax[b])), "wc": (float(wmin[c]), float(wmax[c]))}
    return tab, window, shape, axis


def render(table, shape, tab: Dict, window: Dict, *, sinks=None, vdt=torch.float32,
           chunk: int = 32) -> torch.Tensor:
    """(V, U, 4) rgba of the grid over the classified volume ``table``
    ((Na·Nc·Nb, 4) in ``vdt``, the (A, C, B) permutation of ``shape``
    flattened): ``chunk`` planes at a time, each folded into the carry in
    closed form.  With ``sinks`` (a :class:`ClassifiedSink`) the gathers'
    gradient goes to ``sinks.rgba``."""
    v_rows, u_size = tab["vg"].shape[0], tab["ug"].shape[0]
    dev = table.device
    rgb = torch.zeros((v_rows, u_size, 3), dtype=vdt, device=dev)
    t = torch.ones((v_rows, u_size), dtype=vdt, device=dev)
    corr = tab["corr"].to(vdt)
    k_planes = tab["a0"].shape[0]
    for k0 in range(0, k_planes, chunk):
        idx, (wa, w_b, w_c), fetch = shearwarp.planes(
            tab, slice(k0, min(k0 + chunk, k_planes)), shape, window)
        vals = take(table, idx, sinks, "rgba")  # (8, P, V, U, 4)
        wa, w_b, w_c = (x.to(vdt)[..., None] for x in (wa, w_b, w_c))
        lerp = [vals[i] * (1.0 - wa) + vals[i + 4] * wa for i in range(4)]
        s_c0 = lerp[0] * (1.0 - w_b) + lerp[1] * w_b
        s_c1 = lerp[2] * (1.0 - w_b) + lerp[3] * w_b
        rgba = (s_c0 * (1.0 - w_c) + s_c1 * w_c) * fetch[..., None].to(vdt)
        a_corr = 1.0 - torch.pow(1.0 - torch.clamp(rgba[..., 3], max=ALPHA_CLAMP), corr)
        weight = a_corr * _exclusive_cumprod(1.0 - a_corr) * t
        rgb = rgb + torch.sum(weight[..., None] * rgba[..., :3], dim=0)
        t = t * torch.prod(1.0 - a_corr, dim=0)
    return torch.cat([rgb, (1.0 - t)[..., None]], dim=-1).float()


def samples_inside(tab: Dict, window: Dict) -> int:
    """The samples of a view inside the window: over the K planes, the
    rays whose (b, c) point lies in [wb0, wb1) × [wc0, wc1) (the fetch
    mask of ``shearwarp.planes``, counted without building its taps)."""
    (wb0, wb1), (wc0, wc1) = window["wb"], window["wc"]
    delta = tab["dl"][:, None]
    xb = tab["eb"] + tab["ug"][None, :] * delta
    xc = tab["ec"] + tab["vg"][None, :] * delta
    in_b = ((xb >= wb0) & (xb < wb1)).sum(dim=1, dtype=torch.int64)
    in_c = ((xc >= wc0) & (xc < wc1)).sum(dim=1, dtype=torch.int64)
    return int((in_b * in_c).sum())


def render_views(volume, tf, geoms: List, data_range, *, vdt=torch.float32) -> List:
    """Each view's (V, U, 4) image of ``volume`` (Z, Y, X) under ``tf``;
    ``geoms`` as :func:`view_geometry` returns them."""
    out = []
    with torch.no_grad():
        rgba = classify(volume.to(vdt), tf.to(vdt), data_range)
        for tab, window, shape, axis in geoms:
            table = rgba.permute(PERM[axis] + (3,)).reshape(-1, 4)
            out.append(render(table, shape, tab, window, vdt=vdt))
    return out


def loss_and_grads(volume, tf, geoms: List, targets: List, data_range, *,
                   vdt=torch.float32):
    """(the loss, {"volume", "tf"} gradients, f32) of the mean over the
    views of each view's mean squared error against ``targets``."""
    dev = volume.device
    sinks = Sinks(0, tf.shape[0], dev)
    density = volume.detach().to(vdt).requires_grad_()
    rgba = classify(density, tf.to(vdt), data_range, sinks=sinks)
    d_rgba = torch.zeros(rgba.shape, dtype=torch.float32, device=dev)
    v_size, u_size = targets[0].shape[:2]
    denom = float(len(geoms) * v_size * u_size * 4)
    total = 0.0
    for (tab, window, shape, axis), target in zip(geoms, targets):
        perm = PERM[axis] + (3,)
        table = rgba.detach().permute(perm).reshape(-1, 4)
        view_sink = ClassifiedSink(table.shape[0], dev)
        out = render(table, shape, tab, window, sinks=view_sink, vdt=vdt)
        se = torch.sum((out - target) ** 2) / denom
        se.backward()
        total += float(se.detach())
        d_rgba += view_sink.rgba.reshape(shape + (4,)).permute(
            tuple(perm.index(i) for i in range(4)))
        del view_sink, table
    rgba.backward(d_rgba.to(vdt))
    return total, {"volume": density.grad.float(), "tf": sinks.tf.float()}


def fit(truth, tf_true, tf0, cams: List[Dict], geom: Dict, lr: float, steps: int, *,
        vdt=torch.float32, keep: Optional[int] = None) -> Dict:
    """``steps`` steps of the dense trainer from a flat 0.5 volume and the
    TF ``tf0``, against the targets this reference renders of ``truth``
    under ``tf_true`` from ``cams``; ``geom`` as :func:`view_geometry`
    takes it, with "data_range".  Adam as Kingma and Ba give it, then both
    leaves clamped to [0, 1].  ``keep`` trains on the first ``keep`` views
    only (the half-batch fault)."""
    with Float32Products():
        geoms = [view_geometry(c, tuple(truth.shape), geom, truth.device) for c in cams]
        if keep is not None:
            geoms = geoms[:keep]
        targets = render_views(truth, tf_true, geoms, geom["data_range"], vdt=vdt)
        leaves = {"volume": torch.full_like(truth, 0.5), "tf": tf0.clone()}
        start = {k: v.clone() for k, v in leaves.items()}
        adam = Adam(leaves, lr)
        losses, first = [], None
        for _ in range(steps):
            loss, grads = loss_and_grads(leaves["volume"], leaves["tf"], geoms, targets,
                                         geom["data_range"], vdt=vdt)
            losses.append(loss)
            if first is None:
                first = _norms(grads)
            with torch.no_grad():
                adam.step(leaves, grads)
                for v in leaves.values():
                    v.clamp_(0.0, 1.0)
            del grads
        return {"losses": losses, "grad_norms": first,
                "change_norms": _norms({k: leaves[k] - start[k] for k in leaves})}
