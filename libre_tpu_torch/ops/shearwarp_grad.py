"""Differentiable store rendering (``libre_tpu.ops.shearwarp_grad``).

``render_store_grid_diff(store, tf, vs, static)`` renders the (V, U, 4)
slope grid of a normalized (Na, Nc, Nb) density store under a
``torch.autograd.Function``, or with an (N, 11) matrix of view vectors
the (N, V, U, 4) grids of N views of that one store:

* **Forward**: per view the post-classification sweep of
  ``shearwarp_bricked.post_sweep`` (the K1 kernel on a GPU) with no clip
  planes, no content skipping and a fresh carry; it also yields the final
  transmittance the backward needs.  A view's operands, its sweep
  tables and clip operand (:func:`sweep_operands`), are built for the
  call unless the caller hands in a set built once for the view (the
  store trainer's loss functions do).
* **Slab mode** (the slab-sharded store trainer): a 13-float view vector
  appends [k0, a_base]; the render covers global planes [k0, k0 +
  k_planes) of ``k_total`` out of a store slab whose slice 0 is global
  slice ``a_base`` (``shearwarp_bricked.sweep_tables``' ``slab``), and
  both kernels run on that slab.
* **Backward**: :func:`store_grid_backward`, one recompute sweep a view
  that inverts the front-to-back composite with the total-minus-prefix
  identity and scatters the density and transfer-function gradients —
  the hand-written CUDA kernel ``csrc/store_grid_bwd.cu`` on a GPU,
  :func:`store_grid_backward_reference` on the CPU.  The first view's
  sweep zeroes one store and one TF gradient and every later view's adds
  into them, so N views leave one buffer for each, which autograd hands
  to the leaves as their ``.grad`` without a copy.

Masks (box, SENTINEL coverage, early exit) are comparisons and pass no
gradient, as in autodiff of the plane oracle.  Training runs with the
early exit off (``early_exit`` > 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import _kernels
from libre_tpu_torch.ops import shearwarp as sw
from libre_tpu_torch.ops import shearwarp_bricked as swb
from libre_tpu_torch.ops.reference import ALPHA_CLAMP
from libre_tpu_torch.utils.profiling import span

TF_SIZE = swb.TF_SIZE
VIEW_LEN = 11


@dataclasses.dataclass(frozen=True)
class StaticView:
    """The static geometry of one differentiable view: store and grid
    sizes, the in-plane world bounds, the early-exit threshold and
    whether the TF gets a gradient."""

    na: int
    nc: int
    nb: int
    k_planes: int
    v_size: int
    u_size: int
    wb: Tuple[float, float]
    wc: Tuple[float, float]
    early_exit: float
    diff_tf: bool = True
    na_store: Optional[int] = None  # slab mode: the slab's slices (else na)
    k_total: Optional[int] = None  # slab mode: the global plane count

    @property
    def store_slices(self) -> int:
        return self.na if self.na_store is None else self.na_store


def static_view(
    *,
    na_store: int,
    na_real: int,
    nc_real: int,
    nb_real: int,
    k_planes: int,
    v_size: int,
    u_size: int,
    world_min,
    world_max,
    axis: int,
    early_exit: float,
    diff_tf: bool = True,
    k_total: Optional[int] = None,
) -> StaticView:
    """:class:`StaticView` from the JAX package's ``static_view``
    arguments.  The port's store is unpadded, so ``na_store`` other than
    ``na_real`` is a store slab: slab mode, which ``k_total`` (the global
    plane count) announces and 13-float view vectors feed."""
    if na_store != na_real and k_total is None:
        raise ValueError(
            f"static_view: na_store={na_store} != na_real={na_real} is a "
            "store slab: give k_total (slab mode)"
        )
    wmin = np.asarray(world_min, np.float32)
    wmax = np.asarray(world_max, np.float32)
    b_axis, c_axis = sw._BC_AXES[axis]
    return StaticView(
        na=int(na_real),
        nc=int(nc_real),
        nb=int(nb_real),
        k_planes=int(k_planes),
        v_size=int(v_size),
        u_size=int(u_size),
        wb=(float(wmin[b_axis]), float(wmax[b_axis])),
        wc=(float(wmin[c_axis]), float(wmax[c_axis])),
        early_exit=float(early_exit),
        diff_tf=bool(diff_tf),
        na_store=None if k_total is None else int(na_store),
        k_total=None if k_total is None else int(k_total),
    )


view_vector = swb.view_vector


# ================================================================ backward
def store_grid_backward_reference(
    store: torch.Tensor,
    tf: torch.Tensor,
    tables: swb.SweepTables,
    out: torch.Tensor,
    t_out: torch.Tensor,
    g: torch.Tensor,
    *,
    wb: Tuple[float, float],
    wc: Tuple[float, float],
    early_exit: float,
    diff_tf: bool,
    d_store: Optional[torch.Tensor] = None,
    dtf: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch backward of ``post_sweep`` with no clip planes: the
    specification of ``csrc/store_grid_bwd.cu``.

    ``out``/``t_out`` are the forward's results on the same operands and
    ``g`` the (V, U, 4) cotangent of ``out``.  One front-to-back loop over
    the K planes, vectorised over the (V, U) rays: each sample is
    recomputed as in ``post_sweep_reference`` (2 slices × 2×2 taps), the
    transmittance t and the inclusive prefix P = Σ w·⟨g_rgb, rgb⟩ are
    carried, and the composite is inverted with

        ∂L/∂a_eff = t·D − (TOT − P)/(1 − a_eff) + g_a·t_fin/(1 − a_eff),

    TOT = ⟨g_rgb, out_rgb − rgb_in⟩ (shearwarp_grad.py:587-604).  That is
    chained through the early-exit mask, the opacity correction, the
    alpha clamp and the TF lerp's slope; ``ddens`` is scattered into the
    8 store voxels the sample read and ``drgba`` = (w·g_rgb, ∂L/∂α) into
    the two TF texels, summed in float64 (a training view puts tens of
    millions of samples into a few texels: summed in f32, the plain
    version's own rounding would be the largest error a comparison with
    the kernel sees).  Returns (d_store (Na, Nc, Nb), dtf (256, 4) in
    ``tf``'s dtype); ``dtf`` is zero when ``diff_tf`` is false.  Given
    ``d_store`` or ``dtf``, it adds its gradient into that tensor, in
    place, and returns it."""
    f32 = torch.float32
    dev = store.device
    _na, nc, nb = store.shape
    v_size, u_size = tables.corr.shape
    wb0, wb1 = wb
    wc0, wc1 = wc
    sb_scale = nb / (wb1 - wb0)
    sc_scale = nc / (wc1 - wc0)
    u0, du, dv, eb, ec, v0, _eye_a = tables.view[:7]
    ug = u0 + du * torch.arange(u_size, dtype=f32, device=dev)
    vg = v0 + dv * torch.arange(v_size, dtype=f32, device=dev)
    flat = store.reshape(-1)
    plane = nc * nb
    corr = tables.corr
    g_rgb, g_a = g[..., :3], g[..., 3]
    tot = (g_rgb * (out[..., :3] - tables.rgb_in[..., :3])).sum(-1)

    d_flat = torch.zeros_like(flat) if d_store is None else d_store.view(-1)
    dtf64 = torch.zeros(tf.shape, dtype=torch.float64, device=dev)
    t = tables.t_in.clone()
    p = torch.zeros_like(t)
    for k in range(tables.a0.shape[0]):
        wa = tables.wa[k]
        delta = tables.dl[k]
        xb = eb + ug * delta  # (U,)
        xc = ec + vg * delta  # (V,)
        ib0, ib1, w_b = swb._taps((xb - wb0) * sb_scale - 0.5, nb)
        ic0, ic1, w_c = swb._taps((xc - wc0) * sc_scale - 0.5, nc)
        lo = tables.a0[k].long() * plane
        hi = tables.a1[k].long() * plane
        offs = [  # (offset, in-plane tap weight) of the 2×2 taps
            (ic[:, None] * nb + ib[None, :], wc_[:, None] * wb_[None, :])
            for ic, wc_ in ((ic0, 1.0 - w_c), (ic1, w_c))
            for ib, wb_ in ((ib0, 1.0 - w_b), (ib1, w_b))
        ]
        taps = [flat[lo + o] * (1.0 - wa) + flat[hi + o] * wa for o, _ in offs]
        s_c0 = taps[0] * (1.0 - w_b) + taps[1] * w_b
        s_c1 = taps[2] * (1.0 - w_b) + taps[3] * w_b
        dens = s_c0 * (1.0 - w_c)[:, None] + s_c1 * w_c[:, None]

        inside_u = (xb >= wb0) & (xb < wb1)
        inside_v = (xc >= wc0) & (xc < wc1)
        mask = (
            inside_v[:, None] & inside_u[None, :] & (tables.act[k] != 0)
            & (dens > -0.5)
        ).to(f32)

        s = torch.clamp(torch.clamp(dens, 0.0, 1.0) * TF_SIZE - 0.5, 0.0, TF_SIZE - 1.0)
        i0f = torch.floor(s)
        wt = s - i0f
        i0 = i0f.long()
        i1 = torch.clamp(i0 + 1, max=TF_SIZE - 1)
        c0, c1 = tf[i0], tf[i1]
        rgba = c0 * (1.0 - wt)[..., None] + c1 * wt[..., None]
        a_v = rgba[..., 3] * mask
        a_cl = torch.clamp(a_v, max=ALPHA_CLAMP)
        a_corr = 1.0 - torch.pow(1.0 - a_cl, corr)
        m = ((1.0 - t) <= early_exit).to(f32)
        a_eff = a_corr * m
        w = a_eff * t
        d = (rgba[..., :3] * g_rgb).sum(-1)
        p = p + w * d  # inclusive prefix

        one_m = torch.clamp(1.0 - a_eff, min=1e-12)
        da_eff = t * d - (tot - p) / one_m + g_a * t_out / one_m
        q = torch.pow(torch.clamp(1.0 - a_cl, min=1e-12), corr - 1.0)
        dav = da_eff * m * corr * q * (a_v < ALPHA_CLAMP).to(f32) * mask
        wg = w[..., None] * g_rgb
        slope = TF_SIZE * (
            (dens > 0.0) & (dens < 1.0) & (s > 0.0) & (s < TF_SIZE - 1.0)
        ).to(f32)
        tfd = c1 - c0
        ddens = ((wg * tfd[..., :3]).sum(-1) + dav * tfd[..., 3]) * slope

        for o, w_bc in offs:
            e = ddens * w_bc
            d_flat.index_add_(0, (lo + o).reshape(-1), (e * (1.0 - wa)).reshape(-1))
            d_flat.index_add_(0, (hi + o).reshape(-1), (e * wa).reshape(-1))
        if diff_tf:
            drgba = torch.cat([wg, dav[..., None]], dim=-1)
            for i, wi in ((i0, 1.0 - wt), (i1, wt)):
                dtf64.index_add_(0, i.reshape(-1), (drgba * wi[..., None]).reshape(-1, 4).double())
        t = t * (1.0 - a_eff)
    if dtf is None:
        return d_flat.reshape(store.shape), dtf64.to(tf.dtype)
    return d_flat.reshape(store.shape), dtf.add_(dtf64.to(dtf.dtype))


def store_grid_backward(
    store: torch.Tensor,
    tf: torch.Tensor,
    tables: swb.SweepTables,
    out: torch.Tensor,
    t_out: torch.Tensor,
    g: torch.Tensor,
    *,
    wb: Tuple[float, float],
    wc: Tuple[float, float],
    early_exit: float,
    diff_tf: bool,
    d_store: Optional[torch.Tensor] = None,
    dtf: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward sweep: launches ``csrc/store_grid_bwd.cu`` for CUDA
    tensors and runs :func:`store_grid_backward_reference` for CPU tensors
    (same signature and result).  Each gradient goes into a new zeroed
    tensor, or is added into ``d_store`` / ``dtf`` where the caller hands
    one (the kernel only adds).  ``store_grid_backward.launches`` counts
    kernel launches, ``store_grid_backward.accumulated`` the calls, on
    either device, handed a buffer to add into."""
    v_size, u_size = tables.corr.shape
    f32 = torch.float32
    given = {}
    if d_store is not None:
        given["d_store"] = (d_store, f32, tuple(store.shape))
    if dtf is not None:
        given["dtf"] = (dtf, f32, (TF_SIZE, 4))
    swb._check_sweep_operands(
        store, tf, tables, "store_grid_bwd",
        out=(out, f32, (v_size, u_size, 4)),
        t_out=(t_out, f32, (v_size, u_size)),
        g=(g, f32, (v_size, u_size, 4)),
        **given,
    )
    if given:
        store_grid_backward.accumulated += 1
    kw = dict(wb=wb, wc=wc, early_exit=early_exit, diff_tf=diff_tf)
    if store.device.type == "cpu":
        return store_grid_backward_reference(
            store, tf, tables, out, t_out, g, d_store=d_store, dtf=dtf, **kw)
    if store.device.type != "cuda":
        raise ValueError(f"store_grid_backward: no kernel for device {store.device}")
    _na, nc, nb = store.shape
    if d_store is None:
        d_store = torch.zeros_like(store)
    if dtf is None:
        dtf = torch.zeros((TF_SIZE, 4), dtype=f32, device=store.device)
    with torch.cuda.device(store.device):
        _kernels.launch(
            "store_grid_bwd",
            store, tf, tables.a0, tables.a1, tables.wa, tables.dl, tables.act,
            tables.view, tables.corr, tables.rgb_in, tables.t_in, out, t_out,
            g, d_store, dtf,
            tables.a0.shape[0], nc, nb, v_size, u_size, int(diff_tf),
            wb[0], wb[1], wc[0], wc[1], nb / (wb[1] - wb[0]),
            nc / (wc[1] - wc[0]), early_exit,
        )
    store_grid_backward.launches += 1
    return d_store, dtf


store_grid_backward.launches = 0
store_grid_backward.accumulated = 0


# ======================================================== autograd function
def sweep_operands(vs: torch.Tensor, static: StaticView) -> Tuple[swb.SweepTables, torch.Tensor]:
    """One view's sweep operands on ``vs``'s device: its
    ``shearwarp_bricked.sweep_tables`` (in slab mode over the planes and
    slab that ``vs[11:13]`` and ``static`` give) and a zero clip operand
    (no clip planes).  They depend on ``vs`` and ``static`` alone, and K1
    and K2 only read them, so one set serves every render of the view."""
    slab = None
    if static.k_total is not None:
        slab = (vs[11], vs[12], static.k_total, static.na_store)
    with span("libre.sweep.tables"):
        tables = swb.sweep_tables(
            vs, na=static.na, k_planes=static.k_planes,
            v_size=static.v_size, u_size=static.u_size, slab=slab,
        )
        clip = torch.zeros((swb.MAX_CLIP_PLANES, 4), dtype=torch.float32, device=vs.device)
    return tables, clip


class RenderStoreGridDiff(torch.autograd.Function):
    """(store, tf, vs, static, operands) → the slope grids of the views of
    ``vs`` over one store, differentiable in the store and the TF: one
    view vector gives (V, U, 4), an (N, 11|13) matrix (N, V, U, 4).
    ``operands`` holds each view's :func:`sweep_operands` or None, which
    builds that view's for this call.  The backward's first K2 zeroes the
    store and TF gradients and the other N − 1 add into them."""

    @staticmethod
    def forward(ctx, store, tf, vs, static: StaticView, operands):
        rows = vs if vs.dim() == 2 else vs[None]
        sets = [sweep_operands(v, static) if ops is None else ops
                for v, ops in zip(rows, operands)]
        outs, t_outs = [], []
        with span("libre.sweep.forward"):
            for tables, clip in sets:
                out, t_out = swb.post_sweep(
                    store, tf, tables, clip, n_clip=0, wb=static.wb, wc=static.wc,
                    early_exit=static.early_exit,
                )
                outs.append(out)
                t_outs.append(t_out)
        out = torch.stack(outs) if vs.dim() == 2 else outs[0]
        ctx.save_for_backward(store, tf, out, *t_outs)
        ctx.tables = [tables for tables, _clip in sets]
        ctx.static = static
        return out

    @staticmethod
    def backward(ctx, g):
        store, tf, out, *t_outs = ctx.saved_tensors
        static = ctx.static
        diff_tf = static.diff_tf and ctx.needs_input_grad[1]
        if out.dim() == 3:  # one view
            out, g = out[None], g[None]
        g = g.contiguous()
        d_store = dtf = None
        with span("libre.sweep.backward"):
            for i, (tables, t_out) in enumerate(zip(ctx.tables, t_outs)):
                d_store, dtf = store_grid_backward(
                    store, tf, tables, out[i], t_out, g[i],
                    wb=static.wb, wc=static.wc, early_exit=static.early_exit,
                    diff_tf=diff_tf, d_store=d_store, dtf=dtf,
                )
        return d_store, (dtf if diff_tf else None), None, None, None


def render_store_grid_diff(
    store: torch.Tensor,
    tf: torch.Tensor,
    vs,
    static: StaticView,
    operands=None,
) -> torch.Tensor:
    """Differentiable slope-grid render of an unpadded (Na, Nc, Nb)
    normalized density store and a (256, 4) TF → (V, U, 4).

    ``vs`` is the 11-float view vector (:func:`view_vector`), as a tensor
    or array; ``static`` the view's :class:`StaticView`.  In slab mode
    (``static.k_total`` set) ``vs`` has 13 floats, [k0, a_base] appended,
    and ``store`` is the (na_store, Nc, Nb) slab.  ``operands``, if given,
    are :func:`sweep_operands` of ``vs`` and ``static`` on the store's
    device, built once by a caller that renders the view again and again
    (the store trainer's loss functions build them on their first call);
    without them each call builds its own.  An (N, 11) (or (N, 13))
    matrix of view vectors renders the N views, which share ``static``,
    → (N, V, U, 4), with ``operands`` None or a sequence of N sets (each
    a set or None); their backward leaves one store and one TF gradient
    buffer.  The resample is float32 in
    both directions whatever a view's ``ShearWarpParams.compute_dtype``,
    as the JAX store backward forces it
    (``libre_tpu/ops/shearwarp_grad.py:868``)."""
    vs = torch.as_tensor(vs, dtype=torch.float32, device=store.device)
    want = VIEW_LEN if static.k_total is None else VIEW_LEN + 2
    one = vs.dim() == 1
    if vs.shape[-1:] != (want,) or vs.dim() > 2 or vs.shape[0] == 0:
        raise ValueError(
            f"render_store_grid_diff: view vector shape {tuple(vs.shape)}, needs ({want},) "
            f"or (N, {want})"
        )
    if tuple(store.shape) != (static.store_slices, static.nc, static.nb):
        raise ValueError(
            f"render_store_grid_diff: store shape {tuple(store.shape)} != "
            f"{(static.store_slices, static.nc, static.nb)}"
        )
    if one:
        operands = [operands]
    elif operands is None:
        operands = [None] * vs.shape[0]
    elif len(operands) != vs.shape[0]:
        raise ValueError(
            f"render_store_grid_diff: {len(operands)} operand sets for {vs.shape[0]} views"
        )
    return RenderStoreGridDiff.apply(store, tf, vs, static, operands)
