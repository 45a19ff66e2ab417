"""Inverse rendering through the differentiable store core
(``libre_tpu.train.store_trainer``), on one device or over a mesh.

Optimizes a normalized density store (and the transfer function) so
that the post-classification renders of a set of views match target
slope grids: every view of one store tensor in one call of
``shearwarp_grad.render_store_grid_diff`` (the sweep kernel forward once
a view, the recompute-backward kernel backward once a view, all adding
into one store and one TF gradient; each view's sweep tables built once
per loss function and device), a mean squared error, a ``torch.optim``
update, then the store clamped to [0, 1] where covered with uncovered
voxels pinned at SENTINEL, and the TF clamped to [0, 1].

The early exit is off under grad (a step function of the parameters),
and all views share one major axis because the store is assembled in one
axis permutation.

Over a (ray × brick) mesh (``parallel/mesh.py``):

* :func:`make_loss_fn` with ``mesh``: views shard over the brick axis,
  slope-grid rows over the ray axis (a runtime ``v0`` per shard); the
  store and TF are replicated (moved to each shard's device), and the
  squared errors sum onto the lead device, so the gradients of the
  replicated leaves sum there through autograd's copies — the gradient
  all-reduce of a data-parallel step;
* :func:`make_slab_loss_fn`: the store itself is sharded, 1/d_k of its
  slices per brick-axis shard (:func:`shard_store_slabs_uniform`); each
  shard takes one halo slice from each neighbour, renders its global
  plane range from a fresh carry through the 13-float slab mode of
  ``render_store_grid_diff`` (K1 forward, K2 backward on the extended
  slab), and the segments fold in plane order on the lead device — the
  model-parallel step whose losses and gradients equal the replicated
  trainer's.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from libre_tpu_torch.ops import shearwarp_grad as swg
from libre_tpu_torch.ops.shearwarp_bricked import SENTINEL
from libre_tpu_torch.parallel.compositing import fold_segments, join_rgba, move, split_rgba
from libre_tpu_torch.parallel.mesh import BRICK_AXIS, RAY_AXIS, require_mesh
from libre_tpu_torch.train import update
from libre_tpu_torch.train.update import EARLY_EXIT_OFF


@dataclasses.dataclass(frozen=True)
class StoreProblem:
    """Static inverse-rendering problem over one store geometry.

    ``views`` is the (Nv, 11) matrix of view vectors
    (``shearwarp_grad.view_vector``, all on the same major axis); the
    static geometry is shared.  ``inter_size`` is the (V, U) slope grid
    per view.
    """

    views: np.ndarray  # (Nv, 11)
    na_store: int
    na_real: int
    nc_real: int
    nb_real: int
    k_planes: int
    inter_size: Tuple[int, int]
    world_min: np.ndarray
    world_max: np.ndarray
    axis: int
    diff_tf: bool = True

    def static_for(self, v_size: int) -> swg.StaticView:
        return swg.static_view(
            na_store=self.na_store,
            na_real=self.na_real,
            nc_real=self.nc_real,
            nb_real=self.nb_real,
            k_planes=self.k_planes,
            v_size=v_size,
            u_size=self.inter_size[1],
            world_min=self.world_min,
            world_max=self.world_max,
            axis=self.axis,
            early_exit=EARLY_EXIT_OFF,
            diff_tf=self.diff_tf,
        )


def render_views(problem: StoreProblem, store, tf) -> torch.Tensor:
    """Render every view → (Nv, V, U, 4) (target generation)."""
    static = problem.static_for(problem.inter_size[0])
    views = torch.as_tensor(problem.views, dtype=torch.float32)
    return torch.stack([
        swg.render_store_grid_diff(store, tf, vs, static) for vs in views
    ])


def _row_view(vs: torch.Tensor, vd: int, v_l: int) -> torch.Tensor:
    """Sort-first row offset: rows [vd·V_l, (vd+1)·V_l) of the global grid
    start at v0 + vd·V_l·dv (dv = vs[5]), as the JAX package adds it."""
    out = vs.clone()
    out[8] = vs[8] + float(vd) * (float(v_l) * vs[5])
    return out


def _view_operands(static: swg.StaticView, make_vs: Callable) -> Callable:
    """``operands(*key)`` → (vs, each row's ``shearwarp_grad.
    sweep_operands(row, static)``) with vs = ``make_vs(*key)``, the (N,
    11|13) view vectors one call renders, on its device, built the first
    time ``key`` comes and kept: a problem's views never change, so a loss
    function builds each render's operands once, not once a step."""

    @functools.cache
    def operands(*key):
        vs = make_vs(*key)
        return vs, [swg.sweep_operands(row, static) for row in vs]

    return operands


def make_loss_fn(problem: StoreProblem, mesh=None):
    """(store, tf, targets (Nv, V, U, 4)) → mean-squared error over every
    view, on the store's device.

    Each view's vector, sweep tables and clip operand are built on a
    device the first time the function renders there, and serve every
    later call.  Every view renders in one call (K1 and K2 once per view,
    one store and one TF gradient).  With ``mesh``, shard (vd, kd) renders
    rows vd of views kd·Nv/d_k … (kd+1)·Nv/d_k − 1 on its device in one
    call (the row-shifted views' operands built once per shard), and the
    loss lands on the mesh's lead device.  The views must divide the
    brick axis and V the ray axis (else ValueError)."""
    v_size, u_size = problem.inter_size
    n_views = len(problem.views)
    views = torch.as_tensor(problem.views, dtype=torch.float32)
    denom = float(n_views * v_size * u_size * 4)

    if mesh is None:
        static = problem.static_for(v_size)
        operands = _view_operands(static, lambda dev: views.to(dev))

        def loss_fn(store, tf, targets):
            vs, ops = operands(store.device)
            img = swg.render_store_grid_diff(store, tf, vs, static, ops)
            return torch.sum((img - targets) ** 2) / denom

        return loss_fn

    require_mesh("make_loss_fn", mesh)
    d_k, d_v = mesh.shape[BRICK_AXIS], mesh.shape[RAY_AXIS]
    if n_views % d_k or v_size % d_v:
        raise ValueError(f"views={n_views} V={v_size} must divide mesh axes {d_k}x{d_v}")
    nv_l, v_l = n_views // d_k, v_size // d_v
    static_l = problem.static_for(v_l)
    operands = _view_operands(static_l, lambda vd, kd: move(torch.stack([
        _row_view(views[i], vd, v_l) for i in range(kd * nv_l, (kd + 1) * nv_l)
    ]), mesh.device(vd, kd)))

    def sharded_loss_fn(store, tf, targets):
        parts = []
        for vd, kd, dev in mesh.shards():
            vs, ops = operands(vd, kd)
            img = swg.render_store_grid_diff(move(store, dev), move(tf, dev), vs, static_l, ops)
            tgt = move(targets[kd * nv_l:(kd + 1) * nv_l, vd * v_l:(vd + 1) * v_l], dev)
            parts.append(move(torch.sum((img - tgt) ** 2), mesh.lead))
        return sum(parts) / denom

    return sharded_loss_fn


def shard_store_slabs_uniform(store, d_k: int, devices=None) -> List[torch.Tensor]:
    """(Na, Nc, Nb) store → d_k uniform slabs of Na/d_k slices (slab kd on
    ``devices[kd]``, default the store's device), each a copy: the
    per-shard leaves of the slab trainer, 1/d_k of the store each."""
    store = torch.as_tensor(store)
    na = store.shape[0]
    if na % d_k:
        raise ValueError(f"na={na} must divide the brick axis {d_k}")
    na_l = na // d_k
    devices = [store.device] * d_k if devices is None else list(devices)
    return [
        store[kd * na_l:(kd + 1) * na_l].to(devices[kd], copy=True) for kd in range(d_k)
    ]


def make_slab_loss_fn(problem: StoreProblem, mesh):
    """Loss over a SLAB-SHARDED store: model parallelism for config 5.

    ``slabs`` (from :func:`shard_store_slabs_uniform`) hold Na/d_k slices
    each; shard (vd, kd) reads slab kd (the ray axis replicates it).  Per
    view each shard:

    1. takes ONE boundary slice from each neighbour slab (the halos: a
       plane interpolates between adjacent slices, so a plane range needs
       at most one slice beyond its own slab; the global edges get
       SENTINEL slices, which no plane reads);
    2. sweeps its GLOBAL plane range against the extended slab with a
       fresh carry through ``render_store_grid_diff``'s slab mode (a
       13-float view vector carrying [k0, a_base]; the vectors, their
       sweep tables and clip operands are built on the first call and
       kept), every view in one call on the shard's extended slab;
    3. the segments fold in plane order on the lead device.

    With the early exit off, the fold equals the one-device sweep up to fp
    regrouping, so losses and gradients match the replicated trainer.
    All views must share one major axis AND one march sign; the store
    must be unpadded; Na, K and V must divide the mesh axes; and K ≥ Na
    (one halo slice each side suffices only when planes are at least as
    dense as slices)."""
    require_mesh("make_slab_loss_fn", mesh)
    v_size, u_size = problem.inter_size
    n_views = len(problem.views)
    views = torch.as_tensor(problem.views, dtype=torch.float32)
    d_k, d_v = mesh.shape[BRICK_AXIS], mesh.shape[RAY_AXIS]
    na = problem.na_real
    if problem.na_store != problem.na_real:
        raise ValueError(
            f"slab mode requires an unpadded store (na_store={problem.na_store} != na={na})"
        )
    if n_views and len({float(v[9]) for v in problem.views}) != 1:
        raise ValueError("slab mode: all views must share one march sign")
    sign = float(problem.views[0][9]) if n_views else 1.0
    if na % d_k or problem.k_planes % d_k or v_size % d_v:
        raise ValueError(
            f"na={na} K={problem.k_planes} V={v_size} must divide mesh axes {d_k}x{d_v}"
        )
    if problem.k_planes < na:
        raise ValueError(f"slab mode requires k_planes >= na ({problem.k_planes} < {na})")
    na_l, k_l, v_l = na // d_k, problem.k_planes // d_k, v_size // d_v
    static_l = swg.static_view(
        na_store=na_l + 2, na_real=na, nc_real=problem.nc_real, nb_real=problem.nb_real,
        k_planes=k_l, v_size=v_l, u_size=u_size, world_min=problem.world_min,
        world_max=problem.world_max, axis=problem.axis, early_exit=EARLY_EXIT_OFF,
        diff_tf=problem.diff_tf, k_total=problem.k_planes,
    )
    denom = float(n_views * v_size * u_size * 4)

    def slab_views(vd, kd):
        """The views' (Nv, 13) vectors for shard (vd, kd), on its device.
        Shard kd's planes cover its slab's z range: the plane grid runs
        front to back, so toward −A it starts at the far end."""
        k0 = kd * k_l if sign > 0 else (d_k - 1 - kd) * k_l
        vs = torch.stack([torch.cat([
            _row_view(views[i], vd, v_l),
            torch.tensor([float(k0), float(kd * na_l - 1)]),
        ]) for i in range(n_views)])
        return move(vs, mesh.device(vd, kd))

    operands = _view_operands(static_l, slab_views)

    def extended_slab(slabs, kd, dev):
        own = move(slabs[kd], dev)
        edge = torch.full((1,) + tuple(own.shape[1:]), SENTINEL, dtype=own.dtype, device=dev)
        prev = move(slabs[kd - 1][-1:], dev) if kd > 0 else edge
        nxt = move(slabs[kd + 1][:1], dev) if kd + 1 < d_k else edge
        return torch.cat([prev, own, nxt], dim=0)

    def loss_fn(slabs, tf, targets):
        if len(slabs) != d_k:
            raise ValueError(f"slab loss: {len(slabs)} slabs for a brick axis of {d_k}")
        tfs = {dev: move(tf, dev) for dev in mesh.distinct_devices()}
        rows = []
        for vd in range(d_v):
            segs = []
            for kd in range(d_k):
                dev = mesh.device(vd, kd)
                vs, ops = operands(vd, kd)
                seg = swg.render_store_grid_diff(
                    extended_slab(slabs, kd, dev), tfs[dev], vs, static_l, ops)
                segs.append(split_rgba(move(seg, mesh.lead)))
            if sign < 0:
                segs = segs[::-1]  # fold in front-to-back plane order
            rows.append(join_rgba(fold_segments(segs)))
        img = torch.cat(rows, dim=1)  # (Nv, V, U, 4)
        return torch.sum((img - move(targets, mesh.lead)) ** 2) / denom

    return loss_fn


def make_train_step(
    problem: StoreProblem, optimizer: torch.optim.Optimizer, mesh=None
):
    """(params, targets) → loss, one optimization step in place.

    ``params`` = {"store": (Na, Nc, Nb), "tf": (256, 4)}, the two tensors
    ``optimizer`` was built over.  Gradients flow through the sweep
    kernel's forward and the recompute-backward kernel; with
    ``problem.diff_tf`` false the TF gradient is zero.  After the update
    the store is clamped to [0, 1] where it was covered before the update
    and set to SENTINEL elsewhere, and the TF is clamped to [0, 1]."""
    loss_fn = make_loss_fn(problem, mesh)

    def step(params, targets):
        store, tf = params["store"], params["tf"]
        return _update(problem, optimizer, lambda: loss_fn(store, tf, targets), [store], tf)

    return step


def make_slab_train_step(problem: StoreProblem, optimizer: torch.optim.Optimizer, mesh):
    """:func:`make_train_step` over a slab-sharded store
    (:func:`make_slab_loss_fn`): ``params`` = {"slabs": the d_k slabs of
    :func:`shard_store_slabs_uniform`, "tf": (256, 4)}, the tensors
    ``optimizer`` was built over; each slab is clamped and pinned where it
    lies, so the store and its optimizer state stay 1/d_k per shard."""
    loss_fn = make_slab_loss_fn(problem, mesh)

    def step(params, targets):
        slabs, tf = params["slabs"], params["tf"]
        return _update(problem, optimizer, lambda: loss_fn(slabs, tf, targets), slabs, tf)

    return step


def _update(problem, optimizer, compute_loss, stores: Sequence[torch.Tensor], tf):
    """One step in place (``update.train_step``): ``compute_loss()``,
    backward, the optimizer's update, then each store tensor clamped to
    [0, 1] where it was covered before the update and set to SENTINEL
    elsewhere, and the TF clamped to [0, 1]; with ``problem.diff_tf``
    false the TF steps on a zero gradient."""
    return update.train_step(optimizer, compute_loss, pin=stores, clamp=[tf],
                             zero_grads=() if problem.diff_tf else [tf])


def fit(
    problem: StoreProblem,
    targets,  # (Nv, V, U, 4)
    init_store,
    init_tf,
    *,
    device,
    mesh=None,
    optimizer: Optional[Callable[[Sequence[torch.Tensor]], torch.optim.Optimizer]] = None,
    steps: int = 100,
    on_step: Optional[Callable[[int, float], None]] = None,
) -> Tuple[dict, List[float]]:
    """Run the optimization on ``device``; returns (params, losses).

    ``optimizer`` builds a ``torch.optim.Optimizer`` from the parameter
    list [store, tf] (default ``torch.optim.Adam(lr=3e-2)``).
    ``on_step(i, loss)``, if given, is called after each step."""
    return update.fit(
        lambda opt: make_train_step(problem, opt, mesh), {"store": init_store, "tf": init_tf},
        torch.as_tensor(targets, dtype=torch.float32).to(device), device=device,
        optimizer=optimizer, steps=steps, on_step=on_step,
    )
