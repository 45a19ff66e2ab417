"""Traffic kind ``store_fit``: the store trainer (``train.store_trainer``,
the product's gradient path) fitting a store to views of a truth store.

Set-up makes the orbit's cameras (an offset drawn from the seed: every
seed fits the same store from other angles), asks the program's LOD
selection which bricks each view takes at the configuration's
screen-space error (this driver serves a configuration whose views
take bricks of the finest level only, within the GPU cache), makes the
truth store of that level on the card (the gradient field of the
configuration's volume), and through the program the views' problem,
the targets (K1) and one train step over ``torch.optim.Adam`` as
``store_trainer.fit`` builds it, from 0.5 wherever the truth is covered.
It takes the traffic's checked steps through that same step object,
reading one loss each as ``fit`` does, and records the readings.  The
window goes on with that step object in jobs of ``job_steps`` steps
(``fit``'s default job), each from the same start (the parameters and
the optimizer's state as before the first step), so a step costs the
same whatever the speed of the steps before it.  Each step renders every
view forward (K1) and backward (K2)."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import inputs, peaks
from perfbench.drivers.common import (
    Jobs,
    Phases,
    first_grad_norms,
    free_device,
    norms_of_change,
    program_camera,
    restart_optimizer,
)
from perfbench.reference import shearwarp as ref_sw
from perfbench.reference import train as ref_train
from perfbench.reference.views import BC_AXES, shearwarp_view
from perfbench.work import k1, k2

# The store of major axis a is the (Z, Y, X) volume permuted to (A, C, B).
PERM = {0: (2, 0, 1), 1: (1, 0, 2), 2: (0, 1, 2)}


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.log = []

    def _geometry(self):
        vol = self.cfg["volume"]
        dims = inputs.mem_dims(vol["uri"])[0][::-1]  # (Z, Y, X)
        half = np.float32(dims[::-1]) / max(dims) / 2  # world box: the largest axis spans 1
        self.world_min, self.world_max = -half, half
        w, h = self.cfg["viewport"]
        cams = inputs.orbit(self.cfg["orbit"], w, h, self.seed)
        self.cams = cams[::self.traffic["view_stride"]][:self.traffic["views"]]
        self._require_finest_level(dims)
        self.inter_size = tuple(self.cfg["slope_grid"])
        self.k_planes = self.cfg["samples_per_ray"]
        self.truth_zyx = inputs.gradient_store(dims, vol["phase"], self.device)
        self.tf0 = inputs.color_map(self.cfg["tf_entries"], self.device)

    def _require_finest_level(self, dims):
        """Each view's LOD selection (the program's) at the configuration's
        screen-space error takes bricks of the finest level only, so the
        engine's store is that level's; and its f32 store fits the GPU
        cache.  Raises otherwise.  (A brick wholly outside a view's
        frustum is culled, at most 1 of 4096 in this orbit; the store
        keeps it.)"""
        from libre_tpu_torch.core.frustum import Frustum
        from libre_tpu_torch.core.select_visibles import select_visibles
        from libre_tpu_torch.data import DataSource
        from libre_tpu_torch.data import memory  # noqa: F401  (registers mem://)

        source = DataSource(self.cfg["volume"]["uri"])
        finest = source.volume_info.root_node.depth - 1
        for cam in self.cams:
            frustum = Frustum(np.linalg.inv(cam["inv_mv"].astype(np.float64)).astype(np.float32),
                              np.linalg.inv(cam["inv_proj"].astype(np.float64)).astype(np.float32))
            levels = {n.level for n in select_visibles(source, frustum, cam["viewport"][3],
                                                       self.cfg["screen_space_error"])}
            if levels != {finest}:
                raise ValueError(f"a view selects bricks at levels {sorted(levels)}, "
                                 f"not only the finest ({finest})")
        if 4 * int(np.prod(dims)) > self.cfg["gpu_cache_mb"] * 2 ** 20:
            raise ValueError("the finest level's store is over the GPU cache")

    def setup(self):
        from libre_tpu_torch.ops import shearwarp as sw
        from libre_tpu_torch.ops import shearwarp_bricked as swb
        from libre_tpu_torch.ops.reference import RenderParams
        from libre_tpu_torch.train.store_trainer import (
            StoreProblem,
            make_train_step,
            render_views,
        )

        self.phases = Phases()
        self._geometry()
        self.phases.mark("cameras, selection, truth store")
        margin = self.cfg["slope_margin"]
        plans = [sw.make_view_plan(program_camera(c), margin) for c in self.cams]
        if len({(p.axis, p.sign) for p in plans}) != 1:
            raise ValueError("the views do not share one major axis and sign")
        axis = plans[0].axis
        self.store = self.truth_zyx.permute(PERM[axis]).contiguous()
        na, nc, nb = self.store.shape
        sweep = swb.SlabSweep(
            device=self.device, axis=axis, na=na,
            params=RenderParams(max_samples_per_ray=self.cfg["max_samples_per_ray"]),
            swp=sw.ShearWarpParams(n_planes=self.k_planes, inter_size=self.inter_size,
                                   slope_margin=margin, classification="post"),
            world_min=self.world_min, world_max=self.world_max,
        )
        views = np.stack([sweep.view(p.eye, p.sign, p.bounds) for p in plans])
        self.problem = StoreProblem(
            views=views, na_store=na, na_real=na, nc_real=nc, nb_real=nb,
            k_planes=self.k_planes, inter_size=self.inter_size, world_min=self.world_min,
            world_max=self.world_max, axis=axis, diff_tf=self.traffic["diff_tf"],
        )
        self.phases.mark("view plans, sweep, problem")
        with torch.no_grad():
            self.targets = render_views(self.problem, self.store, self.tf0)
        self.phases.mark("targets (first K1: the kernels load)")
        self.start = {"store": torch.where(self.store > -0.5, 0.5, swb.SENTINEL),
                      "tf": self.tf0}
        self.params = {k: v.clone().requires_grad_() for k, v in self.start.items()}
        self.optimizer = torch.optim.Adam([self.params["store"], self.params["tf"]],
                                          lr=self.traffic["lr"])
        self.step = make_train_step(self.problem, self.optimizer)
        losses = []
        for i in range(self.traffic["checked_steps"]):
            losses.append(float(self.step(self.params, self.targets)))
            if i == 0:
                grads = first_grad_norms(self.optimizer, self.params)
                self.phases.mark("checked step 1 (the first K2 and Adam: their kernels load)")
        self.readings = {"losses": losses, "grad_norms": grads,
                         "change_norms": norms_of_change(self.params, self.start)}
        self.axis = axis
        self.jobs = Jobs(self.traffic["job_steps"], len(losses))
        self.phases.mark("the other checked steps")

    def unit(self) -> bool:
        if self.jobs.position() == 0:
            restart_optimizer(self.optimizer, self.params, self.start)
        with torch.profiler.record_function("perfbench.step"):
            loss = float(self.step(self.params, self.targets))
        self.log.append(0)
        return bool(np.isfinite(loss))

    def release(self):
        del self.step, self.optimizer, self.params, self.targets, self.problem, self.store
        self.start = None
        free_device()

    def _ref_views(self):
        return [shearwarp_view(c, self.world_min, self.world_max, self.inter_size,
                               self.cfg["slope_margin"],
                               float(self.cfg["max_samples_per_ray"]))[0] for c in self.cams]

    def _geom(self):
        b, c = BC_AXES[self.axis]
        return {"k_planes": self.k_planes, "inter_size": self.inter_size,
                "wb": (float(self.world_min[b]), float(self.world_max[b])),
                "wc": (float(self.world_min[c]), float(self.world_max[c]))}

    def reference(self, vdt=torch.float32, keep=None):
        """The reference's readings of the checked steps ("keep": the
        first ``keep`` views only)."""
        truth = self.truth_zyx.permute(PERM[self.axis]).contiguous()
        return ref_train.store_fit(
            truth, self.tf0, self._ref_views(), self._geom(), self.traffic["lr"],
            self.traffic["checked_steps"], diff_tf=self.traffic["diff_tf"], vdt=vdt,
            keep=keep)

    def check(self):
        from perfbench.check import training_numbers

        return training_numbers(self.readings, self.reference())

    def end_to_end(self, units, window_s):
        v, u = self.inter_size
        rays = units * len(self.cams) * v * u
        return {"train_mrays_per_s": rays / window_s / 1e6}

    def launch_bounds(self, kernel):
        """Per window launch of K1 ("k1") or K2 ("k2"), its least time:
        each step launches both once per view."""
        if kernel not in ("k1", "k2"):
            return None
        truth = self.truth_zyx.permute(PERM[self.axis]).contiguous()
        shape = tuple(truth.shape)
        geom = self._geom()
        window = {"wb": geom["wb"], "wc": geom["wc"]}
        v, u = self.inter_size
        if not hasattr(self, "counts"):
            self.counts = []
            for vs in self._ref_views():
                tab = ref_sw.tables(torch.as_tensor(vs, device=self.device), shape[0],
                                    self.k_planes, v, u)
                touched = torch.zeros(truth.numel(), dtype=torch.bool, device=self.device)
                samples = ref_sw.count_work(tab, shape, window, touched)
                self.counts.append(dict(touched=int(touched.sum()), samples=samples,
                                        n_rays=v * u, k_planes=self.k_planes,
                                        n_tf=self.tf0.shape[0]))
        per_view = []
        for count in self.counts:
            if kernel == "k1":
                work = k1.bytes_ops(**count)
            else:
                work = k2.bytes_ops(diff_tf=self.traffic["diff_tf"], **count)
            per_view.append(peaks.bound_s(*work))
        return per_view * len(self.log)
