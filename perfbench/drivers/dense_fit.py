"""Traffic kind ``dense_fit``: the dense trainer (``train.ShearWarpProblem``
and ``make_shearwarp_train_step``: the plain shear-warp pipeline under
autograd) fitting a whole (Z, Y, X) density and the TF to views of a
truth volume.

Set-up makes the configuration's smooth truth volume on the card and the
orbit's cameras (an offset drawn from the seed), of which it takes every
``view_stride``-th pose up to ``views``.  Through the program it builds
the problem as a user does (``ShearWarpProblem.from_cameras``, the early
exit off; the configuration's planes, slope grid, margin and
classification), renders the targets from the truth and the colormap,
and makes the leaves from a flat 0.5 volume and the grayscale ramp TF
under ``torch.optim.Adam`` (``fit``'s default lr) and the step.  It takes
the traffic's checked steps through that step, reading each loss, and
records the readings.  The window goes on with that step in jobs of
``job_steps`` steps, each from the same start.  A step renders every view
forward and backward (per view the classification with its TF gathers,
three resample products a channel and the composite), then the Adam
kernel with the clamp over both leaves."""

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
from perfbench.reference import dense_pre as ref_dense
from perfbench.work import dense_pre as work

WORLD_MIN, WORLD_MAX = np.float32([-0.5] * 3), np.float32([0.5] * 3)


def grayscale_ramp(size: int, device) -> torch.Tensor:
    """(size, 4) f32: every channel the ramp 0 → 1 over the entries."""
    x = torch.from_numpy(np.linspace(0.0, 1.0, size, dtype=np.float32))
    return torch.stack([x] * 4, dim=-1).to(device)


def classify_counter():
    """The program's count of classifications, or None where it keeps none."""
    from libre_tpu_torch.ops.shearwarp import precompute_classified_volume

    return getattr(precompute_classified_volume, "calls", None)


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.log = []

    def setup(self):
        from libre_tpu_torch.ops import shearwarp as sw
        from libre_tpu_torch.ops.reference import RenderParams
        from libre_tpu_torch.train import ShearWarpProblem, make_shearwarp_train_step

        self.phases = Phases()
        vol, r = self.cfg["volume"], self.cfg["renderer"]
        self.truth = inputs.smooth_volume(vol["n"], vol["field_seed"], self.device)
        self.tf_true = inputs.color_map(self.cfg["tf_entries"], self.device)
        self.tf0 = grayscale_ramp(self.cfg["tf_entries"], self.device)
        w, h = self.cfg["viewport"]
        cams = inputs.orbit(self.cfg["orbit"], w, h, self.seed)
        self.cams = cams[::self.traffic["view_stride"]][:self.traffic["views"]]
        self.phases.mark("cameras, truth volume")
        params = RenderParams(n_samples_per_ray=r["samples_per_ray"],
                              max_samples_per_ray=r["max_samples_per_ray"],
                              data_source_range=tuple(r["data_range"]), filter_mode=r["filter"])
        swp = sw.ShearWarpParams(n_planes=r["samples_per_ray"],
                                 inter_size=tuple(self.cfg["slope_grid"]),
                                 slope_margin=self.cfg["slope_margin"],
                                 classification=r["classification"])
        self.problem = ShearWarpProblem.from_cameras(
            [program_camera(c) for c in self.cams], WORLD_MIN, WORLD_MAX, params, swp)
        with torch.no_grad():
            self.targets = self.problem.render_views(None, self.truth, self.tf_true)
        self.phases.mark("the problem, the targets")
        self.start = {"volume": torch.full_like(self.truth, 0.5), "tf": self.tf0}
        self.params = {k: v.clone().requires_grad_() for k, v in self.start.items()}
        self.optimizer = torch.optim.Adam([self.params["volume"], self.params["tf"]],
                                          lr=self.traffic["lr"])
        self.step = make_shearwarp_train_step(self.problem, self.optimizer)
        losses = []
        for i in range(self.traffic["checked_steps"]):
            losses.append(float(self.step(self.params, self.targets)))
            if i == 0:
                grads = first_grad_norms(self.optimizer, self.params)
                self.phases.mark("checked step 1 (the first Adam: its kernel loads)")
        self.readings = {"losses": losses, "grad_norms": grads,
                         "change_norms": norms_of_change(self.params, self.start)}
        self.jobs = Jobs(self.traffic["job_steps"], len(losses))
        self.calls = classify_counter()
        self.phases.mark("the other checked steps")

    def unit(self) -> bool:
        if self.jobs.position() == 0:
            restart_optimizer(self.optimizer, self.params, self.start)
        with torch.profiler.record_function("perfbench.step"):
            loss = float(self.step(self.params, self.targets))
        self.log.append(0)
        return bool(np.isfinite(loss))

    def release(self):
        calls = classify_counter()
        if self.calls is not None and calls is not None and self.log:
            self.classify_calls = (calls - self.calls) / len(self.log)
        del self.step, self.optimizer, self.params, self.targets, self.problem
        self.start = None
        free_device()

    def _geom(self):
        r = self.cfg["renderer"]
        return {"k_planes": r["samples_per_ray"], "inter_size": tuple(self.cfg["slope_grid"]),
                "world_min": WORLD_MIN, "world_max": WORLD_MAX,
                "slope_margin": self.cfg["slope_margin"],
                "max_samples_per_ray": r["max_samples_per_ray"],
                "data_range": tuple(r["data_range"])}

    def reference(self, vdt=torch.float32, keep=None):
        """The reference's readings of the checked steps (``keep``: the
        first ``keep`` views only)."""
        return ref_dense.fit(self.truth, self.tf_true, self.tf0, self.cams, self._geom(),
                             self.traffic["lr"], self.traffic["checked_steps"], vdt=vdt,
                             keep=keep)

    def check(self):
        from perfbench.check import training_numbers

        return training_numbers(self.readings, self.reference())

    def end_to_end(self, units, window_s):
        v, u = self.cfg["slope_grid"]
        return {"train_mrays_per_s": units * len(self.cams) * v * u / window_s / 1e6}

    def launch_bounds(self, kernel):
        """Per window step, the least time of its render ("dense": every
        view forward and backward, ``work/dense_pre``); None otherwise."""
        if kernel != "dense":
            return None
        if not hasattr(self, "bound"):
            geom = self._geom()
            samples = 0
            for cam in self.cams:
                tab, window, _shape, _axis = ref_dense.view_geometry(
                    cam, tuple(self.truth.shape), geom, self.device)
                samples += ref_dense.samples_inside(tab, window)
            v, u = geom["inter_size"]
            self.bound = peaks.bound_s(*work.bytes_ops(
                voxels=self.truth.numel(), samples=samples, n_rays=len(self.cams) * v * u,
                n_tf=self.tf0.shape[0]))
        return [self.bound] * len(self.log)
