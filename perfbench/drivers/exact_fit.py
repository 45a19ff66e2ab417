"""Traffic kind ``exact_fit``: the exact trainer
(``train.trainer.make_exact_train_step`` over ``init_exact_state``)
fitting a density and the TF to views of a truth volume.

Set-up makes the configuration's smooth truth volume on the card and the
orbit's cameras (an offset drawn from the seed: every seed fits the same
volume from other angles); through the program it
builds each pose's ``ExactView``, renders the targets (K3, the early
exit off as under training), the state from a flat 0.5 density over
``torch.optim.Adam`` and one step per pose.  It takes the checked steps
(step s on pose s − 1) through those same objects, reading each loss,
and records the readings.  The window goes on through the poses in turn
in jobs of ``job_steps`` steps, each from the same start (the density,
the TF and the optimizer's state as before the first step; step j of a
job on pose j mod the poses), so a step costs the same whatever the
speed of the steps before it.  A step is K3 forward, the loss, K4
backward, Adam, the TF clamp."""

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
from perfbench.reference import exact as ref_exact
from perfbench.reference import train as ref_train
from perfbench.reference.views import exact_rays, max_steps
from perfbench.work import k3, k4


def render_cfg(cfg, early_exit):
    """The reference's settings for the configuration's renderer."""
    r = cfg["renderer"]
    step = 1.0 / r["samples_per_ray"]
    return {"step": step, "alpha_correction": r["max_samples_per_ray"] / r["samples_per_ray"],
            "early_exit": early_exit, "range": tuple(r["data_range"]),
            "box": ([-0.5] * 3, [0.5] * 3), "max_steps": max_steps([-0.5] * 3, [0.5] * 3, step)}


def program_params(cfg, early_exit):
    from libre_tpu_torch.ops.reference import RenderParams

    r = cfg["renderer"]
    return RenderParams(n_samples_per_ray=r["samples_per_ray"],
                        max_samples_per_ray=r["max_samples_per_ray"],
                        data_source_range=tuple(r["data_range"]), filter_mode=r["filter"],
                        early_exit=early_exit)


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.log = []

    def setup(self):
        from libre_tpu_torch.ops import exact
        from libre_tpu_torch.train import init_exact_state, make_exact_train_step

        self.phases = Phases()
        n = self.cfg["volume"]["n"]
        self.truth = inputs.smooth_volume(n, self.cfg["volume"]["field_seed"], self.device)
        self.tf0 = inputs.color_map(self.cfg["tf_entries"], self.device)
        w, h = self.traffic["viewport"]
        self.cams = inputs.orbit(self.cfg["orbit"], w, h, self.seed)
        self.phases.mark("cameras, truth volume")
        params = program_params(self.cfg, self.traffic["early_exit"])
        self.views = [exact.exact_view(program_camera(c), params, device=self.device)
                      for c in self.cams]
        self.phases.mark("views (the rays of each pose)")
        with torch.no_grad():
            self.targets = [exact.render_exact_diff(self.truth, self.tf0, v) for v in self.views]
        self.phases.mark("targets (first K3: the kernels load)")
        lr = self.traffic["lr"]
        self.state = init_exact_state(torch.full_like(self.truth, 0.5), self.tf0,
                                      lambda p: torch.optim.Adam(p, lr=lr), device=self.device)
        self.steps = [make_exact_train_step(v) for v in self.views]
        self.start = {"density": torch.full_like(self.truth, 0.5), "tf": self.tf0}
        losses = []
        for i in range(self.traffic["checked_steps"]):
            losses.append(float(self.steps[i](self.state, self.targets[i])))
            if i == 0:
                grads = first_grad_norms(self.state.optimizer, self.state.params)
                self.phases.mark("checked step 1 (the first K4 and Adam: their kernels load)")
        self.readings = {"losses": losses, "grad_norms": grads,
                         "change_norms": norms_of_change(self.state.params, self.start)}
        self.jobs = Jobs(self.traffic["job_steps"], len(losses))
        self.phases.mark("the other checked steps")

    def unit(self) -> bool:
        j = self.jobs.position()
        if j == 0:
            restart_optimizer(self.state.optimizer, self.state.params, self.start)
            self.state.step = 0
        i = j % len(self.steps)
        with torch.profiler.record_function("perfbench.step"):
            loss = float(self.steps[i](self.state, self.targets[i]))
        self.log.append(i)
        return bool(np.isfinite(loss))

    def release(self):
        del self.state, self.steps, self.views, self.targets, self.start
        free_device()

    def rays(self):
        cfg = render_cfg(self.cfg, self.traffic["early_exit"])
        return [exact_rays(c, cfg["step"], *cfg["box"], self.device) for c in self.cams]

    def reference(self, vdt=torch.float32, keep_half=False):
        return ref_train.exact_fit(
            self.truth, self.tf0, self.rays(), render_cfg(self.cfg, self.traffic["early_exit"]),
            self.traffic["lr"], self.traffic["checked_steps"],
            block=self.traffic["reference_block"], vdt=vdt, keep_half=keep_half)

    def check(self):
        from perfbench.check import training_numbers

        return training_numbers(self.readings, self.reference())

    def end_to_end(self, units, window_s):
        w, h = self.traffic["viewport"]
        return {"train_mrays_per_s": units * w * h / window_s / 1e6}

    def launch_bounds(self, kernel):
        """Per window launch of K3 ("k3") or K4 ("k4"), its least time:
        each step launches both once, on its pose."""
        if kernel not in ("k3", "k4"):
            return None
        if not hasattr(self, "samples"):
            cfg = render_cfg(self.cfg, self.traffic["early_exit"])
            self.samples = {}
            for i in sorted(set(self.log)):
                rays = exact_rays(self.cams[i], cfg["step"], *cfg["box"], self.device)
                counts = torch.zeros(rays["dirs"].shape[0], dtype=torch.int64, device=self.device)
                ref_exact.render(self.truth, self.tf0, rays, cfg,
                                 block=self.traffic["reference_block"], counts=counts)
                self.samples[i] = int(counts.sum())
        w, h = self.traffic["viewport"]
        voxels, n_tf = self.truth.numel(), self.tf0.shape[0]
        out = []
        for i in self.log:
            if kernel == "k3":
                work = k3.bytes_ops(brick_voxels_used=voxels, n_bricks=1,
                                    samples=self.samples[i], n_rays=w * h, n_tf=n_tf)
            else:
                work = k4.bytes_ops(voxels=voxels, samples=self.samples[i], n_rays=w * h,
                                    n_tf=n_tf, diff_tf=True)
            out.append(peaks.bound_s(*work))
        return out
