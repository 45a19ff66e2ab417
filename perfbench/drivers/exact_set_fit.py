"""Traffic kind ``exact_set_fit``: the mesh trainer
(``train.trainer.make_train_step`` over ``init_state`` on
``parallel.mesh.make_mesh()``'s one-card 1×1 mesh) fitting a density held
as padded bricks, and the TF, to views of a truth volume.

Set-up makes the configuration's smooth truth volume on the card, bricks
it through the program (``data.lod_store.brick_volume``: bricks of the
configuration's block size with its ghost voxels), sorts the set once
front to back from the orbit's centre eye
(``parallel.render.shard_bricks_front_to_back``, one brick shard) and
builds the ``InverseRenderProblem`` over it, whose ``max_steps`` is the
real bricks' march.  Per pose it makes the rays (``ops.rays``) and
renders the target through the program from the truth's set, then the
state from a 0.5 density in every brick and the colormap TF over
``torch.optim.Adam``, and takes the checked steps (step s on pose s − 1),
reading each loss.  The window goes on through the traffic's ``views``
poses in turn in jobs of ``job_steps`` steps, each from the same start,
as ``exact_fit``'s.  A step is the sharded render's host rebuild (ray
pack, box rows, host reads), K3 over the set, the loss, K4's set
instance, Adam, the TF clamp."""

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
from perfbench.drivers.exact_fit import program_params, render_cfg
from perfbench.reference import exact_set as ref_set
from perfbench.reference.views import exact_rays, max_steps
from perfbench.work import k3, k4_set


def sort_eye(cfg):
    """The orbit's centre eye (azimuth 0, before the seed's turn), f32."""
    o = cfg["orbit"]
    return np.float32([0.0, o["height"], o["distance"]])


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.log = []

    def setup(self):
        from libre_tpu_torch.data.lod_store import brick_volume
        from libre_tpu_torch.ops import rays as ray_ops
        from libre_tpu_torch.ops.reference import max_steps_for_bricks
        from libre_tpu_torch.parallel.mesh import make_mesh
        from libre_tpu_torch.parallel.render import render_rays_sharded, shard_bricks_front_to_back
        from libre_tpu_torch.train import InverseRenderProblem, init_state, make_train_step

        self.phases = Phases()
        n, brk = self.cfg["volume"]["n"], self.cfg["bricking"]
        self.truth = inputs.smooth_volume(n, self.cfg["volume"]["field_seed"], self.device)
        self.tf0 = inputs.color_map(self.cfg["tf_entries"], self.device)
        w, h = self.traffic["viewport"]
        self.cams = inputs.orbit(self.cfg["orbit"], w, h, self.seed)[:self.traffic["views"]]
        self.mesh = (make_mesh() if self.device.type == "cuda"
                     else make_mesh(devices=[self.device]))
        if self.mesh.size != 1:
            raise ValueError(f"one card is one brick shard; the mesh is {self.mesh.shape}")
        truth_set, _ = shard_bricks_front_to_back(
            brick_volume(self.truth, brk["block_size"], brk["overlap"]), sort_eye(self.cfg), 1)
        self.phases.mark("cameras, truth volume, its bricks sorted")
        gmin, gmax = (-0.5,) * 3, (0.5,) * 3
        params = program_params(self.cfg, self.traffic["early_exit"])
        start = truth_set._replace(data=torch.full_like(truth_set.data, 0.5))
        self.problem = InverseRenderProblem(
            bricks=start, global_min=gmin, global_max=gmax, params=params,
            max_steps=max_steps_for_bricks(start.world_min.cpu().numpy(),
                                           start.world_max.cpu().numpy(), params.step_size),
            width=w)
        self.rays = []
        for c in self.cams:
            cam = program_camera(c)
            eye, dirs, cos_z, _ = ray_ops.make_rays(cam.inv_proj, cam.inv_mv, cam.viewport,
                                                    device=self.device)
            self.rays.append((eye, dirs.reshape(-1, 3),
                              ray_ops.near_plane_t(cos_z.reshape(-1), cam.near)))
        self.phases.mark("the problem, the rays of each pose")
        with torch.no_grad():
            self.targets = [self.problem.render(self.mesh, truth_set.data, self.tf0, *r)
                            for r in self.rays]
        del truth_set
        self.phases.mark("targets (first K3: the kernels load)")
        lr = self.traffic["lr"]
        factory = lambda p: torch.optim.Adam(p, lr=lr)  # noqa: E731
        self.state = init_state(self.problem, self.tf0, factory, mesh=self.mesh)
        self.step = make_train_step(self.problem, factory, self.mesh)
        (density,) = self.state.params["density"]
        self.leaves = {"density": density, "tf": self.state.params["tf"]}
        self.start = {"density": torch.tensor(0.5, device=self.device), "tf": self.tf0}
        losses = []
        for i in range(self.traffic["checked_steps"]):
            losses.append(float(self.step(self.state, *self.rays[i], self.targets[i])))
            if i == 0:
                grads = first_grad_norms(self.state.optimizer, self.leaves)
                self.phases.mark("checked step 1 (the first K4 and Adam: their kernels load)")
        self.readings = {"losses": losses, "grad_norms": grads,
                         "change_norms": norms_of_change(self.leaves, self.start)}
        self.jobs = Jobs(self.traffic["job_steps"], len(losses))
        self.reads = getattr(render_rays_sharded, "host_reads", None)
        self.phases.mark("the other checked steps")

    def unit(self) -> bool:
        j = self.jobs.position()
        if j == 0:
            restart_optimizer(self.state.optimizer, self.leaves, self.start)
            self.state.step = 0
        i = j % len(self.rays)
        with torch.profiler.record_function("perfbench.step"):
            loss = float(self.step(self.state, *self.rays[i], self.targets[i]))
        self.log.append(i)
        return bool(np.isfinite(loss))

    def release(self):
        from libre_tpu_torch.parallel.render import render_rays_sharded

        reads = getattr(render_rays_sharded, "host_reads", None)
        if self.reads is not None and reads is not None and self.log:
            self.host_reads = (reads - self.reads) / len(self.log)
        del self.state, self.step, self.problem, self.leaves, self.targets, self.rays
        free_device()

    def _render_cfg(self):
        cfg = render_cfg(self.cfg, self.traffic["early_exit"])
        block = self.cfg["bricking"]["block_size"] / self.cfg["volume"]["n"]
        cfg["max_steps"] = max_steps([0.0] * 3, [block] * 3, cfg["step"])
        return cfg

    def ref_rays(self):
        cfg = self._render_cfg()
        return [exact_rays(c, cfg["step"], *cfg["box"], self.device) for c in self.cams]

    def _bricking(self):
        brk = self.cfg["bricking"]
        return {"block_size": brk["block_size"], "overlap": brk["overlap"],
                "sort_eye": [float(x) for x in sort_eye(self.cfg)]}

    def reference(self, vdt=torch.float32, keep=None):
        """The reference's readings of the checked steps (``keep``: the
        first ``keep`` / ``views`` share of each view's rays only)."""
        share = 1.0 if keep is None else keep / self.traffic["views"]
        return ref_set.fit(self.truth, self.tf0, self.ref_rays(), self._render_cfg(),
                           self._bricking(), self.traffic["lr"], self.traffic["checked_steps"],
                           block=self.traffic["reference_block"], vdt=vdt, keep_share=share)

    def check(self):
        from perfbench.check import training_numbers

        return training_numbers(self.readings, self.reference())

    def end_to_end(self, units, window_s):
        w, h = self.traffic["viewport"]
        return {"train_mrays_per_s": units * w * h / window_s / 1e6}

    def launch_bounds(self, kernel):
        """Per window launch of K3 ("k3") or K4's set instance ("k4"), its
        least time: each step launches both once, on its pose, over every
        brick of the set."""
        if kernel not in ("k3", "k4"):
            return None
        brk = self.cfg["bricking"]
        n_bricks = (self.cfg["volume"]["n"] // brk["block_size"]) ** 3
        brick_voxels = (brk["block_size"] + 2 * brk["overlap"]) ** 3
        if not hasattr(self, "samples"):
            cfg, rays = self._render_cfg(), self.ref_rays()
            bricks = ref_set.brick_set(self.truth, brk["block_size"], brk["overlap"],
                                       self._bricking()["sort_eye"])
            self.samples = {}
            for i in sorted(set(self.log)):
                counts = torch.zeros(rays[i]["dirs"].shape[0], dtype=torch.int64,
                                     device=self.device)
                used = torch.zeros(n_bricks, dtype=torch.bool, device=self.device)
                ref_set.render(bricks, self.tf0, rays[i], cfg,
                               block=self.traffic["reference_block"], counts=counts, used=used)
                self.samples[i] = (int(counts.sum()), int(used.sum()))
            del bricks
        w, h = self.traffic["viewport"]
        n_tf = self.tf0.shape[0]
        out = []
        for i in self.log:
            samples, used = self.samples[i]
            if kernel == "k3":
                work = k3.bytes_ops(brick_voxels_used=used * brick_voxels, n_bricks=n_bricks,
                                    samples=samples, n_rays=w * h, n_tf=n_tf)
            else:
                work = k4_set.bytes_ops(voxels=n_bricks * brick_voxels, samples=samples,
                                        n_rays=w * h, n_bricks=n_bricks, n_tf=n_tf, diff_tf=True)
            out.append(peaks.bound_s(*work))
        return out
