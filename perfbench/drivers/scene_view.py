"""Traffic kind ``scene_view``: frames of ``models.VolumeScene.render``,
one client in a closed loop, each frame synchronised before the next is
asked for.

Set-up makes the configuration's smooth truth volume on the card, the
scene over it (one brick filling the box, the configuration's renderer
settings with the early exit on) and the orbit's cameras (an offset
drawn from the seed), and renders every pose once (warm-up).  The window
renders the poses in turn: per frame the scene builds the view's rays
(``exact.exact_view``) and marches them (K3).  A reservoir drawn from
the seed keeps the traffic's number of frames, uniformly over the
window's, for the check against the reference."""

from __future__ import annotations

import numpy as np
import torch

from perfbench import inputs, peaks
from perfbench.drivers.common import Phases, free_device, program_camera
from perfbench.drivers.exact_fit import program_params, render_cfg
from perfbench.reference import exact as ref_exact
from perfbench.reference.views import exact_rays
from perfbench.work import k3


class Driver:
    def __init__(self, config, traffic, seed, device):
        self.cfg, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.log = []
        self.kept = []  # (frame number, pose, image)
        self.rng = np.random.default_rng(seed)

    def setup(self):
        from libre_tpu_torch.models import VolumeScene

        self.phases = Phases()
        n = self.cfg["volume"]["n"]
        self.truth = inputs.smooth_volume(n, self.cfg["volume"]["field_seed"], self.device)
        self.tf0 = inputs.color_map(self.cfg["tf_entries"], self.device)
        w, h = self.cfg["viewport"]
        self.cams = inputs.orbit(self.cfg["orbit"], w, h, self.seed)
        self.phases.mark("cameras, truth volume")
        self.scene = VolumeScene.from_volume(
            self.truth, self.tf0.cpu().numpy(),
            params=program_params(self.cfg, self.traffic["early_exit"]), device=self.device)
        self.cameras = [program_camera(c) for c in self.cams]
        self.phases.mark("scene")
        with torch.no_grad():
            for cam in self.cameras:
                self.scene.render(cam)
        self.phases.mark("one frame a pose (first K3: the kernels load)")
        self.next = 0

    def unit(self) -> bool:
        i = self.next % len(self.cameras)
        with torch.profiler.record_function("perfbench.frame"), torch.no_grad():
            img = self.scene.render(self.cameras[i])
            if img.is_cuda:
                torch.cuda.synchronize()
        k, n = self.traffic["checked_frames"], len(self.log)
        slot = n if n < k else int(self.rng.integers(0, n + 1))
        if slot < k:
            entry = (n, i, img.clone())
            if slot < len(self.kept):
                self.kept[slot] = entry
            else:
                self.kept.append(entry)
        self.log.append(i)
        self.next += 1
        return True

    def release(self):
        del self.scene, self.cameras
        free_device()

    def reference_frames(self, poses, vdt=torch.float32, counts=None):
        cfg = render_cfg(self.cfg, self.traffic["early_exit"])
        out = []
        for i in poses:
            rays = exact_rays(self.cams[i], cfg["step"], *cfg["box"], self.device)
            c = None if counts is None else torch.zeros(rays["dirs"].shape[0], dtype=torch.int64,
                                                        device=self.device)
            img = ref_exact.render(self.truth, self.tf0, rays, cfg,
                                   block=self.traffic["reference_block"], vdt=vdt, counts=c)
            if counts is not None:
                counts[i] = int(c.sum())
            out.append(img)
        return out

    def check(self):
        from perfbench.check import frame_numbers

        frames = [img for _n, _i, img in self.kept]
        return frame_numbers(frames, self.reference_frames([i for _n, i, _img in self.kept]))

    def end_to_end(self, units, window_s):
        return {"frame_ms": window_s / units * 1e3}

    def launch_bounds(self, kernel):
        """Per window frame, K3's least time on its pose (one launch a
        frame: one brick, one sample per pixel)."""
        if kernel != "k3":
            return None
        if not hasattr(self, "samples"):
            self.samples = {}
            self.reference_frames(sorted(set(self.log)), counts=self.samples)
        w, h = self.cfg["viewport"]
        return [peaks.bound_s(*k3.bytes_ops(
            brick_voxels_used=self.truth.numel(), n_bricks=1, samples=self.samples[i],
            n_rays=w * h, n_tf=self.tf0.shape[0])) for i in self.log]
