"""A/B timing of the exact backward kernel K4 (``csrc/exact_march_bwd.cu``)
as two checkouts have it, on one NVIDIA GPU::

    python -m libre_tpu_torch.benchmarks.exact_bwd_ab --parent DIR [--rounds 3] [--reps 10]
        [--tf-size T]

``DIR`` is another checkout of the repo, e.g. a parent commit unpacked
with ``git archive``.  Both sources are built at once with the port's
flags and ``-Xptxas -v`` (registers and spills printed); each build is
bound with the launcher signature its source declares (a launcher with no
``early_exit`` operand is the kernel from before the exit rule, which
walks every sample; one with an ``n_bricks`` operand walks a brick set,
here the one brick; one with an ``n_tf`` operand is given the TF's T,
256 by default, its fixed instance, and ``--tf-size`` another).  The
operands are the exact trainer's view 0 (512² rays, 512 samples per ray,
trilinear, the early exit off) over the 512³ smooth ground truth with the
default TF (``testing.tf_of_size``), K3's forward and a seeded
N(0, 1) cotangent.  Each build's gradients are held against the plain
version's (normalised by its max |·|, within
``testing.EXACT_GRAD_TOL_MAX``); then the builds are timed with CUDA
events in rounds, in the order given and its reverse, the TF gradient
on, each time with the card's name and power limit.  Without a CUDA
device it raises.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from ..apps.render_cli import build_camera
from ..ops import _kernels, exact
from ..ops.reference import RenderParams
from ..testing import EXACT_GRAD_TOL_MAX, smooth_volume, tf_of_size
from ._common import timed
from .demo_inverse_render import EYES


def launcher_params(src: Path):
    """(the number of float parameters, whether it takes ``n_bricks``,
    whether it takes the TF size ``n_tf``) of the ``exact_march_bwd``
    launcher that ``src`` declares."""
    decl = re.search(r'extern "C" int exact_march_bwd\((.*?)\)\s*\{', src.read_text(), re.S)
    if decl is None:
        raise ValueError(f"no exact_march_bwd launcher in {src}")
    params = decl.group(1)
    return len(re.findall(r"\bfloat\b", params)), "n_bricks" in params, "n_tf" in params


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--tf-size", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("exact_bwd_ab: no CUDA device")
    parent_src = args.parent.resolve() / "libre_tpu_torch" / "csrc" / "exact_march_bwd.cu"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    jobs = {"K4 parent": parent_src, "K4": _kernels.SRC_DIR / "exact_march_bwd.cu"}
    out_dir = Path(tempfile.mkdtemp(prefix="exact_bwd_ab-"))
    try:
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = {t: pool.submit(_kernels.build_verbose, out_dir, t, s)
                       for t, s in jobs.items()}
            built = {t: f.result() for t, f in futures.items()}
        for tag, (_lib, report) in built.items():
            print(f"build {tag}: {_kernels.report_text(report)}")

        n = 512
        params = RenderParams(n_samples_per_ray=512, data_source_range=(0.0, 1.0),
                              filter_mode="trilinear", early_exit=1.1)
        view = exact.exact_view(build_camera(512, 512, EYES[0], (0.0, 0.0, 0.0))[0], params,
                                device=dev)
        volume = smooth_volume(n, seed=7, device=dev)
        tf = torch.from_numpy(tf_of_size(args.tf_size)).to(dev)
        with torch.no_grad():
            out = exact.render_exact_diff(volume, tf, view)
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(0)).to(dev)
        want = exact.march_exact_backward_reference(volume, tf, view, out, g)
        lo, hi = params.data_source_range
        ex, ey, ez = (float(v) for v in view.eye)

        def run_of(tag):
            fn = getattr(ctypes.CDLL(str(built[tag][0])), "exact_march_bwd")
            floats, over_set, takes_n_tf = launcher_params(jobs[tag])
            if not takes_n_tf and tf.shape[0] != 256:
                raise ValueError(f"{tag}'s launcher takes only a 256-entry TF")
            ints = [1, 1] + [1] * over_set + [view.n_rays, view.width, n, n, n, view.max_steps]
            tail = [tf.shape[0]] * takes_n_tf
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * len(ints)
                           + [ctypes.c_float] * floats + [ctypes.c_int] * len(tail)
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            scalars = [ex, ey, ez, params.step_size, 1.0 / (hi - lo), -lo / (hi - lo),
                       params.alpha_correction, params.early_exit][:floats]
            d_volume, d_tf = torch.zeros_like(volume), torch.zeros_like(tf)
            ptrs = [t.data_ptr() for t in (volume, view.brick_boxes, tf, view.ray_pack, out,
                                           g, d_volume, d_tf)]

            def run():
                d_volume.zero_()
                d_tf.zero_()
                err = fn(*ptrs, *ints, *scalars, *tail,
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{tag} launch failed: cudaError_t {err}")
                return d_volume, d_tf
            return run

        runs = {t: run_of(t) for t in jobs}
        for tag, run in runs.items():
            got = run()
            torch.cuda.synchronize()
            for name, a, b in zip(("d_volume", "d_tf"), got, want):
                err = float((a - b).abs().max() / b.abs().max())
                print(f"{tag} vs plain, {name}: max|d|/max|plain| {err:.3e}")
                if err > EXACT_GRAD_TOL_MAX:
                    raise AssertionError(f"{tag} disagrees with the plain K4 ({name}, {err})")
        order = list(runs)
        times = {t: [] for t in order}
        for _ in range(args.rounds):
            for tag in order + order[::-1]:
                times[tag].append(timed(runs[tag], dev, args.reps)[0] * 1e3)
        base = min(times[order[0]])
        print(f"K4 on exact training view 0 over the 512^3 ground truth (512x512 rays, 512 "
              f"samples per ray, trilinear, early exit off, TF gradient on, T = {tf.shape[0]}; "
              f"d_volume and d_tf zeroed in each call):")
        for tag in order:
            ts = times[tag]
            print(f"  {tag}: {min(ts):.4f}-{max(ts):.4f} ms ({min(ts) / base - 1.0:+.2%} "
                  f"against {order[0]}) {card}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    main()
