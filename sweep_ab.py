#!/usr/bin/env python3
"""A/B timing of the port's plane sweeps K1 and K5 on one NVIDIA GPU.

    python3 sweep_ab.py --parent DIR [--rounds 2] [--reps 20]

``DIR`` is another checkout of the repo, e.g. a parent commit unpacked
with ``git archive``.  The script builds K5 (``csrc/pre_sweep.cu``) and
K1 (``csrc/post_sweep.cu``) as this checkout and as ``DIR`` have them,
each with ``-Xptxas -v`` for its registers and spills (the flag changes
no code), and counts the lines in which the two K1 builds' SASS
(``cuobjdump``) differ.  It then takes the operands of ``chip_smoke.py``'s
main paths on the last pose of its 8-pose orbit over the 512³ ``mem://``
volume (K5 over the classified level-4 stack, K1 over the
screen-space-error-1 store) and ``testing.dense_case("slice")``, checks
every build bit-equal to the plain version there, prints the work behind
the time (planes listed per tile and composited at), and times the
builds by CUDA events in rounds of the order given and its reverse, each
time with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

def build(out_dir: Path, tag: str, src: Path):
    """nvcc ``src`` with the port's flags → (library path, ptxas report)."""
    from libre_tpu_torch.ops import _kernels

    lib = out_dir / ("lib" + re.sub(r"\W+", "_", tag) + ".so")
    cmd = [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {tag}:\n{proc.stdout}\n{proc.stderr}")
    regs = re.findall(r"Used (\d+) registers", proc.stderr)
    spills = re.findall(r"(\d+) bytes spill stores", proc.stderr)
    return lib, f"{','.join(regs)} registers, {','.join(spills) or '0'} bytes spilled"


def bind(lib: Path, name: str):
    from libre_tpu_torch.ops import _kernels

    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = _kernels.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, args, out_index):
    """A call that launches ``fn`` on recorded ``args`` with an output of
    its own at ``out_index`` and returns that output."""
    import torch

    args = list(args)
    args[out_index] = torch.empty_like(args[out_index])
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

    def run():
        err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        return args[out_index]

    return run


def sass(lib: Path) -> str:
    """The SASS of a library's kernels, without the file name."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    return "\n".join(line for line in text.splitlines() if "Fatbin" not in line
                     and "code for" not in line and lib.name not in line)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_ab: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    parent_src = args.parent.resolve() / "libre_tpu_torch" / "csrc"
    if not (parent_src / "pre_sweep.cu").exists():
        raise SystemExit(f"sweep_ab: no libre_tpu_torch/csrc/pre_sweep.cu under {args.parent}")

    from chip_smoke import URI, Recorder, cuda_ms, orbit_cameras
    from libre_tpu_torch.data.datasource import DataSource, load_plugins
    from libre_tpu_torch.ops import _kernels
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops import shearwarp_dense as swd
    from libre_tpu_torch.render.engine import RenderEngine
    from libre_tpu_torch.testing import dense_case

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(smi)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    out_dir = Path(tempfile.mkdtemp(prefix="sweep_ab-"))
    try:
        src = _kernels.SRC_DIR
        jobs = {
            "K5 parent": parent_src / "pre_sweep.cu",
            "K5": src / "pre_sweep.cu",
            "K1 parent": parent_src / "post_sweep.cu",
            "K1": src / "post_sweep.cu",
        }
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = {t: pool.submit(build, out_dir, t, s) for t, s in jobs.items()}
            built = {t: f.result() for t, f in futures.items()}
        for tag, (_lib, report) in built.items():
            print(f"build {tag}: {report}")
        new, old = (sass(built[t][0]).splitlines() for t in ("K1", "K1 parent"))
        moved = sum(1 for a, b in zip(new, old) if a != b) + abs(len(new) - len(old))
        print(f"K1's SASS: {len(new)} lines against the parent's {len(old)}, {moved} differ")

        # The main paths' operands on the orbit's last pose, recorded from
        # one steady frame of each engine.
        load_plugins()
        camera, frustum = orbit_cameras()[-1]
        bricked = RenderEngine(DataSource(URI), device=dev)
        bricked.render_bricked(camera, frustum, screen_space_error=1.0)
        with Recorder("post_sweep") as k1_rec:
            bricked.render_bricked(camera, frustum, screen_space_error=1.0)
        dense = RenderEngine(DataSource(URI), device=dev)
        dense.render_shearwarp(camera)
        with Recorder("pre_sweep") as k5_rec:
            dense.render_shearwarp(camera)
        torch.cuda.synchronize()
        (_n, k1_args), = k1_rec.calls
        (_n, k5_orbit), = k5_rec.calls
        c = dense_case("slice", seed=0, device=dev)
        with Recorder("pre_sweep") as k5_rec:
            swd.pre_sweep(c.chans, c.tables, **c.kw)
        (_n, k5_slice), = k5_rec.calls

        cases = [("K5, orbit view", k5_orbit), ("K5, slice case", k5_slice)]
        for what, k5_args in cases:
            (chans, a0, a1, wa, dl, act, view, corr, _out, _k, _nc, _nb, v_size, u_size,
             wb0, wb1, wc0, wc1, _sb, _sc, early_exit) = k5_args
            tables = swb.SweepTables(a0=a0, a1=a1, wa=wa, dl=dl, act=act, view=view,
                                     corr=corr, rgb_in=None, t_in=None)
            kw = dict(wb=(wb0, wb1), wc=(wc0, wc1), early_exit=early_exit)
            lists = swb.tile_planes_reference(tables, kw["wb"], kw["wc"])
            fetches = torch.zeros_like(lists)
            samples = torch.zeros((v_size, u_size), dtype=torch.int64, device=dev)
            want = swd.pre_sweep_reference(chans, tables, fetches=fetches, samples=samples, **kw)
            n_tiles = lists[..., 0].numel()
            print(f"{what}: {int(samples.sum())} samples; the {n_tiles} tiles of 4x32 rays "
                  f"list {int(lists.sum()) / n_tiles:.1f} planes each and composite at "
                  f"{int(fetches.sum()) / n_tiles:.1f}")
            runs = {t: launcher(bind(built[t][0], "pre_sweep"), k5_args, 8)
                    for t in ("K5 parent", "K5")}
            time_builds(what, runs, want, args.rounds, args.reps, card, cuda_ms)
            del want, lists, fetches, samples

        from chip_smoke import k1_operands

        (store, tf, tables, clip, kw), _outs = k1_operands(k1_args)
        want, _t = swb.post_sweep_reference(store, tf, tables, clip, **kw)
        runs = {t: launcher(bind(built[t][0], "post_sweep"), k1_args, 12)
                for t in ("K1 parent", "K1")}
        time_builds("K1, orbit view", runs, want, args.rounds, args.reps, card, cuda_ms)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


def time_builds(what, runs, want, rounds, reps, card, cuda_ms):
    """Check each build's output bit-equal to ``want``, then time them in
    rounds of the given order and its reverse; print each build's times."""
    import torch

    for tag, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{what}: {tag} is not bit-equal to the plain sweep")
    print(f"{what}: every build bit-equal to the plain sweep")
    order = list(runs)
    times = {t: [] for t in order}
    for _ in range(rounds):
        for tag in order + order[::-1]:
            times[tag].append(cuda_ms(runs[tag], reps=reps))
    base = min(times[order[0]])
    for tag in order:
        ts = times[tag]
        print(f"  {tag}: {min(ts):.4f}-{max(ts):.4f} ms ({min(ts) / base - 1.0:+.1%} against "
              f"{order[0]}) {card}")


if __name__ == "__main__":
    sys.exit(main())
