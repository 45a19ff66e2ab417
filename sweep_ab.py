#!/usr/bin/env python3
"""A/B timing of the port's kernels K1, K5, K3 and K2 on one NVIDIA GPU,
as this checkout and another have them (K4 has its own script,
``python -m libre_tpu_torch.benchmarks.exact_bwd_ab``).

    python3 sweep_ab.py --parent DIR [--rounds 2] [--reps 20] [--kernels K5,K1,K3,K2]
                        [--tf-size T]

``DIR`` is another checkout of the repo, e.g. a parent commit unpacked
with ``git archive``.  The script builds K5 (``csrc/pre_sweep.cu``), K1
(``csrc/post_sweep.cu``), K3 (``csrc/exact_march.cu``) and K2
(``csrc/store_grid_bwd.cu``) as this checkout and as ``DIR`` have them,
each with ``-Xptxas -v`` for its registers and spills (the flag changes
no code), binds each build with the launcher signature its own source
declares (operands a newer launcher appends, such as K1's and K5's bf16
switch or K3's TF size, are left off the older one: the newer build runs
its f32, T = 256 instance), and counts the lines in which the two K1
builds' SASS (``cuobjdump``) of the f32 instance differ.  It then takes
the operands of ``chip_smoke.py``'s main paths on the last pose of its
8-pose orbit over the 512³ ``mem://`` volume (K5 over the classified
level-4 stack, K1 over the screen-space-error-1 store, K3 over its 4096
bricks), ``testing.dense_case("slice")`` and, for K2, the 512² rays × 512
planes of ``testing.store_grad_case`` over a random 512³ store with the
early exit off and the TF gradient on.  It checks every sweep build
bit-equal to the plain version, every K3 build bit-equal to the
recorded launch (with ``--tf-size`` T other than 256, the recorded launch
with a T-entry TF, every K3 build bit-equal to the parent's: the runtime-T
instances), every K2 build within the backward kernels' bound of
the plain backward, prints the work behind the time (planes listed per
tile and composited at), and times the builds by CUDA events in rounds
of the order given and its reverse, each time with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

def bind(lib: Path, name: str, src: Path):
    """Launcher ``name`` of ``lib``, typed as its source ``src`` declares it."""
    from libre_tpu_torch.ops import _kernels

    fn = getattr(ctypes.CDLL(str(lib)), name)
    fn.argtypes = _kernels.declared_signature(src, name)
    fn.restype = ctypes.c_int
    return fn


def launcher(fn, args, out_index, zero=()):
    """A call that launches ``fn`` on recorded ``args`` (the operands its
    launcher takes, the leading ones) with outputs of its own at
    ``out_index`` (an index or a tuple of them), zeroing those at
    ``zero`` first as the wrapper does, and returns the outputs."""
    import torch

    args = list(args)[: len(fn.argtypes) - 1]
    outs = out_index if isinstance(out_index, tuple) else (out_index,)
    for i in outs:
        args[i] = torch.empty_like(args[i])
    cargs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]

    def run():
        for i in zero:
            args[i].zero_()
        err = fn(*cargs, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")
        got = tuple(args[i] for i in outs)
        return got if isinstance(out_index, tuple) else got[0]

    return run


def sass(lib: Path, skip: str = "") -> str:
    """The SASS of a library's kernels, without the file name and without
    the functions whose name holds ``skip`` (another instance)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    keep, lines = True, []
    for line in text.splitlines():
        if "Function :" in line:
            keep = not (skip and skip in line)
            continue
        if keep and "Fatbin" not in line and "code for" not in line and lib.name not in line:
            lines.append(line)
    return "\n".join(lines)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_ab: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--kernels", default="K5,K1,K3,K2")
    ap.add_argument("--tf-size", type=int, default=256,
                    help="K3's TF entries (256: the recorded launch's TF)")
    args = ap.parse_args()
    kernels = args.kernels.split(",")
    parent_src = args.parent.resolve() / "libre_tpu_torch" / "csrc"
    if not (parent_src / "pre_sweep.cu").exists():
        raise SystemExit(f"sweep_ab: no libre_tpu_torch/csrc/pre_sweep.cu under {args.parent}")

    from chip_smoke import URI, Recorder, cuda_ms, orbit_cameras
    from libre_tpu_torch.data.datasource import DataSource, load_plugins
    from libre_tpu_torch.ops import _kernels
    from libre_tpu_torch.ops import shearwarp_bricked as swb
    from libre_tpu_torch.ops import shearwarp_dense as swd
    from libre_tpu_torch.ops import shearwarp_grad as swg
    from libre_tpu_torch.render.engine import RenderEngine
    from libre_tpu_torch.testing import compare_grads, dense_case, store_grad_case

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
        sources = {"K5": "pre_sweep", "K1": "post_sweep", "K3": "exact_march",
                   "K2": "store_grid_bwd"}
        jobs = {}
        for k in kernels:
            jobs[f"{k} parent"] = parent_src / f"{sources[k]}.cu"
            jobs[k] = src / f"{sources[k]}.cu"
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futures = {t: pool.submit(_kernels.build_verbose, out_dir, t, s)
                       for t, s in jobs.items()}
            built = {t: f.result() for t, f in futures.items()}
        for tag, (_lib, report) in built.items():
            print(f"build {tag}: {_kernels.report_text(report)}")

        def runs_of(k, recorded, out_index, zero=()):
            return {t: launcher(bind(built[t][0], sources[k], jobs[t]), recorded, out_index, zero)
                    for t in (f"{k} parent", k)}

        if "K1" in kernels:
            # The f32 instance's SASS: the bf16 instance (template argument
            # true, "ILb1E") left out.
            new, old = (sass(built[t][0], skip="ILb1E").splitlines() for t in ("K1", "K1 parent"))
            moved = sum(1 for a, b in zip(new, old) if a != b) + abs(len(new) - len(old))
            print(f"K1's SASS (f32 instance): {len(new)} lines against the parent's {len(old)}, "
                  f"{moved} differ")

        # The main paths' operands on the orbit's last pose, recorded from
        # one steady frame of each engine.
        load_plugins()
        camera, frustum = orbit_cameras()[-1]
        bricked = RenderEngine(DataSource(URI), device=dev)
        bricked.render_bricked(camera, frustum, screen_space_error=1.0)
        with Recorder("post_sweep") as k1_rec:
            bricked.render_bricked(camera, frustum, screen_space_error=1.0)
        with Recorder("exact_march") as k3_rec:
            bricked.render(camera, frustum, screen_space_error=1.0)
        torch.cuda.synchronize()
        (_n, k1_args), = k1_rec.calls
        k3_args = k3_rec.calls[0][1]  # the first pass, from a zero carry
        k3_want = k3_args[6].clone()
        cases = []
        if "K5" in kernels:
            dense = RenderEngine(DataSource(URI), device=dev)
            dense.render_shearwarp(camera)
            with Recorder("pre_sweep") as k5_rec:
                dense.render_shearwarp(camera)
            (_n, k5_orbit), = k5_rec.calls
            c = dense_case("slice", seed=0, device=dev)
            with Recorder("pre_sweep") as k5_rec:
                swd.pre_sweep(c.chans, c.tables, **c.kw)
            (_n, k5_slice), = k5_rec.calls
            cases = [("K5, orbit view", k5_orbit), ("K5, slice case", k5_slice)]
        for what, k5_args in cases:
            (chans, a0, a1, wa, dl, act, view, corr, _out, _k, _nc, _nb, v_size, u_size,
             wb0, wb1, wc0, wc1, _sb, _sc, early_exit, _bf16) = k5_args
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
            time_builds(what, runs_of("K5", k5_args, 8), want, args.rounds, args.reps, card,
                        cuda_ms)
            del want, lists, fetches, samples

        if "K1" in kernels:
            from chip_smoke import k1_operands

            (store, tf, tables, clip, kw), _outs = k1_operands(k1_args)
            want, _t = swb.post_sweep_reference(store, tf, tables, clip, **kw)
            time_builds("K1, orbit view", runs_of("K1", k1_args, 12), want, args.rounds,
                        args.reps, card, cuda_ms)
        if "K3" in kernels and args.tf_size == 256:
            # The recorded launch's output is the check: a build of the same
            # f32, T = 256 code gives it bit for bit.
            time_builds(f"K3, orbit view ({k3_args[11]} bricks, {k3_args[12]} rays)",
                        runs_of("K3", k3_args, 6), k3_want, args.rounds, args.reps, card,
                        cuda_ms, against="the recorded K3 launch")
        elif "K3" in kernels:
            # Another T: the recorded launch with an n-entry TF, every build
            # bit-equal to the parent's.
            from libre_tpu_torch.testing import tf_of_size

            tf_n = torch.from_numpy(tf_of_size(args.tf_size)).to(dev)
            k3_args = (*k3_args[:3], tf_n, *k3_args[4:-1], args.tf_size)
            runs = runs_of("K3", k3_args, 6)
            parent_out = runs["K3 parent"]().clone()
            time_builds(f"K3, orbit view ({k3_args[11]} bricks, {k3_args[12]} rays), "
                        f"T = {args.tf_size}", runs, parent_out, args.rounds, args.reps, card,
                        cuda_ms, against="the parent build")
        if "K2" in kernels:
            store, tf, tables, out, t_out, g, kw = store_grad_case(
                (512, 512, 512, 512, 512, 512), seed=0, device=dev, early_exit=1.1)
            with Recorder("store_grid_bwd") as k2_rec:
                swg.store_grid_backward(store, tf, tables, out, t_out, g, diff_tf=True, **kw)
            (_n, k2_args), = k2_rec.calls
            want = swg.store_grid_backward_reference(store, tf, tables, out, t_out, g,
                                                     diff_tf=True, **kw)

            def check(tag, got):
                for i, (a, b) in enumerate(zip(got, want)):
                    compare_grads(a, b, f"K2 {tag}, gradient {i} vs plain", 1.1)

            time_builds("K2, 512^2 rays x 512 planes over a random 512^3 store",
                        runs_of("K2", k2_args, (14, 15), zero=(14, 15)), None, args.rounds,
                        args.reps, card, cuda_ms, check=check)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    return 0


def time_builds(what, runs, want, rounds, reps, card, cuda_ms, against="the plain sweep",
                check=None):
    """Check each build's output bit-equal to ``want`` (or by
    ``check(tag, output)``), then time them in rounds of the given order
    and its reverse; print each build's times."""
    import torch

    for tag, run in runs.items():
        got = run()
        torch.cuda.synchronize()
        if check is not None:
            check(tag, got)
        elif not torch.equal(got, want):
            raise AssertionError(f"{what}: {tag} is not bit-equal to {against}")
    if check is None:
        print(f"{what}: every build bit-equal to {against}")
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
