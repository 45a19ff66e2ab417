"""The port's RenderEngine.render_shearwarp, its ``shearwarp`` renderer
and ``render_cli --renderer shearwarp`` against the JAX package's, end to
end on the CPU.

Same ``mem://`` volume, same camera: the JAX engine runs its jnp backend
(its Pallas backend does not run on the CPU), the port's engine runs on
``device="cpu"`` with both backends: "jnp" (the plain pipeline) and
"pallas" (the classified stack swept by K5's plain version).  atol 5e-5:
the sweep's 2e-5 plus what the bilinear screen warp adds.
"""

import os

import numpy as np
import pytest
import torch

from libre_tpu.core.frustum import Frustum, look_at, perspective
from libre_tpu.data.datasource import DataSource, load_plugins
from libre_tpu.ops.reference import Camera as CameraJ, RenderParams as ParamsJ
from libre_tpu.render.engine import RenderEngine as EngineJ
from libre_tpu_torch.apps import render_cli
from libre_tpu_torch.core.frustum import Frustum as FrustumT
from libre_tpu_torch.data.datasource import DataSource as DataSourceT
from libre_tpu_torch.data.datasource import load_plugins as load_plugins_t
from libre_tpu_torch.ops import shearwarp_dense as swd
from libre_tpu_torch.ops.reference import Camera as CameraT, RenderParams as ParamsT
from libre_tpu_torch.ops.transfer_function import default_color_map
from libre_tpu_torch.render.engine import RenderEngine as EngineT
from libre_tpu_torch.render.registry import create_renderer
from libre_tpu_torch.utils.image import read_image

torch.set_num_threads(1)
load_plugins()
load_plugins_t()

W = H = 48
URI = "mem://#32,32,32,16?pattern=gradient&datatype=uint8"


def view(eye):
    proj = perspective(50.0, 1.0, 0.1, 15.0)
    mv = look_at(list(eye), [0, 0, 0], [0, 1, 0])
    kw = dict(
        inv_proj=np.linalg.inv(proj.astype(np.float64)).astype(np.float32),
        inv_mv=np.linalg.inv(mv.astype(np.float64)).astype(np.float32),
        viewport=(0, 0, W, H),
        near=Frustum(mv, proj).near,
    )
    return CameraJ(**kw), CameraT(**kw), FrustumT(mv, proj)


CASES = {
    # name: (eye, n_planes or None for the engine's default, explicit params)
    "z_axis_64": ((0.2, 0.1, 1.4), 64, True),
    "x_axis_default": ((1.3, 0.3, -0.4), None, False),
}


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_render_shearwarp_matches_jax(case, backend):
    eye, n_planes, explicit = CASES[case]
    cam_j, cam_t, _ = view(eye)
    kw = dict(n_planes=n_planes)
    params_j = params_t = None
    if explicit:
        spec = dict(n_samples_per_ray=n_planes, data_source_range=(0.0, 255.0),
                    filter_mode="trilinear")
        params_j, params_t = ParamsJ(**spec), ParamsT(**spec)
    eng_j = EngineJ(DataSource(URI), max_gpu_cache_mb=64, filter_mode="trilinear")
    want = np.asarray(eng_j.render_shearwarp(cam_j, params=params_j, backend="jnp", **kw))
    eng_t = EngineT(DataSourceT(URI), max_gpu_cache_mb=64, device="cpu")
    launches = swd.pre_sweep.launches
    got = eng_t.render_shearwarp(cam_t, params=params_t, backend=backend, **kw)
    assert got.shape == (H, W, 4) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)
    assert float(got[..., 3].max()) > 0.1
    assert swd.pre_sweep.launches == launches  # the CPU runs no kernel
    assert len(eng_t._classified_cache) == (backend == "pallas")


def test_classified_stack_cache():
    """Steady frames reuse the stack; an edit of the TF in place
    re-classifies into the same entry (its version moved), a new TF object
    into a new one."""
    _cam_j, cam_t, _ = view((0.2, 0.1, 1.4))
    eng = EngineT(DataSourceT(URI), max_gpu_cache_mb=64, device="cpu")
    kw = dict(n_planes=32, backend="pallas")
    eng.render_shearwarp(cam_t, n_planes=32)  # "auto" on a CPU engine: the plain pipeline
    assert len(eng._classified_cache) == 0
    first = eng.render_shearwarp(cam_t, **kw)
    assert len(eng._classified_cache) == 1
    assert torch.equal(eng.render_shearwarp(cam_t, **kw), first)
    assert len(eng._classified_cache) == 1
    eng.transfer_function[:, 3] = 0.0  # in place: re-classified
    cleared = eng.render_shearwarp(cam_t, **kw)
    assert len(eng._classified_cache) == 1
    assert float(cleared[..., 3].max()) == 0.0
    eng.transfer_function = eng.transfer_function.clone()  # a new object
    assert torch.equal(eng.render_shearwarp(cam_t, **kw), cleared)
    assert len(eng._classified_cache) == 2
    with pytest.raises(ValueError):
        eng.render_shearwarp(cam_t, backend="mxu")


def test_swapped_tfs_give_their_own_frames():
    """Three TFs swapped on one engine, each a new tensor assigned over the
    last, so that but for the cache entries the old ones would be freed
    and their ids free for reuse: every frame, over two rounds of swaps,
    equals a fresh engine's with that TF."""
    _cam_j, cam_t, _ = view((0.2, 0.1, 1.4))
    kw = dict(n_planes=32, backend="pallas")
    base = default_color_map()
    tfs = [base, base[::-1].copy(), np.clip(base * 3.0, 0.0, 1.0)]
    fresh = []
    for tf in tfs:
        eng = EngineT(DataSourceT(URI), max_gpu_cache_mb=64, device="cpu")
        eng.transfer_function = torch.from_numpy(tf.copy())
        fresh.append(eng.render_shearwarp(cam_t, **kw))
    assert not torch.equal(fresh[0], fresh[1]) and not torch.equal(fresh[0], fresh[2])
    eng = EngineT(DataSourceT(URI), max_gpu_cache_mb=64, device="cpu")
    for _round in range(2):
        for tf, want in zip(tfs, fresh):
            eng.transfer_function = torch.from_numpy(tf.copy())
            assert torch.equal(eng.render_shearwarp(cam_t, **kw), want)
    # An edit in place re-classifies: the same tensor, now TF 1's table.
    eng.transfer_function.copy_(torch.from_numpy(tfs[1]))
    assert torch.equal(eng.render_shearwarp(cam_t, **kw), fresh[1])


def test_shearwarp_renderer():
    """The registry's ``shearwarp`` entry passes level, time step, planes
    and backend to the engine and drops the other keywords."""
    _cam_j, cam_t, frustum = view((0.2, 0.1, 1.4))
    eng = EngineT(DataSourceT(URI), max_gpu_cache_mb=64, device="cpu")
    renderer = create_renderer("shearwarp")
    assert renderer.name == "shearwarp"
    img = renderer.render(eng, cam_t, frustum, level=0, n_planes=16, backend="jnp",
                          screen_space_error=1.0, synchronous=True)
    want = eng.render_shearwarp(cam_t, level=0, n_planes=16, backend="jnp")
    assert torch.equal(img, want) and float(img[..., 3].max()) > 0


def test_render_cli_shearwarp_writes_png(tmp_path, capsys):
    out = tmp_path / "out"
    rc = render_cli.main([
        "--volume", "mem://#32,32,32,16?pattern=gradient", "--renderer", "shearwarp",
        "--device", "cpu", "--width", "40", "--height", "32",
        "--samples-per-ray", "32", "-o", str(out),
    ])
    assert rc == 0
    path = out / "frame_000000.png"
    assert path.exists() and os.path.getsize(path) > 0
    img = read_image(str(path))
    assert img.shape[:2] == (32, 40) and img.max() > 0
    assert "shearwarp level 1 on cpu" in capsys.readouterr().out
