"""The port's package-level API against the JAX package's: the renderer
registry's ``available_renderers`` (the cases of
tests/test_registry_memory.py::test_registry_dispatch) and the names
``libre_tpu/__init__.py`` exports, which ``libre_tpu_torch`` exports
too, each behaving as its JAX counterpart on the same inputs."""

import numpy as np
import pytest

import libre_tpu
import libre_tpu_torch
from libre_tpu.render import registry as registry_j
from libre_tpu_torch.render.registry import (
    RendererPlugin,
    available_renderers,
    create_renderer,
    register_renderer,
)


def test_registry_dispatch():
    assert "xla" in available_renderers()
    assert "shearwarp" in available_renderers()
    assert "bricked" in available_renderers()
    assert "pallas-exact" in available_renderers()
    assert available_renderers() == sorted(available_renderers())
    r = create_renderer("xla")
    assert r.name == "xla"
    with pytest.raises(ValueError, match="no renderer plugin"):
        create_renderer("cuda")  # the reference's name; not ours
    # The JAX package's built-ins are the port's too.
    builtins = {"xla", "shearwarp", "bricked", "pallas-exact"}
    assert builtins <= set(registry_j.available_renderers())
    assert builtins <= set(available_renderers())


def test_registry_lists_a_custom_plugin():
    @register_renderer("test-null-port")
    class NullRenderer(RendererPlugin):
        def render(self, engine, camera, frustum, *, params=None, **kw):
            return None

    assert "test-null-port" in available_renderers()
    assert create_renderer("test-null-port").render(None, None, None) is None


def test_package_exports_match_jax():
    assert libre_tpu_torch.__all__ == libre_tpu.__all__
    for name in libre_tpu.__all__:
        assert getattr(libre_tpu_torch, name).__name__ == getattr(libre_tpu, name).__name__
        assert getattr(libre_tpu_torch, name).__module__.startswith("libre_tpu_torch.core.")


def test_package_exports_behave_as_jax():
    """The same node ids, volume information and LOD node from the two
    packages' exports."""
    t, j = libre_tpu_torch, libre_tpu
    for level, pos in ((0, (0, 0, 0)), (2, (1, 3, 2)), (3, (7, 0, 5))):
        a, b = t.NodeId.from_coords(level, pos, 1), j.NodeId.from_coords(level, pos, 1)
        assert a.id == b.id and a.level == b.level and a.position == b.position
    assert t.NodeId().is_valid() is j.NodeId().is_valid() is False
    assert t.RootNode(4, (2, 2, 1)).block_size(2) == j.RootNode(4, (2, 2, 1)).block_size(2)
    assert [d.name for d in t.DataType] == [d.name for d in j.DataType]
    infos = [pkg.fill_regular_volume_info(pkg.VolumeInformation(
        voxels=(96, 64, 40), maximum_block_size=(18, 18, 18), overlap=(1, 1, 1),
        data_type=pkg.DataType.UINT16)) for pkg in (t, j)]
    for field in ("world_size", "world_space_per_voxel", "block_size", "bytes_per_voxel"):
        assert getattr(infos[0], field) == getattr(infos[1], field), field
    assert infos[0].root_node.depth == infos[1].root_node.depth
    assert infos[0].root_node.block_count == infos[1].root_node.block_count
    nodes = [pkg.LODNode(pkg.NodeId.from_coords(1, (1, 0, 1)), (16, 16, 16), (0.0, -0.5, 0.0),
                         (0.5, 0.0, 0.5)) for pkg in (t, j)]
    assert nodes[0].voxel_box == nodes[1].voxel_box
    np.testing.assert_array_equal(nodes[0].world_space_per_voxel(),
                                  nodes[1].world_space_per_voxel())
