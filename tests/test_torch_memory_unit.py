"""The port's copy of ``libre_tpu/data/memory_unit.py`` against the cases
of tests/test_registry_memory.py::test_memory_units, and against the JAX
package's classes on the same buffers."""

import numpy as np
import pytest

from libre_tpu.data import memory_unit as mu_j
from libre_tpu_torch.data import memory_unit as mu_t


def test_memory_units():
    assert mu_t.NoMemoryUnit().mem_size == 0

    backing = np.arange(16, dtype=np.uint8)
    view = mu_t.ConstMemoryUnit(backing)
    assert view.mem_size == 16
    np.testing.assert_array_equal(view.get_data(), backing)

    own = mu_t.AllocMemoryUnit(backing)
    backing[0] = 99
    assert own.get_data()[0] == 0  # owning copy unaffected
    assert mu_t.AllocMemoryUnit(8).mem_size == 8
    assert own.get_data(np.uint32).dtype == np.uint32


def test_const_unit_is_a_read_only_view():
    backing = np.arange(8, dtype=np.uint8)
    view = mu_t.ConstMemoryUnit(backing)
    backing[3] = 42
    assert view.get_data()[3] == 42  # a view, not a copy
    with pytest.raises(ValueError):
        view.get_data()[0] = 1
    assert backing.flags.writeable  # the caller's array is left as it was
    assert view.alloc_size == view.mem_size == 8
    with pytest.raises(NotImplementedError):
        mu_t.MemoryUnit().get_data()


@pytest.mark.parametrize("make", [
    lambda m, a: m.NoMemoryUnit(),
    lambda m, a: m.ConstMemoryUnit(a),
    lambda m, a: m.AllocMemoryUnit(a),
    lambda m, a: m.AllocMemoryUnit(12),
])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
def test_matches_jax_package(make, dtype):
    a = np.arange(24, dtype=np.uint8)
    got, want = make(mu_t, a.copy()), make(mu_j, a.copy())
    assert (got.mem_size, got.alloc_size) == (want.mem_size, want.alloc_size)
    np.testing.assert_array_equal(got.get_data(dtype), want.get_data(dtype))
    assert got.get_data(dtype).dtype == want.get_data(dtype).dtype
