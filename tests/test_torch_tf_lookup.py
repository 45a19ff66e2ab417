"""The TF lookup's plain versions on the CPU (``ops/transfer_function``).

* ``testing.lookup_backward_reference``, the closed form that ``csrc/tf_lookup.cu``'s
  backward computes, agrees with autograd of ``lookup_reference`` within
  f32 round-off (``testing.tf_lookup_bounds``) at every TF size of
  ``testing.TF_LOOKUP_SIZES``, over densities at 0, 1, texel centres, the
  clamp edges and their neighbours, outside [0, 1], and a flat 0.5 volume;
* ``lookup`` on CPU tensors is ``lookup_reference``, output and gradients
  bit for bit, and launches nothing.

The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from libre_tpu_torch.ops import transfer_function as tfm
from libre_tpu_torch.testing import (
    TF_LOOKUP_SIZES,
    assert_tf_lookup_grads,
    lookup_backward_reference,
    tf_lookup_bounds,
    tf_lookup_densities,
    tf_of_size,
)


def _case(n_tf, density, seed):
    rng = np.random.default_rng(seed)
    tf = torch.from_numpy(tf_of_size(n_tf) * np.float32(0.8) + np.float32(0.1))
    g = torch.from_numpy(rng.uniform(-0.5, 1.5, tuple(density.shape) + (4,)).astype(np.float32))
    return tf, g


def _autograd(fn, tf, density, g):
    tf, density = tf.clone().requires_grad_(), density.clone().requires_grad_()
    out = fn(tf, density)
    return (out.detach(),) + torch.autograd.grad(out, [tf, density], g)


@pytest.mark.parametrize("n_tf", TF_LOOKUP_SIZES)
@pytest.mark.parametrize("field", ["edges", "flat"])
def test_backward_reference_matches_autograd(n_tf, field):
    density = tf_lookup_densities(n_tf, seed=n_tf)
    if field == "flat":  # every density in the same two bins
        density = torch.full((9, 11, 13), 0.5)
    tf, g = _case(n_tf, density, seed=7)
    _out, d_tf, d_density = _autograd(tfm.lookup_reference, tf, density, g)
    want = lookup_backward_reference(tf, density, g)
    assert want[0].dtype == want[1].dtype == torch.float32
    assert want[0].shape == tf.shape and want[1].shape == density.shape
    bounds = tf_lookup_bounds(tf, density, g)
    assert_tf_lookup_grads((d_tf, d_density), want, bounds, f"T={n_tf} {field}")
    passes = want[1] != 0
    assert bool((d_density[~passes] == 0).all())
    if n_tf == 1:  # one texel: both taps on it, the density gradient exactly 0
        assert not bool(passes.any())


@pytest.mark.parametrize("n_tf", [2, 256, 8192])
def test_cpu_lookup_is_the_reference(n_tf):
    density = tf_lookup_densities(n_tf, seed=3)[:1000].reshape(10, 10, 10)
    tf, g = _case(n_tf, density, seed=5)
    launches = tfm.lookup.launches
    got = _autograd(tfm.lookup, tf, density, g)
    want = _autograd(tfm.lookup_reference, tf, density, g)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert got[0].shape == density.shape + (4,)
    assert tfm.lookup.launches == launches
