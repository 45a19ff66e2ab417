"""The port's ``entry()`` on the CPU against ``__graft_entry__.entry()``:
the same example volume, and the same image (1e-5) from the JAX ``fn``
(the XLA marcher) on the port's example inputs."""

import jax.numpy as jnp
import numpy as np
import torch

import __graft_entry__
from libre_tpu_torch import entry as entry_t

torch.set_num_threads(1)


def test_entry_matches_graft_entry():
    fn_j, args_j = __graft_entry__.entry()
    fn_t, args_t = entry_t.entry(device="cpu")
    vol_t, tf_t = args_t
    assert vol_t.device.type == "cpu" and tf_t.shape == (64, 4)
    np.testing.assert_array_equal(vol_t.numpy(), np.asarray(args_j[0]))
    np.testing.assert_array_equal(tf_t.numpy(), np.asarray(args_j[1]))
    got = fn_t(vol_t, tf_t)
    want = np.asarray(fn_j(jnp.asarray(vol_t.numpy()), jnp.asarray(tf_t.numpy())))
    assert got.shape == want.shape == (entry_t.IMG, entry_t.IMG, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert want[..., 3].max() > 0.5


def test_dryrun_multichip_on_cpu_shards(capsys):
    """``dryrun_multichip`` over 4 and 3 logical CPU shards: every
    sharded path runs once (K3, K1 and K2 by their plain versions), and
    over 2 shards the mesh-sharded exact trainer's step (K3 and K4 over
    each shard's brick chunk by their plain versions) gives a finite
    loss."""
    out = entry_t.dryrun_multichip(4, ["cpu"] * 4)
    assert out["mesh"] == {"ray": 2, "brick": 2}
    assert out["exact_alpha_max"] > 0.5 and out["bricked_alpha_max"] > 0.5
    assert np.isfinite(out["store_loss"]) and out["slab_grad_max"] > 0
    assert "render_cli --mesh ok" in capsys.readouterr().out
    out3 = entry_t.dryrun_multichip(3, ["cpu"] * 3)
    assert out3["mesh"] == {"ray": 3, "brick": 1} and "slab_loss" not in out3
    out2 = entry_t.dryrun_multichip(2, ["cpu"] * 2, exact_trainer=True)
    assert out2["mesh"] == {"ray": 1, "brick": 2}
    assert np.isfinite(out2["exact_train_loss"]) and out2["exact_train_loss"] > 0
    assert "marcher trainer loss=" in capsys.readouterr().out
