"""The port's multi-process layer (``libre_tpu_torch.parallel.distributed``):
single-process no-ops, and one 2-process ``gloo`` run on the CPU
(``parallel/two_process.py``, two subprocesses as tests/test_distributed.py
starts them, with a 120 s limit of its own): the controller's frame state
broadcast, a barrier, and a process-spanning ray axis whose gathered rows
equal the one-device slope grid (2e-5, early exit off) and whose summed
slab-sharded loss and TF gradient equal the one-device loss (rtol 1e-6)
and TF gradient (1e-5), on every process."""

import json

import torch

from libre_tpu_torch.parallel import distributed, two_process


def test_single_process_noops():
    distributed.initialize(num_processes=1)  # no-op
    distributed.initialize()  # no-op
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.is_controller()
    tree = {"a": [1, 2, 3], "uri": "mem://#8,8,8,8"}
    assert distributed.broadcast_frame_state(tree) is tree
    distributed.sync_global_devices("frame")
    x = torch.arange(6.0).reshape(3, 2)
    assert distributed.gather_rows(x) is x
    assert torch.equal(distributed.all_reduce_sum(x), x)
    assert distributed.process_rows(8) == slice(0, 8)
    distributed.shutdown()  # no group: nothing to leave


def test_two_process_gloo_rows_loss_and_tf_gradient():
    outs = two_process.run("cpu", vox=16, img=16, timeout=120)
    results = []
    for rank, out in enumerate(outs):
        line = next(ln for ln in out.splitlines() if ln.startswith(f"OK rank={rank} "))
        results.append(json.loads(line.split(" ", 2)[2]))
    for r in results:
        assert r["img_err"] <= 2e-5 and r["loss_rel_err"] <= 1e-6 and r["tf_grad_err"] <= 1e-5
        assert r["alpha_max"] > 0.1 and r["tf_grad_max"] > 1e-3
    assert results[0]["loss"] == results[1]["loss"]
