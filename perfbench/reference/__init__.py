"""The plain references the benchmark judges the program's outputs by:
plain PyTorch and numpy, importing nothing of ``libre_tpu_torch``, ``jax``
or ``libre_tpu``.  They work out again whatever the program derives from
the inputs (view vectors, ray packs, sweep tables), render through
autograd for the gradients, and update with a plain Adam."""
