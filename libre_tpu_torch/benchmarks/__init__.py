"""The port's benchmark scripts: the JAX package's gather probes
``benchmarks/probe_*.py``, module for module, on the hand-written kernels
of ``ops/gather.py``; and its throughput and demo scripts
(``bench_forward``, ``probe_bwd_breakdown``, ``demo_inverse_render``,
``demo_out_of_core``) on the port's render and training paths, each a
``main(argv)`` that times with CUDA events and ends its output with the
render kernels' launch counts.

Each module keeps its reference's ``build_*`` names (``mk(axis)`` and
``f1``-``f3`` for the last two); each returns ``(fn, args, work)`` at the
probe's own shapes, its inputs made from a seed on the given device.
``main`` times every probe of its module on the card (CUDA events), with
its gathers per second, its check against the plain version and the time
of the one PyTorch call that computes the same function where there is
one; with no CUDA device it raises.  Nothing runs at import::

    python -m libre_tpu_torch.benchmarks.probe_kernel_gather
"""

# The probe modules, in the order of their P numbers.  Not imported here,
# so that ``python -m`` runs each as ``__main__`` without a second copy.
MODULES = (
    "probe_gather",
    "probe_gather2",
    "probe_gather_axis0",
    "probe_kernel_gather",
    "probe_pallas_gather",
)
# The throughput and demo scripts.
SCRIPTS = (
    "bench_forward",
    "probe_bwd_breakdown",
    "demo_inverse_render",
    "demo_out_of_core",
)
