"""``k4_roofline.set``: the share of its roofline of K4's set instance over
the window, in % (the kernels named ``exact_march_bwd_kernel``; the bound
from ``work/k4_set``: the set's bytes, the samples and a slab test for
every brick on every ray)."""

from perfbench.metrics import roofline_pct


def read(trace, driver):
    return roofline_pct(trace, driver, "k4", "exact_march_bwd_kernel")
