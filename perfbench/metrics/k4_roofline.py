"""``k4_roofline``: K4's share of its roofline over the window, in % (the
kernels named ``exact_march_bwd_kernel``)."""

from perfbench.metrics import roofline_pct


def read(trace, driver):
    return roofline_pct(trace, driver, "k4", "exact_march_bwd_kernel")
