"""``k2_roofline``: K2's share of its roofline over the window, in % (the
kernels named ``store_grid_bwd_kernel``)."""

from perfbench.metrics import roofline_pct


def read(trace, driver):
    return roofline_pct(trace, driver, "k2", "store_grid_bwd_kernel")
