"""``k3_roofline.set``: K3's share of its roofline over the window, in %,
marching the set (the kernels named ``exact_march_kernel``; the bound
from ``work/k3`` over every brick of the set)."""

from perfbench.metrics import roofline_pct


def read(trace, driver):
    return roofline_pct(trace, driver, "k3", "exact_march_kernel")
