"""The per-layer metrics: ``<metric>.py`` holds ``read(trace, driver)``,
which returns the metric's value from the ``--trace 1`` run's
``perfbench.trace.Trace`` and the cell's driver, or None where it finds
nothing to read (the harness then leaves the metric out)."""

import sys


def roofline_pct(trace, driver, kernel: str, name_part: str):
    """A kernel's share of its roofline, in %: the least time of the
    window's launches of it (``driver.launch_bounds``, from the work its
    inputs need) over their device time.  None where the window launched
    it not once, or another number of times than the driver's count."""
    seconds, launches = trace.kernel(name_part)
    if not launches or seconds <= 0.0:
        return None
    bounds = driver.launch_bounds(kernel)
    if not bounds or len(bounds) != launches:
        print(f"perfbench: {launches} launches of {name_part} in the trace, "
              f"{len(bounds or [])} counted by the driver", file=sys.stderr)
        return None
    return 100.0 * sum(bounds) / seconds
