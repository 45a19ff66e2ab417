"""``host_reads.set``: the tensors the sharded render copies to the host
a step (``render_rays_sharded.host_reads``, a program counter; on the card
each a device-to-host read and a synchronise), counted by the driver over
the window; None where the program has no such counter."""


def read(trace, driver):
    return getattr(driver, "host_reads", None)
