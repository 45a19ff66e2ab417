"""The published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its 700 W limit) and the least time a kernel's work could take.

A kernel's roofline share is that least time over its measured device
time; ``work/<kernel>.py`` counts the bytes and operations from the
cell's inputs, never from launch geometry."""

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(bytes_: float, ops: float) -> float:
    """Seconds: the larger of the bytes over the HBM rate and the f32
    operations (outside the tensor cores) over their peak."""
    return max(bytes_ / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)
