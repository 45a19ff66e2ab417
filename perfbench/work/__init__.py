"""Each kernel's bytes and f32 operations for the work the cell's inputs
need: the samples and texels counted by the plain reference, never the
launch geometry, so a redesign that keeps the work keeps the bound.

Operations per sample are counted from the kernels' per-sample code: an
add, multiply, divide, compare, min/max, floor, conversion or atomic add
counts one, ``powf`` three; integer index arithmetic is not counted."""
