"""The dense trainer's render (``ShearWarpProblem`` with classification
"pre"), forward and backward, over one step's views: the least work those
views need, whatever computes them (the plain pipeline's matrix products
today, a kernel later), counted from the cell's inputs.

Bytes: the volume read and its gradient written (each voxel once), the TF
read and its gradient written, and 12 floats a ray (the rgba out, the
target in, the forward's rgba in again for the backward).  Operations:

* per voxel, once a step, 54: the classification (the range's
  normalisation and clamp, the texel coordinate and its clamp: 8; floor,
  weight and 1 − weight: 3; the four channels' lerps: 12) and its
  backward (the weight's cotangent from the four channels' differences:
  11; the density's through the two scales and the clamps' masks: 4; the
  TF's eight products and eight adds: 16);
* per sample inside the box, 120 forward: the in-plane coordinates, taps
  and weights (14), the window test (4), the 28 lerps of the four channels
  (four axis lerps, two in b and one in c, 3 each: 84, and their three
  1 − w), the alpha clamp (1), the opacity correction (two differences
  and ``powf``, counted 3: 5) and the composite (weight, three products
  and sums, the transmittance: 9);
* per sample inside the box, 284 backward: the forward recomputed (120),
  the composite's and the opacity correction's backward (20), the 28
  lerps' backward (two products and two adds each: 112) and the 32 taps'
  gradient adds (8 taps × 4 channels: 32).
"""

OPS_PER_VOXEL = 54
OPS_PER_SAMPLE_FORWARD = 120
OPS_PER_SAMPLE_BACKWARD = 284
FLOATS_PER_RAY = 12


def bytes_ops(*, voxels: int, samples: int, n_rays: int, n_tf: int):
    """(bytes, f32 operations) of one step: ``samples`` and ``n_rays``
    summed over its views."""
    return (2 * voxels * 4 + 2 * n_tf * 16 + n_rays * FLOATS_PER_RAY * 4,
            voxels * OPS_PER_VOXEL
            + samples * (OPS_PER_SAMPLE_FORWARD + OPS_PER_SAMPLE_BACKWARD))
