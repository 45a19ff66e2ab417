// One plane sample of the post-classification sweep, shared by the forward
// sweep (post_sweep.cu) and its recompute backward (store_grid_bwd.cu), so the
// backward recomputes exactly the samples the forward composited.  The plain
// PyTorch specification is libre_tpu_torch/ops/shearwarp_bricked.py::
// post_sweep_reference.
#pragma once

#include <cuda_runtime.h>

namespace sweep {

constexpr int kTfSize = 256;
constexpr float kAlphaClamp = 1.0f - 1.0f / 256.0f;

struct Taps {
  int i0, i1;
  float w;
};

// Two-tap indices and weight at fractional voxel coordinate s, clamp to edge:
// shearwarp_pallas._interp_matrix (clip to [-0.5, n-0.5], i0 = floor of the
// coordinate clipped to [0, n-1], i1 = min(i0 + 1, n - 1)).
__device__ __forceinline__ Taps taps(float s, int n) {
  s = fminf(fmaxf(s, -0.5f), (float)n - 0.5f);
  const float i0f = floorf(fminf(fmaxf(s, 0.0f), (float)(n - 1)));
  Taps t;
  t.w = fminf(fmaxf(s - i0f, 0.0f), 1.0f);
  t.i0 = (int)i0f;
  t.i1 = min(t.i0 + 1, n - 1);
  return t;
}

// Density at one sample from slices lo (weight 1 - w_a) and hi (weight w_a):
// the axis lerp at each of the 2x2 in-plane taps, then along b, then along c
// (the reference's order).
__device__ __forceinline__ float density(const float* lo, const float* hi,
                                         float w_a, Taps tb, Taps tc, int nb) {
  const size_t r0 = (size_t)tc.i0 * nb, r1 = (size_t)tc.i1 * nb;
  const float v00 = lo[r0 + tb.i0] * (1.0f - w_a) + hi[r0 + tb.i0] * w_a;
  const float v01 = lo[r0 + tb.i1] * (1.0f - w_a) + hi[r0 + tb.i1] * w_a;
  const float v10 = lo[r1 + tb.i0] * (1.0f - w_a) + hi[r1 + tb.i0] * w_a;
  const float v11 = lo[r1 + tb.i1] * (1.0f - w_a) + hi[r1 + tb.i1] * w_a;
  const float s_c0 = v00 * (1.0f - tb.w) + v01 * tb.w;
  const float s_c1 = v10 * (1.0f - tb.w) + v11 * tb.w;
  return s_c0 * (1.0f - tc.w) + s_c1 * tc.w;
}

// The transfer function's texel coordinate of a density: the clamped density
// scaled to [-0.5, 255.5], clamped to [0, 255].  i0 = floor(s), the lerp
// weight is s - i0 and the upper texel min(i0 + 1, 255).
__device__ __forceinline__ float tf_coord(float dens) {
  const float s = fminf(fmaxf(dens, 0.0f), 1.0f) * kTfSize - 0.5f;
  return fminf(fmaxf(s, 0.0f), (float)(kTfSize - 1));
}

__device__ __forceinline__ float4 lerp4(float4 c0, float4 c1, float wt) {
  return make_float4(c0.x * (1.0f - wt) + c1.x * wt,
                     c0.y * (1.0f - wt) + c1.y * wt,
                     c0.z * (1.0f - wt) + c1.z * wt,
                     c0.w * (1.0f - wt) + c1.w * wt);
}

}  // namespace sweep
