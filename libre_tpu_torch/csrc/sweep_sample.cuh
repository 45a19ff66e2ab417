// One plane sample of the post-classification sweep, shared by the forward
// sweep (post_sweep.cu) and its recompute backward (store_grid_bwd.cu), so the
// backward recomputes exactly the samples the forward composited.  The plain
// PyTorch specification is libre_tpu_torch/ops/shearwarp_bricked.py::
// post_sweep_reference.  rgba() is the pre-classified sample of the dense
// sweep (pre_sweep.cu).  density_bf16() and rgba_bf16() are the same samples
// with the JAX kernels' compute_dtype="bfloat16" resample (the kBf16
// instances of post_sweep.cu and pre_sweep.cu).
#pragma once

#include <cuda_bf16.h>
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

// The texel coordinate of a density in an n-entry transfer function: the
// clamped density scaled to [-0.5, n - 0.5], clamped to [0, n - 1].
// i0 = floor(s), the lerp weight is s - i0 and the upper texel
// min(i0 + 1, n - 1).  K1, K2 and K5 read n = 256; K3 and K4 any n.
__device__ __forceinline__ float tf_coord(float dens, int n = kTfSize) {
  const float s = fminf(fmaxf(dens, 0.0f), 1.0f) * (float)n - 0.5f;
  return fminf(fmaxf(s, 0.0f), (float)(n - 1));
}

__device__ __forceinline__ float4 lerp4(float4 c0, float4 c1, float wt) {
  return make_float4(c0.x * (1.0f - wt) + c1.x * wt,
                     c0.y * (1.0f - wt) + c1.y * wt,
                     c0.z * (1.0f - wt) + c1.z * wt,
                     c0.w * (1.0f - wt) + c1.w * wt);
}

// The 2x2 in-plane float4 taps of one (Nc, Nb) RGBA slice at a sample:
// rows tc.i0, tc.i1 x columns tb.i0, tb.i1.
struct Quad {
  float4 v00, v01, v10, v11;
};

__device__ __forceinline__ Quad quad(const float4* __restrict__ s, Taps tb, Taps tc,
                                     int nb) {
  const size_t r0 = (size_t)tc.i0 * nb, r1 = (size_t)tc.i1 * nb;
  return Quad{s[r0 + tb.i0], s[r0 + tb.i1], s[r1 + tb.i0], s[r1 + tb.i1]};
}

// Pre-classified RGBA at one sample from the taps of slices lo (weight
// 1 - w_a) and hi (weight w_a): per channel, density()'s order (axis lerp at
// each 2x2 tap, then along b, then along c).  The dense sweep (pre_sweep.cu)
// uses it; its plain PyTorch specification is libre_tpu_torch/ops/
// shearwarp_dense.py::pre_sweep_reference.  K5 loads each slice's four taps
// together (quad), then lerps: with the two slices' loads interleaved per
// tap it took 64 registers against 62 and ran slower (PERF.md section 6).
__device__ __forceinline__ float4 rgba(const Quad& lo, const Quad& hi, float w_a, Taps tb,
                                       Taps tc) {
  const float4 v00 = lerp4(lo.v00, hi.v00, w_a);
  const float4 v01 = lerp4(lo.v01, hi.v01, w_a);
  const float4 v10 = lerp4(lo.v10, hi.v10, w_a);
  const float4 v11 = lerp4(lo.v11, hi.v11, w_a);
  return lerp4(lerp4(v00, v01, tb.w), lerp4(v10, v11, tb.w), tc.w);
}

// ---- the bf16 resample (ShearWarpParams.compute_dtype = "bfloat16").
// Each of the JAX kernels' two resample products (shearwarp_bricked.py:
// 180-211, shearwarp_pallas.py:281-312) rounds both of its operands to
// bf16, round to nearest even, and sums in f32: stage 1 the axis-lerped
// slice and the b-interpolation matrix, stage 2 the stage-1 result and the
// c-matrix.  A product of two bf16 values is exact in f32, so each stage is
// one rounded f32 add of its two taps, as here.

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Weights {
  float w0, w1;
};

// The taps' weights as the interpolation matrix holds them (shearwarp_pallas.
// _interp_matrix), each rounded to bf16: (1 - w) and w one by one (they need
// not sum to 1 after rounding); at the clamped edge, where i0 = i1, the one
// entry (1 - w) + w on tap i0.
__device__ __forceinline__ Weights bf16_weights(Taps t) {
  Weights k;
  if (t.i0 == t.i1) {
    k.w0 = bf16_round((1.0f - t.w) + t.w);
    k.w1 = 0.0f;
  } else {
    k.w0 = bf16_round(1.0f - t.w);
    k.w1 = bf16_round(t.w);
  }
  return k;
}

// density() with the bf16 resample: the axis lerp in f32 at each 2x2 tap,
// rounded; along b with the rounded weights, rounded; along c.
__device__ __forceinline__ float density_bf16(const float* lo, const float* hi,
                                              float w_a, Taps tb, Taps tc, int nb) {
  const size_t r0 = (size_t)tc.i0 * nb, r1 = (size_t)tc.i1 * nb;
  const float v00 = bf16_round(lo[r0 + tb.i0] * (1.0f - w_a) + hi[r0 + tb.i0] * w_a);
  const float v01 = bf16_round(lo[r0 + tb.i1] * (1.0f - w_a) + hi[r0 + tb.i1] * w_a);
  const float v10 = bf16_round(lo[r1 + tb.i0] * (1.0f - w_a) + hi[r1 + tb.i0] * w_a);
  const float v11 = bf16_round(lo[r1 + tb.i1] * (1.0f - w_a) + hi[r1 + tb.i1] * w_a);
  const Weights wb = bf16_weights(tb), wc = bf16_weights(tc);
  const float s_c0 = bf16_round(v00 * wb.w0 + v01 * wb.w1);
  const float s_c1 = bf16_round(v10 * wb.w0 + v11 * wb.w1);
  return s_c0 * wc.w0 + s_c1 * wc.w1;
}

__device__ __forceinline__ float4 round4(float4 v) {
  return make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z), bf16_round(v.w));
}

__device__ __forceinline__ float4 mix4(float4 c0, float4 c1, Weights k) {
  return make_float4(c0.x * k.w0 + c1.x * k.w1, c0.y * k.w0 + c1.y * k.w1,
                     c0.z * k.w0 + c1.z * k.w1, c0.w * k.w0 + c1.w * k.w1);
}

// rgba() with the bf16 resample, per channel as density_bf16().
__device__ __forceinline__ float4 rgba_bf16(const Quad& lo, const Quad& hi, float w_a,
                                            Taps tb, Taps tc) {
  const float4 v00 = round4(lerp4(lo.v00, hi.v00, w_a));
  const float4 v01 = round4(lerp4(lo.v01, hi.v01, w_a));
  const float4 v10 = round4(lerp4(lo.v10, hi.v10, w_a));
  const float4 v11 = round4(lerp4(lo.v11, hi.v11, w_a));
  const Weights wb = bf16_weights(tb), wc = bf16_weights(tc);
  return mix4(round4(mix4(v00, v01, wb)), round4(mix4(v10, v11, wb)), wc);
}

}  // namespace sweep
