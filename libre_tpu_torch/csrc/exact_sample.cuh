// One brick's samples of the exact march, shared by the forward
// (exact_march.cu, K3) and its recompute backward (exact_march_bwd.cu, K4),
// so the backward visits exactly the samples the forward composited and
// rounds every position, tap and texel coordinate the same way: one sample
// more or fewer would break the backward's total-minus-prefix inversion,
// whose total comes from the forward's output.  The plain PyTorch
// specification is libre_tpu_torch/ops/raycast.py (_brick_samples, _taps,
// _fetch, _tf_taps).
#pragma once

#include <cuda_runtime.h>

#include "sweep_sample.cuh"

namespace exact {

using sweep::kAlphaClamp;
using sweep::kTfSize;

// Rays per block: a 16x8 screen tile, so that neighbouring rays fetch
// neighbouring voxels.
constexpr int kTileX = 16;
constexpr int kTileY = 8;

__device__ __forceinline__ int cell(float x, int dim) {
  return min(max((int)x, 0), dim - 1);
}

// The taps along one axis: raycast._taps.  Trilinear: i0, i1 = min(i0 + 1,
// dim - 1) and the weight w of i1; nearest: the voxel i0 (i1 = i0, w = 0).
struct Axis {
  int i0, i1;
  float w;
};

template <bool kTrilinear>
__device__ __forceinline__ Axis prep(float tex, int dim) {
  Axis a;
  if (!kTrilinear) {
    a.i0 = a.i1 = cell(floorf(tex * (float)dim), dim);
    a.w = 0.0f;
    return a;
  }
  const float s = fminf(fmaxf(tex * (float)dim - 0.5f, 0.0f), (float)dim - 1.0f);
  const float i0f = floorf(s);
  a.w = s - i0f;
  a.i0 = cell(i0f, dim);
  a.i1 = min(a.i0 + 1, dim - 1);
  return a;
}

struct Taps {
  Axis x, y, z;
};

// Corner (dxb, dyb, dzb) of the trilinear cell: its voxel and its weight
// (wx * wy) * wz.
struct Corner {
  size_t voxel;
  float weight;
};

__device__ __forceinline__ Corner corner(const Taps& k, int dxb, int dyb, int dzb,
                                         int bx, int by) {
  const int ix = dxb ? k.x.i1 : k.x.i0;
  const int iy = dyb ? k.y.i1 : k.y.i0;
  const int iz = dzb ? k.z.i1 : k.z.i0;
  Corner c;
  c.voxel = ((size_t)iz * by + iy) * bx + ix;
  c.weight = (dxb ? k.x.w : 1.0f - k.x.w) * (dyb ? k.y.w : 1.0f - k.y.w) *
             (dzb ? k.z.w : 1.0f - k.z.w);
  return c;
}

// The raw value at the taps, in raycast._fetch's order (corners x outer,
// z inner, summed left to right).
template <typename T, bool kTrilinear>
__device__ __forceinline__ float fetch(const T* __restrict__ brick, const Taps& k,
                                       int bx, int by) {
  if (!kTrilinear) return (float)brick[((size_t)k.z.i0 * by + k.y.i0) * bx + k.x.i0];
  float out = 0.0f;
#pragma unroll
  for (int dxb = 0; dxb < 2; ++dxb) {
#pragma unroll
    for (int dyb = 0; dyb < 2; ++dyb) {
#pragma unroll
      for (int dzb = 0; dzb < 2; ++dzb) {
        const Corner c = corner(k, dxb, dyb, dzb, bx, by);
        const float v = (float)brick[c.voxel] * c.weight;
        out = (dxb | dyb | dzb) ? out + v : v;
      }
    }
  }
  return out;
}

// Per-ray constants: one column of raycast.ray_pack (PACK_ROWS), and the
// reciprocal direction of ops/rays.intersect_box (zero components nudged to
// 1e-10).
struct Ray {
  float dx, dy, dz, tnp, tng, t_lo, t_hi, inv_x, inv_y, inv_z;
  int n_start;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int n_rays,
                                        int r) {
  Ray ray;
  ray.dx = rays[r];
  ray.dy = rays[n_rays + r];
  ray.dz = rays[2 * n_rays + r];
  ray.tnp = rays[3 * n_rays + r];
  ray.tng = rays[4 * n_rays + r];
  ray.n_start = (int)rays[5 * n_rays + r];
  ray.t_lo = rays[6 * n_rays + r];
  ray.t_hi = rays[7 * n_rays + r];
  ray.inv_x = 1.0f / (ray.dx == 0.0f ? 1e-10f : ray.dx);
  ray.inv_y = 1.0f / (ray.dy == 0.0f ? 1e-10f : ray.dy);
  ray.inv_z = 1.0f / (ray.dz == 0.0f ? 1e-10f : ray.dz);
  return ray;
}

// One brick's part of a ray: the grid samples n in [first, end) whose
// t_n = tn_global + n * step lies in (lo, hi].
struct Span {
  float lo, hi;
  int first, end;
};

// Slab test of the brick box (p.xyz, (p.w, q.x, q.y)) (ops/rays.
// intersect_box) intersected with the ray's clip interval; n starts at a
// lower bound on the first member, floor((max(lo, t_near_plane) -
// tn_global) / step) - 1, and at n_start.  False when no sample can lie in
// (lo, hi].
__device__ __forceinline__ bool brick_span(const Ray& ray, float4 p, float4 q,
                                           float ex, float ey, float ez,
                                           float step, int max_steps,
                                           Span* span) {
  float tb = ray.inv_x * (p.x - ex), tt = ray.inv_x * (p.w - ex);
  float t0 = fminf(tt, tb), t1 = fmaxf(tt, tb);
  tb = ray.inv_y * (p.y - ey);
  tt = ray.inv_y * (q.x - ey);
  t0 = fmaxf(t0, fminf(tt, tb));
  t1 = fminf(t1, fmaxf(tt, tb));
  tb = ray.inv_z * (p.z - ez);
  tt = ray.inv_z * (q.y - ez);
  t0 = fmaxf(t0, fminf(tt, tb));
  t1 = fminf(t1, fmaxf(tt, tb));
  span->lo = fmaxf(t0, ray.t_lo);
  span->hi = fminf(t1, ray.t_hi);
  if (!(span->lo < span->hi)) return false;
  const int n0 = (int)floorf((fmaxf(span->lo, ray.tnp) - ray.tng) / step) - 1;
  span->first = max(n0, ray.n_start);
  span->end = n0 + max_steps;
  return true;
}

// Calls visit(t) for each sample of the span, front to back, until visit
// returns true.  t is monotone in n, so the walk stops at the first t > hi.
template <typename F>
__device__ __forceinline__ void for_each_sample(const Span& span, float tng,
                                                float step, F&& visit) {
  for (int n = span.first; n < span.end; ++n) {
    const float t = tng + (float)n * step;
    if (t > span.hi) break;
    if (!(t > span.lo)) continue;
    if (visit(t)) break;
  }
}

// The taps of the sample at t: tex = (eye + dir * t) * s + o, with the
// brick's map s = (s.x, s.y, s.z), o = (s.w, o.x, o.y) (raycast.brick_boxes).
template <bool kTrilinear>
__device__ __forceinline__ Taps taps_at(const Ray& ray, float t, float ex,
                                        float ey, float ez, float4 s, float4 o,
                                        int bx, int by, int bz) {
  const float tx = (ex + ray.dx * t) * s.x + s.w;
  const float ty = (ey + ray.dy * t) * s.y + o.x;
  const float tz = (ez + ray.dz * t) * s.z + o.y;
  Taps k;
  k.x = prep<kTrilinear>(tx, bx);
  k.y = prep<kTrilinear>(ty, by);
  k.z = prep<kTrilinear>(tz, bz);
  return k;
}

// The data-range normalisation, clamped to [0, 1].
__device__ __forceinline__ float normalise(float raw, float mult, float add) {
  return fminf(fmaxf(raw * mult + add, 0.0f), 1.0f);
}

// The transfer function's two texels and lerp weight at a density
// (raycast._tf_taps): s in [0, 255], i0 = floor(s), i1 = min(i0 + 1, 255).
struct TfTaps {
  float s, w;
  int i0, i1;
};

__device__ __forceinline__ TfTaps tf_taps(float dens) {
  TfTaps k;
  k.s = sweep::tf_coord(dens);
  const float i0f = floorf(k.s);
  k.w = k.s - i0f;
  k.i0 = (int)i0f;
  k.i1 = min(k.i0 + 1, kTfSize - 1);
  return k;
}

}  // namespace exact
