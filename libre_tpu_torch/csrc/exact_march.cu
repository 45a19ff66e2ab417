// Exact per-ray march of one pass of bricks, for Hopper (sm_90a).
//
// Replaces the TPU kernel libre_tpu/ops/exact_pallas.py::_make_exact_kernel
// (launched by _compiled_group from render_exact_rays and the engine's
// _march_pass_pallas).  The plain PyTorch specification is
// libre_tpu_torch/ops/raycast.py::march_exact_reference; the wrapper is
// libre_tpu_torch/ops/exact.py::march_exact.
//
// One thread per ray, in 16x8 screen tiles so that neighbouring rays fetch
// neighbouring voxels.  Each thread walks the pass's bricks in the engine's
// front-to-back order with its (r, g, b, a) carry in registers.  Per brick:
// the slab test of ops/rays.intersect_box (zero direction components nudged
// to 1e-10), the brick's interval (lo, hi] = (max(t0, t_lo), min(t1, t_hi)],
// then the global sample grid t_n = tn_global + n*step from
// n0 = floor((max(lo, t_near_plane) - tn_global) / step) - 1 (a lower bound:
// membership is tested per sample), n >= n_start, stopping at the first
// t_n > hi since t is monotone in n.  Each member sample fetches the brick in
// place from its atlas slot (native dtype: f32, uint8 or uint16; the cast to
// f32 is exact) at tex = (eye + dir*t)*s + o, nearest or trilinear,
// normalises by the data range, looks the 256x4 transfer function up in
// shared memory, applies the opacity correction 1 - (1 - min(a, 1-1/256))^corr
// with powf and composites front to back.  A sample is skipped iff the
// accumulated alpha before it exceeds early_exit; from then on nothing
// changes, so the thread leaves both loops.  That is exact.
//
// The TPU kernel bucketed samples into volume slabs, bounded a c-window and
// composited chunks in closed form because Mosaic has no arbitrary gather
// (exact_pallas.py:1-39).  A GPU thread gathers directly, so none of that is
// carried over: one kernel serves every ray direction, with no tiers and no
// fallback path for oblique rays.
//
// What bounds it: per sample, 1 (nearest) or 8 (trilinear) dependent loads
// from the brick, which neighbouring rays mostly share through L1/L2, and the
// serial compositing chain.  Known extra cost: every ray slab-tests every
// brick of the pass (4096 per ray on a 512^3 volume at screen-space error 1),
// a loop of box loads that all threads of a warp share; culling bricks per
// screen tile is later work.
//
// Numerics: f32 throughout, IEEE division, powf (not __powf), no fast-math and
// no FMA contraction (ops/_kernels.py builds with --fmad=false): the per-ray
// constants come from the wrapper, computed with the plain version's ops, and
// every sample position, texture coordinate and voxel index rounds as the
// plain version's, so nearest-filter fetches on voxel boundaries agree.

#include <cuda_runtime.h>

#include <cstdint>

#include "sweep_sample.cuh"

namespace {

using sweep::kAlphaClamp;
using sweep::kTfSize;

constexpr int kTileX = 16;
constexpr int kTileY = 8;

__device__ __forceinline__ int cell(float x, int dim) {
  return min(max((int)x, 0), dim - 1);
}

// Trilinear taps along one axis: raycast._fetch_trilinear's prep.
struct Axis {
  int i0, i1;
  float w;
};

__device__ __forceinline__ Axis prep(float tex, int dim) {
  const float s = fminf(fmaxf(tex * (float)dim - 0.5f, 0.0f), (float)dim - 1.0f);
  const float i0f = floorf(s);
  Axis a;
  a.w = s - i0f;
  a.i0 = cell(i0f, dim);
  a.i1 = min(a.i0 + 1, dim - 1);
  return a;
}

template <typename T, bool kTrilinear>
__device__ __forceinline__ float fetch(const T* __restrict__ brick, float tx,
                                       float ty, float tz, int bx, int by,
                                       int bz) {
  if (!kTrilinear) {
    const int ix = cell(floorf(tx * (float)bx), bx);
    const int iy = cell(floorf(ty * (float)by), by);
    const int iz = cell(floorf(tz * (float)bz), bz);
    return (float)brick[((size_t)iz * by + iy) * bx + ix];
  }
  const Axis ax = prep(tx, bx), ay = prep(ty, by), az = prep(tz, bz);
  // The corners in raycast._fetch_trilinear's order (x outer, z inner), each
  // weighted (wx * wy) * wz, summed left to right.
  float out = 0.0f;
#pragma unroll
  for (int dxb = 0; dxb < 2; ++dxb) {
#pragma unroll
    for (int dyb = 0; dyb < 2; ++dyb) {
#pragma unroll
      for (int dzb = 0; dzb < 2; ++dzb) {
        const int ix = dxb ? ax.i1 : ax.i0;
        const int iy = dyb ? ay.i1 : ay.i0;
        const int iz = dzb ? az.i1 : az.i0;
        const float wgt = (dxb ? ax.w : 1.0f - ax.w) *
                          (dyb ? ay.w : 1.0f - ay.w) *
                          (dzb ? az.w : 1.0f - az.w);
        const float v = (float)brick[((size_t)iz * by + iy) * bx + ix];
        out = (dxb | dyb | dzb) ? out + v * wgt : v * wgt;
      }
    }
  }
  return out;
}

template <typename T, bool kTrilinear>
__global__ void __launch_bounds__(kTileX* kTileY) exact_march_kernel(
    const T* __restrict__ atlas,        // (n_slots, BZ, BY, BX)
    const int* __restrict__ slots,      // (B,)
    const float4* __restrict__ boxes,   // (B, 4) float4, raycast.BOX_FLOATS
    const float4* __restrict__ tf,      // (256,) rgba
    const float* __restrict__ rays,     // (8, R), raycast.PACK_ROWS
    const float4* __restrict__ carry,   // (R,) rgba in
    float4* __restrict__ out,           // (R,) rgba out
    int* __restrict__ samples,          // (R,) or null: += samples composited
    int* __restrict__ used,             // (B,) or null: 1 if the brick composited any
    int n_bricks, int n_rays, int width, int bx, int by, int bz, int max_steps,
    float ex, float ey, float ez, float step, float mult, float add, float corr,
    float early_exit) {
  __shared__ float4 s_tf[kTfSize];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < kTfSize; i += blockDim.x * blockDim.y) s_tf[i] = tf[i];
  __syncthreads();

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= width) return;
  const int r = y * width + x;
  if (r >= n_rays) return;

  const float dx = rays[r], dy = rays[n_rays + r], dz = rays[2 * n_rays + r];
  const float tnp = rays[3 * n_rays + r], tng = rays[4 * n_rays + r];
  const int n_start = (int)rays[5 * n_rays + r];
  const float t_lo = rays[6 * n_rays + r], t_hi = rays[7 * n_rays + r];
  const float inv_x = 1.0f / (dx == 0.0f ? 1e-10f : dx);
  const float inv_y = 1.0f / (dy == 0.0f ? 1e-10f : dy);
  const float inv_z = 1.0f / (dz == 0.0f ? 1e-10f : dz);
  const size_t brick_voxels = (size_t)bx * by * bz;

  const float4 c_in = carry[r];
  float cr = c_in.x, cg = c_in.y, cb = c_in.z, ca = c_in.w;
  int count = 0;
  bool done = ca > early_exit;

  for (int b = 0; b < n_bricks && !done; ++b) {
    // Slab test (ops/rays.intersect_box): box = (p.xyz, (p.w, q.x, q.y)).
    const float4 p = __ldg(boxes + 4 * b), q = __ldg(boxes + 4 * b + 1);
    float tb = inv_x * (p.x - ex), tt = inv_x * (p.w - ex);
    float t0 = fminf(tt, tb), t1 = fmaxf(tt, tb);
    tb = inv_y * (p.y - ey);
    tt = inv_y * (q.x - ey);
    t0 = fmaxf(t0, fminf(tt, tb));
    t1 = fminf(t1, fmaxf(tt, tb));
    tb = inv_z * (p.z - ez);
    tt = inv_z * (q.y - ez);
    t0 = fmaxf(t0, fminf(tt, tb));
    t1 = fminf(t1, fmaxf(tt, tb));
    const float lo = fmaxf(t0, t_lo), hi = fminf(t1, t_hi);
    if (!(lo < hi)) continue;  // no sample can lie in (lo, hi]

    const float4 s = __ldg(boxes + 4 * b + 2), o = __ldg(boxes + 4 * b + 3);
    const T* brick = atlas + (size_t)__ldg(slots + b) * brick_voxels;
    const int n0 = (int)floorf((fmaxf(lo, tnp) - tng) / step) - 1;
    const int n_end = n0 + max_steps;
    int brick_count = 0;
    for (int n = max(n0, n_start); n < n_end; ++n) {
      const float t = tng + (float)n * step;
      if (t > hi) break;
      if (!(t > lo)) continue;
      const float tx = (ex + dx * t) * s.x + s.w;
      const float ty = (ey + dy * t) * s.y + o.x;
      const float tz = (ez + dz * t) * s.z + o.y;
      const float raw = fetch<T, kTrilinear>(brick, tx, ty, tz, bx, by, bz);
      const float dens = fminf(fmaxf(raw * mult + add, 0.0f), 1.0f);
      const float sc = sweep::tf_coord(dens);
      const float i0f = floorf(sc);
      const int i0 = (int)i0f;
      const float4 src = sweep::lerp4(s_tf[i0], s_tf[min(i0 + 1, kTfSize - 1)],
                                      sc - i0f);
      const float alpha = 1.0f - powf(1.0f - fminf(src.w, kAlphaClamp), corr);
      const float w = alpha * (1.0f - ca);
      cr = cr + src.x * w;
      cg = cg + src.y * w;
      cb = cb + src.z * w;
      ca = ca + w;
      ++brick_count;
      if (ca > early_exit) {
        done = true;
        break;
      }
    }
    count += brick_count;
    if (used != nullptr && brick_count > 0) used[b] = 1;
  }
  out[r] = make_float4(cr, cg, cb, ca);
  if (samples != nullptr) samples[r] += count;
}

template <typename T>
cudaError_t launch_typed(const void* atlas, int trilinear, dim3 grid, dim3 block,
                         cudaStream_t stream, const int* slots,
                         const float4* boxes, const float4* tf,
                         const float* rays, const float4* carry, float4* out,
                         int* samples, int* used, int n_bricks, int n_rays,
                         int width, int bx, int by, int bz, int max_steps,
                         float ex, float ey, float ez, float step, float mult,
                         float add, float corr, float early_exit) {
  if (trilinear)
    exact_march_kernel<T, true><<<grid, block, 0, stream>>>(
        (const T*)atlas, slots, boxes, tf, rays, carry, out, samples, used,
        n_bricks, n_rays, width, bx, by, bz, max_steps, ex, ey, ez, step, mult,
        add, corr, early_exit);
  else
    exact_march_kernel<T, false><<<grid, block, 0, stream>>>(
        (const T*)atlas, slots, boxes, tf, rays, carry, out, samples, used,
        n_bricks, n_rays, width, bx, by, bz, max_steps, ex, ey, ez, step, mult,
        add, corr, early_exit);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 uint8, 2 uint16 (ops/exact.py::ATLAS_DTYPES).
extern "C" int exact_march(
    const void* atlas, const void* slots, const void* boxes, const void* tf,
    const void* rays, const void* carry, void* out, void* samples, void* used,
    int dtype, int trilinear, int n_bricks, int n_rays, int width, int bx,
    int by, int bz, int max_steps, float ex, float ey, float ez, float step,
    float mult, float add, float corr, float early_exit, void* stream) {
  const dim3 block(kTileX, kTileY);
  const int height = (n_rays + width - 1) / width;
  const dim3 grid((width + kTileX - 1) / kTileX, (height + kTileY - 1) / kTileY);
  const auto s = (cudaStream_t)stream;
#define EXACT_MARCH_ARGS                                                     \
  atlas, trilinear, grid, block, s, (const int*)slots, (const float4*)boxes, \
      (const float4*)tf, (const float*)rays, (const float4*)carry,           \
      (float4*)out, (int*)samples, (int*)used, n_bricks, n_rays, width, bx,  \
      by, bz, max_steps, ex, ey, ez, step, mult, add, corr, early_exit
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_typed<float>(EXACT_MARCH_ARGS); break;
    case 1: err = launch_typed<uint8_t>(EXACT_MARCH_ARGS); break;
    case 2: err = launch_typed<uint16_t>(EXACT_MARCH_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef EXACT_MARCH_ARGS
  return (int)err;
}
