// Exact per-ray march of one pass of bricks, for Hopper (sm_90a).
//
// Replaces the TPU kernel libre_tpu/ops/exact_pallas.py::_make_exact_kernel
// (launched by _compiled_group from render_exact_rays and the engine's
// _march_pass_pallas).  The plain PyTorch specification is
// libre_tpu_torch/ops/raycast.py::march_exact_reference, and
// tile_bricks_reference beside it that of the brick lists; the wrapper is
// libre_tpu_torch/ops/exact.py::march_exact.
//
// One CTA per 16x8 screen tile of rays, one thread per ray, so that
// neighbouring rays fetch neighbouring voxels.
//
// Brick lists.  All rays start at the eye (ex, ey, ez), a kernel uniform.
// In a prologue the tile's rays reduce their unit directions to a cone: its
// axis (their normalised sum) and its half-angle (the largest angle to the
// axis, plus kConeAngleMargin).  Then, kBrickChunk bricks of the pass at a
// time, the CTA's threads test each brick's bounding sphere, grown by
// kConeRadiusMargin of its radius, against the cone: a sphere that holds
// the eye always passes; any other passes iff the angle between the axis
// and its centre is at most the cone's half-angle plus the angle the
// sphere subtends.  A sample at t > 0 of a ray in the cone that lies in the
// brick lies in the sphere, so the survivors are a superset of the bricks
// any ray of the tile samples; the margins cover the f32 rounding of the
// slab test and of the test itself.  The survivors are written in the
// pass's front-to-back order (compact.cuh) to a list in
// shared memory, then marched; shared memory does not grow with n_bricks.
// Once every ray of the tile is done, the CTA culls and marches no further
// chunk.
//
// Per listed brick each thread runs what it always ran: the slab test of
// ops/rays.intersect_box (zero direction components nudged to 1e-10), the
// brick's interval (lo, hi] = (max(t0, t_lo), min(t1, t_hi)], then the
// global sample grid t_n = tn_global + n*step from
// n0 = floor((max(lo, t_near_plane) - tn_global) / step) - 1 (a lower bound:
// membership is tested per sample), n >= n_start, stopping at the first
// t_n > hi since t is monotone in n.  Each member sample fetches the brick in
// place from its atlas slot (native dtype: f32, uint8 or uint16; the cast to
// f32 is exact) at tex = (eye + dir*t)*s + o, nearest or trilinear,
// normalises by the data range, looks the (T, 4) transfer function up (in
// shared memory up to kSharedTfMax entries, past it in global memory),
// applies the opacity correction 1 - (1 - min(a, 1-1/256))^corr
// with powf and composites front to back.  A sample is skipped iff the
// accumulated alpha before it exceeds early_exit; from then on nothing
// changes, so the thread leaves both loops.  That is exact.  A brick left
// off the list is one no ray of the tile takes a sample of, so the rays
// composite the same samples in the same order as over every brick.
//
// The TPU kernel bucketed samples into volume slabs, bounded a c-window and
// composited chunks in closed form because Mosaic has no arbitrary gather
// (exact_pallas.py:1-39).  A GPU thread gathers directly, so none of that is
// carried over: one kernel serves every ray direction, with no tiers and no
// fallback path for oblique rays.
//
// What bounds it: per sample, 1 (nearest) or 8 (trilinear) dependent loads
// from the brick, which neighbouring rays mostly share through L1/L2, and the
// serial compositing chain.  The lists take the slab tests of the bricks
// no ray of a tile samples out of every ray's loop.
//
// Numerics: f32 throughout, IEEE division, powf (not __powf), no fast-math and
// no FMA contraction (ops/_kernels.py builds with --fmad=false): the per-ray
// constants come from the wrapper, computed with the plain version's ops, and
// every sample position, texture coordinate and voxel index rounds as the
// plain version's, so nearest-filter fetches on voxel boundaries agree.  The
// sample set, taps and texel coordinates come from exact_sample.cuh, shared
// with the recompute backward (exact_march_bwd.cu).
//
// The TF's size T, a template choice (exact_sample.cuh's kinds).  A 256-entry
// TF (every caller of the engine, the trainers' default) runs the fixed
// instances (kTfFixed): a static 256-entry table and T folded to the
// constant, so that this path keeps its registers and time (PERF.md section
// 6).  Any other T up to kSharedTfMax runs the shared instances (kTfShared):
// T is the launch operand n_tf and the table lies in dynamic shared memory
// sized to it.  Past that, with no limit but memory, the global instances
// (kTfGlobal) read the float4 TF from global memory through L2 only
// (exact_sample.cuh::tf_entry; a 65 536-entry TF is 1 MB of the 50 MB).  In
// every kind the TF coordinate is clip(d, 0, 1) T - 0.5 clamped to
// [0, T - 1], i1 = min(i0 + 1, T - 1), as the JAX marcher's
// (raycast.py:107-112).

#include <cuda_runtime.h>

#include <cstdint>

#include "compact.cuh"
#include "exact_sample.cuh"

namespace {

using exact::kTileX;
using exact::kTileY;
using exact::kAlphaClamp;
using exact::kTfSize;
constexpr int kThreads = kTileX * kTileY;
constexpr int kWarps = kThreads / 32;
// Bricks culled into one list before they are marched.
constexpr int kBrickChunk = 1024;
// The cone test's margins (raycast.CONE_RADIUS_MARGIN, CONE_ANGLE_MARGIN).
constexpr float kConeRadiusMargin = 1e-3f;
constexpr float kConeAngleMargin = 1e-5f;
constexpr float kPi = 3.14159265358979f;

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// The angle between the unit axis a and the vector w: atan2(|a x w|, a.w),
// accurate at small angles too.
__device__ __forceinline__ float angle_to(float ax, float ay, float az, float wx,
                                          float wy, float wz) {
  const float kx = ay * wz - az * wy, ky = az * wx - ax * wz, kz = ax * wy - ay * wx;
  return atan2f(sqrtf(kx * kx + ky * ky + kz * kz), ax * wx + ay * wy + az * wz);
}

// Whether the brick box (p.xyz, (p.w, q.x, q.y)) may hold a sample of a ray
// from the eye inside the cone (axis a, half-angle theta): its bounding
// sphere, grown by kConeRadiusMargin, holds the eye or meets the cone.
__device__ __forceinline__ bool in_cone(float4 p, float4 q, float ex, float ey,
                                        float ez, float ax, float ay, float az,
                                        float theta) {
  const float hx = 0.5f * (p.w - p.x), hy = 0.5f * (q.x - p.y), hz = 0.5f * (q.y - p.z);
  const float wx = 0.5f * (p.x + p.w) - ex;
  const float wy = 0.5f * (p.y + q.x) - ey;
  const float wz = 0.5f * (p.z + q.y) - ez;
  const float rad = sqrtf(hx * hx + hy * hy + hz * hz) * (1.0f + kConeRadiusMargin);
  const float d = sqrtf(wx * wx + wy * wy + wz * wz);
  if (!(d > rad)) return true;
  return !(angle_to(ax, ay, az, wx, wy, wz) > theta + asinf(rad / d));
}

// The kernels' operands.
#define EXACT_MARCH_PARAMS                                                            \
  const T *__restrict__ atlas,      /* (n_slots, BZ, BY, BX) */                       \
      const int *__restrict__ slots,    /* (B,) */                                     \
      const float4 *__restrict__ boxes, /* (B, 4) float4, raycast.BOX_FLOATS */        \
      const float4 *__restrict__ tf,    /* (T,) rgba */                                \
      const float *__restrict__ rays,   /* (8, R), raycast.PACK_ROWS */                \
      const float4 *__restrict__ carry, /* (R,) rgba in */                             \
      float4 *__restrict__ out,         /* (R,) rgba out */                            \
      int *__restrict__ samples,        /* (R,) or null: += samples composited */      \
      int *__restrict__ used, /* (B,) or null: 1 if the brick composited any */        \
      int n_bricks, int n_rays, int width, int bx, int by, int bz, int max_steps,      \
      float ex, float ey, float ez, float step, float mult, float add, float corr,     \
      float early_exit, int n_tf
#define EXACT_MARCH_OPERANDS                                                         \
  atlas, slots, boxes, tf, rays, carry, out, samples, used, n_bricks, n_rays, width, \
      bx, by, bz, max_steps, ex, ey, ez, step, mult, add, corr, early_exit, n_tf

template <typename T, bool kTrilinear, int kTf>
__device__ __forceinline__ void exact_march_body(EXACT_MARCH_PARAMS) {
  __shared__ float4 s_tf_fixed[kTf == exact::kTfFixed ? kTfSize : 1];
  extern __shared__ float4 s_tf_dyn[];  // (n_tf,) in the shared instances
  float4* s_tf = kTf == exact::kTfShared ? s_tf_dyn : s_tf_fixed;
  // The table the samples read: the global instances read the TF itself.
  const float4* tf_table = kTf == exact::kTfGlobal ? tf : s_tf;
  const int n = exact::tf_size<kTf>(n_tf);
  __shared__ int s_list[kBrickChunk];
  __shared__ float s_red[kWarps][4];
  __shared__ int s_count[kWarps];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  if (kTf != exact::kTfGlobal)
    for (int i = tid; i < n; i += kThreads) s_tf[i] = tf[i];

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int r = y * width + x;
  const bool valid = x < width && r < n_rays;
  exact::Ray ray = {};
  float cr = 0.0f, cg = 0.0f, cb = 0.0f, ca = 0.0f;
  int count = 0;
  bool done = true;
  // This ray's unit direction; a zero or non-finite one widens the cone to
  // every direction.
  float ux = 0.0f, uy = 0.0f, uz = 0.0f;
  bool any_dir = false;
  if (valid) {
    ray = exact::load_ray(rays, n_rays, r);
    const float4 c_in = carry[r];
    cr = c_in.x, cg = c_in.y, cb = c_in.z, ca = c_in.w;
    done = ca > early_exit;
    const float norm = sqrtf(ray.dx * ray.dx + ray.dy * ray.dy + ray.dz * ray.dz);
    if (norm > 0.0f && norm < 3e38f) {
      ux = ray.dx / norm;
      uy = ray.dy / norm;
      uz = ray.dz / norm;
    } else {
      any_dir = true;
    }
  }

  // The tile's cone: axis = the normalised sum of its unit directions,
  // half-angle = the largest angle to the axis.
  const float sx = warp_sum(ux), sy = warp_sum(uy), sz = warp_sum(uz);
  if (lane == 0) {
    s_red[warp][0] = sx;
    s_red[warp][1] = sy;
    s_red[warp][2] = sz;
  }
  any_dir = __syncthreads_or(any_dir);
  float ax = 0.0f, ay = 0.0f, az = 0.0f;
  for (int w = 0; w < kWarps; ++w) {
    ax += s_red[w][0];
    ay += s_red[w][1];
    az += s_red[w][2];
  }
  const float an = sqrtf(ax * ax + ay * ay + az * az);
  ax /= an, ay /= an, az /= an;
  const float mine = valid ? angle_to(ax, ay, az, ux, uy, uz) : 0.0f;
  const float warp_theta = warp_max(mine);
  if (lane == 0) s_red[warp][3] = warp_theta;
  __syncthreads();
  float theta = 0.0f;
  for (int w = 0; w < kWarps; ++w) theta = fmaxf(theta, s_red[w][3]);
  if (any_dir || !(an > 0.0f) || !(theta <= kPi)) theta = kPi;
  theta += kConeAngleMargin;

  const size_t brick_voxels = (size_t)bx * by * bz;
  for (int chunk = 0; chunk < n_bricks; chunk += kBrickChunk) {
    // Every thread is done with the last chunk's list here.
    if (!__syncthreads_or(!done)) break;
    const int chunk_end = min(chunk + kBrickChunk, n_bricks);
    int n_list = 0;
    for (int base = chunk; base < chunk_end; base += kThreads) {
      const int b = base + tid;
      const bool keep = b < chunk_end && in_cone(__ldg(boxes + 4 * b),
                                                 __ldg(boxes + 4 * b + 1), ex, ey,
                                                 ez, ax, ay, az, theta);
      compact::append<kWarps>(keep, tid, s_count, n_list,
                              [&](int pos) { s_list[pos] = b; });
    }

    for (int i = 0; i < n_list && !done; ++i) {
      const int b = s_list[i];
      exact::Span span;
      if (!exact::brick_span(ray, __ldg(boxes + 4 * b), __ldg(boxes + 4 * b + 1), ex,
                             ey, ez, step, max_steps, &span))
        continue;
      const float4 s = __ldg(boxes + 4 * b + 2), o = __ldg(boxes + 4 * b + 3);
      const T* brick = atlas + (size_t)__ldg(slots + b) * brick_voxels;
      int brick_count = 0;
      exact::for_each_sample(span, ray.tng, step, [&](float t) {
        const exact::Taps k =
            exact::taps_at<kTrilinear>(ray, t, ex, ey, ez, s, o, bx, by, bz);
        const float raw = exact::fetch<T, kTrilinear>(brick, k, bx, by);
        const exact::TfTaps q = exact::tf_taps(exact::normalise(raw, mult, add), n);
        const float4 src = sweep::lerp4(exact::tf_entry<kTf>(tf_table, q.i0),
                                        exact::tf_entry<kTf>(tf_table, q.i1), q.w);
        const float alpha = 1.0f - powf(1.0f - fminf(src.w, kAlphaClamp), corr);
        const float w = alpha * (1.0f - ca);
        cr = cr + src.x * w;
        cg = cg + src.y * w;
        cb = cb + src.z * w;
        ca = ca + w;
        ++brick_count;
        done = ca > early_exit;
        return done;
      });
      count += brick_count;
      if (used != nullptr && brick_count > 0) used[b] = 1;
    }
  }
  if (!valid) return;
  out[r] = make_float4(cr, cg, cb, ca);
  if (samples != nullptr) samples[r] += count;
}

// The fixed and shared instances.
template <typename T, bool kTrilinear, int kTf>
__global__ void __launch_bounds__(kThreads) exact_march_kernel(EXACT_MARCH_PARAMS) {
  exact_march_body<T, kTrilinear, kTf>(EXACT_MARCH_OPERANDS);
}

// The global instances, with a floor of one block an SM in their launch
// bounds: without it ptxas holds the uint8 and uint16 trilinear instances to
// 72 registers, for occupancy, and spills 12 and 28 bytes; with it they take
// 84-86 and spill nothing (PERF.md section 6 has both builds' times).
template <typename T, bool kTrilinear>
__global__ void __launch_bounds__(kThreads, 1) exact_march_global_kernel(EXACT_MARCH_PARAMS) {
  exact_march_body<T, kTrilinear, exact::kTfGlobal>(EXACT_MARCH_OPERANDS);
}

#undef EXACT_MARCH_OPERANDS
#undef EXACT_MARCH_PARAMS

// The kernel of an instance; only the kind asked for is instantiated.
template <typename T, bool kTrilinear, int kTf>
auto kernel_of() {
  if constexpr (kTf == exact::kTfGlobal) {
    return exact_march_global_kernel<T, kTrilinear>;
  } else {
    return exact_march_kernel<T, kTrilinear, kTf>;
  }
}

template <typename T, bool kTrilinear, int kTf>
cudaError_t launch_instance(const void* atlas, dim3 grid, dim3 block,
                            cudaStream_t stream, const int* slots,
                            const float4* boxes, const float4* tf,
                            const float* rays, const float4* carry, float4* out,
                            int* samples, int* used, int n_bricks, int n_rays,
                            int width, int bx, int by, int bz, int max_steps,
                            float ex, float ey, float ez, float step, float mult,
                            float add, float corr, float early_exit, int n_tf) {
  const auto kernel = kernel_of<T, kTrilinear, kTf>();
  const int smem = kTf == exact::kTfShared ? n_tf * (int)sizeof(float4) : 0;
  if (kTf == exact::kTfShared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, smem, stream>>>(
      (const T*)atlas, slots, boxes, tf, rays, carry, out, samples, used,
      n_bricks, n_rays, width, bx, by, bz, max_steps, ex, ey, ez, step, mult,
      add, corr, early_exit, n_tf);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const void* atlas, int trilinear, dim3 grid, dim3 block,
                         cudaStream_t stream, const int* slots,
                         const float4* boxes, const float4* tf,
                         const float* rays, const float4* carry, float4* out,
                         int* samples, int* used, int n_bricks, int n_rays,
                         int width, int bx, int by, int bz, int max_steps,
                         float ex, float ey, float ez, float step, float mult,
                         float add, float corr, float early_exit, int n_tf) {
#define EXACT_MARCH_INSTANCE(kTrilinear, kTf)                                       \
  launch_instance<T, kTrilinear, kTf>(atlas, grid, block, stream, slots, boxes, tf,    \
                                      rays, carry, out, samples, used, n_bricks,       \
                                      n_rays, width, bx, by, bz, max_steps, ex, ey, ez, \
                                      step, mult, add, corr, early_exit, n_tf)
#define EXACT_MARCH_KINDS(kTrilinear)                                              \
  (kind == exact::kTfFixed    ? EXACT_MARCH_INSTANCE(kTrilinear, exact::kTfFixed)  \
   : kind == exact::kTfShared ? EXACT_MARCH_INSTANCE(kTrilinear, exact::kTfShared) \
                              : EXACT_MARCH_INSTANCE(kTrilinear, exact::kTfGlobal))
  const int kind = exact::tf_kind(n_tf);
  const cudaError_t err = trilinear ? EXACT_MARCH_KINDS(true) : EXACT_MARCH_KINDS(false);
#undef EXACT_MARCH_KINDS
#undef EXACT_MARCH_INSTANCE
  return err;
}

}  // namespace

// dtype: 0 float32, 1 uint8, 2 uint16 (ops/exact.py::ATLAS_DTYPES); n_tf:
// the TF's entries, at least 1.
extern "C" int exact_march(
    const void* atlas, const void* slots, const void* boxes, const void* tf,
    const void* rays, const void* carry, void* out, void* samples, void* used,
    int dtype, int trilinear, int n_bricks, int n_rays, int width, int bx,
    int by, int bz, int max_steps, float ex, float ey, float ez, float step,
    float mult, float add, float corr, float early_exit, int n_tf, void* stream) {
  if (n_tf < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(kTileX, kTileY);
  const int height = (n_rays + width - 1) / width;
  const dim3 grid((width + kTileX - 1) / kTileX, (height + kTileY - 1) / kTileY);
  const auto s = (cudaStream_t)stream;
#define EXACT_MARCH_ARGS                                                     \
  atlas, trilinear, grid, block, s, (const int*)slots, (const float4*)boxes, \
      (const float4*)tf, (const float*)rays, (const float4*)carry,           \
      (float4*)out, (int*)samples, (int*)used, n_bricks, n_rays, width, bx,  \
      by, bz, max_steps, ex, ey, ez, step, mult, add, corr, early_exit, n_tf
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
