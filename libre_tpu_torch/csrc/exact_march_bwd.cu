// Recompute backward of the exact march (K3) over a set of f32 bricks, for
// Hopper (sm_90a): the density and transfer-function gradients of
// exact_march.cu's output for a cotangent g, with the early exit off or on.
//
// Replaces the TPU kernel libre_tpu/ops/exact_pallas.py::
// _make_exact_bwd_kernel (launched by _compiled_group_bwd from the custom VJP
// render_exact_diff).  The plain PyTorch specification is
// libre_tpu_torch/ops/raycast.py::march_exact_backward_reference; the wrapper
// is libre_tpu_torch/ops/exact.py::march_exact_backward.
//
// One thread per ray, in K3's 16x8 screen tiles.  Each thread walks the
// set's B bricks in their order, as K3 walks slots arange(B) of its pass
// (exact_march.cu), and re-marches each brick's samples front to back
// (exact_sample.cuh: the forward's sample set, taps and texel coordinates,
// rounded the same way) with its transmittance T and the inclusive prefix
// P = sum of w_j <g_rgb, rgb_j> in registers, carried across the bricks, and
// inverts the composite over the whole set with the total-minus-prefix
// identity (exact_pallas.py:1686-1708), TOT = <g_rgb, out_rgb> and
// T_fin = 1 - out_a from the forward's output (zero carry in):
//
//   dL/dalpha = T D - (TOT - P) / (1 - alpha) + g_a T_fin / (1 - alpha),
//
// then chains it through the opacity correction and the alpha-clamp gate,
// the TF lerp (into bins i0 and i1), the gates 0 < density < 1 and
// 0 < s_tf < 255, the data-range scale and the fetch's taps.  The gates are
// strict, as the JAX kernel's.  Each sample's gradient goes into its own
// brick's slice of d_volume: the ghost voxels of adjacent bricks are
// separate entries.
//
// K3 culls, per tile, the bricks no ray of the tile samples (its cone test);
// this kernel runs every brick's slab test instead, which takes the same
// samples in the same order, so the inversion's TOT - P holds.  A brick the
// ray misses, as the far-away pads of shard_bricks_front_to_back, takes no
// sample and gets no gradient.  A one-brick set runs its own instance
// (kSet = false, the loop's trip count fixed at 1): with the brick loop the
// one-brick kernel took 8-11 more registers and ran 7% slower on the exact
// trainer's view.
//
// The early exit (early_exit <= 1, the kExit instance): K3 stops after the
// sample at which its carried ca = ca + alpha (1 - ca) first exceeds
// early_exit, and marches no further brick.  This kernel carries ca across
// the bricks with K3's own expression and order (not 1 - T, which rounds
// differently at the boundary), so it walks exactly the samples K3
// composited and stops where K3 stopped.  The inversion holds over
// that truncated set, because out is its composite; the samples past the exit
// get no gradient, as jax.grad gives through the JAX marcher's mask.  With
// early_exit > 1 ca never exceeds it, and the kExit = false instance (the
// exact trainer's) carries no ca.
//
// The TPU kernel bucketed samples into volume slabs, bounded a c-window and
// transposed the gathers as one-hot matmuls because Mosaic has neither gather
// nor scatter (exact_pallas.py:1433-1440); none of that is carried over.
// Density gradients go straight to global memory with float atomics (8 taps
// trilinear, 1 nearest) into a d_volume the wrapper zeroes.  TF gradients go
// through tf_grad.cuh, as store_grid_bwd.cu's: a run per thread in
// registers, warp-aggregated flushes into the CTA's shared (T, 4) table,
// added to the global d_tf once per CTA (past kSharedTfMax entries, the
// flushes go to d_tf itself), so no second TF pass.  With
// diff_tf = 0 (the TF needs no gradient) the accumulator is skipped.
//
// What bounds it: per sample, the forward's 8 (1) dependent loads and 8 (1)
// global RED atomics into d_volume, and the serial per-ray loop (up to ~890
// samples at 512 samples per unit); the TF gradient adds a few percent on
// a training view; per brick, one slab test.
//
// Numerics: f32, IEEE division, powf, no FMA contraction (--fmad=false): the
// inversion subtracts the prefix from a total that the forward accumulated in
// another order, so both must see the same samples with the same values.
// The float atomics add in an order that changes from run to run.
//
// The TF's size T, a template choice as in exact_march.cu: a 256-entry TF
// runs the fixed instances (kTfFixed: static tables, T folded to 256, so
// that they keep their registers and time); any other T up to kSharedTfMax
// the shared instances (kTfShared), with T the launch operand n_tf and the
// float4 TF and (with diff_tf) its gradient table in dynamic shared memory
// sized to it; past it, with no limit but memory, the global instances
// (kTfGlobal): the TF read from global memory through L2,
// and tf_grad.cuh's runs and warp-aggregated flushes kept, each flush added
// straight into the global d_tf (one float atomic per bin, channel, warp and
// flush) in place of the block's shared table and its end-of-block pass.
// The gates and the TF slope read T: 0 < s < T - 1, and dd scales by T.

#include <cuda_runtime.h>

#include "exact_sample.cuh"
#include "tf_grad.cuh"

namespace {

using exact::kAlphaClamp;
using exact::kTfSize;
using exact::kTileX;
using exact::kTileY;

template <bool kTrilinear, bool kExit, bool kSet, int kTf>
__global__ void __launch_bounds__(kTileX* kTileY) exact_march_bwd_kernel(
    const float* __restrict__ bricks,    // (B, BZ, BY, BX)
    const float4* __restrict__ boxes,    // (B, 4) float4, raycast.BOX_FLOATS
    const float4* __restrict__ tf,       // (T,) rgba
    const float* __restrict__ rays,      // (8, R), raycast.PACK_ROWS
    const float4* __restrict__ out,      // (R,) forward output, zero carry in
    const float4* __restrict__ g,        // (R,) cotangent of out
    float* __restrict__ d_volume,        // (B, BZ, BY, BX), zeroed by the wrapper
    float* __restrict__ d_tf,            // (T, 4), zeroed by the wrapper
    int diff_tf, int n_bricks, int n_rays, int width, int bx, int by, int bz,
    int max_steps, float ex, float ey, float ez, float step, float mult,
    float add, float corr, float early_exit, int n_tf) {
  __shared__ float4 s_tf_fixed[kTf == exact::kTfFixed ? kTfSize : 1];
  __shared__ float s_dtf_fixed[kTf == exact::kTfFixed ? tfgrad::kTableFloats : 1];
  // The shared instances: the (n_tf,) float4 TF, then (with diff_tf) the
  // n_tf x 4 table.
  extern __shared__ float4 s_dyn[];
  const int n = exact::tf_size<kTf>(n_tf);
  // The nearest set instance with a shared TF holds T as floats from here:
  // converted per sample, as the other instances do, it spilled 16 bytes.
  constexpr bool kHoist = !kTrilinear && kSet && kTf == exact::kTfShared;
  const float n_f = (float)n, last_f = (float)(n - 1);
  float4* s_tf = kTf == exact::kTfShared ? s_dyn : s_tf_fixed;
  // The global instances read the TF and flush into d_tf themselves.
  const float4* tf_table = kTf == exact::kTfGlobal ? tf : s_tf;
  float* dtf_table = kTf == exact::kTfShared   ? reinterpret_cast<float*>(s_dyn + n_tf)
                     : kTf == exact::kTfGlobal ? d_tf
                                               : s_dtf_fixed;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  if (kTf != exact::kTfGlobal) {
    for (int i = tid; i < n; i += n_threads) s_tf[i] = tf[i];
    if (diff_tf) tfgrad::zero_table(dtf_table, tid, n_threads, n);
    __syncthreads();
  }
  tfgrad::Run run;

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int r = y * width + x;
  // K3 composites nothing from a zero carry when 0 > early_exit.
  if (x < width && r < n_rays && !(kExit && 0.0f > early_exit)) {
    const exact::Ray ray = exact::load_ray(rays, n_rays, r);
    const float4 gv = g[r], ov = out[r];
    const float tot = gv.x * ov.x + gv.y * ov.y + gv.z * ov.z;
    const float t_fin = 1.0f - ov.w;
    float trans = 1.0f, prefix = 0.0f;
    float ca = 0.0f;  // K3's carried alpha (kExit only)
    bool done = false;
    const size_t brick_voxels = (size_t)bx * by * bz;
    const int n_walk = kSet ? n_bricks : 1;
    for (int b = 0; b < n_walk && !done; ++b) {
      exact::Span span;
      if (!exact::brick_span(ray, __ldg(boxes + 4 * b), __ldg(boxes + 4 * b + 1), ex,
                             ey, ez, step, max_steps, &span))
        continue;
      const float4 s = __ldg(boxes + 4 * b + 2), o = __ldg(boxes + 4 * b + 3);
      const float* brick = bricks + (size_t)b * brick_voxels;
      float* d_brick = d_volume + (size_t)b * brick_voxels;
      exact::for_each_sample(span, ray.tng, step, [&](float t) {
        const exact::Taps k =
            exact::taps_at<kTrilinear>(ray, t, ex, ey, ez, s, o, bx, by, bz);
        const float dens =
            exact::normalise(exact::fetch<float, kTrilinear>(brick, k, bx, by),
                             mult, add);
        const exact::TfTaps q = exact::tf_taps(dens, n);
        const float4 c0 = exact::tf_entry<kTf>(tf_table, q.i0);
        const float4 c1 = exact::tf_entry<kTf>(tf_table, q.i1);
        const float4 c = sweep::lerp4(c0, c1, q.w);

        // Forward recompute, with K3's expression for alpha.
        const float a_cl = fminf(c.w, kAlphaClamp);
        const float alpha = 1.0f - powf(1.0f - a_cl, corr);
        const float w = alpha * trans;
        const float d = c.x * gv.x + c.y * gv.y + c.z * gv.z;
        prefix += w * d;  // inclusive

        // Composite -> opacity correction -> alpha clamp.
        const float one_m = fmaxf(1.0f - alpha, 1e-12f);
        const float dalpha =
            trans * d - (tot - prefix) / one_m + gv.w * t_fin / one_m;
        const float pw = powf(fmaxf(1.0f - a_cl, 1e-12f), corr - 1.0f);
        const float dav = (c.w < kAlphaClamp) ? dalpha * corr * pw : 0.0f;
        const float wr = w * gv.x, wg = w * gv.y, wb = w * gv.z;

        // TF lerp -> bins i0 (1 - w) and i1 (w).
        if (diff_tf) run.add(dtf_table, q.i0, q.w, wr, wg, wb, dav, n);

        // TF slope -> density gates -> data range -> the fetch's taps.
        if (dens > 0.0f && dens < 1.0f && q.s > 0.0f &&
            q.s < (kHoist ? last_f : (float)(n - 1))) {
          const float dd = (wr * (c1.x - c0.x) + wg * (c1.y - c0.y) +
                            wb * (c1.z - c0.z) + dav * (c1.w - c0.w)) *
                           (kHoist ? n_f : (float)n) * mult;
          if (!kTrilinear) {
            atomicAdd(d_brick + ((size_t)k.z.i0 * by + k.y.i0) * bx + k.x.i0, dd);
          } else {
#pragma unroll
            for (int dxb = 0; dxb < 2; ++dxb) {
#pragma unroll
              for (int dyb = 0; dyb < 2; ++dyb) {
#pragma unroll
                for (int dzb = 0; dzb < 2; ++dzb) {
                  const exact::Corner cn = exact::corner(k, dxb, dyb, dzb, bx, by);
                  atomicAdd(d_brick + cn.voxel, dd * cn.weight);
                }
              }
            }
          }
        }
        trans = trans * (1.0f - alpha);
        if (kExit) {
          ca = ca + alpha * (1.0f - ca);  // exact_march.cu's composite
          done = ca > early_exit;
        }
        return done;
      });
    }
  }
  if (diff_tf) {  // uniform over the block
    run.flush(dtf_table, n);  // the ray's last run, if any
    if (kTf != exact::kTfGlobal) {
      __syncthreads();
      tfgrad::add_table(dtf_table, d_tf, tid, n_threads, n);
    }
  }
}

template <bool kTrilinear, bool kExit, bool kSet, int kTf>
cudaError_t launch_instance(dim3 grid, dim3 block, cudaStream_t stream,
                            const float* bricks, const float4* boxes, const float4* tf,
                            const float* rays, const float4* out, const float4* g,
                            float* d_volume, float* d_tf, int diff_tf, int n_bricks,
                            int n_rays, int width, int bx, int by, int bz, int max_steps,
                            float ex, float ey, float ez, float step, float mult,
                            float add, float corr, float early_exit, int n_tf) {
  const auto kernel = exact_march_bwd_kernel<kTrilinear, kExit, kSet, kTf>;
  const int smem =
      kTf == exact::kTfShared ? n_tf * (int)sizeof(float4) * (diff_tf ? 2 : 1) : 0;
  if (kTf == exact::kTfShared) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, smem, stream>>>(bricks, boxes, tf, rays, out, g, d_volume, d_tf,
                                        diff_tf, n_bricks, n_rays, width, bx, by, bz,
                                        max_steps, ex, ey, ez, step, mult, add, corr,
                                        early_exit, n_tf);
  return cudaGetLastError();
}

}  // namespace

// n_tf: the TF's entries, at least 1.
extern "C" int exact_march_bwd(
    const void* bricks, const void* boxes, const void* tf, const void* rays,
    const void* out, const void* g, void* d_volume, void* d_tf,
    int trilinear, int diff_tf, int n_bricks, int n_rays, int width, int bx,
    int by, int bz, int max_steps, float ex, float ey, float ez, float step, float mult,
    float add, float corr, float early_exit, int n_tf, void* stream) {
  if (n_tf < 1) return (int)cudaErrorInvalidValue;
  const dim3 block(kTileX, kTileY);
  const int height = (n_rays + width - 1) / width;
  const dim3 grid((width + kTileX - 1) / kTileX, (height + kTileY - 1) / kTileY);
  const auto s = (cudaStream_t)stream;
#define EXACT_MARCH_BWD_ARGS                                                   \
  grid, block, s, (const float*)bricks, (const float4*)boxes, (const float4*)tf, \
      (const float*)rays, (const float4*)out, (const float4*)g,                \
      (float*)d_volume, (float*)d_tf, diff_tf, n_bricks, n_rays, width, bx,    \
      by, bz, max_steps, ex, ey, ez, step, mult, add, corr, early_exit, n_tf
  const bool exit = early_exit <= 1.0f;
  const int kind = exact::tf_kind(n_tf);
#define EXACT_MARCH_BWD(kTrilinear, kExit, kSet)                                          \
  (kind == exact::kTfFixed                                                                \
       ? launch_instance<kTrilinear, kExit, kSet, exact::kTfFixed>(EXACT_MARCH_BWD_ARGS)  \
   : kind == exact::kTfShared                                                             \
       ? launch_instance<kTrilinear, kExit, kSet, exact::kTfShared>(EXACT_MARCH_BWD_ARGS) \
       : launch_instance<kTrilinear, kExit, kSet, exact::kTfGlobal>(EXACT_MARCH_BWD_ARGS))
  cudaError_t err;
  if (n_bricks > 1) {
    if (trilinear && exit) err = EXACT_MARCH_BWD(true, true, true);
    else if (trilinear) err = EXACT_MARCH_BWD(true, false, true);
    else if (exit) err = EXACT_MARCH_BWD(false, true, true);
    else err = EXACT_MARCH_BWD(false, false, true);
  } else {
    if (trilinear && exit) err = EXACT_MARCH_BWD(true, true, false);
    else if (trilinear) err = EXACT_MARCH_BWD(true, false, false);
    else if (exit) err = EXACT_MARCH_BWD(false, true, false);
    else err = EXACT_MARCH_BWD(false, false, false);
  }
#undef EXACT_MARCH_BWD
#undef EXACT_MARCH_BWD_ARGS
  return (int)err;
}
