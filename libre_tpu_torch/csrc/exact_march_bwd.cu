// Recompute backward of the exact march (K3) over one f32 brick, early exit
// off, for Hopper (sm_90a): the density and transfer-function gradients of
// exact_march.cu's output for a cotangent g.
//
// Replaces the TPU kernel libre_tpu/ops/exact_pallas.py::
// _make_exact_bwd_kernel (launched by _compiled_group_bwd from the custom VJP
// render_exact_diff).  The plain PyTorch specification is
// libre_tpu_torch/ops/raycast.py::march_exact_backward_reference; the wrapper
// is libre_tpu_torch/ops/exact.py::march_exact_backward.
//
// One thread per ray, in K3's 16x8 screen tiles.  Each thread re-marches its
// ray's samples front to back (exact_sample.cuh: the forward's sample set,
// taps and texel coordinates, rounded the same way) with its transmittance T
// and the inclusive prefix P = sum of w_j <g_rgb, rgb_j> in registers, and
// inverts the front-to-back composite with the total-minus-prefix identity
// (exact_pallas.py:1686-1708), TOT = <g_rgb, out_rgb> and T_fin = 1 - out_a
// from the forward's output (zero carry in):
//
//   dL/dalpha = T D - (TOT - P) / (1 - alpha) + g_a T_fin / (1 - alpha),
//
// then chains it through the opacity correction and the alpha-clamp gate,
// the TF lerp (into bins i0 and i1), the gates 0 < density < 1 and
// 0 < s_tf < 255, the data-range scale and the fetch's taps.  The gates are
// strict, as the JAX kernel's.
//
// The TPU kernel bucketed samples into volume slabs, bounded a c-window and
// transposed the gathers as one-hot matmuls because Mosaic has neither gather
// nor scatter (exact_pallas.py:1433-1440); none of that is carried over.
// Density gradients go straight to global memory with float atomics (8 taps
// trilinear, 1 nearest) into a d_volume the wrapper zeroes.  TF gradients go
// through tf_grad.cuh, as store_grid_bwd.cu's: a run per thread in
// registers, warp-aggregated flushes into the CTA's shared 256x4 table,
// added to the global d_tf once per CTA, so no second TF pass.  With
// diff_tf = 0 (the TF needs no gradient) the accumulator is skipped.
//
// What bounds it: per sample, the forward's 8 (1) dependent loads and 8 (1)
// global RED atomics into d_volume, and the serial per-ray loop (up to ~890
// samples at 512 samples per unit); the TF gradient adds a few percent on
// a training view.
//
// Numerics: f32, IEEE division, powf, no FMA contraction (--fmad=false): the
// inversion subtracts the prefix from a total that the forward accumulated in
// another order, so both must see the same samples with the same values.
// The float atomics add in an order that changes from run to run.

#include <cuda_runtime.h>

#include "exact_sample.cuh"
#include "tf_grad.cuh"

namespace {

using exact::kAlphaClamp;
using exact::kTfSize;
using exact::kTileX;
using exact::kTileY;

template <bool kTrilinear>
__global__ void __launch_bounds__(kTileX* kTileY) exact_march_bwd_kernel(
    const float* __restrict__ brick,     // (BZ, BY, BX)
    const float4* __restrict__ boxes,    // (1, 4) float4, raycast.BOX_FLOATS
    const float4* __restrict__ tf,       // (256,) rgba
    const float* __restrict__ rays,      // (8, R), raycast.PACK_ROWS
    const float4* __restrict__ out,      // (R,) forward output, zero carry in
    const float4* __restrict__ g,        // (R,) cotangent of out
    float* __restrict__ d_volume,        // (BZ, BY, BX), zeroed by the wrapper
    float* __restrict__ d_tf,            // (256, 4), zeroed by the wrapper
    int diff_tf, int n_rays, int width, int bx, int by, int bz, int max_steps,
    float ex, float ey, float ez, float step, float mult, float add,
    float corr) {
  __shared__ float4 s_tf[kTfSize];
  __shared__ float s_dtf[tfgrad::kTableFloats];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid; i < kTfSize; i += n_threads) s_tf[i] = tf[i];
  if (diff_tf) tfgrad::zero_table(s_dtf, tid, n_threads);
  __syncthreads();
  tfgrad::Run run;

  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int r = y * width + x;
  exact::Span span;
  if (x < width && r < n_rays) {
    const exact::Ray ray = exact::load_ray(rays, n_rays, r);
    if (exact::brick_span(ray, __ldg(boxes), __ldg(boxes + 1), ex, ey, ez, step,
                          max_steps, &span)) {
      const float4 s = __ldg(boxes + 2), o = __ldg(boxes + 3);
      const float4 gv = g[r], ov = out[r];
      const float tot = gv.x * ov.x + gv.y * ov.y + gv.z * ov.z;
      const float t_fin = 1.0f - ov.w;
      float trans = 1.0f, prefix = 0.0f;
      exact::for_each_sample(span, ray.tng, step, [&](float t) {
        const exact::Taps k =
            exact::taps_at<kTrilinear>(ray, t, ex, ey, ez, s, o, bx, by, bz);
        const float dens =
            exact::normalise(exact::fetch<float, kTrilinear>(brick, k, bx, by),
                             mult, add);
        const exact::TfTaps q = exact::tf_taps(dens);
        const float4 c0 = s_tf[q.i0], c1 = s_tf[q.i1];
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
        if (diff_tf) run.add(s_dtf, q.i0, q.w, wr, wg, wb, dav);

        // TF slope -> density gates -> data range -> the fetch's taps.
        if (dens > 0.0f && dens < 1.0f && q.s > 0.0f && q.s < (float)(kTfSize - 1)) {
          const float dd = (wr * (c1.x - c0.x) + wg * (c1.y - c0.y) +
                            wb * (c1.z - c0.z) + dav * (c1.w - c0.w)) *
                           (float)kTfSize * mult;
          if (!kTrilinear) {
            atomicAdd(d_volume + ((size_t)k.z.i0 * by + k.y.i0) * bx + k.x.i0, dd);
          } else {
#pragma unroll
            for (int dxb = 0; dxb < 2; ++dxb) {
#pragma unroll
              for (int dyb = 0; dyb < 2; ++dyb) {
#pragma unroll
                for (int dzb = 0; dzb < 2; ++dzb) {
                  const exact::Corner cn = exact::corner(k, dxb, dyb, dzb, bx, by);
                  atomicAdd(d_volume + cn.voxel, dd * cn.weight);
                }
              }
            }
          }
        }
        trans = trans * (1.0f - alpha);
        return false;
      });
    }
  }
  if (diff_tf) {  // uniform over the block
    run.flush(s_dtf);  // the ray's last run, if any
    __syncthreads();
    tfgrad::add_table(s_dtf, d_tf, tid, n_threads);
  }
}

}  // namespace

extern "C" int exact_march_bwd(
    const void* brick, const void* boxes, const void* tf, const void* rays,
    const void* out, const void* g, void* d_volume, void* d_tf,
    int trilinear, int diff_tf, int n_rays, int width, int bx, int by, int bz,
    int max_steps, float ex, float ey, float ez, float step, float mult,
    float add, float corr, void* stream) {
  const dim3 block(kTileX, kTileY);
  const int height = (n_rays + width - 1) / width;
  const dim3 grid((width + kTileX - 1) / kTileX, (height + kTileY - 1) / kTileY);
  const auto s = (cudaStream_t)stream;
#define EXACT_MARCH_BWD_ARGS                                                   \
  (const float*)brick, (const float4*)boxes, (const float4*)tf,                \
      (const float*)rays, (const float4*)out, (const float4*)g,                \
      (float*)d_volume, (float*)d_tf, diff_tf, n_rays, width, bx, by, bz,      \
      max_steps, ex, ey, ez, step, mult, add, corr
  if (trilinear)
    exact_march_bwd_kernel<true><<<grid, block, 0, s>>>(EXACT_MARCH_BWD_ARGS);
  else
    exact_march_bwd_kernel<false><<<grid, block, 0, s>>>(EXACT_MARCH_BWD_ARGS);
#undef EXACT_MARCH_BWD_ARGS
  return (int)cudaGetLastError();
}
