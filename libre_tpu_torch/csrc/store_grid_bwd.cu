// Recompute backward of the post-classification plane sweep, for Hopper
// (sm_90a): the density-store and transfer-function gradients of
// post_sweep.cu for a cotangent g on the (V, U, 4) slope grid.
//
// Replaces the TPU kernel libre_tpu/ops/shearwarp_grad.py::_make_bwd_kernel
// (launched by _compiled_bwd_pallas) together with the TF-gradient scatter
// that runs after it outside the kernel (_tf_scatter).  The plain PyTorch
// specification is libre_tpu_torch/ops/shearwarp_grad.py::
// store_grid_backward_reference.
//
// Layout as in post_sweep.cu: one thread per slope ray (v, u), block (32, 8),
// threadIdx.x along u.  Each thread walks the K planes front to back once with
// its transmittance t, the inclusive prefix P = sum of w_j <g_rgb, rgb_j>, its
// cotangent, TOT = <g_rgb, out_rgb - rgb_in> and the forward's final
// transmittance in registers, and inverts the front-to-back composite with the
// total-minus-prefix identity (shearwarp_grad.py:587-604):
//
//   dL/da_eff = t D - (TOT - P) / (1 - a_eff) + g_a t_fin / (1 - a_eff),
//
// so one sweep suffices (the forward already gives TOT).  Each sample is
// recomputed with the forward's own taps, lerp order and opacity-correction
// expression (sweep_sample.cuh), so the early-exit mask and t follow the
// forward launch; (1 - a_cl)^(corr - 1) serves only the derivative.  Masked
// samples (outside the box, SENTINEL, inactive plane) get no gradient and
// are skipped; once the early exit fires the thread leaves its loop (exact).
//
// Density gradient: each sample's ddens goes to the 8 store voxels it read,
// weighted (1-wa | wa) x (1-wb | wb) x (1-wc | wc), with global float atomics
// into a d_store the wrapper zeroes.  This replaces the TPU's slice-resident
// d0/d1 output blocks and their coverage masks.  TF gradient: drgba =
// (w g_r, w g_g, w g_b, da) split (1 - wt) to bin i0 and wt to bin i1, through
// tf_grad.cuh (shared with exact_march_bwd.cu): a run per thread in
// registers, flushed when i0 changes and at the ray's end, warp-aggregated
// flushes into the CTA's shared 256x4 table, added to the global dtf once
// per CTA.  That drops the TPU kernel's (K, V, U) per-plane w / da outputs
// (512 MiB each at 512^2 x 512), the second recompute pass and the rank-16
// one-hot scatter.  With diff_tf = 0 the accumulator is skipped.
//
// What bounds it: 8 global RED atomics into d_store per sample on top of the
// forward's 8 store loads, and the serial per-ray loop; the TF gradient
// adds ~10% on a training view, more where the bin moves every sample.
// Tile-local d_store accumulation in shared memory is left for later.
//
// Numerics: f32, powf, no fast-math, no FMA contraction (--fmad=false, as
// post_sweep.cu): the gradient jumps where a sample crosses a TF texel whose
// slope changes, the alpha clamp or the [0, 1] clamp, so the recompute must
// round as the forward and the plain version do.  The float atomics add in
// an order that changes from run to run, so d_store and dtf are
// nondeterministic in their last bits.

#include <cuda_runtime.h>

#include "sweep_sample.cuh"
#include "tf_grad.cuh"

namespace {

using sweep::kAlphaClamp;
using sweep::kTfSize;
using sweep::Taps;

__global__ void __launch_bounds__(256) store_grid_bwd_kernel(
    const float* __restrict__ store,   // (Na, Nc, Nb)
    const float4* __restrict__ tf,     // (256,) rgba
    const int* __restrict__ a0,        // (K,)
    const int* __restrict__ a1,        // (K,)
    const float* __restrict__ wa,      // (K,)
    const float* __restrict__ dl,      // (K,) plane z - eye_a
    const int* __restrict__ act,       // (K,)
    const float* __restrict__ view,    // (8,) u0 du dv eb ec v0 eye_a 0
    const float* __restrict__ corr,    // (V, U)
    const float* __restrict__ rgb_in,  // (V, U, 4) forward carry-in
    const float* __restrict__ t_in,    // (V, U)
    const float* __restrict__ out,     // (V, U, 4) forward output
    const float* __restrict__ t_out,   // (V, U) forward final transmittance
    const float* __restrict__ g,       // (V, U, 4) cotangent of out
    float* __restrict__ d_store,       // (Na, Nc, Nb) zeroed by the wrapper
    float* __restrict__ dtf,           // (256, 4) zeroed by the wrapper
    int k_planes, int nc, int nb, int v_size, int u_size, float wb0, float wb1,
    float wc0, float wc1, float sb_scale, float sc_scale, float early_exit,
    int diff_tf) {
  __shared__ float4 s_tf[kTfSize];
  __shared__ float s_dtf[tfgrad::kTableFloats];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid; i < kTfSize; i += n_threads) s_tf[i] = tf[i];
  if (diff_tf) tfgrad::zero_table(s_dtf, tid, n_threads);
  __syncthreads();
  tfgrad::Run run;

  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  if (u < u_size && v < v_size) {
    const float u0 = view[0], du = view[1], dv = view[2];
    const float eb = view[3], ec = view[4], v0 = view[5];
    const float ug = u0 + du * (float)u;
    const float vg = v0 + dv * (float)v;
    const int ray = v * u_size + u;
    const float cexp = corr[ray];
    const float gr = g[4 * ray], gg = g[4 * ray + 1], gb = g[4 * ray + 2];
    const float ga = g[4 * ray + 3];
    const float tot = gr * (out[4 * ray] - rgb_in[4 * ray]) +
                      gg * (out[4 * ray + 1] - rgb_in[4 * ray + 1]) +
                      gb * (out[4 * ray + 2] - rgb_in[4 * ray + 2]);
    const float t_fin = t_out[ray];
    float t = t_in[ray];
    float p = 0.0f;
    const size_t plane = (size_t)nc * nb;

    for (int k = 0; k < k_planes; ++k) {
      if (1.0f - t > early_exit) break;  // m = 0 for the rest of the ray
      if (act[k] == 0) continue;
      const float delta = dl[k];
      const float xb = eb + ug * delta;
      const float xc = ec + vg * delta;
      if (!(xb >= wb0 && xb < wb1 && xc >= wc0 && xc < wc1)) continue;

      const Taps tb = sweep::taps((xb - wb0) * sb_scale - 0.5f, nb);
      const Taps tc = sweep::taps((xc - wc0) * sc_scale - 0.5f, nc);
      const float w_a = wa[k];
      const size_t lo = (size_t)a0[k] * plane, hi = (size_t)a1[k] * plane;
      const float dens =
          sweep::density(store + lo, store + hi, w_a, tb, tc, nb);
      if (!(dens > -0.5f)) continue;  // masked: no gradient

      const float s = sweep::tf_coord(dens);
      const float i0f = floorf(s);
      const float wt = s - i0f;
      const int i0 = (int)i0f;
      const int i1 = min(i0 + 1, kTfSize - 1);
      const float4 c0 = s_tf[i0], c1 = s_tf[i1];
      const float4 c = sweep::lerp4(c0, c1, wt);

      // Forward recompute, with the forward's expression for a_corr.
      const float a_cl = fminf(c.w, kAlphaClamp);
      const float a_corr = 1.0f - powf(1.0f - a_cl, cexp);
      const float w = a_corr * t;
      const float d = c.x * gr + c.y * gg + c.z * gb;
      p += w * d;  // inclusive prefix

      // Chain: composite -> opacity correction -> alpha clamp -> TF slope.
      const float one_m = fmaxf(1.0f - a_corr, 1e-12f);
      const float da_eff = t * d - (tot - p) / one_m + ga * t_fin / one_m;
      const float q = powf(fmaxf(1.0f - a_cl, 1e-12f), cexp - 1.0f);
      const float dav = (c.w < kAlphaClamp) ? da_eff * cexp * q : 0.0f;
      const float wr = w * gr, wg = w * gg, wb = w * gb;
      const bool slope = dens > 0.0f && dens < 1.0f && s > 0.0f &&
                         s < (float)(kTfSize - 1);
      if (slope) {
        const float dd = (wr * (c1.x - c0.x) + wg * (c1.y - c0.y) +
                          wb * (c1.z - c0.z) + dav * (c1.w - c0.w)) *
                         (float)kTfSize;
        const float e0 = dd * (1.0f - tc.w), e1 = dd * tc.w;
        const float e00 = e0 * (1.0f - tb.w), e01 = e0 * tb.w;
        const float e10 = e1 * (1.0f - tb.w), e11 = e1 * tb.w;
        const size_t r0 = (size_t)tc.i0 * nb, r1 = (size_t)tc.i1 * nb;
        const float wl = 1.0f - w_a;
        atomicAdd(d_store + lo + r0 + tb.i0, e00 * wl);
        atomicAdd(d_store + hi + r0 + tb.i0, e00 * w_a);
        atomicAdd(d_store + lo + r0 + tb.i1, e01 * wl);
        atomicAdd(d_store + hi + r0 + tb.i1, e01 * w_a);
        atomicAdd(d_store + lo + r1 + tb.i0, e10 * wl);
        atomicAdd(d_store + hi + r1 + tb.i0, e10 * w_a);
        atomicAdd(d_store + lo + r1 + tb.i1, e11 * wl);
        atomicAdd(d_store + hi + r1 + tb.i1, e11 * w_a);
      }
      if (diff_tf) run.add(s_dtf, i0, wt, wr, wg, wb, dav);
      t = t * (1.0f - a_corr);
    }
  }
  if (diff_tf) {  // uniform over the block
    run.flush(s_dtf);  // the ray's last run, if any
    __syncthreads();
    tfgrad::add_table(s_dtf, dtf, tid, n_threads);
  }
}

}  // namespace

extern "C" int store_grid_bwd(
    const void* store, const void* tf, const void* a0, const void* a1,
    const void* wa, const void* dl, const void* act, const void* view,
    const void* corr, const void* rgb_in, const void* t_in, const void* out,
    const void* t_out, const void* g, void* d_store, void* dtf, int k_planes,
    int nc, int nb, int v_size, int u_size, int diff_tf, float wb0, float wb1,
    float wc0, float wc1, float sb_scale, float sc_scale, float early_exit,
    void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((u_size + block.x - 1) / block.x,
                  (v_size + block.y - 1) / block.y);
  store_grid_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)store, (const float4*)tf, (const int*)a0, (const int*)a1,
      (const float*)wa, (const float*)dl, (const int*)act, (const float*)view,
      (const float*)corr, (const float*)rgb_in, (const float*)t_in,
      (const float*)out, (const float*)t_out, (const float*)g,
      (float*)d_store, (float*)dtf, k_planes, nc, nb, v_size, u_size, wb0, wb1,
      wc0, wc1, sb_scale, sc_scale, early_exit, diff_tf);
  return (int)cudaGetLastError();
}
