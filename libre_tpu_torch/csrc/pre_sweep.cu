// Dense pre-classified plane sweep over a slope-ray grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel libre_tpu/ops/shearwarp_pallas.py::_make_kernel
// (launched by _fused_call from _compiled_renderer and _compiled_frame).  The
// plain PyTorch specification is libre_tpu_torch/ops/shearwarp_dense.py::
// pre_sweep_reference.
//
// K1's program (post_sweep.cu) without its TF lookup, SENTINEL test and clip
// planes: one thread per slope ray (v, u), threadIdx.x along u, looping over
// the K virtual planes front to back with its (r, g, b, t) carry in registers.
// The classified stack is (Na, Nc, Nb) float4 RGBA, so each of a sample's 8
// taps (2 slices x 2x2 in-plane) is one 16-byte load straight from global
// memory / L2; the lerps run per channel in the reference's order (axis, then
// b, then c: sweep::rgba).  The TPU kernel resampled with one-hot
// interpolation matrices on its matrix unit and padded Nc, Nb to 128 lanes;
// neither is needed here.
//
// Skipping, all exact: a plane whose two slices hold no alpha (act = 0)
// composites as the identity; so does a sample outside the half-open b/c box
// (its RGBA is 0); and once 1 - t > early_exit the composite mask stays 0 for
// the rest of the ray, so the thread leaves its loop.  That replaces the TPU
// kernel's whole-grid saturation flag and hit mask.
//
// What bounds it: the stack reads, 8 x 16 bytes per sample with little reuse
// inside a thread (a slice pair is 8 MB at 512^2, inside the 50 MB L2), and the
// serial per-ray loop.  wgmma, TMA staging of slice tiles and a tile-per-block
// layout are left for later work.
//
// Numerics: f32 throughout, powf (not __powf), no fast-math and no FMA
// contraction (ops/_kernels.py builds with --fmad=false), so each sample
// rounds as the reference's does and the early-exit test follows it.

#include <cuda_runtime.h>

#include "sweep_sample.cuh"

namespace {

using sweep::kAlphaClamp;
using sweep::Taps;

__global__ void __launch_bounds__(256) pre_sweep_kernel(
    const float4* __restrict__ chans,  // (Na, Nc, Nb) rgba
    const int* __restrict__ a0,        // (K,)
    const int* __restrict__ a1,        // (K,)
    const float* __restrict__ wa,      // (K,)
    const float* __restrict__ dl,      // (K,) plane z - eye_a
    const int* __restrict__ act,       // (K,)
    const float* __restrict__ view,    // (8,) u0 du dv eb ec v0 eye_a 0
    const float* __restrict__ corr,    // (V, U)
    float* __restrict__ out,           // (V, U, 4)
    int k_planes, int nc, int nb, int v_size, int u_size, float wb0,
    float wb1, float wc0, float wc1, float sb_scale, float sc_scale,
    float early_exit) {
  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  if (u >= u_size || v >= v_size) return;

  const float u0 = view[0], du = view[1], dv = view[2];
  const float eb = view[3], ec = view[4], v0 = view[5];
  const float ug = u0 + du * (float)u;
  const float vg = v0 + dv * (float)v;
  const int ray = v * u_size + u;
  const float cexp = corr[ray];
  float r = 0.0f, g = 0.0f, b = 0.0f, t = 1.0f;
  const size_t plane = (size_t)nc * nb;

  for (int k = 0; k < k_planes; ++k) {
    if (1.0f - t > early_exit) break;  // composite mask is 0 from here on
    if (act[k] == 0) continue;
    const float delta = dl[k];
    const float xb = eb + ug * delta;
    const float xc = ec + vg * delta;
    if (!(xb >= wb0 && xb < wb1 && xc >= wc0 && xc < wc1)) continue;

    const Taps tb = sweep::taps((xb - wb0) * sb_scale - 0.5f, nb);
    const Taps tc = sweep::taps((xc - wc0) * sc_scale - 0.5f, nc);
    const float4 c = sweep::rgba(chans + (size_t)a0[k] * plane,
                                 chans + (size_t)a1[k] * plane, wa[k], tb, tc,
                                 nb);

    const float a_corr = 1.0f - powf(1.0f - fminf(c.w, kAlphaClamp), cexp);
    const float w = a_corr * t;
    r += w * c.x;
    g += w * c.y;
    b += w * c.z;
    t = t * (1.0f - a_corr);
  }
  out[4 * ray] = r;
  out[4 * ray + 1] = g;
  out[4 * ray + 2] = b;
  out[4 * ray + 3] = 1.0f - t;
}

}  // namespace

extern "C" int pre_sweep(const void* chans, const void* a0, const void* a1,
                         const void* wa, const void* dl, const void* act,
                         const void* view, const void* corr, void* out,
                         int k_planes, int nc, int nb, int v_size, int u_size,
                         float wb0, float wb1, float wc0, float wc1,
                         float sb_scale, float sc_scale, float early_exit,
                         void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((u_size + block.x - 1) / block.x,
                  (v_size + block.y - 1) / block.y);
  pre_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float4*)chans, (const int*)a0, (const int*)a1, (const float*)wa,
      (const float*)dl, (const int*)act, (const float*)view,
      (const float*)corr, (float*)out, k_planes, nc, nb, v_size, u_size, wb0,
      wb1, wc0, wc1, sb_scale, sc_scale, early_exit);
  return (int)cudaGetLastError();
}
