// Dense pre-classified plane sweep over a slope-ray grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel libre_tpu/ops/shearwarp_pallas.py::_make_kernel
// (launched by _fused_call from _compiled_renderer and _compiled_frame).  The
// plain PyTorch specification is libre_tpu_torch/ops/shearwarp_dense.py::
// pre_sweep_reference; shearwarp_bricked.py::tile_planes_reference is the
// specification of the plane lists.
//
// K1's program (post_sweep.cu) without its TF lookup, SENTINEL test and clip
// planes.  One CTA per 32x4 tile of slope rays (v, u), one thread per ray,
// threadIdx.x along u so that neighbouring threads read neighbouring b
// addresses.  Each thread composites front to back with its (r, g, b, t)
// carry in registers.  The classified stack is (Na, Nc, Nb) float4 RGBA, so
// each of a sample's 8 taps (2 slices x 2x2 in-plane) is one 16-byte load;
// the lerps run per channel in the reference's order (axis, then b, then c:
// sweep::rgba).  The TPU kernel resampled with one-hot interpolation
// matrices on its matrix unit and padded Nc, Nb to 128 lanes; neither is
// needed here.
//
// Plane list.  In a prologue the CTA lists, kPlaneChunk planes at a time,
// the planes its tile can sample at (sweep_list.cuh, K1's lists): act[k] != 0
// (a plane whose two slices hold no alpha composites as the identity) and
// the window overlapping the sample points of the tile's first and last
// rays.  Each thread then walks the list with no barrier, keeping the
// per-ray window test (a sample outside the half-open b/c box has RGBA 0)
// and leaving at its early exit: once 1 - t > early_exit the composite mask
// stays 0 for the rest of the ray.  A CTA whose rays have all exited lists
// no further chunk.  That replaces the TPU kernel's whole-grid saturation
// flag and hit mask.
//
// A carried slice was measured slower on the card and not kept (PERF.md
// section 6): each thread kept the 2x2 taps of the slice its next sample
// shares and took them from registers instead of loading them again.  It
// was exact and carried 28% of the taps on the orbit view, but its 91
// registers against 62 cost more occupancy than the loads it saved.
//
// What bounds it: the serial per-ray chain (taps, powf, composite) and its
// latency at the occupancy its registers allow, not bytes: a slice pair is
// 8 MB at 512^2, inside the 50 MB L2, and the resident CTAs walk the planes
// roughly together.
//
// Numerics: f32 throughout, powf (not __powf), no fast-math and no FMA
// contraction (ops/_kernels.py builds with --fmad=false), so each sample
// rounds as the reference's does and the early-exit test follows it: the
// output is bit for bit the reference's.
//
// The bf16 resample (kBf16, ShearWarpParams.compute_dtype = "bfloat16", the
// JAX kernel's compute_dtype): the sample is sweep::rgba_bf16, per channel
// each resample stage's operands rounded to bf16 and summed in f32, as the
// JAX kernel's two products (its stage-1 result rounded per channel,
// shearwarp_pallas.py:303-312); the composite is the f32 instance's.  Its
// plain version is pre_sweep_reference(compute_dtype="bfloat16").  A
// template instance of its own, so that the f32 instance (kBf16 = false)
// keeps its code, registers and time.

#include <cuda_runtime.h>

#include "sweep_list.cuh"
#include "sweep_sample.cuh"

namespace {

using sweep::kAlphaClamp;
using sweep::kPlaneChunk;
using sweep::kThreads;
using sweep::kTileU;
using sweep::kTileV;
using sweep::kWarps;
using sweep::Plane;
using sweep::Taps;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) pre_sweep_kernel(
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
  __shared__ Plane s_planes[kPlaneChunk];
  __shared__ int s_count[kWarps];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int u = blockIdx.x * kTileU + threadIdx.x;
  const int v = blockIdx.y * kTileV + threadIdx.y;
  const bool valid = u < u_size && v < v_size;
  const int ray = v * u_size + u;
  const float eb = view[3], ec = view[4];
  const float ug = view[0] + view[1] * (float)u;
  const float vg = view[5] + view[2] * (float)v;
  const float cexp = valid ? corr[ray] : 0.0f;
  float r = 0.0f, g = 0.0f, b = 0.0f, t = 1.0f;
  bool alive = valid;
  const size_t plane = (size_t)nc * nb;

  for (int k0 = 0; k0 < k_planes; k0 += kPlaneChunk) {
    // Prologue: list this chunk's planes the tile can sample at.  Its
    // barriers keep the last chunk's list until every thread is done
    // with it.
    if (!__syncthreads_or(alive)) break;
    const int n_list = sweep::list_planes(
        s_planes, s_count, act, a0, a1, wa, dl, view, k0,
        min(kPlaneChunk, k_planes - k0), u_size, v_size, wb0, wb1, wc0, wc1, tid);
    for (int j = 0; j < n_list && alive; ++j) {
      const Plane q = s_planes[j];
      const float xb = eb + ug * q.dl;
      const float xc = ec + vg * q.dl;
      if (!(xb >= wb0 && xb < wb1 && xc >= wc0 && xc < wc1)) continue;

      const Taps tb = sweep::taps((xb - wb0) * sb_scale - 0.5f, nb);
      const Taps tc = sweep::taps((xc - wc0) * sc_scale - 0.5f, nc);
      const sweep::Quad lo = sweep::quad(chans + (size_t)q.a0 * plane, tb, tc, nb);
      const sweep::Quad hi = sweep::quad(chans + (size_t)q.a1 * plane, tb, tc, nb);
      const float4 c = kBf16 ? sweep::rgba_bf16(lo, hi, q.wa, tb, tc)
                             : sweep::rgba(lo, hi, q.wa, tb, tc);

      const float a_corr = 1.0f - powf(1.0f - fminf(c.w, kAlphaClamp), cexp);
      const float w = a_corr * t;
      r += w * c.x;
      g += w * c.y;
      b += w * c.z;
      t = t * (1.0f - a_corr);
      alive = !(1.0f - t > early_exit);  // composite mask is 0 from here on
    }
  }
  if (valid) {
    out[4 * ray] = r;
    out[4 * ray + 1] = g;
    out[4 * ray + 2] = b;
    out[4 * ray + 3] = 1.0f - t;
  }
}

}  // namespace

extern "C" int pre_sweep(const void* chans, const void* a0, const void* a1,
                         const void* wa, const void* dl, const void* act,
                         const void* view, const void* corr, void* out,
                         int k_planes, int nc, int nb, int v_size, int u_size,
                         float wb0, float wb1, float wc0, float wc1,
                         float sb_scale, float sc_scale, float early_exit,
                         int bf16, void* stream) {
  const dim3 block(kTileU, kTileV);
  const dim3 grid((u_size + kTileU - 1) / kTileU, (v_size + kTileV - 1) / kTileV);
  const auto kernel = bf16 ? pre_sweep_kernel<true> : pre_sweep_kernel<false>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float4*)chans, (const int*)a0, (const int*)a1, (const float*)wa,
      (const float*)dl, (const int*)act, (const float*)view,
      (const float*)corr, (float*)out, k_planes, nc, nb, v_size, u_size, wb0,
      wb1, wc0, wc1, sb_scale, sc_scale, early_exit);
  return (int)cudaGetLastError();
}
