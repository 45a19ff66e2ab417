// Post-classification plane sweep over a slope-ray grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel libre_tpu/ops/shearwarp_bricked.py::_make_post_kernel
// (launched by _post_call from _compiled_store_frame).  The plain PyTorch
// specification is libre_tpu_torch/ops/shearwarp_bricked.py::post_sweep_reference;
// tile_planes_reference beside it is the specification of the plane lists.
//
// One CTA per 32x4 tile of slope rays (v, u), one thread per ray, threadIdx.x
// along u so that neighbouring threads read neighbouring b addresses of the
// store.  Each thread composites front to back with its (r, g, b, t) carry in
// registers: the TPU's sequential grid axis becomes each thread's walk over
// its tile's list of planes.  Per plane the density is fetched as 2 slices
// x 2x2 taps of the unpadded (Na, Nc, Nb) f32 store (the TPU kernel built
// one-hot interpolation matrices for its matrix unit because it has no
// gather); the order of the lerps is the reference's: axis, then b, then c.
// The 256x4 transfer function sits in shared memory (4 KB).
//
// Plane list.  In a prologue the CTA lists, kPlaneChunk planes at a time,
// the planes its tile can fetch at (sweep_list.cuh, shared with the dense
// sweep K5): act[k] != 0 and the window overlapping the sample points of
// the tile's first and last rays, in front-to-back order, one 16-byte
// struct per plane.  The per-ray window, clip, SENTINEL and early-exit
// tests stay as they were, so the list only has to be a superset of the
// planes the tile's rays fetch at.
//
// The walk.  Each thread walks its tile's list with no barrier, running
// per plane what the old loop over all K planes ran: the window and clip
// tests, the 8 taps from the store (neighbouring rays share them through
// L1), the SENTINEL test, the TF lookup and the composite; it leaves the
// walk at its early exit, and a warp leaves it with its last ray.  A CTA
// whose rays have all exited lists no further chunk.  These were built
// and measured slower on the card (PERF.md section 6): staging each
// plane's (c, b) footprint in shared memory with cp.async behind a
// per-plane barrier (every warp then waits for the block's slowest),
// prefetching the next
// plane's taps into registers or into L2, and 32x8, 64x4 or 16x16 tiles
// (with those this code compiled to 48 registers and a spill).
//
// The early exit is exact: once 1 - t > early_exit the reference's
// composite mask stays 0 for the rest of the ray; that replaces the TPU
// kernel's whole-grid saturation flag and its hit mask.
//
// What bounds it: the serial per-ray chain (taps, TF lookup, powf,
// composite) and its latency at the occupancy its registers allow, not
// bytes.
//
// Numerics: f32 throughout, powf (not __powf), no fast-math and no FMA
// contraction (ops/_kernels.py builds with --fmad=false), so each sample
// rounds as the reference's does and the early-exit test follows it: the
// output is bit for bit the reference's.
//
// The bf16 resample (kBf16, ShearWarpParams.compute_dtype = "bfloat16", the
// JAX kernel's compute_dtype): the sample's density is sweep::density_bf16,
// each resample stage's operands rounded to bf16 and summed in f32, as the
// JAX kernel's two products; the rest of the sample is the f32 instance's.
// Its plain version is post_sweep_reference(compute_dtype="bfloat16").  A
// template instance of its own, so that the f32 instance (kBf16 = false)
// keeps its code, registers and time.

#include <cuda_runtime.h>

#include "sweep_list.cuh"
#include "sweep_sample.cuh"

namespace {

using sweep::kAlphaClamp;
using sweep::kPlaneChunk;
using sweep::kTfSize;
using sweep::kThreads;
using sweep::kTileU;
using sweep::kTileV;
using sweep::kWarps;
using sweep::Plane;
using sweep::Taps;
constexpr int kMaxClip = 8;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads) post_sweep_kernel(
    const float* __restrict__ store,   // (Na, Nc, Nb)
    const float4* __restrict__ tf,     // (256,) rgba
    const int* __restrict__ a0,        // (K,)
    const int* __restrict__ a1,        // (K,)
    const float* __restrict__ wa,      // (K,)
    const float* __restrict__ dl,      // (K,) plane z - eye_a
    const int* __restrict__ act,       // (K,)
    const float* __restrict__ view,    // (8,) u0 du dv eb ec v0 eye_a 0
    const float* __restrict__ corr,    // (V, U)
    const float* __restrict__ clip,    // (8, 4) [n_a n_b n_c d]
    const float* __restrict__ rgb_in,  // (V, U, 4)
    const float* __restrict__ t_in,    // (V, U)
    float* __restrict__ out,           // (V, U, 4)
    float* __restrict__ t_out,         // (V, U)
    int k_planes, int nc, int nb, int v_size, int u_size, int n_clip,
    float wb0, float wb1, float wc0, float wc1, float sb_scale,
    float sc_scale, float early_exit) {
  __shared__ float4 s_tf[kTfSize];
  __shared__ float4 s_clip[kMaxClip];
  __shared__ Plane s_planes[kPlaneChunk];
  __shared__ int s_count[kWarps];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < kTfSize; i += kThreads) s_tf[i] = tf[i];
  if (tid < kMaxClip)
    s_clip[tid] = make_float4(clip[4 * tid], clip[4 * tid + 1],
                              clip[4 * tid + 2], clip[4 * tid + 3]);

  const int u = blockIdx.x * kTileU + threadIdx.x;
  const int v = blockIdx.y * kTileV + threadIdx.y;
  const bool valid = u < u_size && v < v_size;
  const int ray = v * u_size + u;
  const float eb = view[3], ec = view[4], eye_a = view[6];
  const float ug = view[0] + view[1] * (float)u;
  const float vg = view[5] + view[2] * (float)v;
  float cexp = 0.0f, r = 0.0f, g = 0.0f, b = 0.0f, t = 1.0f;
  if (valid) {
    cexp = corr[ray];
    r = rgb_in[4 * ray];
    g = rgb_in[4 * ray + 1];
    b = rgb_in[4 * ray + 2];
    t = t_in[ray];
  }
  bool alive = valid && !(1.0f - t > early_exit);
  const size_t plane = (size_t)nc * nb;

  for (int k0 = 0; k0 < k_planes; k0 += kPlaneChunk) {
    // Prologue: list this chunk's planes the tile can fetch at, kThreads
    // at a time.  Its barriers also publish s_tf and s_clip and keep the
    // last chunk's list until every thread is done with it.
    if (!__syncthreads_or(alive)) break;
    const int n_list = sweep::list_planes(
        s_planes, s_count, act, a0, a1, wa, dl, view, k0,
        min(kPlaneChunk, k_planes - k0), u_size, v_size, wb0, wb1, wc0, wc1, tid);
    for (int j = 0; j < n_list && alive; ++j) {
      const Plane q = s_planes[j];
      const float xb = eb + ug * q.dl;
      const float xc = ec + vg * q.dl;
      if (!(xb >= wb0 && xb < wb1 && xc >= wc0 && xc < wc1)) continue;
      const float z = q.dl + eye_a;
      bool keep = true;
      for (int p = 0; p < n_clip; ++p) {
        const float4 c = s_clip[p];
        keep = keep && (c.x * z + c.y * xb + c.z * xc + c.w >= 0.0f);
      }
      if (!keep) continue;

      const Taps tb = sweep::taps((xb - wb0) * sb_scale - 0.5f, nb);
      const Taps tc = sweep::taps((xc - wc0) * sc_scale - 0.5f, nc);
      const float* lo = store + (size_t)q.a0 * plane;
      const float* hi = store + (size_t)q.a1 * plane;
      const float dens = kBf16 ? sweep::density_bf16(lo, hi, q.wa, tb, tc, nb)
                               : sweep::density(lo, hi, q.wa, tb, tc, nb);
      if (!(dens > -0.5f)) continue;  // a SENTINEL (uncovered) voxel contributed

      const float s = sweep::tf_coord(dens);
      const float i0f = floorf(s);
      const float wt = s - i0f;
      const int i0 = (int)i0f;
      const float4 c = sweep::lerp4(s_tf[i0], s_tf[min(i0 + 1, kTfSize - 1)], wt);

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
    t_out[ray] = t;
  }
}

}  // namespace

extern "C" int post_sweep(
    const void* store, const void* tf, const void* a0, const void* a1,
    const void* wa, const void* dl, const void* act, const void* view,
    const void* corr, const void* clip, const void* rgb_in, const void* t_in,
    void* out, void* t_out, int k_planes, int nc, int nb, int v_size,
    int u_size, int n_clip, float wb0, float wb1, float wc0, float wc1,
    float sb_scale, float sc_scale, float early_exit, int bf16, void* stream) {
  const dim3 block(kTileU, kTileV);
  const dim3 grid((u_size + kTileU - 1) / kTileU, (v_size + kTileV - 1) / kTileV);
  const auto kernel = bf16 ? post_sweep_kernel<true> : post_sweep_kernel<false>;
  kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)store, (const float4*)tf, (const int*)a0, (const int*)a1,
      (const float*)wa, (const float*)dl, (const int*)act, (const float*)view,
      (const float*)corr, (const float*)clip, (const float*)rgb_in,
      (const float*)t_in, (float*)out, (float*)t_out, k_planes, nc, nb, v_size,
      u_size, n_clip, wb0, wb1, wc0, wc1, sb_scale, sc_scale, early_exit);
  return (int)cudaGetLastError();
}
