// Post-classification plane sweep over a slope-ray grid, for Hopper (sm_90a).
//
// Replaces the TPU kernel libre_tpu/ops/shearwarp_bricked.py::_make_post_kernel
// (launched by _post_call from _compiled_store_frame).  The plain PyTorch
// specification is libre_tpu_torch/ops/shearwarp_bricked.py::post_sweep_reference.
//
// One thread per slope ray (v, u), threadIdx.x along u so that neighbouring
// threads read neighbouring b addresses of the store.  Each thread loops over
// the K virtual planes front to back with its (r, g, b, t) carry in registers:
// the TPU's sequential grid axis becomes this in-thread loop.  Per plane the
// density is fetched directly as 2 slices x 2x2 taps from the unpadded
// (Na, Nc, Nb) f32 store (the TPU kernel built one-hot interpolation matrices
// for its matrix unit because it has no gather); the order of the lerps is
// the reference's: axis, then b, then c.  The 256x4 transfer function sits in
// shared memory (4 KB).
//
// Early exit: once 1 - t > early_exit the reference's composite mask stays 0
// for the rest of the ray, so the thread leaves its loop.  That is exact and
// replaces the TPU kernel's whole-grid saturation flag and its hit mask.
//
// What bounds it: the store reads, 8 four-byte loads per sample with little
// reuse inside a thread (the current slice pair, 2 MB at 512^2, sits in the
// 50 MB L2), and the serial per-ray loop.  wgmma, TMA staging of slice tiles
// and a tile-per-block layout are left for later work.
//
// Numerics: f32 throughout, powf (not __powf), no fast-math, so the early-exit
// test and the TF lerp follow the reference; only FMA contraction differs.

#include <cuda_runtime.h>

namespace {

constexpr int kTfSize = 256;
constexpr int kMaxClip = 8;
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

__global__ void __launch_bounds__(256) post_sweep_kernel(
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
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  for (int i = tid; i < kTfSize; i += blockDim.x * blockDim.y) s_tf[i] = tf[i];
  if (tid < kMaxClip)
    s_clip[tid] = make_float4(clip[4 * tid], clip[4 * tid + 1],
                              clip[4 * tid + 2], clip[4 * tid + 3]);
  __syncthreads();

  const int u = blockIdx.x * blockDim.x + threadIdx.x;
  const int v = blockIdx.y * blockDim.y + threadIdx.y;
  if (u >= u_size || v >= v_size) return;

  const float u0 = view[0], du = view[1], dv = view[2];
  const float eb = view[3], ec = view[4], v0 = view[5], eye_a = view[6];
  const float ug = u0 + du * (float)u;
  const float vg = v0 + dv * (float)v;
  const int ray = v * u_size + u;
  const float cexp = corr[ray];
  float r = rgb_in[4 * ray], g = rgb_in[4 * ray + 1], b = rgb_in[4 * ray + 2];
  float t = t_in[ray];
  const size_t plane = (size_t)nc * nb;

  for (int k = 0; k < k_planes; ++k) {
    if (1.0f - t > early_exit) break;  // composite mask is 0 from here on
    if (act[k] == 0) continue;
    const float delta = dl[k];
    const float xb = eb + ug * delta;
    const float xc = ec + vg * delta;
    if (!(xb >= wb0 && xb < wb1 && xc >= wc0 && xc < wc1)) continue;
    const float z = delta + eye_a;
    bool keep = true;
    for (int p = 0; p < n_clip; ++p) {
      const float4 c = s_clip[p];
      keep = keep && (c.x * z + c.y * xb + c.z * xc + c.w >= 0.0f);
    }
    if (!keep) continue;

    const Taps tb = taps((xb - wb0) * sb_scale - 0.5f, nb);
    const Taps tc = taps((xc - wc0) * sc_scale - 0.5f, nc);
    const float w_a = wa[k];
    const float* lo = store + (size_t)a0[k] * plane;
    const float* hi = store + (size_t)a1[k] * plane;
    const size_t r0 = (size_t)tc.i0 * nb, r1 = (size_t)tc.i1 * nb;
    const float v00 = lo[r0 + tb.i0] * (1.0f - w_a) + hi[r0 + tb.i0] * w_a;
    const float v01 = lo[r0 + tb.i1] * (1.0f - w_a) + hi[r0 + tb.i1] * w_a;
    const float v10 = lo[r1 + tb.i0] * (1.0f - w_a) + hi[r1 + tb.i0] * w_a;
    const float v11 = lo[r1 + tb.i1] * (1.0f - w_a) + hi[r1 + tb.i1] * w_a;
    const float s_c0 = v00 * (1.0f - tb.w) + v01 * tb.w;
    const float s_c1 = v10 * (1.0f - tb.w) + v11 * tb.w;
    const float dens = s_c0 * (1.0f - tc.w) + s_c1 * tc.w;
    if (!(dens > -0.5f)) continue;  // a SENTINEL (uncovered) voxel contributed

    float s = fminf(fmaxf(dens, 0.0f), 1.0f) * kTfSize - 0.5f;
    s = fminf(fmaxf(s, 0.0f), (float)(kTfSize - 1));
    const float i0f = floorf(s);
    const float wt = s - i0f;
    const int i0 = (int)i0f;
    const float4 c0 = s_tf[i0];
    const float4 c1 = s_tf[min(i0 + 1, kTfSize - 1)];
    const float cr = c0.x * (1.0f - wt) + c1.x * wt;
    const float cg = c0.y * (1.0f - wt) + c1.y * wt;
    const float cb = c0.z * (1.0f - wt) + c1.z * wt;
    const float ca = c0.w * (1.0f - wt) + c1.w * wt;

    const float a_corr = 1.0f - powf(1.0f - fminf(ca, kAlphaClamp), cexp);
    const float w = a_corr * t;
    r += w * cr;
    g += w * cg;
    b += w * cb;
    t = t * (1.0f - a_corr);
  }
  out[4 * ray] = r;
  out[4 * ray + 1] = g;
  out[4 * ray + 2] = b;
  out[4 * ray + 3] = 1.0f - t;
  t_out[ray] = t;
}

}  // namespace

extern "C" int post_sweep(
    const void* store, const void* tf, const void* a0, const void* a1,
    const void* wa, const void* dl, const void* act, const void* view,
    const void* corr, const void* clip, const void* rgb_in, const void* t_in,
    void* out, void* t_out, int k_planes, int nc, int nb, int v_size,
    int u_size, int n_clip, float wb0, float wb1, float wc0, float wc1,
    float sb_scale, float sc_scale, float early_exit, void* stream) {
  const dim3 block(32, 8);
  const dim3 grid((u_size + block.x - 1) / block.x,
                  (v_size + block.y - 1) / block.y);
  post_sweep_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const float*)store, (const float4*)tf, (const int*)a0, (const int*)a1,
      (const float*)wa, (const float*)dl, (const int*)act, (const float*)view,
      (const float*)corr, (const float*)clip, (const float*)rgb_in,
      (const float*)t_in, (float*)out, (float*)t_out, k_planes, nc, nb, v_size,
      u_size, n_clip, wb0, wb1, wc0, wc1, sb_scale, sc_scale, early_exit);
  return (int)cudaGetLastError();
}
