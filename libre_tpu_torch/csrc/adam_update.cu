// One step of Adam over one leaf, with the leaf's epilogue fused in, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves its optimizer to optax under
// XLA.  It was added because torch.optim.Adam's foreach update makes seven
// passes over a leaf (lerp, mul, addcmul, sqrt, div, add, addcdiv), 72 B a
// voxel, and the store trainer's pin four more (s > -0.5, clamp, where,
// copy_), about 30 B: 3.48-3.54 ms a step over the trainers' 512^3 leaves on
// an H100, a third of the exact trainer's 10.4 ms step (PERF.md §5).  The
// plain PyTorch specification is libre_tpu_torch/ops/adam.py::
// adam_update_reference.
//
// torch's Adam in f32 and in torch's order, the scalars computed by the host
// in double as torch computes them and passed as floats:
//   m <- lerp(m, g, w)                     w = 1 - beta1, torch.lerp's two forms
//   v <- v * beta2 + ((1 - beta2) * g) * g
//   p <- p + (-lr / bc1) * (m / (sqrt(v) / sqrt(bc2) + eps))
// then the leaf's epilogue: none; clamp01, p clamped to [0, 1]; pin, p
// clamped to [0, 1] where the p read before the update is > -0.5, else the
// sentinel.  The clamp keeps a NaN, as torch.clamp does (no fminf / fmaxf,
// which drop it).  Built with --fmad=false (ops/_kernels.py): no product is
// contracted into its sum.
//
// What bounds it: bytes.  One pass reads p, g, m and v and writes p, m and v:
// 28 B a voxel, 3.76 GB or 1.12 ms at 3.35 TB/s for a 512^3 leaf.  The pin's
// coverage comes from the p that the pass reads anyway, so it costs nothing.
// The design streams: 16 B (float4) loads and stores, kUnroll independent
// float4s of each of the four streams in flight per thread, a grid-stride walk
// over waves of the SMs, streaming cache hints (__ldcs / __stcs: a 512^3
// leaf's 3.76 GB is 75 times the 50 MB L2), and the n mod 4 tail one float at
// a time.  On an H100 at 700 W a 512^3 step took 1.270 ms with 4 float4s a
// stream in flight and up to 64 blocks an SM, against 1.276-1.315 ms with 1
// or 2 and 2-16 blocks an SM; the cache hints moved it by under 0.1%.

#include <cstddef>
#include <cuda_runtime.h>

#include "wave.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;        // float4s of each stream a thread has in flight
constexpr int kBlocksPerSm = 64;  // the grid: waves of resident blocks (2 an SM at 89 registers)

enum Epilogue { kNone = 0, kClamp01 = 1, kPin = 2 };

struct Scalars {
  float w;         // 1 - beta1, the lerp weight
  float beta2;
  float w2;        // 1 - beta2
  float neg_step;  // -lr / bc1
  float bc2_sqrt;  // sqrt(bc2)
  float eps;
  float sentinel;  // the pin's value of an uncovered voxel
};

__device__ __forceinline__ float clamp01(float x) {
  return x < 0.0f ? 0.0f : (x > 1.0f ? 1.0f : x);
}

// torch.lerp: self + w (end - self) for |w| < 0.5, else end - (end - self)(1 - w).
__device__ __forceinline__ float lerp(float self, float end, float w) {
  return fabsf(w) < 0.5f ? self + w * (end - self) : end - (end - self) * (1.0f - w);
}

template <int kEpi>
__device__ __forceinline__ void adam1(float& p, float g, float& m, float& v, const Scalars& s) {
  const float p_old = p;
  m = lerp(m, g, s.w);
  v = v * s.beta2 + (s.w2 * g) * g;
  const float denom = sqrtf(v) / s.bc2_sqrt + s.eps;
  p = p + s.neg_step * (m / denom);
  if (kEpi == kClamp01) p = clamp01(p);
  if (kEpi == kPin) p = p_old > -0.5f ? clamp01(p) : s.sentinel;
}

template <int kEpi>
__device__ __forceinline__ void adam4(float4& p, const float4& g, float4& m, float4& v,
                                      const Scalars& s) {
  adam1<kEpi>(p.x, g.x, m.x, v.x, s);
  adam1<kEpi>(p.y, g.y, m.y, v.y, s);
  adam1<kEpi>(p.z, g.z, m.z, v.z, s);
  adam1<kEpi>(p.w, g.w, m.w, v.w, s);
}

template <int kEpi>
__global__ void __launch_bounds__(kThreads)
    adam_update_kernel(float* __restrict__ p, const float* __restrict__ g,
                       float* __restrict__ m, float* __restrict__ v, int n, Scalars s) {
  const size_t n4 = (size_t)n / 4;
  const size_t stride = (size_t)gridDim.x * kThreads;
  const size_t tid = (size_t)blockIdx.x * kThreads + threadIdx.x;
  float4* p4 = reinterpret_cast<float4*>(p);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  for (size_t base = tid; base < n4; base += kUnroll * stride) {
    float4 pr[kUnroll], gr[kUnroll], mr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + u * stride;
      if (i < n4) {
        pr[u] = __ldcs(p4 + i);
        gr[u] = __ldcs(g4 + i);
        mr[u] = __ldcs(m4 + i);
        vr[u] = __ldcs(v4 + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + u * stride;
      if (i < n4) {
        adam4<kEpi>(pr[u], gr[u], mr[u], vr[u], s);
        __stcs(p4 + i, pr[u]);
        __stcs(m4 + i, mr[u]);
        __stcs(v4 + i, vr[u]);
      }
    }
  }
  for (size_t e = 4 * n4 + tid; e < (size_t)n; e += stride) {
    float pe = p[e], me = m[e], ve = v[e];
    adam1<kEpi>(pe, g[e], me, ve, s);
    p[e] = pe;
    m[e] = me;
    v[e] = ve;
  }
}

template <int kEpi>
void launch(float* p, const float* g, float* m, float* v, int n, const Scalars& s,
            cudaStream_t stream) {
  const long long items = ((long long)n / 4 + kUnroll - 1) / kUnroll;  // a thread's work
  const int blocks = wave::blocks(items, kThreads, kBlocksPerSm);
  adam_update_kernel<kEpi><<<blocks, kThreads, 0, stream>>>(p, g, m, v, n, s);
}

}  // namespace

// p, g, m and v are n contiguous floats each, 16 B aligned (the wrapper
// checks); epilogue is 0 none, 1 clamp01, 2 pin.
extern "C" int adam_update(void* p, const void* g, void* m, void* v, int n, int epilogue,
                           float w, float beta2, float w2, float neg_step, float bc2_sqrt,
                           float eps, float sentinel, void* stream) {
  const Scalars s{w, beta2, w2, neg_step, bc2_sqrt, eps, sentinel};
  const cudaStream_t st = (cudaStream_t)stream;
  float* pf = (float*)p;
  const float* gf = (const float*)g;
  float* mf = (float*)m;
  float* vf = (float*)v;
  if (epilogue == kPin)
    launch<kPin>(pf, gf, mf, vf, n, s, st);
  else if (epilogue == kClamp01)
    launch<kClamp01>(pf, gf, mf, vf, n, s, st);
  else
    launch<kNone>(pf, gf, mf, vf, n, s, st);
  return (int)cudaGetLastError();
}
