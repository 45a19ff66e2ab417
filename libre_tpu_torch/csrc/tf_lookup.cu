// The TF lookup, forward and backward, for Hopper (sm_90a): the GL
// linear-filtered, clamp-to-edge 1-D RGBA texture fetch of a (T, 4) transfer
// function at every density of a tensor, and its gradient.
//
// Replaces no TPU kernel: the JAX package's lookup is a jnp.take that XLA
// fuses.  It was added because the port's plain lookup (two index_select row
// gathers of the table, an int64 index volume each, and ~13 elementwise
// passes around them, with a bincount backward per channel) took 97 ms of the
// dense trainer's 200 ms step at 256^3 on an H100 (PERF.md §5), for bytes
// that need ~1 ms.  The plain PyTorch specifications are
// libre_tpu_torch/ops/transfer_function.py::lookup_reference (forward) and
// libre_tpu_torch/testing.py::lookup_backward_reference (backward).  For a
// density d:
//
//   s' = clamp(d, 0, 1) * T - 0.5;  s = clamp(s', 0, T - 1)
//   i0 = floor(s);  w = s - i0;  i1 = min(i0 + 1, T - 1)
//   out[c] = tf[i0][c] * (1 - w) + tf[i1][c] * w
//   d_d    = T * sum_c g[c] (tf[i1][c] - tf[i0][c])   where 0 <= d <= 1 and
//            0 <= s' <= T - 1 (torch.clamp's backward: the ends pass), else 0
//   d_tf[i0] += g (1 - w);  d_tf[i1] += g w
//
// The forward is lookup_reference op for op: f32, no contraction
// (ops/_kernels.py builds with --fmad=false), each product rounded before the
// sum as torch's three ops round them, so it is bit-equal to the plain version
// on the card.  The backward's density gradient is the closed form above in
// f32 (autograd's order differs: round-off); its TF gradient is summed in
// another order than the plain version's bincount, and the order of its
// atomics changes from run to run.
//
// What bounds it: bytes.  Forward 20 B a density (4 B read, 16 B written),
// backward 24 B (the density and the cotangent read, the density gradient
// written); the table is read once a block.  The design streams: one pass
// each, a grid-stride walk of one wave of resident blocks in which a warp
// takes 32 neighbouring densities, so that every access is coalesced (4 B
// density loads, 16 B RGBA stores and cotangent loads), four densities a wave
// apart in flight a thread, the four lerps formed in registers.  Nothing of
// the lookup is saved for the backward but the density itself: the backward
// recomputes the taps.  A table of up to kSharedTfMax entries is staged in
// dynamic shared memory once a block (the backward's TF gradient table beside
// it); a larger one is read through L2 (__ldg) and the backward's flushes go
// straight into d_tf, as K4's global-TF instances do.  At the dense trainer's
// 256^3 densities and 256 entries on an H100 (PERF.md) the forward took
// 0.128 ms (bound 0.100) against 0.336 ms for four neighbouring densities a
// thread (16 B density loads, each thread's stores 64 B apart from its
// neighbour's), and the backward 0.147-0.316 ms against 0.249-0.403 ms on a
// flat and a smooth volume.
//
// The TF gradient goes through tf_grad.cuh's accumulator: a run in registers
// that flushes when i0 changes, a warp-aggregated flush into the block's table,
// one global atomic per non-zero entry at the end of the block.  The dense
// trainer starts from a flat 0.5 volume, so at its first step every density
// adds to the same two bins: one shared atomic per density would serialise the
// pass, and a run flushes once per thread.  Where the bins vary (a smooth
// field at 256 entries changes bin from one voxel to the next) a run is one
// density long and the warp's flush, whose lanes hold neighbours that often
// share a bin, does the aggregating: that flush is what the backward spends
// past its bytes (0.29 of its 0.32 ms on the smooth field without d_d).

#include <cuda_runtime.h>

#include "tf_grad.cuh"
#include "wave.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSharedTfMax = 4096;  // past it the table is read through L2

struct Tap {
  int i0, i1;
  float w;
  bool pass;  // the density gradient passes both clamps
};

__device__ __forceinline__ Tap tap(float d, int n, float n_f, float top) {
  const float x = fminf(fmaxf(d, 0.0f), 1.0f);
  const float s_pre = x * n_f - 0.5f;
  const float s = fminf(fmaxf(s_pre, 0.0f), top);
  const float f = floorf(s);
  Tap t;
  t.w = s - f;
  t.i0 = (int)f;
  t.i1 = min(t.i0 + 1, n - 1);
  t.pass = d >= 0.0f && d <= 1.0f && s_pre >= 0.0f && s_pre <= top;
  return t;
}

__device__ __forceinline__ float4 lerp_rows(const float4* tab, float d, int n, float n_f,
                                            float top) {
  const Tap t = tap(d, n, n_f, top);
  const float4 lo = tab[t.i0], hi = tab[t.i1];
  const float wl = 1.0f - t.w;
  return make_float4(lo.x * wl + hi.x * t.w, lo.y * wl + hi.y * t.w, lo.z * wl + hi.z * t.w,
                     lo.w * wl + hi.w * t.w);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    tf_lookup_fwd_kernel(const float* __restrict__ d, const float4* __restrict__ tf,
                         float4* __restrict__ out, long long n_elem, int n) {
  extern __shared__ float4 s_tf[];
  const float4* tab = tf;
  if (kShared) {
    for (int i = threadIdx.x; i < n; i += kThreads) s_tf[i] = __ldg(tf + i);
    __syncthreads();
    tab = s_tf;
  }
  const float n_f = (float)n, top = (float)(n - 1);
  const long long stride = (long long)gridDim.x * kThreads;
  long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; e + 3 * stride < n_elem; e += 4 * stride) {
    float dv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) dv[u] = __ldcs(d + e + u * stride);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      __stcs(out + e + u * stride, lerp_rows(tab, dv[u], n, n_f, top));
  }
  for (; e < n_elem; e += stride) out[e] = lerp_rows(tab, __ldcs(d + e), n, n_f, top);
}

// One density's backward: its density gradient (returned) and its share of
// the TF gradient into the thread's run.
template <bool kWantD, bool kWantTf>
__device__ __forceinline__ float bwd1(const float4* tab, float* table, tfgrad::Run& run,
                                      float d, float4 g, int n, float n_f, float top) {
  const Tap t = tap(d, n, n_f, top);
  float dd = 0.0f;
  if (kWantD && t.pass) {
    const float4 lo = tab[t.i0], hi = tab[t.i1];
    const float dot = g.x * (hi.x - lo.x) + g.y * (hi.y - lo.y) + g.z * (hi.z - lo.z) +
                      g.w * (hi.w - lo.w);
    dd = n_f * dot;
  }
  if (kWantTf) run.add(table, t.i0, t.w, g.x, g.y, g.z, g.w, n);
  return dd;
}

template <bool kShared, bool kWantD, bool kWantTf>
__global__ void __launch_bounds__(kThreads)
    tf_lookup_bwd_kernel(const float* __restrict__ d, const float4* __restrict__ tf,
                         const float4* __restrict__ g, float* __restrict__ d_d,
                         float* __restrict__ d_tf, long long n_elem, int n) {
  // The shared instance: the (n,) float4 TF, then the n x 4 gradient table.
  extern __shared__ float4 s_dyn[];
  const float4* tab = tf;
  float* table = d_tf;
  if (kShared) {
    for (int i = threadIdx.x; i < n; i += kThreads) s_dyn[i] = __ldg(tf + i);
    table = reinterpret_cast<float*>(s_dyn + n);
    if (kWantTf) tfgrad::zero_table(table, threadIdx.x, kThreads, n);
    __syncthreads();
    tab = s_dyn;
  }
  tfgrad::Run run;
  const float n_f = (float)n, top = (float)(n - 1);
  const long long stride = (long long)gridDim.x * kThreads;
  long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; e + 3 * stride < n_elem; e += 4 * stride) {
    float dv[4];
    float4 gv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      dv[u] = __ldcs(d + e + u * stride);
      gv[u] = __ldcs(g + e + u * stride);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float dd = bwd1<kWantD, kWantTf>(tab, table, run, dv[u], gv[u], n, n_f, top);
      if (kWantD) __stcs(d_d + e + u * stride, dd);
    }
  }
  for (; e < n_elem; e += stride) {
    const float dd =
        bwd1<kWantD, kWantTf>(tab, table, run, __ldcs(d + e), __ldcs(g + e), n, n_f, top);
    if (kWantD) d_d[e] = dd;
  }
  if (kWantTf) {
    run.flush(table, n);  // the thread's last run, if any
    if (kShared) {
      __syncthreads();
      tfgrad::add_table(table, d_tf, threadIdx.x, kThreads, n);
    }
  }
}

// Launches `kernel` as one wave of its resident blocks (fewer where the work
// is smaller), with `smem` bytes of dynamic shared memory.
template <typename Kernel, typename... Args>
cudaError_t launch_wave(Kernel kernel, size_t smem, long long items, cudaStream_t stream,
                        Args... args) {
  if (smem > 0) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int resident = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  kernel<<<wave::blocks(items, kThreads, resident), kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <bool kShared>
cudaError_t backward(const float* d, const float4* tf, const float4* g, float* d_d,
                     float* d_tf, long long n_elem, int n, cudaStream_t stream) {
  const long long items = (n_elem + 3) / 4;
  const size_t smem = kShared ? (size_t)n * sizeof(float4) * (d_tf ? 2 : 1) : 0;
  if (d_d && d_tf)
    return launch_wave(tf_lookup_bwd_kernel<kShared, true, true>, smem, items, stream, d, tf,
                       g, d_d, d_tf, n_elem, n);
  if (d_d)
    return launch_wave(tf_lookup_bwd_kernel<kShared, true, false>, smem, items, stream, d, tf,
                       g, d_d, d_tf, n_elem, n);
  return launch_wave(tf_lookup_bwd_kernel<kShared, false, true>, smem, items, stream, d, tf, g,
                     d_d, d_tf, n_elem, n);
}

}  // namespace

// d: (n_elem,) densities; tf: (n_tf, 4); tf, g and out 16 B aligned.  With g
// null, the forward: out (n_elem, 4).  Else the backward of cotangent g
// (n_elem, 4): d_d (n_elem,) written, unless null; d_tf (n_tf, 4), zeroed by
// the caller, added into, unless null.  n_tf at least 1.
extern "C" int tf_lookup(const void* d, const void* tf, const void* g, void* out, void* d_d,
                         void* d_tf, long long n_elem, int n_tf, void* stream) {
  if (n_tf < 1 || n_elem < 1) return (int)cudaErrorInvalidValue;
  const auto s = (cudaStream_t)stream;
  const auto* d_f = (const float*)d;
  const auto* tf4 = (const float4*)tf;
  const bool shared = n_tf <= kSharedTfMax;
  if (!g) {
    const long long items = (n_elem + 3) / 4;
    return (int)(shared ? launch_wave(tf_lookup_fwd_kernel<true>, (size_t)n_tf * sizeof(float4),
                                      items, s, d_f, tf4, (float4*)out, n_elem, n_tf)
                        : launch_wave(tf_lookup_fwd_kernel<false>, 0, items, s, d_f, tf4,
                                      (float4*)out, n_elem, n_tf));
  }
  if (!d_d && !d_tf) return (int)cudaErrorInvalidValue;
  const auto* g4 = (const float4*)g;
  return (int)(shared ? backward<true>(d_f, tf4, g4, (float*)d_d, (float*)d_tf, n_elem, n_tf, s)
                      : backward<false>(d_f, tf4, g4, (float*)d_d, (float*)d_tf, n_elem, n_tf,
                                        s));
}
