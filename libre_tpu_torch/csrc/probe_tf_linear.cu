// Two-tap linear RGBA transfer-function lookup by density, for Hopper
// (sm_90a).
//
// Replaces the TPU probe benchmarks/probe_kernel_gather.py::f2/k2 (P12).
// The plain PyTorch specification is libre_tpu_torch/ops/gather.py::
// tf_linear_reference.  For d (K, plane) and tf (C, T):
//
//   s = clip(clip(d, 0, 1) * T - 0.5, 0, T - 1);  i0 = floor(s);  w = s - i0
//   i1 = min(i0 + 1, T - 1)
//   out[k, c, p] = tf[c, i0] * (1 - w) + tf[c, i1] * w
//
// Channels before the rows, as f2 writes them.  Each block stages the (C, T)
// table in shared memory once and walks the densities grid-stride, one
// thread per density: it reads d once, forms the two taps and the weight
// once, and writes its C channels, each a coalesced row of the output (the
// threads of a warp hold neighbouring p).  The grid is a few blocks per SM,
// so the table is read once per block.  The TPU probe broadcast each channel
// of the table to the tile and lowered both taps to lane gathers; here each
// tap is one shared-memory load.
//
// What bounds it: bytes, at P12's 512 planes of 64x256 (33.5 MB read, 134 MB
// written).  Numerics: f32, no contraction (ops/_kernels.py builds with
// --fmad=false), so each lerp rounds as the plain version's does.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
    probe_tf_linear_kernel(const float* __restrict__ d, const float* __restrict__ tf,
                           float* __restrict__ out, int k_planes, int plane, int t_size,
                           int channels) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < t_size * channels; i += kThreads) tab[i] = __ldg(tf + i);
  __syncthreads();
  const int total = k_planes * plane;
  const float t_f = (float)t_size;
  const float top = (float)(t_size - 1);
  for (int e = blockIdx.x * kThreads + threadIdx.x; e < total; e += gridDim.x * kThreads) {
    const int k = e / plane;
    const int p = e - k * plane;
    float s = fminf(fmaxf(__ldg(d + e), 0.0f), 1.0f) * t_f - 0.5f;
    s = fminf(fmaxf(s, 0.0f), top);
    const float f = floorf(s);
    const float w = s - f;
    const float wl = 1.0f - w;
    const int i0 = (int)f;
    const int i1 = min(i0 + 1, t_size - 1);
    float* o = out + (long long)k * channels * plane + p;
    for (int c = 0; c < channels; ++c) {
      const float lo = tab[c * t_size + i0];
      const float hi = tab[c * t_size + i1];
      o[(long long)c * plane] = lo * wl + hi * w;
    }
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  return sms;
}

}  // namespace

extern "C" int probe_tf_linear(const void* d, const void* tf, void* out, int k_planes,
                               int plane, int t_size, int channels, void* stream) {
  const int needed = (k_planes * plane + kThreads - 1) / kThreads;
  const int cap = sm_count() * kBlocksPerSm;
  const int blocks = needed < cap ? needed : cap;
  const size_t smem = (size_t)t_size * channels * sizeof(float);
  probe_tf_linear_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)tf, (float*)out, k_planes, plane, t_size, channels);
  return (int)cudaGetLastError();
}
