// Nearest transfer-function lookup by density, for Hopper (sm_90a).
//
// Replaces the TPU probes of the in-kernel TF lookup:
// benchmarks/probe_kernel_gather.py::f1/k1 and f3/k3 (P11, P13) and
// benchmarks/probe_pallas_gather.py::build_onehot_tf (P17).  The plain
// PyTorch specification is libre_tpu_torch/ops/gather.py::tf_nearest_reference.
//
//   clip (P11, P13): i = clip(trunc(d * scale), 0, T - 1); out = tf[i]
//   zero (P17):      i = floor(d * scale);  out = tf[i], or 0 if i not in [0, T)
//
// tf is (T, C), C >= 1, and the output is channels last: out[e * C + c].
// Each block stages the table in shared memory once and then walks the
// outputs grid-stride, one thread per output value, neighbouring threads on
// neighbouring outputs (coalesced density reads and output writes; the C
// threads of one density read the same word).  The grid is a few blocks per
// SM, so the table is read once per block, not once per 256 outputs.  The
// TPU probes broadcast the table to the tile and lowered the lookup to a
// lane gather, padded the table to the tile width (P13's 512 entries) or
// built it as a one-hot matrix product on the matrix unit (P17); here each
// lookup is one shared-memory load.
//
// What bounds it: bytes, at P11's 512 planes of 64x256 (33.5 MB read, 33.5 MB
// written).  The index arithmetic is a multiply and a rounding, exact as the
// plain version's (no contraction; ops/_kernels.py builds with --fmad=false).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__global__ void __launch_bounds__(kThreads)
    probe_tf_nearest_kernel(const float* __restrict__ d, const float* __restrict__ tf,
                            float* __restrict__ out, int n_out, int t_size, int channels,
                            float scale, int zero_outside) {
  extern __shared__ float tab[];
  for (int i = threadIdx.x; i < t_size * channels; i += kThreads) tab[i] = __ldg(tf + i);
  __syncthreads();
  const float top = (float)(t_size - 1);
  for (int n = blockIdx.x * kThreads + threadIdx.x; n < n_out; n += gridDim.x * kThreads) {
    const int e = channels == 1 ? n : n / channels;
    const int c = n - e * channels;
    const float s = __ldg(d + e) * scale;
    float v;
    if (zero_outside) {
      const float f = floorf(s);
      v = (f >= 0.0f && f < (float)t_size) ? tab[(int)f * channels + c] : 0.0f;
    } else {
      v = tab[(int)fminf(fmaxf(truncf(s), 0.0f), top) * channels + c];
    }
    out[n] = v;
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

extern "C" int probe_tf_nearest(const void* d, const void* tf, void* out, int n_out,
                                int t_size, int channels, float scale, int zero_outside,
                                void* stream) {
  const int needed = (n_out + kThreads - 1) / kThreads;
  const int cap = sm_count() * kBlocksPerSm;
  const int blocks = needed < cap ? needed : cap;
  const size_t smem = (size_t)t_size * channels * sizeof(float);
  probe_tf_nearest_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)tf, (float*)out, n_out, t_size, channels, scale,
      zero_outside);
  return (int)cudaGetLastError();
}
