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
// The TPU probes broadcast the table to the tile and lowered the lookup to a
// lane gather, padded the table to the tile width (P13's 512 entries) or
// built it as a one-hot matrix product on the matrix unit (P17); here each
// lookup is one load from a table that sits in L1.
//
// One kernel, one thread per density, no integer division, the grid sized
// to the work, and the table read through the read-only path with no
// staging and no barrier: at most a few KB, resident in L1 after the first
// warp of a block.  Three instances, chosen by the launcher from C and the
// operands' alignment.  C = 4 (table and output 16 B aligned): the thread
// loads its density, then the table row as one float4, and stores it as one
// float4.  C = 1 (densities and output 16 B aligned): four densities as one
// float4, their four lookups stored as one float4, the last n mod 4
// densities one by one.  Any other C or alignment: the density's C values
// by scalar loads and stores.  Staging the table in shared memory once per
// block of a grid-stride walk (the parent's way) measured slower at every
// probe's size, P11's 8.4 M outputs included (PERF.md §6).
//
// What bounds it: bytes, at P11's 512 planes of 64x256 (33.5 MB read, 33.5 MB
// written); at P13's and P17's 0.1-2.5 MB the launch and one chain of two
// dependent loads and a store.  The index arithmetic is a multiply and a
// rounding, exact as the plain version's (no contraction; ops/_kernels.py
// builds with --fmad=false).

#include <cstddef>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

// The table entry of density d: clip(trunc(d * scale), 0, T - 1), or for
// "zero" floor(d * scale), -1 outside [0, T).
__device__ __forceinline__ int entry(float d, float scale, int t_size, int zero_outside) {
  const float s = d * scale;
  if (zero_outside) {
    const float f = floorf(s);
    return (f >= 0.0f && f < (float)t_size) ? (int)f : -1;
  }
  return (int)fminf(fmaxf(truncf(s), 0.0f), (float)(t_size - 1));
}

// kC is 4 or 1 for the float4 instances, 0 for any C (`channels`).
template <int kC>
__global__ void __launch_bounds__(kThreads)
    probe_tf_nearest_row_kernel(const float* __restrict__ d, const float* __restrict__ tf,
                                float* __restrict__ out, int n_dens, int t_size, int channels,
                                float scale, int zero_outside) {
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (kC == 0) {
    if (j >= n_dens) return;
    const int i = entry(__ldg(d + j), scale, t_size, zero_outside);
    for (int c = 0; c < channels; ++c)
      out[j * channels + c] = i >= 0 ? __ldg(tf + i * channels + c) : 0.0f;
  } else if (kC == 4) {
    if (j >= n_dens) return;
    const int i = entry(__ldg(d + j), scale, t_size, zero_outside);
    reinterpret_cast<float4*>(out)[j] =
        i >= 0 ? __ldg(reinterpret_cast<const float4*>(tf) + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  } else if (4 * j + 4 <= n_dens) {
    const float4 dv = __ldg(reinterpret_cast<const float4*>(d) + j);
    const int i[4] = {entry(dv.x, scale, t_size, zero_outside),
                      entry(dv.y, scale, t_size, zero_outside),
                      entry(dv.z, scale, t_size, zero_outside),
                      entry(dv.w, scale, t_size, zero_outside)};
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = i[k] >= 0 ? __ldg(tf + i[k]) : 0.0f;
    reinterpret_cast<float4*>(out)[j] = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int e = 4 * j; e < n_dens; ++e) {
      const int i = entry(__ldg(d + e), scale, t_size, zero_outside);
      out[e] = i >= 0 ? __ldg(tf + i) : 0.0f;
    }
  }
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <int kC>
void launch_rows(const float* d, const float* tf, float* out, int n_dens, int t_size,
                 int channels, float scale, int zero_outside, cudaStream_t stream) {
  const int items = kC == 1 ? (n_dens + 3) / 4 : n_dens;  // a thread's work: 4 or 1 densities
  const int blocks = (items + kThreads - 1) / kThreads;
  probe_tf_nearest_row_kernel<kC><<<blocks, kThreads, 0, stream>>>(
      d, tf, out, n_dens, t_size, channels, scale, zero_outside);
}

}  // namespace

extern "C" int probe_tf_nearest(const void* d, const void* tf, void* out, int n_out,
                                int t_size, int channels, float scale, int zero_outside,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* df = (const float*)d;
  const float* tff = (const float*)tf;
  float* o = (float*)out;
  const int n_dens = n_out / channels;
  if (channels == 4 && aligned16(tf) && aligned16(out))
    launch_rows<4>(df, tff, o, n_dens, t_size, 4, scale, zero_outside, s);
  else if (channels == 1 && aligned16(d) && aligned16(out))
    launch_rows<1>(df, tff, o, n_dens, t_size, 1, scale, zero_outside, s);
  else
    launch_rows<0>(df, tff, o, n_dens, t_size, channels, scale, zero_outside, s);
  return (int)cudaGetLastError();
}
