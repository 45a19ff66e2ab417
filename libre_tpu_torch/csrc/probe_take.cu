// Flat gather from a table in device memory, for Hopper (sm_90a).
//
// Replaces the TPU gather probes that take from a flat or row-major table:
// benchmarks/probe_gather.py::build_take_flat (P1), probe_gather2.py::
// build_row_take (P9) and probe_pallas_gather.py::build_take_flat and
// build_take_2d_table (P14, P15).  The plain PyTorch specification is
// libre_tpu_torch/ops/gather.py::take_reference.
//
//   out[n] = table[idx[j] * row + c],        n = j * row + c, c < row
//   out[j] = table[idx[j] * width + lane[j]] with a lane index (row 1)
//
// One thread per output value, neighbouring threads on neighbouring outputs,
// so the index reads and the output writes coalesce; the table is read
// through the read-only path (__ldg).  The TPU probes staged the table in
// VMEM and lowered the take to a vector gather or, for P15, to a row take
// followed by a lane take (its (row, lane) split); here the kernel forms
// the flat offset itself and each thread loads its one value.
//
// What bounds it: at the probes' sizes (1024 to 131 072 outputs) the launch
// and one dependent load chain (index, then value) per thread, not bytes: a
// few microseconds against bounds of nanoseconds.  An index outside the
// table reads nothing and gives NaN (jnp's fill mode; the plain version
// raises); so does a lane outside the table's width.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    probe_take_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                      const int* __restrict__ lane, float* __restrict__ out,
                      int n_out, int row, int width, int n_table) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= n_out) return;
  long long at;
  if (lane != nullptr) {
    const int l = __ldg(lane + n);
    at = (unsigned)l < (unsigned)width ? (long long)__ldg(idx + n) * width + l : -1;
  } else if (row == 1) {
    at = __ldg(idx + n);
  } else {
    const int j = n / row;
    at = (long long)__ldg(idx + j) * row + (n - j * row);
  }
  out[n] = (at >= 0 && at < n_table) ? __ldg(table + at) : CUDART_NAN_F;
}

}  // namespace

extern "C" int probe_take(const void* table, const void* idx, const void* lane, void* out,
                          int n_out, int row, int width, int n_table, void* stream) {
  const int blocks = (n_out + kThreads - 1) / kThreads;
  probe_take_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (const int*)lane, (float*)out, n_out, row,
      width, n_table);
  return (int)cudaGetLastError();
}
