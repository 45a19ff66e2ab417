// Gather along one axis of a 2-D table, alone or summed over a loop of
// shifted indices, for Hopper (sm_90a).
//
// Replaces the TPU gather probes built on jnp.take_along_axis:
// benchmarks/probe_gather.py::build_take_along_lane, build_take_along_sublane
// and build_onehot_mxu (P2-P4), probe_gather2.py::build_lane_gather_loop,
// build_lane_gather_wide, build_sublane_gather_fullshape and
// build_sublane_gather_8 (P5-P8), probe_gather_axis0.py::mk (P10) and
// probe_pallas_gather.py::build_take_along_lanes (P16).  The plain PyTorch
// specification is libre_tpu_torch/ops/gather.py::take_along_reference.
//
//   i_k = (idx[r, l] + k) mod `mod` (floored; idx[r, l] + k without mod)
//   axis 1: v_k = table[r, i_k]      axis 0: v_k = table[i_k, l]
//   loop 1: out[r, l] = v_0;  loop > 1: out[r, l] = ((0 + v_0) + v_1) + ...
//
// One thread per output value, neighbouring threads on neighbouring lanes l;
// the loop over k runs in registers, its index wrapped by one compare per
// step instead of a division, its sum in the reference fori_loop's order, so
// the result is bit for bit the plain version's.  Table reads go through the
// read-only path (__ldg).  The TPU's sublane/lane distinction (a dynamic
// gather along lanes, a different lowering or a one-hot matrix product along
// sublanes, P4) does not exist here: both axes are one strided load.
//
// What bounds it: at the probes' sizes (1024 to 65 536 outputs, loops of up
// to 512) the launch and each thread's chain of dependent adds, not bytes.
// An index outside the table reads nothing and gives NaN (jnp's fill mode;
// the plain version raises).

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    probe_take_along_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                            float* __restrict__ out, int rows, int cols, int t_rows,
                            int t_cols, int axis, int loop, int mod) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= rows * cols) return;
  const int r = n / cols;
  const int l = n - r * cols;
  const float* base = axis == 1 ? table + (long long)r * t_cols : table + l;
  const int stride = axis == 1 ? 1 : t_cols;
  const int extent = axis == 1 ? t_cols : t_rows;
  int i = __ldg(idx + n);
  if (mod > 0) {
    i %= mod;
    if (i < 0) i += mod;
  }
  if (loop == 1) {
    out[n] = (unsigned)i < (unsigned)extent ? __ldg(base + (long long)i * stride) : CUDART_NAN_F;
    return;
  }
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < loop; ++k) {
    acc += (unsigned)i < (unsigned)extent ? __ldg(base + (long long)i * stride) : CUDART_NAN_F;
    ++i;
    if (i == mod && mod > 0) i = 0;
  }
  out[n] = acc;
}

}  // namespace

extern "C" int probe_take_along(const void* table, const void* idx, void* out, int rows,
                                int cols, int t_rows, int t_cols, int axis, int loop, int mod,
                                void* stream) {
  const int blocks = (rows * cols + kThreads - 1) / kThreads;
  probe_take_along_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)table, (const int*)idx, (float*)out, rows, cols, t_rows, t_cols, axis,
      loop, mod);
  return (int)cudaGetLastError();
}
