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
// Three kernels, and a fill.
//
// The single gather (loop 1, P2-P4, P7, P10, P16): a kernel of its own,
// templated on the axis and on whether a mod wraps the index, one thread per
// output value, neighbouring threads on neighbouring outputs, blocks of 256
// threads.  Its body is one chain: the index load, the table load that
// depends on it, the store.  The row and lane of output n (a division by
// cols) are formed while the index load is in flight, and the table load is
// not predicated on the range test (an index outside the table reads entry 0
// of its row or column, and the store selects NaN), so that the compiler
// loads the table's address operands before the index arrives and not after
// it.  On a 2-D grid (row by blockIdx.y, no division), with the load
// predicated, at 32-128 threads a block or with two outputs a thread, the
// same chain measured slower than the shared kernel it replaces on P7
// (PERF.md §6).  The TPU's
// sublane/lane distinction (a dynamic gather along lanes, a different
// lowering or a one-hot matrix product along sublanes, P4) does not exist
// here: both axes are one load through the read-only path.
//
// The loop sum (loop > 1, P5, P6, P8), as the TPU kernel held its table in
// VMEM: one warp per 32 lanes of one row of outputs, so that the 1024
// outputs of the probes spread over 32 SMs.  The warp stages in shared
// memory the part of the table its outputs read, once: row r (axis 1, 512 B
// for P5, 4 KB for P6) or the 32 columns of its lanes (axis 0, 1 KB for
// P8), and past mod a repeat of its first kChunk entries.  Each thread
// then tests its index range once: with 0 < mod <= extent every wrapped
// index lies in the table, and otherwise the indices i_0 .. i_{loop-1} are
// checked as a whole (a sum over an index outside the table is NaN whatever
// the other terms).  The sum runs from shared memory in chunks of kChunk
// steps: a chunk's indices i .. i + kChunk - 1 never wrap (the repeat holds
// the wrapped ones), so its loads take constant offsets from one address,
// and the next chunk's loads are issued before this chunk's adds, so that
// the chain of dependent adds, in the reference fori_loop's order
// ((0 + v_0) + v_1) + ..., sets the time and the result is bit for bit the
// plain version's.
//
// A loop whose table slice is too large to stage: one thread per output
// value, neighbouring threads on neighbouring lanes, table reads through the
// read-only path (__ldg); the loop wraps its index by one compare per step
// and tests its range per step.
//
// A table with no entry along the axis has nothing to read: a fill writes
// NaN to every output, so that no kernel above meets it.
//
// What bounds it: at the probes' sizes (1024 to 65 536 outputs, loops of up
// to 512) the launch and each thread's chain of dependent loads, or of
// dependent adds (512 adds of about 4 cycles), not bytes.  An index outside
// the table gives NaN (jnp's fill mode; the plain version raises).

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
// The staged loop: one warp a block, kChunk steps a chunk.
constexpr int kLanes = 32;
constexpr int kChunk = 16;
// The largest table slice the staged loop holds: 48 KB, the dynamic shared
// memory a block takes without opting in.
constexpr int kStageFloats = 48 * 1024 / 4;

template <int kAxis, bool kMod>
__global__ void __launch_bounds__(kThreads)
    probe_take_along_single_kernel(const float* __restrict__ table,
                                   const int* __restrict__ idx, float* __restrict__ out,
                                   int rows, int cols, int t_cols, int extent, int mod) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= rows * cols) return;
  int i = __ldg(idx + n);
  const int r = n / cols;
  const int l = n - r * cols;
  if (kMod) {
    i %= mod;
    if (i < 0) i += mod;
  }
  const bool inside = (unsigned)i < (unsigned)extent;
  const int at = inside ? i : 0;
  const float v = __ldg(table + (kAxis == 1 ? r * t_cols + at : at * t_cols + l));
  out[n] = inside ? v : CUDART_NAN_F;
}

__global__ void __launch_bounds__(kThreads) fill_nan_kernel(float* __restrict__ out, int n) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k < n) out[k] = CUDART_NAN_F;
}

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
  float acc = 0.0f;
#pragma unroll 8
  for (int k = 0; k < loop; ++k) {
    acc += (unsigned)i < (unsigned)extent ? __ldg(base + (long long)i * stride) : CUDART_NAN_F;
    ++i;
    if (i == mod && mod > 0) i = 0;
  }
  out[n] = acc;
}

__global__ void __launch_bounds__(kLanes)
    probe_take_along_loop_kernel(const float* __restrict__ table,
                                 const int* __restrict__ idx, float* __restrict__ out,
                                 int cols, int t_rows, int t_cols, int axis, int loop,
                                 int mod) {
  extern __shared__ float4 s_slice[];  // the staged slice, sized by the launch
  float* s_table = reinterpret_cast<float*>(s_slice);
  const int chunks = (cols + kLanes - 1) / kLanes;  // blocks per row of outputs
  const int r = blockIdx.x / chunks;
  const int l0 = (blockIdx.x - r * chunks) * kLanes;
  const int tx = threadIdx.x;
  const int l = l0 + tx;
  const int n = r * cols + l;
  const int extent = axis == 1 ? t_cols : t_rows;
  // The index first, so that its load overlaps the staging.
  int i = l < cols ? __ldg(idx + n) : 0;
  // Stage the slice: row r (axis 1) at s_table[j], or columns l0 .. l0 + 31
  // of every row at s_table[j * kLanes + tx] (axis 0); then, where the loop
  // wraps (0 < mod <= extent), kChunk entries past mod that repeat the
  // slice's first ones, so that a chunk of indices i .. i + kChunk - 1 from
  // i < mod needs no wrap.
  const bool wraps = mod > 0 && mod <= extent;
  if (axis == 1) {
    const float* row = table + (long long)r * t_cols;
    if ((t_cols & 3) == 0 && ((size_t)row & 15) == 0) {
      for (int j = tx; j < t_cols / 4; j += kLanes)
        s_slice[j] = __ldg(reinterpret_cast<const float4*>(row) + j);
    } else {
      for (int j = tx; j < t_cols; j += kLanes) s_table[j] = __ldg(row + j);
    }
    __syncwarp();
    if (wraps && tx < kChunk) s_table[mod + tx] = s_table[tx % mod];
  } else if (l < cols) {
    for (int j = 0; j < t_rows; ++j)
      s_table[j * kLanes + tx] = __ldg(table + (long long)j * t_cols + l);
    if (wraps)
      for (int u = 0; u < kChunk; ++u)
        s_table[(mod + u) * kLanes + tx] = s_table[(u % mod) * kLanes + tx];
  }
  __syncwarp();
  if (l >= cols) return;
  const float* s = axis == 1 ? s_table : s_table + tx;
  const int stride = axis == 1 ? 1 : kLanes;
  if (mod > 0) {
    i %= mod;
    if (i < 0) i += mod;
  }
  // The largest index the loop visits: without mod i + loop - 1; with mod
  // the wrap point's predecessor, or i + loop - 1 if the loop ends before.
  const long long last = (long long)i + loop - 1;
  const bool inside = mod > 0 ? min(last, (long long)mod - 1) < extent
                              : i >= 0 && last < extent;
  if (!inside) {
    out[n] = CUDART_NAN_F;
    return;
  }
  // Valid and not wrapping within the slice (mod 0, or mod past the extent
  // with the loop ending before the wrap): the indices only grow.
  const int wrap = wraps ? mod : INT_MAX;
  const int advance = kChunk % wrap;  // a chunk's step, wrapped
  float acc = 0.0f;
  int k = 0;
  if (loop >= kChunk) {
    // Chunk c's kChunk terms are s[(i_c + u) * stride], u < kChunk, with
    // i_c < wrap: the staged repeat past mod holds the wrapped ones.
    float v[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) v[u] = s[(i + u) * stride];
    for (k = kChunk; k + kChunk <= loop; k += kChunk) {
      i += advance;
      if (i >= wrap) i -= wrap;
      float w[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) w[u] = s[(i + u) * stride];  // ahead of the adds
#pragma unroll
      for (int u = 0; u < kChunk; ++u) acc += v[u];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) v[u] = w[u];
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) acc += v[u];
    i += advance;
    if (i >= wrap) i -= wrap;
  }
  for (; k < loop; ++k) {
    acc += s[i * stride];
    ++i;
    if (i == wrap) i = 0;
  }
  out[n] = acc;
}

template <int kAxis, bool kMod>
void launch_single(const float* table, const int* idx, float* out, int rows, int cols,
                   int t_cols, int extent, int mod, cudaStream_t stream) {
  const int blocks = (rows * cols + kThreads - 1) / kThreads;
  probe_take_along_single_kernel<kAxis, kMod><<<blocks, kThreads, 0, stream>>>(
      table, idx, out, rows, cols, t_cols, extent, mod);
}

}  // namespace

extern "C" int probe_take_along(const void* table, const void* idx, void* out, int rows,
                                int cols, int t_rows, int t_cols, int axis, int loop, int mod,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const float* t = (const float*)table;
  const int* ix = (const int*)idx;
  float* o = (float*)out;
  const int extent = axis == 1 ? t_cols : t_rows;
  const int blocks = (rows * cols + kThreads - 1) / kThreads;
  if (extent == 0) {
    fill_nan_kernel<<<blocks, kThreads, 0, s>>>(o, rows * cols);
    return (int)cudaGetLastError();
  }
  if (loop == 1) {
    if (axis == 1 && mod > 0)
      launch_single<1, true>(t, ix, o, rows, cols, t_cols, extent, mod, s);
    else if (axis == 1)
      launch_single<1, false>(t, ix, o, rows, cols, t_cols, extent, 0, s);
    else if (mod > 0)
      launch_single<0, true>(t, ix, o, rows, cols, t_cols, extent, mod, s);
    else
      launch_single<0, false>(t, ix, o, rows, cols, t_cols, extent, 0, s);
    return (int)cudaGetLastError();
  }
  // The slice and the kChunk entries that repeat its start past mod.
  const int staged = (axis == 1 ? t_cols : t_rows * kLanes) + kChunk * (axis == 1 ? 1 : kLanes);
  if (staged <= kStageFloats) {
    const int warps = rows * ((cols + kLanes - 1) / kLanes);
    probe_take_along_loop_kernel<<<warps, kLanes, staged * sizeof(float), s>>>(
        t, ix, o, cols, t_rows, t_cols, axis, loop, mod);
    return (int)cudaGetLastError();
  }
  probe_take_along_kernel<<<blocks, kThreads, 0, s>>>(t, ix, o, rows, cols, t_rows, t_cols, axis,
                                                       loop, mod);
  return (int)cudaGetLastError();
}
