// The transfer-function gradient of the two recompute-backward kernels,
// store_grid_bwd.cu (K2) and exact_march_bwd.cu (K4): one accumulator that
// both share, over an n-entry TF: n = 256 (kTfSize) in K2 and in K4's fixed
// instances, where every n below folds to that constant (K2's code stays
// what it is); any n up to exact_sample.cuh's kSharedTfMax in K4's shared
// instances, whose table lies in dynamic shared memory; any larger n in
// K4's global instances, whose "table" is the global d_tf itself.  A sample
// at TF coordinate s (bins i0 = floor(s) and i1 = min(i0 + 1, n - 1), lerp
// weight wt) adds its (w g_r, w g_g, w g_b,
// dL/da) x (1 - wt) to bin i0 and x wt to bin i1, as the plain versions'
// two index_add_ do (shearwarp_grad.store_grid_backward_reference,
// raycast.march_exact_backward_reference).
//
// Where those sums are taken, in two pieces:
//
// 1. A run in registers.  Each thread keeps its current i0 and the eight
//    partial sums of bins i0 and i1, adds each sample to them, and flushes
//    only when i0 changes and once when its ray ends.  Along a ray through
//    a smooth field a run spans several samples; on the trainers' flat
//    start (every density 0.5) it spans the whole ray.
// 2. A warp-aggregated flush.  The lanes that flush the same bin at the
//    same time (__match_any_sync over the active lanes: flushes happen in
//    divergent code) sum their runs with shuffles, and one lane adds the
//    sum to the block's n x 4 table in shared memory with shared atomics.
//    At the end of the block the table is added to the global d_tf, one
//    float atomic per non-zero entry.  K4's global instances (a TF too
//    large for shared memory) give d_tf as the table: the flush's atomics
//    go to L2 and there is no end-of-block pass.
//
// So a sample's TF gradient reaches shared memory only through a run's
// flush: on the trainers' flat start, one shared atomic per bin and warp
// instead of one per sample.  One table per warp, against contention
// between warps, gave nothing once these two were in (PERF.md), so the
// block has one.
//
// Numerics: the runs and the tree sum add in another order than one atomic
// per sample; the order of the atomics still changes from run to run.
#pragma once

#include <cuda_runtime.h>

#include "sweep_sample.cuh"

namespace tfgrad {

using sweep::kTfSize;
constexpr int kTableFloats = kTfSize * 4;  // the block's 256x4 table at n = 256

__device__ __forceinline__ unsigned lane_id() {
  unsigned lane;
  asm("mov.u32 %0, %%laneid;" : "=r"(lane));
  return lane;
}

// Thread `tid` of `threads` (linear in the block) zeroes its share of the
// n x 4 table.
__device__ __forceinline__ void zero_table(float* table, int tid, int threads,
                                           int n = kTfSize) {
  for (int i = tid; i < 4 * n; i += threads) table[i] = 0.0f;
}

// After a __syncthreads: the table added to the global d_tf with one
// atomic per non-zero entry.
__device__ __forceinline__ void add_table(const float* table, float* d_tf, int tid,
                                          int threads, int n = kTfSize) {
  for (int i = tid; i < 4 * n; i += threads) {
    const float x = table[i];
    if (x != 0.0f) atomicAdd(d_tf + i, x);
  }
}

// Sums v over the lanes of `peers` (which holds this lane; all of `active`
// call this together) into the lowest lane of `peers`, by a tree over the
// peers' ranks; true on that lane.
__device__ __forceinline__ bool sum_to_leader(unsigned active, unsigned peers,
                                              float (&v)[8]) {
  const unsigned lane = lane_id();
  unsigned rank = __popc(peers & ((1u << lane) - 1u));  // peers below this lane
  const bool leader = rank == 0;
  peers &= 0xfffffffeu << lane;  // the peers above this lane
  while (__any_sync(active, peers)) {
    const int next = __ffs(peers);  // 1 + the next peer's lane, 0 for none
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const float t = __shfl_sync(active, v[c], next - 1);
      if (next) v[c] += t;
    }
    // The odd ranks were added into the even ones below them: drop them.
    peers &= __ballot_sync(active, !(rank & 1u));
    rank >>= 1;
  }
  return leader;
}

// One thread's run: the samples since its TF bin i0 last changed, summed
// per channel for bin i0 (lo) and bin i1 (hi).
struct Run {
  int bin = -1;  // i0 of the run; -1: no sample yet
  float lo[4], hi[4];

  // Adds the run to the n x 4 `table` and empties it; nothing for an
  // empty run.
  __device__ __forceinline__ void flush(float* table, int n = kTfSize) {
    if (bin < 0) return;
    float v[8] = {lo[0], lo[1], lo[2], lo[3], hi[0], hi[1], hi[2], hi[3]};
    const unsigned active = __activemask();
    if (sum_to_leader(active, __match_any_sync(active, bin), v)) {
      float* b0 = table + 4 * bin;
      float* b1 = table + 4 * min(bin + 1, n - 1);  // bin n - 1: both halves there
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        atomicAdd(b0 + c, v[c]);
        atomicAdd(b1 + c, v[4 + c]);
      }
    }
    bin = -1;
  }

  // One sample: (r, g, b, a) split (1 - wt) to bin i0 and wt to bin i1.
  __device__ __forceinline__ void add(float* table, int i0, float wt, float r, float g,
                                      float b, float a, int n = kTfSize) {
    if (i0 != bin) {
      flush(table, n);
      bin = i0;
#pragma unroll
      for (int c = 0; c < 4; ++c) lo[c] = hi[c] = 0.0f;
    }
    const float w0 = 1.0f - wt;
    lo[0] += r * w0;
    lo[1] += g * w0;
    lo[2] += b * w0;
    lo[3] += a * w0;
    hi[0] += r * wt;
    hi[1] += g * wt;
    hi[2] += b * wt;
    hi[3] += a * wt;
  }
};

}  // namespace tfgrad
