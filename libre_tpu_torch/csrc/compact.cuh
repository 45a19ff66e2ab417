// Block-wide ordered compaction: how the forward kernels build their
// per-tile work lists in shared memory, the sweeps post_sweep.cu (K1) and
// pre_sweep.cu (K5) their planes (sweep_list.cuh) and exact_march.cu (K3)
// its bricks.
#pragma once

#include <cuda_runtime.h>

namespace compact {

// One round of the compaction, called by every thread of a CTA of kWarps
// full warps with whether it keeps its item.  The kept items take the
// list's next positions from n_list on, in thread order (a ballot, then
// prefix counts over the warps), put(pos) writes each to its position, and
// n_list grows by the round's count on every thread.  The first barrier
// publishes the warps' counts; the second keeps them, and the list, until
// every thread has read and written.
template <int kWarps, typename Put>
__device__ __forceinline__ void append(bool keep, int tid, int* s_count, int& n_list,
                                       Put put) {
  const int lane = tid & 31, warp = tid >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) s_count[warp] = __popc(ballot);
  __syncthreads();
  int pos = n_list + __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < kWarps; ++w) {
    pos += w < warp ? s_count[w] : 0;
    n_list += s_count[w];
  }
  if (keep) put(pos);
  __syncthreads();
}

}  // namespace compact
