// The grid of a streaming kernel that walks its work in waves of resident
// blocks (a grid-stride loop): adam_update.cu and tf_lookup.cu.  Enough
// blocks of `threads` for `items` pieces of a thread's work, and no more
// than `per_sm` blocks on each SM of the current device; at least one.

#pragma once

#include <cuda_runtime.h>

namespace wave {

inline int blocks(long long items, int threads, int per_sm) {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long wanted = (items + threads - 1) / threads;
  const long long cap = (long long)(sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  return (int)(wanted < 1 ? 1 : (wanted < cap ? wanted : cap));
}

}  // namespace wave
