// An empty kernel: the launch floor beside which the gather probes'
// CUDA-graph times are read (chip_smoke.py phase 19).  It replaces no TPU
// kernel and runs on no path of the port; a probe that takes about this
// long is bound by its launch, not by its work.

#include <cuda_runtime.h>

namespace {

__global__ void launch_floor_kernel() {}

}  // namespace

extern "C" int launch_floor(void* stream) {
  launch_floor_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
