// The per-tile plane lists of the two forward sweeps, post_sweep.cu (K1)
// and pre_sweep.cu (K5).  The plain PyTorch specification is
// libre_tpu_torch/ops/shearwarp_bricked.py::tile_planes_reference.
//
// One CTA owns a kTileU x kTileV tile of slope rays (v, u) and lists, in a
// prologue, the planes its rays can sample at: act[k] != 0 and the window
// [wb0, wb1) x [wc0, wc1) overlapping the tile's sample points
// xb = eb + ug*dl[k], xc = ec + vg*dl[k].  In f32 too, xb is monotone in the
// ray's u and xc in its v (each is a chain of rounded adds and products),
// so the tile's first and last rays bound them.  The list keeps the planes'
// front-to-back order (compact.cuh) and holds each plane's slices, axis
// weight and dl as one 16-byte struct, so a walk reads one shared word per
// plane instead of five global ones.  A sweep keeps its per-ray window and
// early-exit tests, so the list only has to be a superset of the planes the
// tile's rays sample at.
#pragma once

#include <cuda_runtime.h>

#include "compact.cuh"

namespace sweep {

// The tile of both sweeps: 32 rays along u (threadIdx.x) by 4 along v, one
// thread each.  At 32x8 K1 took 48 registers with a spill and ran 9-18%
// slower, and K5 ran 0.5-1.4% slower (PERF.md section 6).
constexpr int kTileU = 32;
constexpr int kTileV = 4;
constexpr int kThreads = kTileU * kTileV;
constexpr int kWarps = kThreads / 32;
// Planes one prologue lists.
constexpr int kPlaneChunk = 512;

// One listed plane: its two slices, axis weight and dl (one 16-byte load).
struct alignas(16) Plane {
  int a0, a1;
  float wa, dl;
};

// The prologue: writes to s_planes, in front-to-back order, the planes
// k0 .. k0 + chunk - 1 this CTA's tile of rays can sample at, and returns
// how many.  Every thread of the CTA calls it; view is (u0 du dv eb ec v0
// ...).
__device__ __forceinline__ int list_planes(
    Plane* s_planes, int* s_count, const int* __restrict__ act,
    const int* __restrict__ a0, const int* __restrict__ a1,
    const float* __restrict__ wa, const float* __restrict__ dl,
    const float* __restrict__ view, int k0, int chunk, int u_size, int v_size,
    float wb0, float wb1, float wc0, float wc1, int tid) {
  const int u_first = blockIdx.x * kTileU, v_first = blockIdx.y * kTileV;
  const float eb = view[3], ec = view[4];
  const float ug_first = view[0] + view[1] * (float)u_first;
  const float ug_last = view[0] + view[1] * (float)min(u_first + kTileU - 1, u_size - 1);
  const float vg_first = view[5] + view[2] * (float)v_first;
  const float vg_last = view[5] + view[2] * (float)min(v_first + kTileV - 1, v_size - 1);
  int n_list = 0;
  for (int base = 0; base < chunk; base += kThreads) {
    const int k = k0 + base + tid;
    bool keep = false;
    if (base + tid < chunk && act[k] != 0) {
      const float delta = dl[k];
      const float xb_a = eb + ug_first * delta, xb_b = eb + ug_last * delta;
      const float xc_a = ec + vg_first * delta, xc_b = ec + vg_last * delta;
      keep = fmaxf(xb_a, xb_b) >= wb0 && fminf(xb_a, xb_b) < wb1 &&
             fmaxf(xc_a, xc_b) >= wc0 && fminf(xc_a, xc_b) < wc1;
    }
    compact::append<kWarps>(keep, tid, s_count, n_list, [&](int pos) {
      s_planes[pos] = Plane{a0[k], a1[k], wa[k], dl[k]};
    });
  }
  return n_list;
}

}  // namespace sweep
