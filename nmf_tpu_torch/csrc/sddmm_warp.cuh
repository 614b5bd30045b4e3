// One warp samples (W @ Ht') at up to 32 slots: the routine of the sampled
// product over the quad store (quad_sddmm.cu).  The chunk store's
// (chunk_sddmm.cu) walks its pieces with a group of lanes a slot instead.
//
// W is row-major (p, k) and Ht row-major (n, k), so both gathers are 4k
// contiguous bytes.  The warp visits its real slots one after the other: the
// 32 lanes read the two rows side by side (16 bytes a lane when k is a
// multiple of 4, VEC), multiply, and sum across the warp with a butterfly of
// shuffles, a fixed order, so two runs give the same bits and nothing is
// atomic.  Lane s keeps the sum of slot s; slots that are not real give 0.
// Every lane of the warp must make the call.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

template <bool VEC>
__device__ __forceinline__ float sddmm_warp_sample(const float* __restrict__ W,
                                                   const float* __restrict__ Ht,
                                                   int row, int col, bool real,
                                                   int k) {
  const int lane = threadIdx.x & 31;
  unsigned todo = __ballot_sync(0xffffffffu, real);
  float mine = 0.f;
  while (todo) {  // the same in every lane of the warp
    const int s = __ffs(todo) - 1;
    todo &= todo - 1;
    const float* w = W + (size_t)__shfl_sync(0xffffffffu, row, s) * k;
    const float* h = Ht + (size_t)__shfl_sync(0xffffffffu, col, s) * k;
    float acc = 0.f;
    if (VEC) {
      const float4* w4 = reinterpret_cast<const float4*>(w);
      const float4* h4 = reinterpret_cast<const float4*>(h);
      for (int j = lane; j < (k >> 2); j += 32) {
        const float4 a = w4[j];
        const float4 b = h4[j];
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
        acc = fmaf(a.z, b.z, acc);
        acc = fmaf(a.w, b.w, acc);
      }
    } else {
      for (int j = lane; j < k; j += 32) acc = fmaf(w[j], h[j], acc);
    }
#pragma unroll
    for (int off = 16; off; off >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == s) mine = acc;
  }
  return mine;
}
