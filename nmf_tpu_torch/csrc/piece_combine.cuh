// The second pass of every product that cuts a row panel's work into pieces
// (piece_walk.cuh for the chunk and quad products, dense_matmul.cu): the
// pieces of a split panel have written partial panels to a scratch tensor,
// and this pass adds them in piece order, element by element, so that the
// same inputs give the same bits on every run and every k slab keeps its
// bits.

#pragma once

#include <cuda_runtime.h>

#ifndef TILE
#define TILE 128
#endif

namespace piece_walk {

// out panel (=, or += with accumulate) = partials of one split panel added in
// piece order; blockIdx.x is the split panel.
static __global__ void __launch_bounds__(256)
combine_kernel(const int* __restrict__ split_ptr,
               const int* __restrict__ split_panel,
               const float* __restrict__ parts, float* __restrict__ out,
               int rows, int k, int accumulate) {
  const int s = blockIdx.x;
  const int p0 = split_ptr[s];
  const int np = split_ptr[s + 1] - p0;
  const int panel = split_panel[s];
  const size_t stride = (size_t)TILE * k;
  const int valid = min(TILE, rows - panel * TILE) * k;
  const float* src = parts + (size_t)p0 * stride;
  float* dst = out + (size_t)panel * stride;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < valid;
       e += gridDim.y * blockDim.x) {
    float sum = src[e];
    for (int q = 1; q < np; ++q) sum += src[(size_t)q * stride + e];
    dst[e] = accumulate ? dst[e] + sum : sum;
  }
}

// Adds the partials of n_split split panels (n_parts x TILE x k in parts)
// into out.  Returns the CUDA error code of the launch (0 = success).
static inline int launch_combine(const int* split_ptr, const int* split_panel,
                                 const float* parts, float* out, int n_split,
                                 int rows, int k, int accumulate,
                                 cudaStream_t stream) {
  if (n_split <= 0) return 0;
  // about four floats a thread at k = 128
  const int per = (TILE * k + 1023) / 1024;
  combine_kernel<<<dim3(n_split, per), 256, 0, stream>>>(
      split_ptr, split_panel, parts, out, rows, k, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace piece_walk
