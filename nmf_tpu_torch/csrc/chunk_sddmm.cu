// Sampled product over the chunk store:  out[slot] = (W @ H)[row(slot), col(slot)].
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_sddmm_kernel_compact
// (launched by _tiled_sddmm_compact_impl).  Every 128-slot chunk holds local
// coordinates ``lcol << 7 | lrow`` inside one (row panel, col panel) tile; the
// value wanted at a slot is the dot product of one row of W and one column
// of H.
//
// What bounds it on an H100: bytes.  A slot costs 8 bytes of store and output
// and two gathered rows of k floats for 2k flops.  The rows of one chunk come
// from one 128-row panel of W and one 128-column panel of H, so the gathers
// hit the caches and the floor is coords, W, H and the output moved once
// each.  This kernel also reads the refresh map, 4 bytes a slot on top of
// that floor, to tell padding slots from stored entries.
//
// Design: one thread block takes one chunk, one warp 32 consecutive slots,
// sampled by the routine of sddmm_warp.cuh (two contiguous gathers a slot, a
// butterfly sum in a fixed order, nothing atomic).  Padding slots (the
// refresh map points them one past the last stored entry) and slots outside
// the matrix are skipped and give 0; on degree-ordered data most slots of
// the chunk store are padding, so the work follows the entries the data has.
// A chunk tile may span several col panels (wide tail tiles): the local
// column then runs to span * 128 and the window's panel counts wide panels.
// Any k >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sddmm_warp.cuh"

#define TILE 128

template <bool VEC>
__global__ void __launch_bounds__(TILE)
chunk_sddmm_kernel(const int* __restrict__ coords,
                   const int* __restrict__ inv,
                   const int* __restrict__ chunk_rp,
                   const int* __restrict__ win_panel,
                   const int* __restrict__ win_stripe,
                   const float* __restrict__ W,
                   const float* __restrict__ Ht,
                   float* __restrict__ out,
                   int group, int pps, int span, int rows, int cols, int k,
                   int nnz) {
  const int chunk = blockIdx.x;
  const size_t slot = (size_t)chunk * TILE + threadIdx.x;
  const int win = chunk / group;
  const int stripe = win_stripe[win];
  const int c = coords[slot];
  const int row = (stripe * pps + chunk_rp[chunk]) * TILE + (c & (TILE - 1));
  const int col = win_panel[win] * span * TILE + (c >> 7);
  const bool real = inv[slot] < nnz && stripe >= 0 && row < rows && col < cols;
  out[slot] = sddmm_warp_sample<VEC>(W, Ht, row, col, real, k);
}

// out (n_chunks * 128) = (W @ Ht') at every stored slot of the chunk store,
// 0 at padding slots.  W is (rows x k), Ht is (cols x k), both row-major.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int nmf_chunk_sddmm(const int* coords, const int* inv,
                               const int* chunk_rp, const int* win_panel,
                               const int* win_stripe, const float* W,
                               const float* Ht, float* out, int n_chunks,
                               int group, int pps, int span, int rows, int cols,
                               int k, int nnz, void* stream) {
  if (n_chunks <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (k % 4 == 0)
    chunk_sddmm_kernel<true><<<n_chunks, TILE, 0, st>>>(
        coords, inv, chunk_rp, win_panel, win_stripe, W, Ht, out, group, pps,
        span, rows, cols, k, nnz);
  else
    chunk_sddmm_kernel<false><<<n_chunks, TILE, 0, st>>>(
        coords, inv, chunk_rp, win_panel, win_stripe, W, Ht, out, group, pps,
        span, rows, cols, k, nnz);
  return (int)cudaGetLastError();
}
