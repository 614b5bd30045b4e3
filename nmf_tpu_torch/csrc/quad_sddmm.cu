// Sampled product over the quad store:  out[slot] = (W @ H)[row(slot), col(slot)].
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_sddmm_quad_kernel
// (launched by _tiled_sddmm_quad_impl).  A quad chunk holds 128 / seg small
// tiles of one (stripe, col panel), each in its own run of seg slots (seg =
// 32 or 16) with its own row panel; a slot stores its row and its column
// inside the tile.  The value wanted at a slot is the dot product of one row
// of W and one column of H.
//
// What bounds it on an H100: bytes.  A slot costs 12 bytes of store and
// output and two gathered rows of k floats for 2k flops; the floor is the
// coordinates, W, H and the output moved once each.  This kernel also reads
// the refresh map, 4 bytes a slot on top of that floor, to tell padding
// slots from stored entries.
//
// Design: one thread block takes one chunk, one warp 32 consecutive slots
// (one sub-segment at seg 32, two at seg 16), sampled by the routine of
// sddmm_warp.cuh.  A thread finds its row panel through its sub-segment.
// Most slots of a quad chunk are padding, and a sub-segment nothing was
// packed into reads row panel 0 and coordinates (0, 0): the refresh map marks
// every such slot (it points one past the last stored entry), the kernel
// writes 0 there and samples no position, and the work follows the entries
// the data has.  Any k >= 1.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sddmm_warp.cuh"

#define TILE 128

template <bool VEC>
__global__ void __launch_bounds__(TILE)
quad_sddmm_kernel(const int* __restrict__ qlrows,
                  const int* __restrict__ qlcols,
                  const int* __restrict__ qinv,
                  const int* __restrict__ q_rp,
                  const int* __restrict__ qwin_panel,
                  const int* __restrict__ qwin_stripe,
                  const float* __restrict__ W,
                  const float* __restrict__ Ht,
                  float* __restrict__ out,
                  int qgroup, int seg, int pps, int rows, int cols, int k,
                  int nnz) {
  const int chunk = blockIdx.x;
  const size_t slot = (size_t)chunk * TILE + threadIdx.x;
  const int win = chunk / qgroup;
  const int stripe = qwin_stripe[win];
  const int rp = q_rp[chunk * (TILE / seg) + threadIdx.x / seg];
  const int row = (stripe * pps + rp) * TILE + qlrows[slot];
  const int col = qwin_panel[win] * TILE + qlcols[slot];
  const bool real = qinv[slot] < nnz && stripe >= 0 && row < rows && col < cols;
  out[slot] = sddmm_warp_sample<VEC>(W, Ht, row, col, real, k);
}

// out (n_qchunks * 128) = (W @ Ht') at every stored slot of the quad store,
// 0 at padding slots.  W is (rows x k), Ht is (cols x k), both row-major;
// seg is 32 or 16.  Returns the CUDA error code of the launch (0 = success).
extern "C" int nmf_quad_sddmm(const int* qlrows, const int* qlcols,
                              const int* qinv, const int* q_rp,
                              const int* qwin_panel, const int* qwin_stripe,
                              const float* W, const float* Ht, float* out,
                              int n_qchunks, int qgroup, int seg, int pps,
                              int rows, int cols, int k, int nnz,
                              void* stream) {
  if (n_qchunks <= 0) return 0;
  if (seg != 32 && seg != 16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (k % 4 == 0)
    quad_sddmm_kernel<true><<<n_qchunks, TILE, 0, st>>>(
        qlrows, qlcols, qinv, q_rp, qwin_panel, qwin_stripe, W, Ht, out,
        qgroup, seg, pps, rows, cols, k, nnz);
  else
    quad_sddmm_kernel<false><<<n_qchunks, TILE, 0, st>>>(
        qlrows, qlcols, qinv, q_rp, qwin_panel, qwin_stripe, W, Ht, out,
        qgroup, seg, pps, rows, cols, k, nnz);
  return (int)cudaGetLastError();
}
