// Dense-tile product:  out += X_dense @ D.
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_dense_kernel
// (launched by _tiled_dense_impl).  Tiles with many nonzeros are stored as
// plain 128 x 128 float blocks in (col, row) layout; for every block the
// 128-row output panel gets  block' (rows x cols) @ D_panel (cols x k).
//
// What bounds it on an H100: operations.  A block is 64 KB of store for
// 2 * 128 * 128 * k flops (4.2 MFLOP at k = 128), 64 flops a byte, above the
// ratio of the fp32 CUDA-core peak to the memory rate (67 TFLOP/s over
// 3.35 TB/s = 20).  The product is exact fp32 by FMA on the CUDA cores: no
// tensor cores, no TF32, as the TPU kernel pins its highest precision.
//
// Design: one thread block owns one 128-row output panel (times one
// 128-column slice of k) and walks the panel's list of dense blocks (the
// store's row-panel index).  256 threads each keep an 8 x 8 piece of the
// 128 x 128 output in registers across ALL blocks of the panel, so the
// output is touched once, at the end, by a plain read-add-write: no other
// thread block shares the panel, so no atomics, and the summation order is
// fixed by the store.  Each 128 x 128 x 128 block product runs as eight
// 16-deep steps staged through shared memory (8 KB of the tile, 8 KB of D);
// a thread's 8 rows / columns are two runs of 4, 64 apart, so its shared
// memory reads are conflict-free float4s.  Panels of degree-ordered data
// carry very different numbers of blocks; nothing balances them.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 128
#define BK 16
#define NTHREADS 256

__global__ void __launch_bounds__(NTHREADS)
dense_matmul_kernel(const int* __restrict__ dpanel_ptr,
                    const int* __restrict__ dpanel_blocks,
                    const int* __restrict__ dblk_panel,
                    const float* __restrict__ dvals,
                    const float* __restrict__ D,
                    float* __restrict__ out,
                    int dgroup, int rows, int cols, int k) {
  const int panel = blockIdx.x;
  const int beg = dpanel_ptr[panel];
  const int end = dpanel_ptr[panel + 1];
  if (beg == end) return;

  __shared__ __align__(16) float As[BK][TILE];  // tile slice: [col][row]
  __shared__ __align__(16) float Bs[BK][TILE];  // D slice:    [col][j]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // owns columns tx*4 .. +3 and 64 + tx*4 .. +3
  const int ty = tid >> 4;  // owns rows    ty*4 .. +3 and 64 + ty*4 .. +3
  const int j0 = blockIdx.y * TILE;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int it = beg; it < end; ++it) {
    const int b = dpanel_blocks[it];
    const float* tile = dvals + (size_t)b * TILE * TILE;
    const int cbase = dblk_panel[b / dgroup] * TILE;
    for (int c0 = 0; c0 < TILE; c0 += BK) {
      __syncthreads();  // the previous slice is consumed
#pragma unroll
      for (int i = 0; i < BK * TILE / NTHREADS; ++i) {
        const int idx = tid + i * NTHREADS;
        const int c = idx >> 7;
        const int x = idx & (TILE - 1);
        As[c][x] = tile[(c0 + c) * TILE + x];
        const int dcol = cbase + c0 + c;
        const int j = j0 + x;
        Bs[c][x] = (dcol < cols && j < k) ? D[(size_t)dcol * k + j] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        const float4 a0 = *reinterpret_cast<const float4*>(&As[c][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&As[c][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[c][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[c][64 + tx * 4]);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bb[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = panel * TILE + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < k) out[(size_t)row * k + col] += acc[i][j];
    }
  }
}

// out (rows x k) += dense store @ D (cols x k).
// Returns the CUDA error code of the launch (0 = success).
extern "C" int nmf_dense_matmul(const int* dpanel_ptr, const int* dpanel_blocks,
                                const int* dblk_panel, const float* dvals,
                                const float* D, float* out, int n_rowpanels,
                                int dgroup, int rows, int cols, int k,
                                void* stream) {
  if (n_rowpanels <= 0 || k <= 0) return 0;
  dim3 grid(n_rowpanels, (k + TILE - 1) / TILE);
  dense_matmul_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
      dpanel_ptr, dpanel_blocks, dblk_panel, dvals, D, out, dgroup, rows, cols,
      k);
  return (int)cudaGetLastError();
}
