// Narrow-chunk sparse-dense product:  out = X_chunks @ D.
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_kernel_compact
// (launched by _tiled_matmul_compact_impl).  Per 128-slot chunk it gathers
// the row of D at each slot's column, scales it by the slot's value and adds
// it into the slot's row of the chunk's 128-row output panel.
//
// What bounds it on an H100: bytes.  Each stored nonzero costs 8 bytes of
// store plus one gathered row of D (k floats, 512 contiguous bytes at
// k = 128) for 2k flops, far below the card's flops-per-byte ratio.  D is
// read again for every nonzero of a column, so the gathers mostly hit the
// 50 MB L2, and the floor is the store, D and the output moved once each.
//
// Design: one thread block owns one 128-row output panel.  The panel
// (128 x k floats, 64 KB at k = 128) lives in shared memory, zeroed at the
// start and written to device memory once at the end, so blocks share no
// output and need no atomics.  The block walks the panel's chunk list (the
// store's row-panel index); thread j owns column j of the panel, so every
// thread visits the chunk's slots in stored order and the summation order
// is fixed: results are the same from run to run.  A chunk's 128 (coord,
// value) pairs are staged in shared memory by one coalesced load; trailing
// padding slots (value 0) are cut off with a ballot, and the gathers of 8
// slots are issued together before their adds to keep loads in flight.
// A chunk tile may span several col panels (wide tail tiles): a slot's local
// column then runs to span * 128 and the window's panel counts wide panels,
// so the gathered row is one index either way.
// Panels carry very different numbers of chunks on degree-ordered data;
// the heaviest panels come first in block order, nothing else balances them.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 128
#define UNROLL 8

__global__ void __launch_bounds__(TILE)
chunk_matmul_kernel(const int* __restrict__ panel_ptr,
                    const int* __restrict__ panel_chunks,
                    const int* __restrict__ win_panel,
                    const int* __restrict__ coords,
                    const float* __restrict__ vals,
                    const float* __restrict__ D,
                    float* __restrict__ out,
                    int group, int span, int rows, int k) {
  extern __shared__ float acc[];  // TILE x k, row-major
  __shared__ int s_coord[TILE];
  __shared__ float s_val[TILE];
  __shared__ unsigned s_mask[TILE / 32];

  const int tid = threadIdx.x;
  const int panel = blockIdx.x;
  const int npan = TILE * k;
  for (int i = tid; i < npan; i += TILE) acc[i] = 0.f;

  const int beg = panel_ptr[panel];
  const int end = panel_ptr[panel + 1];
  for (int it = beg; it < end; ++it) {
    const int chunk = panel_chunks[it];
    const size_t cbase = (size_t)win_panel[chunk / group] * span * TILE;
    __syncthreads();  // the previous chunk's staged slots are consumed
    const float v = vals[(size_t)chunk * TILE + tid];
    s_coord[tid] = coords[(size_t)chunk * TILE + tid];
    s_val[tid] = v;
    const unsigned m = __ballot_sync(0xffffffffu, v != 0.f);
    if ((tid & 31) == 0) s_mask[tid >> 5] = m;
    __syncthreads();
    int nreal = 0;  // one past the last slot with a nonzero value
    for (int w = TILE / 32 - 1; w >= 0; --w) {
      const unsigned mw = s_mask[w];
      if (mw) { nreal = w * 32 + 32 - __clz(mw); break; }
    }
    for (int j = tid; j < k; j += TILE) {
      for (int s0 = 0; s0 < nreal; s0 += UNROLL) {
        float d[UNROLL];
        int r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = s_coord[s0 + u];
          const float vv = s_val[s0 + u];
          r[u] = c & (TILE - 1);
          d[u] = (vv != 0.f) ? vv * D[(cbase + (size_t)(c >> 7)) * k + j] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc[r[u] * k + j] += d[u];
      }
    }
  }
  __syncthreads();
  const int valid = min(TILE, rows - panel * TILE) * k;
  float* dst = out + (size_t)panel * TILE * k;
  for (int i = tid; i < valid; i += TILE) dst[i] = acc[i];
}

// out (rows x k) = chunk store @ D (cols x k); every row of out is written.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int nmf_chunk_matmul(const int* panel_ptr, const int* panel_chunks,
                                const int* win_panel, const int* coords,
                                const float* vals, const float* D, float* out,
                                int n_rowpanels, int group, int span, int rows,
                                int k, void* stream) {
  if (n_rowpanels <= 0) return 0;
  const size_t smem = (size_t)TILE * k * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      chunk_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  chunk_matmul_kernel<<<n_rowpanels, TILE, smem, (cudaStream_t)stream>>>(
      panel_ptr, panel_chunks, win_panel, coords, vals, D, out, group, span, rows,
      k);
  return (int)cudaGetLastError();
}
