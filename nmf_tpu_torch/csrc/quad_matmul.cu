// Quad-tail sparse-dense product:  out += X_quad @ D.
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_quad_kernel
// (launched by _tiled_quad_impl).  Tiles with few nonzeros share a 128-slot
// chunk: 128 / seg tiles of one (stripe, col panel), each in its own run of
// seg slots (a sub-segment, seg = 32 or 16) with its own row panel.  Per
// slot the kernel gathers the row of D at the slot's column, scales it by
// the slot's value and adds it into the slot's row of the sub-segment's
// 128-row output panel.
//
// What bounds it on an H100: bytes.  A stored nonzero costs 12 bytes of
// store plus one gathered row of D (k floats) for 2k flops.  D is read again
// for every nonzero of a column, mostly from the 50 MB L2, and the floor is
// the store, D and the output moved once each.
//
// Design: one thread block owns one 128-row output panel, as the chunk
// kernel does, and walks the panel's list of sub-segments (the store's
// row-panel index over sub-segments, which leaves out the sub-segments
// nothing was packed into).  The sub-segments of one chunk feed different
// panels, so a chunk is visited by up to 128 / seg blocks, each reading only
// its own seg slots: nothing is shared between blocks and nothing is atomic.
// A round stages 128 / seg sub-segments at once, 128 slots, one coalesced
// run of seg slots each; the slots that hold a value are packed to the
// front in slot order (a ballot and a count per warp), so the walk is as
// long as the entries the round has and the order of summation is fixed by
// the store: results are the same from run to run.  Thread j owns column j
// of the panel (128 x k floats in shared memory, zeroed at the start); the
// gathers of 8 slots are started together before their adds.  The panel is
// added to the output once at the end by a plain read-add-write; a panel
// without any sub-segment leaves its rows of the output untouched.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 128
#define UNROLL 8

__global__ void __launch_bounds__(TILE)
quad_matmul_kernel(const int* __restrict__ qpanel_ptr,
                   const int* __restrict__ qpanel_segs,
                   const int* __restrict__ qwin_panel,
                   const int* __restrict__ qlrows,
                   const int* __restrict__ qlcols,
                   const float* __restrict__ qvals,
                   const float* __restrict__ D,
                   float* __restrict__ out,
                   int qgroup, int seg, int rows, int k) {
  extern __shared__ float acc[];  // TILE x k, row-major
  __shared__ int s_row[TILE];     // row in the panel
  __shared__ int s_col[TILE];     // column in the matrix
  __shared__ float s_val[TILE];
  __shared__ int s_cnt[TILE / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int panel = blockIdx.x;
  const int beg = qpanel_ptr[panel];
  const int end = qpanel_ptr[panel + 1];
  if (beg == end) return;  // the whole block: no barrier is left waiting

  const int npan = TILE * k;
  for (int i = tid; i < npan; i += TILE) acc[i] = 0.f;

  const int nper = TILE / seg;  // sub-segments in a chunk, and in a round
  const int sub = tid / seg;    // the staged sub-segment this thread reads
  const int off = tid % seg;    // its slot there
  for (int it = beg; it < end; it += nper) {
    float v = 0.f;
    int lr = 0, gc = 0;
    if (it + sub < end) {
      const int sg = qpanel_segs[it + sub];
      const int chunk = sg / nper;
      const size_t slot = (size_t)chunk * TILE + (sg % nper) * seg + off;
      v = qvals[slot];
      lr = qlrows[slot];
      gc = qwin_panel[chunk / qgroup] * TILE + qlcols[slot];
    }
    const unsigned m = __ballot_sync(0xffffffffu, v != 0.f);
    if (lane == 0) s_cnt[warp] = __popc(m);
    __syncthreads();  // counts are in; the previous round's slots are consumed
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < TILE / 32; ++w) {
      const int c = s_cnt[w];
      if (w < warp) before += c;
      total += c;
    }
    if (v != 0.f) {
      const int pos = before + __popc(m & ((1u << lane) - 1u));
      s_val[pos] = v;
      s_row[pos] = lr;
      s_col[pos] = gc;
    }
    if (tid >= total) {  // the tail reads as slots that add zero
      s_val[tid] = 0.f;
      s_row[tid] = 0;
      s_col[tid] = 0;
    }
    __syncthreads();
    for (int j = tid; j < k; j += TILE) {
      for (int s0 = 0; s0 < total; s0 += UNROLL) {
        float d[UNROLL];
        int r[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const float vv = s_val[s0 + u];
          r[u] = s_row[s0 + u];
          d[u] = (vv != 0.f) ? vv * D[(size_t)s_col[s0 + u] * k + j] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) acc[r[u] * k + j] += d[u];
      }
    }
  }
  __syncthreads();  // every column of the panel is final
  const int valid = min(TILE, rows - panel * TILE) * k;
  float* dst = out + (size_t)panel * TILE * k;
  for (int i = tid; i < valid; i += TILE) dst[i] += acc[i];
}

// out (rows x k) += quad store @ D (cols x k); seg is 32 or 16.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int nmf_quad_matmul(const int* qpanel_ptr, const int* qpanel_segs,
                               const int* qwin_panel, const int* qlrows,
                               const int* qlcols, const float* qvals,
                               const float* D, float* out, int n_rowpanels,
                               int qgroup, int seg, int rows, int k,
                               void* stream) {
  if (n_rowpanels <= 0) return 0;
  if (seg != 32 && seg != 16) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)TILE * k * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      quad_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  quad_matmul_kernel<<<n_rowpanels, TILE, smem, (cudaStream_t)stream>>>(
      qpanel_ptr, qpanel_segs, qwin_panel, qlrows, qlcols, qvals, D, out,
      qgroup, seg, rows, k);
  return (int)cudaGetLastError();
}
