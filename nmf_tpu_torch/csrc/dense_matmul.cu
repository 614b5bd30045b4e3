// Dense-tile product:  out += X_dense @ D.
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_dense_kernel
// (launched by _tiled_dense_impl).  Tiles with many nonzeros are stored as
// plain 128 x 128 float blocks in (col, row) layout; for every block the
// 128-row output panel gets  block' (rows x cols) @ D_panel (cols x k).
//
// What bounds it on an H100: operations.  A block is 64 KB of store for
// 2 * 128 * 128 * k flops (4.2 MFLOP at k = 128).  The TPU kernel gets exact
// fp32 out of its bf16 matrix unit by splitting each operand (HIGHEST); the
// counterpart here is the 3xTF32 split on the tensor cores: each operand
// element a becomes hi = tf32(a) (cvt.rna) and lo = tf32(a - hi), and
// lo.hi' + hi.lo' + hi.hi' is accumulated in float32 by
// mma.sync.m16n8k8.tf32 (the lo.lo' term is below float32's rounding).
// Three TF32 passes at 495 TFLOP/s take about as long as reading the blocks
// once at 3.35 TB/s.
//
// Design.
// * Balance.  The host cuts each row panel's list of dense blocks into
//   pieces of at most a few blocks (ops/sparse_format.py:_cut_pieces,
//   DENSE_PIECE_BLOCKS); one thread block runs one piece times one
//   128-column slice of k.  A panel of one piece adds its result into out;
//   the pieces of a split panel write partial panels to scratch, and
//   piece_combine.cuh adds them into out in piece order.  No atomics: the
//   same inputs give the same bits on every run.
// * Tensor cores through mma.sync.  wgmma takes TF32 operands only K-major
//   from shared memory; here A = tile' is M-major (the tile is stored
//   (col, row)) and B = D_panel is N-major, so each thread reads its
//   fragments from shared memory, whose 136-float rows make those reads
//   conflict-free.  8 warps, each a 64 x 32 piece of the 128 x 128 output:
//   4 x 4 mma tiles.
// * Rounding.  The tensor cores add with truncation, so a long chain in
//   one accumulator drifts downward: each block's product is summed in its
//   own accumulator (48 tensor-core adds per element) and then added to the
//   piece's float32 sum on the CUDA cores, round to nearest.
// * Staging.  A slice is 64 deep: 64 rows of the tile and 64 rows of D
//   (zeros past cols and past k), copied with cp.async (16 bytes, or 4 where
//   a D row is not 16-byte aligned, i.e. k % 4 != 0) into a ring of STAGES
//   slices; two are in flight while one is multiplied; one barrier a slice.
// * The split where it is used.  Each fragment element is split as it is
//   read from shared memory, cvt.rna's rounding done in two integer
//   operations.  Splitting each element once, while staging, into (hi, lo)
//   pairs was measured slower (tools/dense_split_at_staging.cu and
//   tools/time_dense_split.py; PERF.md): it doubles the shared-memory bytes
//   the fragments read and adds a pass between two barriers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "piece_combine.cuh"

#define BK 64                 // reduction depth of one staged slice
#define STAGES 3              // slices in the ring
#define NTHREADS 256          // 8 warps: 2 along the rows x 4 along k
#define LDS (TILE + 8)        // floats a staged row: conflict-free fragments
#define SLICES (TILE / BK)    // slices a block

namespace {

struct Stage {
  float a[BK][LDS];  // tile slice, [reduction][row]
  float b[BK][LDS];  // D slice, [reduction][column]
};

using namespace cp_async;

// a rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero, the low 13 bits cleared), in two integer operations
__device__ __forceinline__ uint32_t tf32(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}

// a = hi + lo, both TF32, to 2^-22 of a
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32(a);
  lo = tf32(a - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Issues the copies of this thread's share of the slice at depth c0 of one
// block into st.  VEC: 4 = 16-byte copies of D rows (k % 4 == 0, D 16-byte
// aligned), 1 = 4-byte copies.
template <int VEC>
__device__ __forceinline__ void stage_copy(Stage& st, const float* tile,
                                           const float* D, int cbase, int c0,
                                           int j0, int cols, int k) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < BK * TILE / 4 / NTHREADS; ++i) {
    const int id = tid + i * NTHREADS;
    const int r = id >> 5, x = (id & 31) * 4;
    cp_async16(&st.a[r][x], tile + (c0 + r) * TILE + x, 16);
  }
#pragma unroll
  for (int i = 0; i < BK * TILE / VEC / NTHREADS; ++i) {
    const int id = tid + i * NTHREADS;
    const int r = VEC == 4 ? id >> 5 : id >> 7;
    const int x = VEC == 4 ? (id & 31) * 4 : id & (TILE - 1);
    const int dcol = cbase + c0 + r;
    const int j = j0 + x;
    const bool ok = dcol < cols && j < k;
    const float* src = ok ? D + (size_t)dcol * k + j : D;
    if (VEC == 4)
      cp_async16(&st.b[r][x], src, ok ? 16 : 0);
    else
      cp_async4(&st.b[r][x], src, ok ? 4 : 0);
  }
}

template <int VEC>
__global__ void __launch_bounds__(NTHREADS, 1)
dense_piece_kernel(const int* __restrict__ piece_ptr,
                   const int* __restrict__ piece_panel,
                   const int* __restrict__ piece_part,
                   const int* __restrict__ dpanel_blocks,
                   const int* __restrict__ dblk_panel,
                   const float* __restrict__ dvals,
                   const float* __restrict__ D, float* __restrict__ out,
                   float* __restrict__ parts, int dgroup, int rows, int cols,
                   int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  Stage* stages = reinterpret_cast<Stage*>(smem);
  // the column slices of one piece are neighbours in the grid, so the
  // piece's blocks come from device memory once and then from L2
  const int nslab = (k + TILE - 1) / TILE;
  const int p = blockIdx.x / nslab;
  const int j0 = blockIdx.x % nslab * TILE;
  const int beg = piece_ptr[p];
  const int n_slices = (piece_ptr[p + 1] - beg) * SLICES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 1) * 64;   // the warp's rows
  const int n0 = (warp >> 1) * 32;  // the warp's columns

  float acc[4][4][4], blk[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = blk[mi][ni][e] = 0.f;

  auto copy = [&](int s) {  // slice s into its stage, if there is one
    if (s < n_slices) {
      const int b = dpanel_blocks[beg + s / SLICES];
      stage_copy<VEC>(stages[s % STAGES], dvals + (size_t)b * TILE * TILE, D,
                      dblk_panel[b / dgroup] * TILE, (s % SLICES) * BK, j0,
                      cols, k);
    }
    cp_commit();  // one group a slice, empty past the end
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) copy(s);
  for (int s = 0; s < n_slices; ++s) {
    cp_wait<STAGES - 2>();  // this thread's copies of slice s landed
    __syncthreads();        // everyone's; and slice s - 1 read by all
    copy(s + STAGES - 1);   // into slice s - 1's stage
    const Stage& st = stages[s % STAGES];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bh[4][2], bl[4][2], ah[4][4], al[4][4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + ni * 8 + g;
        split(st.b[kk + t][n], bh[ni][0], bl[ni][0]);
        split(st.b[kk + t + 4][n], bh[ni][1], bl[ni][1]);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = m0 + mi * 16 + g;
        split(st.a[kk + t][m], ah[mi][0], al[mi][0]);
        split(st.a[kk + t][m + 8], ah[mi][1], al[mi][1]);
        split(st.a[kk + t + 4][m], ah[mi][2], al[mi][2]);
        split(st.a[kk + t + 4][m + 8], ah[mi][3], al[mi][3]);
      }
      // the small terms first; 16 independent products between two that
      // add into one accumulator
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(blk[mi][ni], al[mi], bh[ni]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(blk[mi][ni], ah[mi], bl[ni]);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma(blk[mi][ni], ah[mi], bh[ni]);
    }
    if (s % SLICES == SLICES - 1) {  // a block done: into the piece's sum
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            acc[mi][ni][e] += blk[mi][ni][e];
            blk[mi][ni][e] = 0.f;
          }
    }
  }
  cp_wait<0>();

  const int part = piece_part[p];
  const int panel = piece_panel[p];
  float* dst = part >= 0 ? parts + (size_t)part * TILE * k
                         : out + (size_t)panel * TILE * k;
  const int valid = part >= 0 ? TILE : min(TILE, rows - panel * TILE);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + mi * 16 + g + 8 * h;
      if (r >= valid) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + n0 + ni * 8 + 2 * t + e;
          if (j >= k) continue;
          float* o = dst + (size_t)r * k + j;
          const float v = acc[mi][ni][2 * h + e];
          *o = part >= 0 ? v : *o + v;
        }
    }
}

template <int VEC>
int launch_pieces(const int* piece_ptr, const int* piece_panel,
                  const int* piece_part, const int* dpanel_blocks,
                  const int* dblk_panel, const float* dvals, const float* D,
                  float* out, float* parts, int n_pieces, int dgroup, int rows,
                  int cols, int k, cudaStream_t stream) {
  const int smem = STAGES * (int)sizeof(Stage);
  cudaError_t e = cudaFuncSetAttribute(
      dense_piece_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  dense_piece_kernel<VEC><<<n_pieces * ((k + TILE - 1) / TILE), NTHREADS,
                            smem, stream>>>(
      piece_ptr, piece_panel, piece_part, dpanel_blocks, dblk_panel, dvals, D,
      out, parts, dgroup, rows, cols, k);
  return (int)cudaGetLastError();
}

}  // namespace

// out (rows x k) += dense store @ D (cols x k), piece by piece; parts holds
// the partial panels of the split panels (n_parts x 128 x k).  dvals must
// start on a 16-byte boundary.  Returns the CUDA error code of the launches
// (0 = success).
extern "C" int nmf_dense_matmul(const int* piece_ptr, const int* piece_panel,
                                const int* piece_part, const int* split_ptr,
                                const int* split_panel,
                                const int* dpanel_blocks, const int* dblk_panel,
                                const float* dvals, const float* D, float* out,
                                float* parts, int n_pieces, int n_split,
                                int dgroup, int rows, int cols, int k,
                                void* stream) {
  if (n_pieces <= 0 || k <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool wide = k % 4 == 0 && (uintptr_t)D % 16 == 0;
  const int e =
      wide ? launch_pieces<4>(piece_ptr, piece_panel, piece_part,
                              dpanel_blocks, dblk_panel, dvals, D, out, parts,
                              n_pieces, dgroup, rows, cols, k, s)
           : launch_pieces<1>(piece_ptr, piece_panel, piece_part,
                              dpanel_blocks, dblk_panel, dvals, D, out, parts,
                              n_pieces, dgroup, rows, cols, k, s);
  if (e) return e;
  return piece_walk::launch_combine(split_ptr, split_panel, parts, out,
                                    n_split, rows, k, 1, s);
}
