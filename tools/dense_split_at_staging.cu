// Kernel 2 (the dense-tile product, nmf_tpu_torch/csrc/dense_matmul.cu)
// with its 3xTF32 split done once an element, while staging, instead of
// where each fragment is read: the measured alternative, kept for
// tools/time_dense_split.py.  Everything else is the product's own design:
// pieces, a per-block accumulator, cp.async staging, mma.sync.m16n8k8.tf32.
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
//   (col, row)) and B = D_panel is N-major, so fragments are read from
//   shared memory by each thread.  8 warps, each a 64 x 32 piece of the
//   128 x 128 output: 4 x 4 mma tiles.
// * Rounding.  The tensor cores add with truncation, so a long chain in
//   one accumulator drifts downward: each block's product is summed in its
//   own accumulator (48 tensor-core adds per element) and then added to the
//   piece's float32 sum on the CUDA cores, round to nearest.
// * Split once, while staging.  A slice is 32 deep: 32 rows of the tile and
//   32 rows of D (zeros past cols and past k).  Each thread copies its share
//   with cp.async (16 bytes, or 4 where a D row is not 16-byte aligned, i.e.
//   k % 4 != 0) into a raw buffer, and one slice later splits the same
//   elements into (hi, lo) pairs in a second buffer, whose 132-pair rows
//   make the 8-byte fragment reads conflict-free.  Raw slices and pairs are
//   double-buffered: slice s + 2 is in flight and slice s + 1 is split while
//   slice s is multiplied; one barrier a slice.

#include <cuda_runtime.h>
#include <stdint.h>

#include "piece_combine.cuh"

#define BK 32                 // reduction depth of one staged slice
#define NTHREADS 256          // 8 warps: 2 along the rows x 4 along k
#define LDP (TILE + 4)        // pairs a staged row: conflict-free fragments
#define SLICES (TILE / BK)    // slices a block

namespace {

struct Raw {  // one slice as copied
  float a[BK][TILE];  // tile slice, [reduction][row]
  float b[BK][TILE];  // D slice, [reduction][column]
};
struct Pairs {  // one slice split: (hi, lo) of each element
  float2 a[BK][LDP];
  float2 b[BK][LDP];
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// n bytes from src (0: zero fill; src is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// a rounded to TF32 as cvt.rna.tf32.f32 rounds (to nearest, ties away from
// zero, the low 13 bits cleared), in two integer operations
__device__ __forceinline__ float tf32(float a) {
  return __uint_as_float((__float_as_uint(a) + 0x1000u) & 0xffffe000u);
}

// (hi, lo), both TF32, hi + lo = a to 2^-22 of a
__device__ __forceinline__ float2 split(float a) {
  const float hi = tf32(a);
  return make_float2(hi, tf32(a - hi));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// This thread's share of a slice: element e of the tile slice is
// (row, col) = (id >> 5, (id & 31) * 4 + u) for id = threadIdx.x + i *
// NTHREADS; of the D slice the same for VEC = 4 (16-byte copies of D rows:
// k % 4 == 0, D 16-byte aligned), and (id >> 7, id & 127) for VEC = 1.
template <int VEC>
__device__ __forceinline__ void at(int i, int& r, int& x) {
  const int id = threadIdx.x + i * NTHREADS;
  r = VEC == 4 ? id >> 5 : id >> 7;
  x = VEC == 4 ? (id & 31) * 4 : id & (TILE - 1);
}

// Issues the copies of this thread's share of the slice at depth c0 of one
// block into raw.
template <int VEC>
__device__ __forceinline__ void stage_copy(Raw& raw, const float* tile,
                                           const float* D, int cbase, int c0,
                                           int j0, int cols, int k) {
#pragma unroll
  for (int i = 0; i < BK * TILE / 4 / NTHREADS; ++i) {
    int r, x;
    at<4>(i, r, x);
    cp_async16(&raw.a[r][x], tile + (c0 + r) * TILE + x, 16);
  }
#pragma unroll
  for (int i = 0; i < BK * TILE / VEC / NTHREADS; ++i) {
    int r, x;
    at<VEC>(i, r, x);
    const int dcol = cbase + c0 + r;
    const int j = j0 + x;
    const bool ok = dcol < cols && j < k;
    const float* src = ok ? D + (size_t)dcol * k + j : D;
    if (VEC == 4)
      cp_async16(&raw.b[r][x], src, ok ? 16 : 0);
    else
      cp_async4(&raw.b[r][x], src, ok ? 4 : 0);
  }
}

// Splits this thread's share of raw (landed) into pairs.
template <int VEC>
__device__ __forceinline__ void stage_split(const Raw& raw, Pairs& pr) {
#pragma unroll
  for (int i = 0; i < BK * TILE / 4 / NTHREADS; ++i) {
    int r, x;
    at<4>(i, r, x);
    const float4 v = *reinterpret_cast<const float4*>(&raw.a[r][x]);
    const float2 p0 = split(v.x), p1 = split(v.y), p2 = split(v.z),
                 p3 = split(v.w);
    *reinterpret_cast<float4*>(&pr.a[r][x]) = make_float4(p0.x, p0.y, p1.x, p1.y);
    *reinterpret_cast<float4*>(&pr.a[r][x + 2]) =
        make_float4(p2.x, p2.y, p3.x, p3.y);
  }
#pragma unroll
  for (int i = 0; i < BK * TILE / VEC / NTHREADS; ++i) {
    int r, x;
    at<VEC>(i, r, x);
#pragma unroll
    for (int u = 0; u < VEC; ++u) pr.b[r][x + u] = split(raw.b[r][x + u]);
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
  Raw* raw = reinterpret_cast<Raw*>(smem);
  Pairs* pairs = reinterpret_cast<Pairs*>(smem + 2 * sizeof(Raw));
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

  auto copy = [&](int s) {  // slice s into raw[s % 2], if there is one
    if (s < n_slices) {
      const int b = dpanel_blocks[beg + s / SLICES];
      stage_copy<VEC>(raw[s & 1], dvals + (size_t)b * TILE * TILE, D,
                      dblk_panel[b / dgroup] * TILE, (s % SLICES) * BK, j0,
                      cols, k);
    }
    cp_commit();  // one group a slice, empty past the end
  };

  copy(0);
  copy(1);
  cp_wait<1>();
  stage_split<VEC>(raw[0], pairs[0]);
  __syncthreads();
  for (int s = 0; s < n_slices; ++s) {
    if (s + 1 < n_slices) {  // the thread's own copies: no barrier needed
      cp_wait<0>();
      stage_split<VEC>(raw[(s + 1) & 1], pairs[(s + 1) & 1]);
    }
    copy(s + 2);
    const Pairs& pr = pairs[s & 1];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 8) {
      uint32_t bh[4][2], bl[4][2], ah[4][4], al[4][4];
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + ni * 8 + g;
        const float2 b0 = pr.b[kk + t][n], b1 = pr.b[kk + t + 4][n];
        bh[ni][0] = __float_as_uint(b0.x);
        bl[ni][0] = __float_as_uint(b0.y);
        bh[ni][1] = __float_as_uint(b1.x);
        bl[ni][1] = __float_as_uint(b1.y);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int m = m0 + mi * 16 + g;
        const float2 a[4] = {pr.a[kk + t][m], pr.a[kk + t][m + 8],
                             pr.a[kk + t + 4][m], pr.a[kk + t + 4][m + 8]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ah[mi][e] = __float_as_uint(a[e].x);
          al[mi][e] = __float_as_uint(a[e].y);
        }
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
    __syncthreads();  // pairs of slice s + 1 complete; of slice s read
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
  const int smem = 2 * (int)(sizeof(Raw) + sizeof(Pairs));
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
extern "C" int x_dense_staged(const int* piece_ptr, const int* piece_panel,
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
