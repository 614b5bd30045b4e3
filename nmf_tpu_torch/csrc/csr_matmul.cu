// General CSR product:  out = X @ D  for one orientation of a general sparse
// X (ops/sparse_format.py: SparseCSR, CSRSide), D (cols x k) row-major.
//
// This kernel replaces no pallas_call.  The reference multiplies a general
// sparse X (a BCOO) with XLA's bcoo_dot_general (nmf_tpu/ops/matops.py:mm
// and mtm); the port holds such an X as row-major CSR in both orientations,
// so X @ D and X' @ D are both this product over rows.
//
// What bounds it on an H100: the gathers.  Every entry gathers one row of D
// (4k bytes: 512 at k = 128) for 2k flops; at ttt4 that is 17.6M gathers, 9
// GB from L2 against 0.25 GB of bytes read once, so the bytes-once bound is
// out of reach and the L2's rate and latency set the pace.  X' @ W gathers
// from W (163,000 x 128 floats, 83 MB), which does not fit the 50 MB L2.
//
// The summation order.  The rows are cut into pieces of at most
// CSR_PIECE_ENTRIES consecutive entries when the container is built
// (csr_piece_index); an empty row is one empty piece.  Each piece is summed
// from zero in CSR order, products and sums rounded apart (no fused
// multiply-add): acc = acc + v * D[c].  A row of one piece is stored as its
// piece's sum, so it keeps the bits of the band kernel (coo_matmul.cu) over
// the same row; an empty row is stored as zeros.  A row of several pieces is
// ((p0 + p1) + p2) + ... over its pieces' sums in piece order (the second
// pass, combine_kernel).  Nothing is atomic: the same inputs give the same
// bits on every run, and the column slabs below change no bit (a column is
// summed on its own).
//
// Design, against the four limits of the band kernel over whole rows:
// * Long rows.  A warp takes one piece, not one row, so the longest row
//   (34,051 entries of X' at ttt4) is spread over many warps and no warp's
//   walk is longer than a piece.
// * One gather in flight.  The lanes own V adjacent columns each (V = 4
//   where k % 4 == 0 and D, out and the scratch are 16-byte aligned, 2 where
//   they are 8-byte aligned and k is even, else 1; a smaller V where the
//   slab is narrower than a warp's 32 V columns) and stage 32 (column,
//   value) pairs with one coalesced load each, the next round's pairs
//   loaded before this round's gathers.  A warp then issues the gathers of GROUP entries as one
//   basic block of unconditional loads from valid addresses (lanes past the
//   piece's end hold the piece's first column) before the first add waits
//   on one.
// * The operand and the L2.  A launch may cut the columns into slabs
//   (blockIdx.y), each slab's pieces walked before the next slab's start,
//   so that a slab of D fits the L2, and may read the pairs with
//   evict-first loads (stream_loads), so that they do not push D's rows out
//   of it.  At ttt4 the slabs lost: 64-column slabs of W (42 MB) cost 5-16 %
//   on X' @ W, 32-column ones 61-78 %; evict-first loads were faster in 13
//   of 16 readings, by up to 7 % (PERF.md, chip_smoke.py phase
//   kernels_general_csr).  So the wrapper passes one slab and evict-first
//   loads; the slabs and the read-only path stay launch options for that
//   measurement.
// * The extra pass over the output.  Every row is written once, by its
//   piece's warp or by the second pass: the wrapper allocates out with
//   torch.empty.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
// (tools/time_csr_variants.py builds the file with other values)
#ifndef WARPS
#define WARPS 4  // a block: a warp a piece
#endif
#ifndef GROUP
#define GROUP 8  // gathers a warp issues before the first add waits on one
#endif

namespace {

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void axpy(T& a, float w, T x) {
    a = __fadd_rn(a, __fmul_rn(w, x));
  }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void axpy(T& a, float w, T x) {
    a.x = __fadd_rn(a.x, __fmul_rn(w, x.x));
    a.y = __fadd_rn(a.y, __fmul_rn(w, x.y));
  }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void axpy(T& a, float w, T x) {
    a.x = __fadd_rn(a.x, __fmul_rn(w, x.x));
    a.y = __fadd_rn(a.y, __fmul_rn(w, x.y));
    a.z = __fadd_rn(a.z, __fmul_rn(w, x.z));
    a.w = __fadd_rn(a.w, __fmul_rn(w, x.w));
  }
};

// a column and a value of the piece: evict-first or through the read-only
// path
template <bool STREAM>
__device__ __forceinline__ void load_pair(const int* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          int e, int& c, float& v) {
  if (STREAM) {
    c = __ldcs(cols + e);
    v = __ldcs(vals + e);
  } else {
    c = __ldg(cols + e);
    v = __ldg(vals + e);
  }
}

// One warp a piece; blockIdx.y is the column slab (slab columns, a multiple
// of V).  A piece of a row of one piece writes the row of out, any other
// piece its slot of parts.
template <int V, bool STREAM>
__global__ void __launch_bounds__(WARPS * 32)
piece_kernel(const int* __restrict__ piece_ptr, const int* __restrict__ piece_row,
             const int* __restrict__ piece_part, const int* __restrict__ cols,
             const float* __restrict__ vals, const float* __restrict__ D,
             float* __restrict__ out, float* __restrict__ parts, int n_pieces,
             int k, int slab) {
  using T = typename Vec<V>::T;
  const int piece = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (piece >= n_pieces) return;
  const int lane = threadIdx.x & 31;
  const int beg = piece_ptr[piece], end = piece_ptr[piece + 1];
  const int part = piece_part[piece];
  T* dst = reinterpret_cast<T*>(part < 0 ? out + (size_t)piece_row[piece] * k
                                         : parts + (size_t)part * k);
  const T* Dv = reinterpret_cast<const T*>(D);
  const int kv = k / V;
  const int v0 = blockIdx.y * (slab / V);
  const int v1 = min(v0 + slab / V, kv);
  for (int jv = v0 + lane; jv - lane < v1; jv += 32) {  // the same trips warp-wide
    const int js = jv < v1 ? jv : v0;  // a valid column for the gathers
    T acc = Vec<V>::zero();
    int c = 0;
    float v = 0.f;
    if (beg < end)
      load_pair<STREAM>(cols, vals, beg + lane < end ? beg + lane : beg, c, v);
    for (int e0 = beg; e0 < end; e0 += 32) {
      const int n = min(32, end - e0);
      int cn;
      float vn;
      const int nx = e0 + 32 + lane;
      load_pair<STREAM>(cols, vals, nx < end ? nx : beg, cn, vn);
      for (int g = 0; g < n; g += GROUP) {
        T x[GROUP];
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const int cu = __shfl_sync(FULL_MASK, c, g + u);
          x[u] = __ldg(Dv + (size_t)cu * kv + js);
        }
#pragma unroll
        for (int u = 0; u < GROUP; ++u) {
          const float vu = __shfl_sync(FULL_MASK, v, g + u);
          if (g + u < n) Vec<V>::axpy(acc, vu, x[u]);
        }
      }
      c = cn;
      v = vn;
    }
    if (jv < v1) dst[jv] = acc;
  }
}

// A split row = its pieces' sums added in piece order; blockIdx.x is the
// split row.
__global__ void __launch_bounds__(128)
combine_kernel(const int* __restrict__ split_ptr, const int* __restrict__ split_row,
               const float* __restrict__ parts, float* __restrict__ out, int k) {
  const int s = blockIdx.x;
  const int p0 = split_ptr[s];
  const int np = split_ptr[s + 1] - p0;
  const float* src = parts + (size_t)p0 * k;
  float* dst = out + (size_t)split_row[s] * k;
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    float sum = src[j];
    for (int q = 1; q < np; ++q) sum = __fadd_rn(sum, src[(size_t)q * k + j]);
    dst[j] = sum;
  }
}

template <int V, bool STREAM>
int launch_pieces(const int* piece_ptr, const int* piece_row, const int* piece_part,
                  const int* cols, const float* vals, const float* D, float* out,
                  float* parts, int n_pieces, int k, int slab, cudaStream_t s) {
  const dim3 grid((n_pieces + WARPS - 1) / WARPS, (k + slab - 1) / slab);
  piece_kernel<V, STREAM><<<grid, WARPS * 32, 0, s>>>(
      piece_ptr, piece_row, piece_part, cols, vals, D, out, parts, n_pieces, k,
      slab);
  return (int)cudaGetLastError();
}

template <bool STREAM>
int launch_v(int vec, const int* piece_ptr, const int* piece_row,
             const int* piece_part, const int* cols, const float* vals,
             const float* D, float* out, float* parts, int n_pieces, int k,
             int slab, cudaStream_t s) {
  if (vec == 4)
    return launch_pieces<4, STREAM>(piece_ptr, piece_row, piece_part, cols, vals,
                                    D, out, parts, n_pieces, k, slab, s);
  if (vec == 2)
    return launch_pieces<2, STREAM>(piece_ptr, piece_row, piece_part, cols, vals,
                                    D, out, parts, n_pieces, k, slab, s);
  return launch_pieces<1, STREAM>(piece_ptr, piece_row, piece_part, cols, vals, D,
                                  out, parts, n_pieces, k, slab, s);
}

}  // namespace

// out (rows x k) = X @ D (cols x k) over the pieces of one CSR orientation,
// in column slabs of slab columns (k for one slab; else a multiple of 4);
// parts holds n_parts x k floats of scratch for the split rows' partial
// sums.  stream_loads != 0 reads the columns and values with evict-first
// loads.  Returns the CUDA error code of the first failed launch (0 =
// success).
extern "C" int nmf_csr_matmul(const int* piece_ptr, const int* piece_row,
                              const int* piece_part, const int* split_ptr,
                              const int* split_row, const int* cols,
                              const float* vals, const float* D, float* out,
                              float* parts, int n_pieces, int n_split, int k,
                              int slab, int stream_loads, void* stream) {
  if (n_pieces <= 0 || k <= 0) return 0;
  if (slab <= 0 || slab > k) slab = k;
  const cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t a = (uintptr_t)D | (uintptr_t)out | (uintptr_t)parts;
  int vec = 1;
  if (k % 4 == 0 && a % 16 == 0)
    vec = 4;
  else if (k % 2 == 0 && a % 8 == 0)
    vec = 2;
  // a slab narrower than a warp's 32 V columns takes a smaller V
  while (vec > 1 && (slab % vec != 0 || slab < 32 * vec)) vec /= 2;
  int err = stream_loads
                ? launch_v<true>(vec, piece_ptr, piece_row, piece_part, cols, vals,
                                 D, out, parts, n_pieces, k, slab, s)
                : launch_v<false>(vec, piece_ptr, piece_row, piece_part, cols, vals,
                                  D, out, parts, n_pieces, k, slab, s);
  if (err || n_split <= 0) return err;
  combine_kernel<<<n_split, 128, 0, s>>>(split_ptr, split_row, parts, out, k);
  return (int)cudaGetLastError();
}
