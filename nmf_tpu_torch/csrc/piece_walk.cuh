// The walk shared by the chunk and quad-tail products (chunk_matmul.cu,
// quad_matmul.cu): one thread block adds one *piece* of a 128-row output
// panel's work list into the panel, held in shared memory; a second pass adds
// the partial panels of a panel cut into several pieces, in piece order.
//
// What bounds both products on an H100: bytes, the latency of the gathers
// that move them, and the instructions each entry costs.  A stored entry
// costs 8-12 bytes of store and one gathered row of D (k floats, 512
// contiguous bytes at k = 128, mostly from the 50 MB L2) for 2k flops; each
// entry also reads and writes a row of the panel in shared memory.
//
// Design.
// * Balance.  The host cuts each panel's list of items (chunks, or quad
//   sub-segments) into pieces of at most a few thousand entries
//   (ops/sparse_format.py:_cut_pieces), so the heaviest panel of a
//   degree-ordered store is spread over many blocks and the grid holds many
//   more blocks than the card keeps resident.
// * A fixed order.  A panel of one piece is written straight to the output;
//   the pieces of a split panel each write a partial panel to a scratch
//   tensor, and combine_kernel adds them in piece order.  Nothing is atomic,
//   so the same inputs give the same bits on every run.
// * Warps on their own.  A block is two warps; each thread owns V = 2
//   adjacent columns of the panel (V = 1 for an odd k), a warp 32 V columns
//   of every 64 V, and no other warp touches them: the block needs no
//   barrier.  Every warp walks the whole piece, and each of its instructions
//   serves V columns (8-byte gathers and panel updates at V = 2).
// * Entries packed into rounds of 32.  A batch is 32 consecutive items of
//   the piece, one per lane, with their counts of entries (the real slots
//   sit at the front of an item) summed across the lanes; a round takes the
//   batch's next 32 entries across item boundaries, lane e staging entry e
//   (its row in the panel, the row of D, its value) with a binary search for
//   its item.  Only real slots are read.  The next round is staged before
//   the current one's gathers, so its loads overlap them; the items of the
//   next two batches are read ahead.
// * 32 gathers in flight a warp: the gathers of a round are one basic block
//   of unconditional loads from valid addresses (lanes past the round's
//   entries read row 0 of D and add 0 to row 0 of the panel), issued before
//   the first add waits on one; then the adds run in entry order, which is
//   the store's order (item order, then slot order).

#pragma once

#include <cuda_runtime.h>

#define TILE 128
#define FULL_MASK 0xffffffffu
#define WARPS 2  // a block

namespace piece_walk {

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ T sum(T a, T b) { return a + b; }
  static __device__ __forceinline__ void add(float& a, float w, float x) {
    a += w != 0.f ? w * x : 0.f;
  }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ T sum(T a, T b) {
    return make_float2(a.x + b.x, a.y + b.y);
  }
  static __device__ __forceinline__ void add(float2& a, float w, float2 x) {
    a.x += w != 0.f ? w * x.x : 0.f;
    a.y += w != 0.f ? w * x.y : 0.f;
  }
};

// Adds one round of 32 staged entries into the warp's columns of the panel;
// lane u holds entry u (row in the panel, row of D, value).
template <int V>
static __device__ __forceinline__ void add_round(float* acc,
                                                 const float* __restrict__ D,
                                                 int k, int row, int drow,
                                                 float v) {
  using T = typename Vec<V>::T;
  const int lane = threadIdx.x & 31;
  for (int c0 = (threadIdx.x >> 5) * 32 * V; c0 < k; c0 += WARPS * 32 * V) {
    const int j = c0 + V * lane;  // the same loop for the whole warp
    const T* Dj = reinterpret_cast<const T*>(D + min(j, k - V));
    const int kv = k / V;
    T x[32];
    float w[32];
    int r[32];
#pragma unroll
    for (int u = 0; u < 32; ++u) {
      w[u] = __shfl_sync(FULL_MASK, v, u);
      r[u] = __shfl_sync(FULL_MASK, row, u);
      x[u] = __ldg(Dj + (size_t)__shfl_sync(FULL_MASK, drow, u) * kv);
    }
    if (j < k) {
      T* col = reinterpret_cast<T*>(acc + j);
#pragma unroll
      for (int u = 0; u < 32; ++u) Vec<V>::add(col[r[u] * kv], w[u], x[u]);
    }
  }
}

// Zeroes the warp's columns of the panel acc (TILE x k in shared memory) and
// adds items[b0:end] into them.  Items are read through Store::item(id, n,
// first slot, col panel) and Store::slot(slot, col panel, row, drow, value).
template <class Store, int V>
static __device__ __forceinline__ void walk_piece(const Store& st, int b0,
                                                  int end,
                                                  const int* __restrict__ items,
                                                  const float* __restrict__ D,
                                                  float* acc, int k) {
  using T = typename Vec<V>::T;
  const int lane = threadIdx.x & 31;
  const int col0 = (threadIdx.x >> 5) * 32 * V;
  const int kv = k / V;
  if (col0 >= k) return;  // a whole warp without a column
  for (int j = col0 + V * lane; j < k; j += WARPS * 32 * V) {
    T* a = reinterpret_cast<T*>(acc + j);
    for (int r = 0; r < TILE; ++r) a[r * kv] = Vec<V>::zero();
  }
  // b0: the first item of the current batch
  if (b0 < end) {
    // this lane's item of the current batch: entries before it in the
    // batch, its first slot, its col panel; total = entries in the batch.
    // (n1, sb1, cp1) are those of the next batch, (n2, sb2, cp2) of the one
    // after, id2 the items of the one after that.
    int ex = 0, total = 0, cp = 0;
    long long sb = 0;
    int n1 = 0, cp1 = 0, n2 = 0, cp2 = 0;
    long long sb1 = 0, sb2 = 0;
    const int id0 = b0 + lane < end ? items[b0 + lane] : -1;
    const int idn = b0 + 32 + lane < end ? items[b0 + 32 + lane] : -1;
    int id2 = b0 + 64 + lane < end ? items[b0 + 64 + lane] : -1;
    if (id0 >= 0) st.item(id0, n1, sb1, cp1);
    if (idn >= 0) st.item(idn, n2, sb2, cp2);
    auto next_batch = [&]() {  // the batch at b0 becomes the current one
      sb = sb1;
      cp = cp1;
      int inc = n1;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(FULL_MASK, inc, o);
        if (lane >= o) inc += t;
      }
      ex = inc - n1;
      total = __shfl_sync(FULL_MASK, inc, 31);
      n1 = n2;
      sb1 = sb2;
      cp1 = cp2;
      n2 = 0;
      if (id2 >= 0) st.item(id2, n2, sb2, cp2);
      id2 = b0 + 96 + lane < end ? items[b0 + 96 + lane] : -1;
    };
    // lane e stages entry pos0 + e of the batch
    auto stage = [&](int pos0, int& row, int& drow, float& v) {
      const int pos = pos0 + lane;
      int s = 0;  // the last item starting at or before pos
#pragma unroll
      for (int step = 16; step; step >>= 1) {
        const int t = __shfl_sync(FULL_MASK, ex, s + step);
        if (t <= pos) s += step;
      }
      const long long sbs = __shfl_sync(FULL_MASK, sb, s);
      const int cps = __shfl_sync(FULL_MASK, cp, s);
      const int exs = __shfl_sync(FULL_MASK, ex, s);
      row = 0;
      drow = 0;
      v = 0.f;
      if (pos < total) st.slot(sbs + (pos - exs), cps, row, drow, v);
    };

    next_batch();
    int pos0 = 0, row, drow;
    float v;
    stage(pos0, row, drow, v);
    for (;;) {
      int nrow = 0, ndrow = 0;
      float nv = 0.f;
      bool more = true;
      if (pos0 + 32 < total) {
        pos0 += 32;
      } else if (b0 + 32 < end) {
        b0 += 32;
        next_batch();
        pos0 = 0;
      } else {
        more = false;
      }
      if (more) stage(pos0, nrow, ndrow, nv);
      add_round<V>(acc, D, k, row, drow, v);
      if (!more) break;
      row = nrow;
      drow = ndrow;
      v = nv;
    }
  }
}

// One block a piece.
template <class Store, int V>
__global__ void __launch_bounds__(WARPS * 32)
piece_kernel(Store st, const int* __restrict__ piece_ptr,
             const int* __restrict__ piece_panel,
             const int* __restrict__ piece_part, const int* __restrict__ items,
             const float* __restrict__ D, float* __restrict__ out,
             float* __restrict__ parts, int rows, int k, int accumulate) {
  using T = typename Vec<V>::T;
  extern __shared__ float acc[];  // TILE x k, row-major
  const int lane = threadIdx.x & 31;
  const int col0 = (threadIdx.x >> 5) * 32 * V;
  const int kv = k / V;
  const int p = blockIdx.x;
  walk_piece<Store, V>(st, piece_ptr[p], piece_ptr[p + 1], items, D, acc, k);

  const int part = piece_part[p];
  const int panel = piece_panel[p];
  const int valid = part >= 0 ? TILE : min(TILE, rows - panel * TILE);
  float* dst = part >= 0 ? parts + (size_t)part * TILE * k
                         : out + (size_t)panel * TILE * k;
  const bool add = part < 0 && accumulate;
  for (int j = col0 + V * lane; j < k; j += WARPS * 32 * V) {
    T* d = reinterpret_cast<T*>(dst + j);
    const T* a = reinterpret_cast<const T*>(acc + j);
    // 16 rows at a time, their reads of the output issued together
    for (int r0 = 0; r0 < valid; r0 += 16) {
      T o[16];
#pragma unroll
      for (int u = 0; u < 16; ++u)
        o[u] = add && r0 + u < valid ? d[(r0 + u) * kv] : Vec<V>::zero();
#pragma unroll
      for (int u = 0; u < 16; ++u)
        if (r0 + u < valid)
          d[(r0 + u) * kv] = add ? Vec<V>::sum(o[u], a[(r0 + u) * kv])
                                 : a[(r0 + u) * kv];
    }
  }
}

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

template <class Store, int V>
static int launch_pieces(Store st, const int* piece_ptr, const int* piece_panel,
                         const int* piece_part, const int* items,
                         const float* D, float* out, float* parts,
                         int n_pieces, int rows, int k, int accumulate,
                         cudaStream_t stream) {
  const size_t smem = (size_t)TILE * k * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      piece_kernel<Store, V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  piece_kernel<Store, V><<<n_pieces, WARPS * 32, smem, stream>>>(
      st, piece_ptr, piece_panel, piece_part, items, D, out, parts, rows, k,
      accumulate);
  return (int)cudaGetLastError();
}

// Both passes on one stream.  Returns the CUDA error code (0 = success).
template <class Store>
int launch(Store st, const int* piece_ptr, const int* piece_panel,
           const int* piece_part, const int* split_ptr, const int* split_panel,
           const int* items, const float* D, float* out, float* parts,
           int n_pieces, int n_split, int rows, int k, int accumulate,
           cudaStream_t stream) {
  if (n_pieces > 0) {
    // 8-byte gathers and panel updates need an even k
    const int e =
        k % 2 == 0
            ? launch_pieces<Store, 2>(st, piece_ptr, piece_panel, piece_part,
                                      items, D, out, parts, n_pieces, rows, k,
                                      accumulate, stream)
            : launch_pieces<Store, 1>(st, piece_ptr, piece_panel, piece_part,
                                      items, D, out, parts, n_pieces, rows, k,
                                      accumulate, stream);
    if (e) return e;
  }
  if (n_split > 0) {
    // about four floats a thread at k = 128
    const int per = (TILE * k + 1023) / 1024;
    combine_kernel<<<dim3(n_split, per), 256, 0, stream>>>(
        split_ptr, split_panel, parts, out, rows, k, accumulate);
    return (int)cudaGetLastError();
  }
  return 0;
}

}  // namespace piece_walk
