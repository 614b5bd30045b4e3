// The walk shared by the sampled products over the chunk store
// (chunk_sddmm.cu, kernel 4) and over the quad store (quad_sddmm.cu,
// kernel 5):  out[slot] = (W @ H)[row(slot), col(slot)], 0 at padding
// slots.  Both stores hold their entries in *items* of 2^shift slots,
// entries at the front (chunks of 128 slots; quad sub-segments of 32 or
// 16), each item feeding one 128-row panel; the row-panel index cuts each
// panel's list of items with entries into pieces (the ones kernels 1 and 3
// walk).  A slot's value is the dot product of one row of W and one column
// of H.
//
// What bounds it on an H100: bytes.  A slot costs 4 bytes of output, a real
// one its coordinates too, and two gathered rows of k floats for 2k flops.
// The floor is the real slots' coordinates, the items' counts, W, H and the
// output moved once each; the gathers (1 KB a slot at k = 128, 2.4 GB on the
// ttt4 chunk store) must come from the caches.
//
// Design.  One thread block a piece.  All items of a piece sample rows of
// one 128-row panel of W, so the block stages that panel once in shared
// memory (TILE x k floats, cp.async; k <= SD_STAGE_K) and gathers only H's
// rows, which the 50 MB L2 holds at k = 128.  The block scans its items'
// counts, in runs of SD_NT items, and passes over their slots in order: a
// padding slot is written 0, a real one has its coordinates and refresh
// map read (coalesced, SD_PASS slots' loads in flight a thread) into tables
// in shared memory, SD_SLOTS real slots at a time.  Then the block walks the
// tabled slots only: a group of G lanes (a power of two, 16 floats a lane at
// most: G = 8 at k = 128; the wrapper's ops/cuda/sparse.py:sddmm_lanes)
// samples a slot, so that nothing but the H gathers stands between the
// tables and the sums; each lane sums its floats in increasing order and the
// group adds the lanes' sums with a butterfly of shuffles in a fixed order,
// so two runs give the same bits and nothing is atomic.  Padding slots are
// written 0: an item's tail by its piece's block, and the items without
// entries (listed in no piece) by the blocks past the pieces, SD_ZERO_SLOTS
// slots each.  Every slot is written once.  An item's column panel is its
// window's: the window of chunk (first slot >> 7) / group; a chunk tile may
// span several col panels (wide tail tiles): the local column then runs to
// span * 128 and the window's panel counts wide panels.  Any k >= 1: above
// SD_STAGE_K the W rows are gathered as H's are.
//
// What held the one-warp kernel back (a block a chunk, a warp walking its
// real slots one after another) was latency: the entries sit at the front
// of an item, so one warp of four worked, one slot in flight, and a block
// for every chunk of mostly padding.  The sizes here (512 threads, two
// blocks an SM by registers; G = 8; one slot a group; tables of 2,048
// slots) were chosen with tools/time_sddmm_variants.py on the chunk store
// on an H100; its numbers in PERF.md.

#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

#define TILE 128
#define SD_NT 512           // threads a block
#define SD_STAGE_K 192      // largest k whose W panel is staged in shared memory
#define SD_ZERO_SLOTS 32768 // slots a zeroing block covers (256 chunks)
#define SD_SLOTS 2048       // real slots whose coordinates a block tables at once
#define SD_PASS 8           // slots a thread reads at once when it fills the tables
// the most dynamic shared memory a block takes: the staged W panel
#define SD_SMEM (TILE * SD_STAGE_K * 4)

// Internal linkage: each translation unit its own kernels and launch
// flags, never merged with another library's by the dynamic loader.
namespace sddmm_piece {
namespace {

using namespace cp_async;

// A slot's local coordinates as one word, ``lcol << 7 | lrow``: a chunk
// slot stores them so; a quad slot keeps its row and its column (< 128) in
// two arrays, packed as they are read.
struct PackedCoords {
  const int* __restrict__ coords;
  __device__ __forceinline__ int load(int slot) const { return coords[slot]; }
};
struct SplitCoords {
  const int* __restrict__ lcols;
  const int* __restrict__ lrows;
  __device__ __forceinline__ int load(int slot) const {
    return lcols[slot] << 7 | lrows[slot];
  }
};

// Writes 0 to every slot of z0 .. z0 + SD_ZERO_SLOTS whose item (2^SHIFT
// slots, at least 4) has no entry: four slots a thread, one 16-byte store
// where out is 16-byte aligned (n_slots is a multiple of 16).
template <int SHIFT>
__device__ __forceinline__ void zero_empty_items(const int* nreal, float* out,
                                                 int z0, int n_slots) {
  static_assert(SHIFT >= 2, "an item holds whole runs of four slots");
  const int end = min(n_slots - z0, SD_ZERO_SLOTS);
  const bool vec = ((uintptr_t)out & 15) == 0;
  for (int s = 4 * threadIdx.x; s < end; s += 4 * SD_NT) {
    if (nreal[(z0 + s) >> SHIFT] != 0) continue;
    if (vec) {
      *reinterpret_cast<float4*>(out + z0 + s) = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) out[z0 + s + e] = 0.f;
    }
  }
}

// Exclusive scan of v over the block (in thread order) into scan[0 ..
// SD_NT]; scan[SD_NT] is the total.  warp_tot: SD_NT / 32 ints of scratch.
__device__ __forceinline__ void block_scan(int v, int* scan, int* warp_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_tot[w];
  scan[threadIdx.x + 1] = before + x;
  if (threadIdx.x == 0) scan[0] = 0;
}

// sum_j w[j] h[j] over this lane's share (j = l, l + G, ..., in increasing
// order) of one slot; ``ok``: the slot is real (else 0, nothing read).
// VEC: k % 4 == 0 and both rows 16-byte aligned, float4 a step.
template <bool VEC>
__device__ __forceinline__ float lane_dot(const float* w, const float* h,
                                          bool ok, int l, int G, int k) {
  const int len = VEC ? k >> 2 : k;
  float acc = 0.f;
  for (int j0 = l; j0 < len; j0 += 4 * G) {
    if (VEC) {
      float4 hb[4];  // the gathers first, all in flight together
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + t * G;
        hb[t] = ok && j < len ? reinterpret_cast<const float4*>(h)[j]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + t * G;
        if (ok && j < len) {
          const float4 a = reinterpret_cast<const float4*>(w)[j];
          acc = fmaf(a.x, hb[t].x, acc);
          acc = fmaf(a.y, hb[t].y, acc);
          acc = fmaf(a.z, hb[t].z, acc);
          acc = fmaf(a.w, hb[t].w, acc);
        }
      }
    } else {
      float hb[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + t * G;
        hb[t] = ok && j < len ? h[j] : 0.f;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int j = j0 + t * G;
        if (ok && j < len) acc = fmaf(w[j], hb[t], acc);
      }
    }
  }
  return acc;
}

// Blocks 0 .. n_pieces - 1: one piece each; the rest zero the items without
// entries.  SHIFT: log2 of an item's slots (a constant, so that the walk's
// arithmetic takes no registers: two blocks of SD_NT threads an SM want at
// most 64 a thread); ``g``: lanes a slot, a power of two up to 32.
template <class Coords, int SHIFT, bool VEC, bool STAGED>
__global__ void __launch_bounds__(SD_NT)
sddmm_piece_kernel(const int* __restrict__ piece_ptr,
                   const int* __restrict__ piece_panel,
                   const int* __restrict__ panel_items,
                   const int* __restrict__ nreal,
                   const int* __restrict__ win_panel,
                   Coords st,
                   const int* __restrict__ inv,
                   const float* __restrict__ W,
                   const float* __restrict__ Ht,
                   float* __restrict__ out,
                   int n_pieces, int n_slots, int group, int span,
                   int rows, int cols, int k, int nnz, int g) {
  extern __shared__ __align__(16) float Ws[];  // TILE x kp: the panel's W rows
  __shared__ int scan[SD_NT + 1];
  __shared__ int cid[SD_NT];         // the run's items
  __shared__ int ccol[SD_NT];        // their first column
  __shared__ int warp_tot[SD_NT / 32];
  __shared__ int tab_slot[SD_SLOTS];  // a real slot's place in out
  __shared__ int tab_hw[SD_SLOTS];    // its col * TILE + local row; -1: not real
  if ((int)blockIdx.x >= n_pieces) {
    zero_empty_items<SHIFT>(nreal, out, (blockIdx.x - n_pieces) * SD_ZERO_SLOTS,
                            n_slots);
    return;
  }
  const int pbeg = piece_ptr[blockIdx.x], pend = piece_ptr[blockIdx.x + 1];
  if (pbeg == pend) return;  // a panel without items: nothing to write
  const int r0 = piece_panel[blockIdx.x] * TILE;  // the panel's first row
  const int kp = (k + 3) & ~3;
  if (STAGED) {  // W[r0 .. r0 + TILE, :k] into rows of kp floats, zero past both
    if (VEC) {
      const int k4 = k >> 2;
      for (int t = threadIdx.x; t < TILE * k4; t += SD_NT) {
        const int r = t / k4, q = t - r * k4;
        const bool ok = r0 + r < rows;
        cp_async16(Ws + r * kp + 4 * q, ok ? W + (size_t)(r0 + r) * k + 4 * q : W,
                   ok ? 16 : 0);
      }
    } else {
      for (int t = threadIdx.x; t < TILE * kp; t += SD_NT) {
        const int r = t / kp, c = t - r * kp;
        const bool ok = r0 + r < rows && c < k;
        cp_async4(Ws + t, ok ? W + (size_t)(r0 + r) * k + c : W, ok ? 4 : 0);
      }
    }
    cp_commit();
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int l = lane & (g - 1), gw = lane / g;  // lane in its group, group in the warp
  const int groups = 32 / g;                    // groups a warp: slots a round

  for (int b0 = pbeg; b0 < pend; b0 += SD_NT) {
    const int nb = min(SD_NT, pend - b0);
    __syncthreads();  // the previous run of items is done
    const int c = threadIdx.x < nb ? panel_items[b0 + threadIdx.x] : 0;
    block_scan(threadIdx.x < nb ? nreal[c] : 0, scan, warp_tot);
    cid[threadIdx.x] = c;
    ccol[threadIdx.x] =
        threadIdx.x < nb ? win_panel[(c >> (7 - SHIFT)) / group] * span * TILE : 0;
    __syncthreads();
    const int total = scan[nb];
    // the run's real slots, SD_SLOTS at a time (one window unless the
    // pieces were cut above the store's 2,048 entries); the first window
    // also zeroes the tails
    for (int w0 = 0; w0 == 0 || w0 < total; w0 += SD_SLOTS) {
      // every slot of the run's items in slot order: a padding slot is
      // written 0 (in the first window), a real slot of this window has its
      // coordinates and refresh map read (coalesced, SD_PASS slots' loads
      // in flight a thread) into the tables
      const int nslot = nb << SHIFT;
      for (int t0 = threadIdx.x; t0 < nslot; t0 += SD_NT * SD_PASS) {
        int cc[SD_PASS], iv[SD_PASS];
#pragma unroll
        for (int j = 0; j < SD_PASS; ++j) {
          const int t = t0 + j * SD_NT, i = t >> SHIFT, s = t & ((1 << SHIFT) - 1);
          const bool mine = t < nslot && s < scan[i + 1] - scan[i] &&
                            (unsigned)(scan[i] + s - w0) < SD_SLOTS;
          cc[j] = mine ? st.load((cid[i] << SHIFT) + s) : 0;
          iv[j] = mine ? inv[(cid[i] << SHIFT) + s] : nnz;
        }
#pragma unroll
        for (int j = 0; j < SD_PASS; ++j) {
          const int t = t0 + j * SD_NT, i = t >> SHIFT, s = t & ((1 << SHIFT) - 1);
          if (t >= nslot) break;
          const int slot = (cid[i] << SHIFT) + s;
          if (s >= scan[i + 1] - scan[i]) {
            if (w0 == 0) out[slot] = 0.f;
            continue;
          }
          const int e = scan[i] + s - w0;
          if (e < 0 || e >= SD_SLOTS) continue;
          const int col = ccol[i] + (cc[j] >> 7), lrow = cc[j] & (TILE - 1);
          const bool ok = iv[j] < nnz && r0 + lrow < rows && col < cols;
          tab_slot[e] = slot;
          tab_hw[e] = ok ? col * TILE + lrow : -1;
        }
      }
      if (STAGED && b0 == pbeg && w0 == 0) cp_wait<0>();
      __syncthreads();
      const int ne = min(SD_SLOTS, total - w0);
      // a slot a group; every lane of a warp takes the same number of
      // rounds (the shuffles want the whole warp)
      for (int base = warp * groups; base < ne; base += (SD_NT / 32) * groups) {
        const int e = base + gw;
        const bool mine = e < ne;
        const int hw = mine ? tab_hw[e] : -1;
        const int slot = mine ? tab_slot[e] : 0;
        const int lrow = hw & (TILE - 1), col = hw >> 7;
        const float* w = STAGED ? Ws + lrow * kp : W + (size_t)(r0 + lrow) * k;
        const float* h = Ht + (size_t)col * k;
        float acc = lane_dot<VEC>(w, h, hw >= 0, l, g, k);
        for (int off = g >> 1; off; off >>= 1)
          acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (mine && l == 0) out[slot] = acc;
      }
      __syncthreads();  // the tables are read
    }
  }
}

inline bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

template <class Coords, int SHIFT, bool VEC, bool STAGED>
int launch_kernel(const int* piece_ptr, const int* piece_panel,
                  const int* panel_items, const int* nreal,
                  const int* win_panel, Coords st, const int* inv,
                  const float* W, const float* Ht, float* out, int n_pieces,
                  int n_slots, int group, int span, int rows, int cols, int k,
                  int nnz, int g, cudaStream_t stream) {
  // the shared-memory attribute, once per device (bit d: device d)
  static unsigned ready = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (STAGED && (dev >= 32 || !(ready >> dev & 1))) {
    e = cudaFuncSetAttribute(sddmm_piece_kernel<Coords, SHIFT, VEC, STAGED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SD_SMEM);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) ready |= 1u << dev;
  }
  const int smem = STAGED ? TILE * ((k + 3) & ~3) * (int)sizeof(float) : 0;
  const int blocks = n_pieces + (n_slots + SD_ZERO_SLOTS - 1) / SD_ZERO_SLOTS;
  sddmm_piece_kernel<Coords, SHIFT, VEC, STAGED><<<blocks, SD_NT, smem, stream>>>(
      piece_ptr, piece_panel, panel_items, nreal, win_panel, st, inv, W, Ht,
      out, n_pieces, n_slots, group, span, rows, cols, k, nnz, g);
  return (int)cudaGetLastError();
}

// out (n_items * 2^SHIFT slots) = (W @ Ht') at every stored slot, 0 at
// padding slots.  W is (rows x k), Ht is (cols x k), both row-major; the
// pieces (piece_ptr, piece_panel over panel_items) and the items' counts
// nreal come from the store's row-panel index; ``g`` lanes sample a slot (a
// power of two up to 32).  Returns the CUDA error code of the launch.
template <class Coords, int SHIFT>
int launch(const int* piece_ptr, const int* piece_panel,
           const int* panel_items, const int* nreal, const int* win_panel,
           Coords st, const int* inv, const float* W, const float* Ht,
           float* out, int n_pieces, int n_items, int group, int span,
           int rows, int cols, int k, int nnz, int g, cudaStream_t stream) {
  if (n_items <= 0) return 0;
  if (k <= 0 || n_pieces < 0 || g < 1 || g > 32 || (g & (g - 1)) ||
      n_items > (INT_MAX >> SHIFT) || cols > INT_MAX / TILE)
    return (int)cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && aligned16(W) && aligned16(Ht);
  const bool staged = k <= SD_STAGE_K;
  auto go = vec ? (staged ? launch_kernel<Coords, SHIFT, true, true>
                          : launch_kernel<Coords, SHIFT, true, false>)
                : (staged ? launch_kernel<Coords, SHIFT, false, true>
                          : launch_kernel<Coords, SHIFT, false, false>);
  return go(piece_ptr, piece_panel, panel_items, nreal, win_panel, st, inv, W,
            Ht, out, n_pieces, n_items << SHIFT, group, span, rows, cols, k,
            nnz, g, stream);
}

}  // namespace
}  // namespace sddmm_piece
