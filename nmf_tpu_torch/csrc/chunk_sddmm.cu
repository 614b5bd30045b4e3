// Sampled product over the chunk store:  out[slot] = (W @ H)[row(slot), col(slot)].
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/sparse.py:_make_sddmm_kernel_compact
// (launched by _tiled_sddmm_compact_impl).  Every 128-slot chunk holds local
// coordinates ``lcol << 7 | lrow`` inside one (row panel, col panel) tile; the
// value wanted at a slot is the dot product of one row of W and one column
// of H.
//
// What bounds it on an H100: bytes.  A slot costs 8 bytes of store and output
// and two gathered rows of k floats for 2k flops.  The floor is coords, W, H
// and the output moved once each; the gathers (1 KB a slot at k = 128, 2.4
// GB on the ttt4 chunk store) must come from the caches.
//
// Design.  The work follows the row-panel index and its pieces (the runs of
// at most PIECE_ENTRIES entries of one row panel's chunk list that kernel 1
// walks): one thread block a piece.  All chunks of a piece sample rows of
// one 128-row panel of W, so the block stages that panel once in shared
// memory (TILE x k floats, cp.async; k <= SD_STAGE_K) and gathers only H's
// rows, which the 50 MB L2 holds at k = 128.  A chunk's entries sit at its
// front (chunk_nreal of them); the block scans its chunks' counts, in runs
// of SD_NT chunks, and passes over their slots in order: a padding slot is
// written 0, a real one has its coordinates and refresh map read (coalesced,
// SD_PASS slots' loads in flight a thread) into tables in shared memory,
// SD_SLOTS real slots at a time.  Then the block walks the tabled slots
// only: a group of G lanes (a power of two, 16 floats a lane at most: G = 8
// at k = 128; the wrapper's ops/cuda/sparse.py:sddmm_lanes) samples a slot,
// so that nothing but the H gathers stands between the tables and the sums;
// each lane sums its floats in increasing order and the group adds the
// lanes' sums with a butterfly of shuffles in a fixed order, so two runs
// give the same bits and nothing is atomic.  Padding slots are
// written 0: a chunk's tail by its piece's block, and the chunks without
// entries (listed in no piece) by the blocks past the pieces,
// SD_ZERO_CHUNKS chunks each.  Every slot is written once.  A chunk tile may
// span several col panels (wide tail tiles): the local column then runs to
// span * 128 and the window's panel counts wide panels.  Any k >= 1: above
// SD_STAGE_K the W rows are gathered as H's are.
//
// What held the one-warp kernel back (a block a chunk, a warp walking its
// real slots one after another) was latency: the entries sit at the front
// of a chunk, so one warp of four worked, one slot in flight, and 90,346
// blocks of mostly padding.  The sizes here (512 threads, two blocks an SM
// by registers; G = 8; one slot a group; tables of 2,048 slots) were chosen
// with tools/time_sddmm_variants.py on an H100; its numbers in PERF.md.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

#define TILE 128
#define SD_NT 512           // threads a block
#define SD_STAGE_K 192      // largest k whose W panel is staged in shared memory
#define SD_ZERO_CHUNKS 256  // chunks a zeroing block covers
#define SD_SLOTS 2048       // real slots whose coordinates a block tables at once
#define SD_PASS 8           // slots a thread reads at once when it fills the tables

namespace {

using namespace cp_async;

// Writes 0 to every slot of the chunks z0 .. z0 + SD_ZERO_CHUNKS that have
// no entry, a warp a chunk.
__device__ __forceinline__ void zero_empty_chunks(const int* chunk_nreal,
                                                  float* out, int z0,
                                                  int n_chunks) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < SD_ZERO_CHUNKS && z0 + i < n_chunks; i += SD_NT / 32) {
    const int c = z0 + i;
    if (chunk_nreal[c] == 0)
#pragma unroll
      for (int s = lane; s < TILE; s += 32) out[(size_t)c * TILE + s] = 0.f;
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

// Blocks 0 .. n_pieces - 1: one piece each; the rest zero the chunks without
// entries.  ``g``: lanes a slot, a power of two up to 32.
template <bool VEC, bool STAGED>
__global__ void __launch_bounds__(SD_NT)
chunk_sddmm_kernel(const int* __restrict__ piece_ptr,
                   const int* __restrict__ piece_panel,
                   const int* __restrict__ panel_chunks,
                   const int* __restrict__ chunk_nreal,
                   const int* __restrict__ win_panel,
                   const int* __restrict__ coords,
                   const int* __restrict__ inv,
                   const float* __restrict__ W,
                   const float* __restrict__ Ht,
                   float* __restrict__ out,
                   int n_pieces, int n_chunks, int group, int span, int rows,
                   int cols, int k, int nnz, int g) {
  extern __shared__ __align__(16) float Ws[];  // TILE x kp: the panel's W rows
  __shared__ int scan[SD_NT + 1];
  __shared__ int cid[SD_NT];         // the run's chunks
  __shared__ int ccol[SD_NT];        // their first column
  __shared__ int warp_tot[SD_NT / 32];
  __shared__ int tab_slot[SD_SLOTS];  // a real slot's place in out
  __shared__ int tab_hw[SD_SLOTS];    // its col * TILE + local row; -1: not real
  if ((int)blockIdx.x >= n_pieces) {
    zero_empty_chunks(chunk_nreal, out, (blockIdx.x - n_pieces) * SD_ZERO_CHUNKS,
                      n_chunks);
    return;
  }
  const int pbeg = piece_ptr[blockIdx.x], pend = piece_ptr[blockIdx.x + 1];
  if (pbeg == pend) return;  // a panel without chunks: nothing to write
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
    __syncthreads();  // the previous run of chunks is done
    const int c = threadIdx.x < nb ? panel_chunks[b0 + threadIdx.x] : 0;
    block_scan(threadIdx.x < nb ? chunk_nreal[c] : 0, scan, warp_tot);
    cid[threadIdx.x] = c;
    ccol[threadIdx.x] = threadIdx.x < nb ? win_panel[c / group] * span * TILE : 0;
    __syncthreads();
    const int total = scan[nb];
    // the run's real slots, SD_SLOTS at a time (one window unless the
    // pieces were cut above the store's 2,048 entries); the first window
    // also zeroes the tails
    for (int w0 = 0; w0 == 0 || w0 < total; w0 += SD_SLOTS) {
      // every slot of the run's chunks in slot order: a padding slot is
      // written 0 (in the first window), a real slot of this window has its
      // coordinates and refresh map read (coalesced, SD_PASS slots' loads
      // in flight a thread) into the tables
      const int nslot = nb * TILE;
      for (int t0 = threadIdx.x; t0 < nslot; t0 += SD_NT * SD_PASS) {
        int cc[SD_PASS], iv[SD_PASS];
#pragma unroll
        for (int j = 0; j < SD_PASS; ++j) {
          const int t = t0 + j * SD_NT, i = t / TILE, s = t % TILE;
          const bool mine = t < nslot && s < scan[i + 1] - scan[i] &&
                            (unsigned)(scan[i] + s - w0) < SD_SLOTS;
          cc[j] = mine ? coords[cid[i] * TILE + s] : 0;
          iv[j] = mine ? inv[cid[i] * TILE + s] : nnz;
        }
#pragma unroll
        for (int j = 0; j < SD_PASS; ++j) {
          const int t = t0 + j * SD_NT, i = t / TILE, s = t % TILE;
          if (t >= nslot) break;
          const int slot = cid[i] * TILE + s;
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

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

typedef void (*SddmmKernel)(const int*, const int*, const int*, const int*,
                            const int*, const int*, const int*, const float*,
                            const float*, float*, int, int, int, int, int, int,
                            int, int, int);

}  // namespace

// out (n_chunks * 128) = (W @ Ht') at every stored slot of the chunk store,
// 0 at padding slots.  W is (rows x k), Ht is (cols x k), both row-major; the
// store's pieces (piece_ptr, piece_panel over panel_chunks) and chunk_nreal
// come from its row-panel index; ``g`` lanes sample a slot (a power of two
// up to 32).  Returns the CUDA error code of the launch (0 = success).
extern "C" int nmf_chunk_sddmm(const int* piece_ptr, const int* piece_panel,
                               const int* panel_chunks, const int* chunk_nreal,
                               const int* win_panel, const int* coords,
                               const int* inv, const float* W, const float* Ht,
                               float* out, int n_pieces, int n_chunks, int group,
                               int span, int rows, int cols, int k, int nnz,
                               int g, void* stream) {
  if (n_chunks <= 0) return 0;
  if (k <= 0 || n_pieces < 0 || g < 1 || g > 32 || (g & (g - 1)) ||
      n_chunks > INT_MAX / TILE || cols > INT_MAX / TILE)
    return (int)cudaErrorInvalidValue;
  const bool vec = k % 4 == 0 && aligned16(W) && aligned16(Ht);
  const bool staged = k <= SD_STAGE_K;
  SddmmKernel kernel = vec ? (staged ? chunk_sddmm_kernel<true, true>
                                     : chunk_sddmm_kernel<true, false>)
                           : (staged ? chunk_sddmm_kernel<false, true>
                                     : chunk_sddmm_kernel<false, false>);
  const int smem = staged ? TILE * ((k + 3) & ~3) * (int)sizeof(float) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int blocks = n_pieces + (n_chunks + SD_ZERO_CHUNKS - 1) / SD_ZERO_CHUNKS;
  kernel<<<blocks, SD_NT, smem, (cudaStream_t)stream>>>(
      piece_ptr, piece_panel, panel_chunks, chunk_nreal, win_panel, coords, inv,
      W, Ht, out, n_pieces, n_chunks, group, span, rows, cols, k, nnz, g);
  return (int)cudaGetLastError();
}
