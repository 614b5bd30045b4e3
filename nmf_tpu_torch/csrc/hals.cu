// The Fast-HALS column sweep of one half-step, for every lane of a batch in
// one launch.
//
// Replaces no TPU kernel.  The JAX package's sweep is a lax.fori_loop over
// the components (nmf_tpu/models/coorddesc.py:90-113), which XLA compiles
// into one program a half-step.  PyTorch runs the loop from the host: a
// column took an addmv over the whole factor and a few elementwise ops, 400
// to 900 launches a half-step, each addmv streaming all of W (162,541 x 128
// x 4 B = 83 MB at MovieLens 25M's shape: 10.6 GB a half-step), and the
// 59,047-row columns of the H half made kernels shorter than their own
// enqueue.  Only the components are sequential; the rows are independent,
// so a thread block walks all k components over a tile of rows on chip and
// writes the tile back once.
//
// What it computes.  W and C are (m x rows x k), G is (m x k x k), perm k
// ints.  For every row i of lane l, and each c in perm in order,
//   g = sum_r W[l,i,r] G[l,r,c] - C[l,i,c]
//   W[l,i,c] = max(0, W[l,i,c] - g * (1 / G[l,c,c]))
// with the already-updated values of the components visited before c.  A
// lane whose G[l,c,c] is 0 leaves its column c as it is.  W and C are read
// through their strides (row-major, a transposed view of a row-major
// matrix, the lanes' views of one (rows x m k) product): nothing is copied.
//
// Bound on an H100 (k = 128; per lane).  W read, C read and W written once:
// 3 rows k 4 bytes; 2 rows k^2 flops.  W half (rows 162,541): 250 MB, 75 us
// at 3.35 TB/s, and 5.3 GFLOP, 80 us at the CUDA cores' 67 TFLOP/s.  H half
// (rows 59,047): 91 MB, 27 us, and 1.9 GFLOP, 29 us.  Bound about evenly by
// bytes and by fp32 FMA; the kernel does k^2 + k HS_B / 2 FMA a row.
//
// Design.  A block of HS_NT threads owns HS_NT rows of one lane (grid.y the
// lane), a row a thread.  The components are visited in slabs of HS_B
// consecutive entries of perm.  For a slab the thread first forms the HS_B
// sums P[t] = -C[i,c_t] + sum_r W[i,r] G[r,c_t] (a small GEMM: W's row from
// shared memory four values at a time, G's slab columns broadcast from
// shared memory, the sums in registers), where r runs over every component
// but the slab's c_0 .. c_{t-1}, then walks the slab with the slab's W
// values in registers:
//   w' = max(0, w - P[t] * recip); P[t'] += w' * G[c_t, c_t'] for t' > t,
// so each sum meets every component at its current value.  (Carrying the
// change w' - w into sums that had taken the slab-start w is the same
// algebra, but where a step clamps a large w to 0 the two terms cancel and
// leave their rounding behind: 6e-6 of max|W| at k 128 against float64,
// and more with longer slabs, where this order keeps 1e-7 to 2e-7.)
// Everything comes in by cp.async, a step ahead: G's slab columns in chunks
// of HS_KS rows (two buffers; the entries a sum leaves out staged as zeros),
// the slab's (HS_B x HS_B) block of G for the walk with its first chunk (two
// buffers, by slab parity), the slab's C for the tile's rows (one buffer,
// refilled for the next slab once the sums have taken it: C read by rows,
// not a thread's scattered entries), and the tile of W column chunk by
// column chunk with the first slab's chunks of G (16 bytes a copy where W is
// row-major and aligned).  The tile lives in shared memory, rows of ld = k
// rounded up to 4, then to 4 mod 32 floats, so the four-value loads of 32
// rows hit distinct banks, and is written back once; where it does not fit
// (k above 356) the thread reads and writes its row of W in device memory
// instead, in the same order.  Two blocks an SM at k 128 (108 KB each; the
// carveout set to shared memory).  Where the time goes, W half at k 128
// (PERF.md): the memory phases about a third, the GEMM under half, the walk
// a fifth; they do not overlap.
//
// The bits.  Each P[t] starts at -C[i,c_t] and adds W[i,r] G[r,c_t] for r =
// 0, 1, ..., k - 1 in order, one fmaf a term (a term left out, and those
// past k, are zeros in G and add +0), then the new values of the slab's
// c_0 .. c_{t-1} times G in visit order, one fmaf each; the step is single
// IEEE operations (__fmul_rn, __fsub_rn: no contraction).  The reciprocal is
// 1.0f / G[c,c] in IEEE division.  Nothing depends on m, on the tile, on the
// grid or on where W lives, so a lane gives the same bits in any batch, and
// no atomics: the same inputs give the same bits on every run.  The plain
// version (ops/cuda/hals.py) sums each g through the library's
// matrix-vector product, in another order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace {

using namespace cp_async;

constexpr int HS_NT = 128;  // threads a block, a row each: the rows a block owns
constexpr int HS_B = 32;    // components a slab
constexpr int HS_KS = 64;   // rows of G a chunk of a slab's columns
constexpr int HS_SMEM_MAX = 232448;  // bytes of shared memory a block may use
// the chunk buffers, the walks' blocks and the slab's C, in floats
constexpr int HS_FIXED = 2 * HS_KS * HS_B + 2 * HS_B * HS_B + HS_NT * (HS_B + 1);

struct Strides {
  long long l, r, c;  // lane, row, column, in elements
};

__host__ __device__ __forceinline__ int hs_k4(int k) { return (k + 3) & ~3; }

// row pitch of the W tile: k rounded up to 4 floats, then up to 4 mod 32
__host__ __device__ __forceinline__ int hs_ld(int k) {
  const int k4 = hs_k4(k);
  return k4 + ((4 - k4) & 31);
}

// bytes of shared memory a block takes, with the W tile or without it
inline size_t hs_smem(int k, bool tile) {
  return ((size_t)HS_FIXED + (tile ? (size_t)HS_NT * hs_ld(k) : 0)) * 4 +
         (size_t)k * 16;  // reciprocals, diagonal, visit order, positions
}

// max(x, 0), NaN kept, -0.0 kept: the bits of clamp_min(0)
__device__ __forceinline__ float proj(float x) { return !(x < 0.f) ? x : 0.f; }

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// G's rows r0 .. r0 + HS_KS at the columns of the slab that starts at entry
// j0 of the visit order into Gc (row r at r * HS_B), zeros past k, past the
// slab, and where row r is a component the slab visits before column t
// (pos[r] - j0 in 0 .. t - 1: the walk adds its new value); with the slab's
// first chunk also its (HS_B x HS_B) block G[c_a, c_t] into Gs.
__device__ __forceinline__ void hs_stage(float* Gc, float* Gs, const float* Gl,
                                         const int* cols, const int* pos, int k,
                                         int j0, int nb, int r0, bool first) {
  for (int e = threadIdx.x; e < HS_KS * HS_B; e += HS_NT) {
    const int r = e / HS_B, t = e - r * HS_B, rr = r0 + r;
    const bool ok = rr < k && t < nb && (unsigned)(pos[rr] - j0) >= (unsigned)t;
    cp_async4(Gc + e, ok ? Gl + (size_t)rr * k + cols[j0 + t] : Gl, ok ? 4 : 0);
  }
  if (first)
    for (int e = threadIdx.x; e < HS_B * HS_B; e += HS_NT) {
      const int a = e / HS_B, t = e - a * HS_B;
      const bool ok = a < nb && t < nb;
      cp_async4(Gs + e, ok ? Gl + (size_t)cols[j0 + a] * k + cols[j0 + t] : Gl,
                ok ? 4 : 0);
    }
  cp_commit();
}

// The slab's C (C[i0 + r, c_t] for r < HS_NT, t < nb) into Cs (row r at r *
// (HS_B + 1)) by cp.async, consecutive threads on consecutive addresses of
// whichever of C's strides is 1; zeros past ``rows`` and past the slab.  No
// commit.
__device__ __forceinline__ void hs_c_load(float* Cs, const float* Cl, Strides sc,
                                          const int* cols, int i0, int rows, int j0,
                                          int nb) {
  const bool by_rows = sc.c == 1 || sc.r != 1;
  for (int e = threadIdx.x; e < HS_NT * HS_B; e += HS_NT) {
    const int r = by_rows ? e / HS_B : e % HS_NT, t = by_rows ? e % HS_B : e / HS_NT;
    const bool ok = i0 + r < rows && t < nb;
    cp_async4(Cs + r * (HS_B + 1) + t,
              ok ? Cl + (long long)(i0 + r) * sc.r + (long long)cols[j0 + t] * sc.c : Cl,
              ok ? 4 : 0);
  }
}

// Columns c0 .. c1 of the tile's W (rows i0 .. i0 + HS_NT of one lane) into
// Ws by cp.async, consecutive threads on consecutive addresses of whichever
// of W's strides is 1 (16 bytes a copy with ``vec``: row-major, k % 4 == 0,
// aligned); rows past ``rows`` and columns k .. k4 read as zeros.  c0 and c1
// are multiples of 4.  No commit.
__device__ __forceinline__ void hs_tile_load(float* Ws, int ld, const float* Wl,
                                             Strides sw, int i0, int rows, int k,
                                             bool vec, int c0, int c1) {
  c1 = min(c1, hs_k4(k));
  const int nc = c1 - c0;
  if (nc <= 0) return;
  if (vec) {
    const int q4 = nc >> 2;
    for (int e = threadIdx.x; e < HS_NT * q4; e += HS_NT) {
      const int r = e / q4, c = c0 + 4 * (e - r * q4);
      const bool ok = i0 + r < rows;
      cp_async16(Ws + r * ld + c, ok ? Wl + (long long)(i0 + r) * sw.r + c : Wl,
                 ok ? 16 : 0);
    }
  } else if (sw.c == 1 || sw.r != 1) {
    for (int e = threadIdx.x; e < HS_NT * nc; e += HS_NT) {
      const int r = e / nc, c = c0 + e - r * nc;
      const bool ok = i0 + r < rows && c < k;
      cp_async4(Ws + r * ld + c,
                ok ? Wl + (long long)(i0 + r) * sw.r + (long long)c * sw.c : Wl, ok ? 4 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < HS_NT * nc; e += HS_NT) {
      const int c = c0 + e / HS_NT, r = e % HS_NT;
      const bool ok = i0 + r < rows && c < k;
      cp_async4(Ws + r * ld + c, ok ? Wl + (i0 + r) + (long long)c * sw.c : Wl, ok ? 4 : 0);
    }
  }
}

// The tile's real entries from Ws back to W (the layouts of hs_tile_load).
__device__ __forceinline__ void hs_tile_store(const float* Ws, int ld, float* Wl,
                                              Strides sw, int i0, int rows, int k,
                                              bool vec) {
  if (vec) {
    const int q4 = k >> 2;
    for (int e = threadIdx.x; e < HS_NT * q4; e += HS_NT) {
      const int r = e / q4, q = e - r * q4;
      if (i0 + r < rows)
        *reinterpret_cast<float4*>(Wl + (long long)(i0 + r) * sw.r + 4 * q) =
            *reinterpret_cast<const float4*>(Ws + r * ld + 4 * q);
    }
  } else if (sw.c == 1 || sw.r != 1) {
    for (int e = threadIdx.x; e < HS_NT * k; e += HS_NT) {
      const int r = e / k, c = e - r * k;
      if (i0 + r < rows) Wl[(long long)(i0 + r) * sw.r + (long long)c * sw.c] = Ws[r * ld + c];
    }
  } else {
    for (int e = threadIdx.x; e < HS_NT * k; e += HS_NT) {
      const int c = e / HS_NT, r = e - c * HS_NT;
      if (i0 + r < rows) Wl[(i0 + r) + (long long)c * sw.c] = Ws[r * ld + c];
    }
  }
}

template <bool TILE>
__global__ void __launch_bounds__(HS_NT)
hals_sweep_kernel(float* __restrict__ W, const float* __restrict__ G,
                  const float* __restrict__ C, const int* __restrict__ perm,
                  int rows, int k, Strides sw, Strides sc, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const int ld = hs_ld(k), k4 = hs_k4(k);
  float* Gc = smem;                           // [2][HS_KS][HS_B]
  float* Gs = Gc + 2 * HS_KS * HS_B;          // [2][HS_B][HS_B]
  float* Cs = Gs + 2 * HS_B * HS_B;           // [HS_NT][HS_B + 1]
  float* Ws = Cs + HS_NT * (HS_B + 1);        // [HS_NT][ld] (TILE)
  float* rcp = Ws + (TILE ? HS_NT * ld : 0);  // [k]
  float* dg = rcp + k;                        // [k]
  int* cols = reinterpret_cast<int*>(dg + k); // [k] the visit order
  int* pos = cols + k;                        // [k] each component's place in it

  const int lane = blockIdx.y, i0 = blockIdx.x * HS_NT;
  const float* Gl = G + (size_t)lane * k * k;
  float* Wl = W + lane * sw.l;
  const float* Cl = C + lane * sc.l;

  // the tile comes in with the first slab's chunks: columns r0 .. r0 + HS_KS
  // with chunk r0 / HS_KS, so the first chunk's FMA start before the rest
  if (TILE) hs_tile_load(Ws, ld, Wl, sw, i0, rows, k, vec, 0, HS_KS);
  for (int c = threadIdx.x; c < k; c += HS_NT) {
    const int v = perm ? perm[c] : c;
    cols[c] = v;
    pos[v] = c;
    const float d = Gl[(size_t)c * k + c];
    dg[c] = d;
    rcp[c] = 1.0f / d;  // IEEE division; not used where d == 0
  }
  __syncthreads();

  // the thread's row: tile row threadIdx.x, row i0 + threadIdx.x of the lane
  const bool valid = i0 + (int)threadIdx.x < rows;
  float* wrow = TILE ? Ws + threadIdx.x * ld : Wl + (long long)(i0 + threadIdx.x) * sw.r;
  const float* crow = Cs + threadIdx.x * (HS_B + 1);  // its slab of C
  const long long wstep = TILE ? 1 : sw.c;

  const int nsl = (k + HS_B - 1) / HS_B, nch = (k4 + HS_KS - 1) / HS_KS;
  const int steps = nsl * nch;
  float acc[HS_B];

  // group 0: the tile (TILE), the first slab's C and the first chunk
  hs_c_load(Cs, Cl, sc, cols, i0, rows, 0, min(HS_B, k));
  hs_stage(Gc, Gs, Gl, cols, pos, k, 0, min(HS_B, k), 0, true);
  for (int step = 0; step < steps; ++step) {
    const int s = step / nch, q = step - s * nch;
    const int j0 = s * HS_B, nb = min(HS_B, k - j0), r0 = q * HS_KS;
    if (step + 1 < steps) {
      const int s1 = (step + 1) / nch, q1 = step + 1 - s1 * nch;
      if (TILE && s1 == 0)
        hs_tile_load(Ws, ld, Wl, sw, i0, rows, k, vec, q1 * HS_KS, (q1 + 1) * HS_KS);
      hs_stage(Gc + ((step + 1) & 1) * HS_KS * HS_B, Gs + (s1 & 1) * HS_B * HS_B,
               Gl, cols, pos, k, s1 * HS_B, min(HS_B, k - s1 * HS_B), q1 * HS_KS,
               q1 == 0);
    } else {
      cp_commit();  // an empty group: the wait below counts the same
    }
    cp_wait<1>();  // every group but the newest: this step's chunk, the slab's C
    __syncthreads();

    if (q == 0) {
      // the sums start at -C; then the next slab's C is copied in
#pragma unroll
      for (int t = 0; t < HS_B; ++t) acc[t] = -crow[t];
      if (s + 1 < nsl) {
        __syncthreads();
        hs_c_load(Cs, Cl, sc, cols, i0, rows, j0 + HS_B, min(HS_B, k - j0 - HS_B));
        cp_commit();
      }
    }

    // P[t] += W[i, r] G[r, c_t] over this chunk's rows, r in order
    const float* gc = Gc + (step & 1) * HS_KS * HS_B;
    const int nr = min(HS_KS, k4 - r0);
    for (int r = 0; r < nr; r += 4) {
      float4 w4;
      if (TILE) {
        w4 = *reinterpret_cast<const float4*>(wrow + r0 + r);
      } else {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = valid && r0 + r + e < k ? wrow[(r0 + r + e) * wstep] : 0.f;
        w4 = make_float4(v[0], v[1], v[2], v[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float a = comp(w4, e);
        const float4* g4 = reinterpret_cast<const float4*>(gc + (r + e) * HS_B);
#pragma unroll
        for (int t4 = 0; t4 < HS_B / 4; ++t4) {
          const float4 g = g4[t4];
          acc[4 * t4 + 0] = fmaf(a, g.x, acc[4 * t4 + 0]);
          acc[4 * t4 + 1] = fmaf(a, g.y, acc[4 * t4 + 1]);
          acc[4 * t4 + 2] = fmaf(a, g.z, acc[4 * t4 + 2]);
          acc[4 * t4 + 3] = fmaf(a, g.w, acc[4 * t4 + 3]);
        }
      }
    }

    if (q == nch - 1) {
      // the slab's walk over its W values held in registers: each column's
      // step, then its value carried into the later columns' sums
      const float* gs = Gs + (s & 1) * HS_B * HS_B;
      float wv[HS_B];
#pragma unroll
      for (int t = 0; t < HS_B; ++t)
        wv[t] = valid && t < nb ? wrow[cols[j0 + t] * wstep] : 0.f;
#pragma unroll
      for (int t = 0; t < HS_B; ++t) {
        if (t < nb) {
          const int c = cols[j0 + t];
          if (dg[c] != 0.f)
            wv[t] = proj(__fsub_rn(wv[t], __fmul_rn(acc[t], rcp[c])));
#pragma unroll
          for (int t2 = t + 1; t2 < HS_B; ++t2)
            acc[t2] = fmaf(wv[t], gs[t * HS_B + t2], acc[t2]);
        }
      }
      if (valid)
#pragma unroll
        for (int t = 0; t < HS_B; ++t)
          if (t < nb) wrow[cols[j0 + t] * wstep] = wv[t];
    }
    __syncthreads();  // this step's buffers are staged into again next
  }
  if (TILE) hs_tile_store(Ws, ld, Wl, sw, i0, rows, k, vec);
}

template <bool TILE>
int hs_launch(float* W, const float* G, const float* C, const int* perm, int m,
              int rows, int k, Strides sw, Strides sc, bool vec, cudaStream_t st) {
  static unsigned ready = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32 || !(ready >> dev & 1)) {
    e = cudaFuncSetAttribute(hals_sweep_kernel<TILE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, HS_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    // all of the SM's shared memory for the kernel: two blocks an SM at k 128
    e = cudaFuncSetAttribute(hals_sweep_kernel<TILE>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return (int)e;
    if (dev < 32) ready |= 1u << dev;
  }
  const dim3 grid((unsigned)((rows + HS_NT - 1) / HS_NT), (unsigned)m);
  hals_sweep_kernel<TILE><<<grid, HS_NT, hs_smem(k, TILE), st>>>(W, G, C, perm, rows,
                                                                  k, sw, sc, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// One sweep of every lane, W updated in place.  W, C (m x rows x k) at the
// element strides (wl, wr, wc), (cl, cr, cc); G (m x k x k) contiguous; perm
// k ints on the card, a permutation of 0 .. k - 1, or null for 0 .. k - 1.
// W must not overlap itself or C.  Returns cudaErrorInvalidValue for more
// than 65,535 lanes or a k whose tables leave no room in shared memory.
extern "C" int nmf_hals_sweep(float* W, const float* G, const float* C,
                              const int* perm, int m, int rows, int k,
                              long long wl, long long wr, long long wc,
                              long long cl, long long cr, long long cc,
                              void* stream) {
  if (m < 0 || rows < 0 || k < 0 || m > 65535) return (int)cudaErrorInvalidValue;
  if (m == 0 || rows == 0 || k == 0) return 0;
  if (hs_smem(k, false) > HS_SMEM_MAX) return (int)cudaErrorInvalidValue;
  const Strides sw{wl, wr, wc}, sc{cl, cr, cc};
  // 16-byte copies of the tile: rows of k % 4 == 0 contiguous floats, every
  // row and lane starting on a 16-byte boundary
  const bool vec = wc == 1 && k % 4 == 0 && wr % 4 == 0 && wl % 4 == 0 &&
                   (uintptr_t)W % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  return hs_smem(k, true) <= HS_SMEM_MAX
             ? hs_launch<true>(W, G, C, perm, m, rows, k, sw, sc, vec, st)
             : hs_launch<false>(W, G, C, perm, m, rows, k, sw, sc, vec, st);
}
