// One 64 x 64 tile of W @ H from operands staged in shared memory: the
// device routine of the dense objectives (objectives.cu), which forms the
// tile, uses it at once and drops it; the p x n product never reaches device
// memory.  The divergence products (mu.cu: wtq, qht) used it too and now
// have their own routine (larger pieces, cp.async staging); the transposed
// slabs below (stage_wt, stage_ht, the ``slab`` argument) served them and
// are unused until the objective moves to that routine as well.
//
// 256 threads, thread (ty, tx) of a 16 x 16 grid owns a 4 x 4 piece.  Every
// small product in these kernels has the shape
//     acc[a][b] += sum_t A[a][t] * B[t][b]
// with A read along the reduction index, so both operands are read as
// float4: 8 loads for 64 fused multiply-adds.  Exact fp32 FMA on the CUDA
// cores, sums in increasing t: the same bits from run to run.
//
// The reduction over k runs in slabs of WH_KS: one slab of the W rows and of
// the H columns sits in shared memory at a time and the piece of the tile
// stays in registers across slabs (the ordinary GEMM k-loop), so any k
// fits.  The additions stay in increasing t across slabs: a k that fits one
// slab sums exactly as a k cut into several.  Where k fits one slab, the
// operand that does not change along the caller's walk is staged once
// before the walk.
//
// Shared tiles that are 64 wide have a row stride of 68 floats: rows stay 16
// byte aligned for the float4 reads and the two rows a warp reads at once
// fall into different banks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define WH_T 64     // tile edge
#define WH_LD 68    // row stride of a 64-wide shared tile
#define WH_NT 256   // threads per block
#define WH_KS 128   // depth of one k-slab

// acc[a][b] += sum_{t < T} A[a * lda + t] * B[t * ldb + b];  T % 4 == 0, A
// points at the thread's first row, B at its first column.
__device__ __forceinline__ void tile_fma(float (&acc)[4][4], const float* A,
                                         int lda, const float* B, int ldb,
                                         int T) {
  for (int t = 0; t < T; t += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      a[u] = *reinterpret_cast<const float4*>(A + u * lda + t);
      b[u] = *reinterpret_cast<const float4*>(B + (t + u) * ldb);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(a[i].x, b[0].x, acc[i][0]);
      acc[i][1] = fmaf(a[i].x, b[0].y, acc[i][1]);
      acc[i][2] = fmaf(a[i].x, b[0].z, acc[i][2]);
      acc[i][3] = fmaf(a[i].x, b[0].w, acc[i][3]);
      acc[i][0] = fmaf(a[i].y, b[1].x, acc[i][0]);
      acc[i][1] = fmaf(a[i].y, b[1].y, acc[i][1]);
      acc[i][2] = fmaf(a[i].y, b[1].z, acc[i][2]);
      acc[i][3] = fmaf(a[i].y, b[1].w, acc[i][3]);
      acc[i][0] = fmaf(a[i].z, b[2].x, acc[i][0]);
      acc[i][1] = fmaf(a[i].z, b[2].y, acc[i][1]);
      acc[i][2] = fmaf(a[i].z, b[2].z, acc[i][2]);
      acc[i][3] = fmaf(a[i].z, b[2].w, acc[i][3]);
      acc[i][0] = fmaf(a[i].w, b[3].x, acc[i][0]);
      acc[i][1] = fmaf(a[i].w, b[3].y, acc[i][1]);
      acc[i][2] = fmaf(a[i].w, b[3].z, acc[i][2]);
      acc[i][3] = fmaf(a[i].w, b[3].w, acc[i][3]);
    }
  }
}

__device__ __forceinline__ void zero_tile(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

// Width of the staged slabs for a given k: k rounded up to a multiple of 4,
// at most WH_KS.  Shared W tiles have a row stride of this plus 4.
__host__ __device__ __forceinline__ int wh_slab(int k) {
  const int kp4 = (k + 3) & ~3;
  return kp4 < WH_KS ? kp4 : WH_KS;
}

// Ws[i][r] = W[i0 + i][r0 + r] for 64 rows of W (p x k), r < kw; zero
// outside W.
__device__ __forceinline__ void stage_w(float* Ws, int ldk, const float* W,
                                        int i0, int p, int k, int r0, int kw) {
  for (int t = threadIdx.x; t < WH_T * kw; t += WH_NT) {
    const int i = t / kw, r = t - i * kw, gi = i0 + i, gr = r0 + r;
    Ws[i * ldk + r] = (gi < p && gr < k) ? W[(size_t)gi * k + gr] : 0.f;
  }
}

// Hs[r][j] = H[r0 + r][j0 + j] for 64 columns of H (k x n), r < kw; zero
// outside H.
__device__ __forceinline__ void stage_h(float* Hs, const float* H, int j0,
                                        int n, int k, int r0, int kw) {
  for (int t = threadIdx.x; t < kw * WH_T; t += WH_NT) {
    const int r = t >> 6, j = t & 63, gj = j0 + j, gr = r0 + r;
    Hs[r * WH_LD + j] = (gr < k && gj < n) ? H[(size_t)gr * n + gj] : 0.f;
  }
}

// The thread's 4 x 4 piece of X (p x n) at (gi0, gj0); zero outside X.
// ``vec``: n % 4 == 0 and X is 16-byte aligned, so a row piece is one float4.
__device__ __forceinline__ void load_x(float (&x)[4][4], const float* X,
                                       int gi0, int gj0, int p, int n,
                                       int vec) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int gi = gi0 + a;
    const float* src = X + (size_t)gi * n + gj0;
    if (gi < p && vec && gj0 < n) {
      const float4 v = *reinterpret_cast<const float4*>(src);
      x[a][0] = v.x; x[a][1] = v.y; x[a][2] = v.z; x[a][3] = v.w;
    } else {
#pragma unroll
      for (int b = 0; b < 4; ++b)
        x[a][b] = (gi < p && gj0 + b < n) ? src[b] : 0.f;
    }
  }
}

// Wt[c][i] = W[i0 + i][c0 + c]: a 64 x 64 transposed slab of W (p x k).
__device__ __forceinline__ void stage_wt(float* Wt, const float* W, int i0,
                                         int c0, int p, int k) {
  for (int t = threadIdx.x; t < WH_T * WH_T; t += WH_NT) {
    const int i = t >> 6, c = t & 63, gi = i0 + i, gc = c0 + c;
    Wt[c * WH_LD + i] = (gi < p && gc < k) ? W[(size_t)gi * k + gc] : 0.f;
  }
}

// Ht[j][c] = H[c0 + c][j0 + j]: a 64 x 64 transposed slab of H (k x n).
__device__ __forceinline__ void stage_ht(float* Ht, const float* H, int j0,
                                         int c0, int n, int k) {
  for (int t = threadIdx.x; t < WH_T * WH_T; t += WH_NT) {
    const int c = t >> 6, j = t & 63, gj = j0 + j, gc = c0 + c;
    Ht[j * WH_LD + c] = (gc < k && gj < n) ? H[(size_t)gc * n + gj] : 0.f;
  }
}

enum { WH_NO_SLAB = 0, WH_W_SLAB = 1, WH_H_SLAB = 2 };

// wh = the thread's piece (rows a0.., columns b0..) of
// W[i0:i0+64, :] @ H[:, j0:j0+64], summed over k one slab at a time into
// Ws (64 x ldk) and Hs (slab x WH_LD), and x = the thread's piece of X at
// (i0 + a0, j0 + b0).  ``ONE``: k fits one slab (k <= WH_KS), known when
// the kernel is compiled, so the walk over slabs vanishes and the code is
// that of a single product.  ``fixed_w``: W is the operand that stays the
// same along the caller's walk (else H); with ONE the caller staged it whole
// before the walk and it is not staged again here.  ``slab``: the caller's
// own 64 x 64 transposed slab of components c0.. (WH_W_SLAB: stage_wt into
// T, WH_H_SLAB: stage_ht into T) is staged with the first slab, and x loaded
// after it, so their loads overlap the staging.  Begins with a barrier, so
// the caller's shared operands of its previous step must be consumed by
// then; ends after the last slab's product, with no barrier.
template <bool ONE>
__device__ __forceinline__ void wh_tile(float (&wh)[4][4], float (&x)[4][4],
                                        const float* X, int xvec, float* Ws,
                                        int ldk, float* Hs, const float* W,
                                        const float* H, int i0, int j0, int p,
                                        int n, int k, bool fixed_w, int a0,
                                        int b0, int slab, float* T, int c0) {
  const int kp4 = (k + 3) & ~3;
  const int nslabs = ONE ? 1 : (kp4 + WH_KS - 1) / WH_KS;
  zero_tile(wh);
  for (int sl = 0; sl < nslabs; ++sl) {
    const int r0 = sl * WH_KS;
    const int kw = ONE ? kp4 : min(WH_KS, kp4 - r0);
    __syncthreads();  // the previous slab's (or step's) operands are consumed
    if (!(ONE && fixed_w)) stage_w(Ws, ldk, W, i0, p, k, r0, kw);
    if (!(ONE && !fixed_w)) stage_h(Hs, H, j0, n, k, r0, kw);
    if (sl == 0) {
      if (slab == WH_W_SLAB) stage_wt(T, W, i0, c0, p, k);
      if (slab == WH_H_SLAB) stage_ht(T, H, j0, c0, n, k);
      load_x(x, X, i0 + a0, j0 + b0, p, n, xvec);
    }
    __syncthreads();
    tile_fma(wh, Ws + a0 * ldk, ldk, Hs + b0, WH_LD, kw);
  }
}
