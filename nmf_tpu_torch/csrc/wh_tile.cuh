// One 64 x 64 tile of W @ H from operands staged in shared memory: the
// device routine shared by the divergence products (mu.cu: wtq, qht) and the
// dense objectives (objectives.cu).  Each forms the tile, uses it at once and
// drops it; the p x n product never reaches device memory.
//
// 256 threads, thread (ty, tx) of a 16 x 16 grid owns a 4 x 4 piece.  Every
// small product in these kernels has the shape
//     acc[a][b] += sum_t A[a][t] * B[t][b]
// with A read along the reduction index, so both operands are read as
// float4: 8 loads for 64 fused multiply-adds.  Exact fp32 FMA on the CUDA
// cores, sums in increasing t: the same bits from run to run.
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

// Ws[i][r] = W[i0 + i][r] for 64 rows of W (p x k), r < kp4; zero outside W.
__device__ __forceinline__ void stage_w(float* Ws, int ldk, const float* W,
                                        int i0, int p, int k, int kp4) {
  for (int t = threadIdx.x; t < WH_T * kp4; t += WH_NT) {
    const int i = t / kp4, r = t - i * kp4, gi = i0 + i;
    Ws[i * ldk + r] = (gi < p && r < k) ? W[(size_t)gi * k + r] : 0.f;
  }
}

// Hs[r][j] = H[r][j0 + j] for 64 columns of H (k x n), r < kp4; zero outside.
__device__ __forceinline__ void stage_h(float* Hs, const float* H, int j0,
                                        int n, int k, int kp4) {
  for (int t = threadIdx.x; t < kp4 * WH_T; t += WH_NT) {
    const int r = t >> 6, j = t & 63, gj = j0 + j;
    Hs[r * WH_LD + j] = (r < k && gj < n) ? H[(size_t)r * n + gj] : 0.f;
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

// wh = the thread's piece of Ws (64 x kp4, rows a0..a0+3) @ Hs (kp4 x 64,
// columns b0..b0+3).
__device__ __forceinline__ void wh_tile(float (&wh)[4][4], const float* Ws,
                                        int ldk, const float* Hs, int kp4,
                                        int a0, int b0) {
  zero_tile(wh);
  tile_fma(wh, Ws + a0 * ldk, ldk, Hs + b0, WH_LD, kp4);
}
