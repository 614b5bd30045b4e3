// The dense objectives without the p x n product in device memory:
//   kind 0:  0.5 * sum((X - W @ H)^2)
//   kind 1:  gkldiv(X, W @ H) = sum(x * (log x - log wh) - x + wh), an entry
//            with x = 0 adding wh
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/objectives.py:_obj_kernel
// (launched by _objective_pallas): one body, a switch on the kind.
//
// What bounds it on an H100: operations, 2 * p * n * k flops over X read
// once (k = 64: 32 flops a byte, above the card's 20), plus a logarithm or
// two per entry for kind 1.
//
// Design: the TPU kernel adds every tile's sum into one scalar that the
// sequential grid revisits.  Here one thread block owns 64 rows of X, stages
// its rows of W once and walks the column tiles (wh_tile.cuh), each thread
// adding the terms of its 4 x 4 piece into a double.  The block sums its 256
// doubles in a fixed order (shuffles inside a warp, then the 8 warps in
// turn) and writes one partial; a second, one-block kernel sums the partials
// in a fixed order, in double, and writes the float result.  No atomics: two
// runs give the same bits.  Rows and columns past the edge read as x = 0,
// wh = 0, where both terms vanish.  Shared memory is
// (64 * (k4 + 4) + k4 * 68) floats, k4 = k rounded up to a multiple of 4: the
// largest k is 436.

#include "wh_tile.cuh"

__global__ void __launch_bounds__(WH_NT)
objective_kernel(const float* __restrict__ X, const float* __restrict__ W,
                 const float* __restrict__ H, double* __restrict__ partial,
                 int p, int n, int k, int kind, int xvec) {
  extern __shared__ __align__(16) float sm[];
  __shared__ double warp_sum[WH_NT / 32];
  const int kp4 = (k + 3) & ~3;
  const int ldk = kp4 + 4;
  float* Ws = sm;                 // 64 x ldk, staged once
  float* Hs = Ws + WH_T * ldk;    // kp4 x WH_LD
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = blockIdx.x * WH_T;

  stage_w(Ws, ldk, W, i0, p, k, kp4);
  double s = 0.0;
  for (int j0 = 0; j0 < n; j0 += WH_T) {
    __syncthreads();  // the previous tile's Hs is consumed
    stage_h(Hs, H, j0, n, k, kp4);
    float x[4][4], wh[4][4];
    load_x(x, X, i0 + 4 * ty, j0 + 4 * tx, p, n, xvec);
    __syncthreads();
    wh_tile(wh, Ws, ldk, Hs, kp4, 4 * ty, 4 * tx);
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float xv = x[a][b], w = wh[a][b];
        float term;
        if (kind == 0) {
          const float d = xv - w;
          term = d * d;
        } else if (xv > 0.f) {
          term = xv * (logf(xv) - logf(w > 0.f ? w : 1.f)) - xv + w;
        } else {
          term = w;
        }
        s += (double)term;
      }
  }
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < WH_NT / 32; ++w) tot += warp_sum[w];
    partial[blockIdx.x] = tot;
  }
}

__global__ void __launch_bounds__(WH_NT)
objective_reduce_kernel(const double* __restrict__ partial, int nparts,
                        double scale, float* __restrict__ out) {
  __shared__ double sh[WH_NT];
  double s = 0.0;
  for (int i = threadIdx.x; i < nparts; i += WH_NT) s += partial[i];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int half = WH_NT / 2; half; half >>= 1) {
    if (threadIdx.x < half) sh[threadIdx.x] += sh[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)(scale * sh[0]);
}

// out[0] = the objective of the given kind; ``partial`` holds ceil(p / 64)
// doubles of scratch.  X (p x n), W (p x k), H (k x n), all row-major.
// Returns the CUDA error code of the launches (0 = success).
extern "C" int nmf_dense_objective(const float* X, const float* W,
                                   const float* H, double* partial, float* out,
                                   int p, int n, int k, int kind, int xvec,
                                   void* stream) {
  if (p <= 0 || n <= 0 || k <= 0) return (int)cudaErrorInvalidValue;
  const int kp4 = (k + 3) & ~3;
  const size_t smem =
      ((size_t)WH_T * (kp4 + 4) + (size_t)kp4 * WH_LD) * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      objective_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int nparts = (p + WH_T - 1) / WH_T;
  objective_kernel<<<nparts, WH_NT, smem, st>>>(X, W, H, partial, p, n, k, kind,
                                                xvec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  objective_reduce_kernel<<<1, WH_NT, 0, st>>>(partial, nparts,
                                               kind == 0 ? 0.5 : 1.0, out);
  return (int)cudaGetLastError();
}
