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
// sequential grid revisits.  Here one thread block owns 64 rows of X and
// walks the column tiles (wh_tile.cuh), each thread
// adding the terms of its 4 x 4 piece into a double.  The block sums its 256
// doubles in a fixed order (shuffles inside a warp, then the 8 warps in
// turn) and writes one partial; a second, one-block kernel sums the partials
// in a fixed order, in double, and writes the float result.  No atomics: two
// runs give the same bits.  Rows and columns past the edge read as x = 0,
// wh = 0, where both terms vanish.  The W @ H tile sums over k in slabs of
// WH_KS (wh_tile.cuh), so any k fits: shared memory is
// (64 * (kw + 4) + kw * 68) floats, kw = k rounded up to a multiple of 4 and
// at most WH_KS; the W rows are staged once when k fits one slab.

#include "wh_tile.cuh"

template <bool ONE>
__global__ void __launch_bounds__(WH_NT)
objective_kernel(const float* __restrict__ X, const float* __restrict__ W,
                 const float* __restrict__ H, double* __restrict__ partial,
                 int p, int n, int k, int kind, int xvec) {
  extern __shared__ __align__(16) float sm[];
  __shared__ double warp_sum[WH_NT / 32];
  const int kw = wh_slab(k);
  const int ldk = kw + 4;
  float* Ws = sm;                 // 64 x ldk: the block's W rows, one slab
  float* Hs = Ws + WH_T * ldk;    // kw x WH_LD
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int i0 = blockIdx.x * WH_T;

  if (ONE) stage_w(Ws, ldk, W, i0, p, k, 0, kw);  // once for the walk
  double s = 0.0;
  for (int j0 = 0; j0 < n; j0 += WH_T) {
    float x[4][4], wh[4][4];
    wh_tile<ONE>(wh, x, X, xvec, Ws, ldk, Hs, W, H, i0, j0, p, n, k, true,
                 4 * ty, 4 * tx, WH_NO_SLAB, nullptr, 0);
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
  const int kw = wh_slab(k);
  const size_t smem =
      ((size_t)WH_T * (kw + 4) + (size_t)kw * WH_LD) * sizeof(float);
  auto kernel = k <= WH_KS ? objective_kernel<true> : objective_kernel<false>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const int nparts = (p + WH_T - 1) / WH_T;
  kernel<<<nparts, WH_NT, smem, st>>>(X, W, H, partial, p, n, k, kind, xvec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  objective_reduce_kernel<<<1, WH_NT, 0, st>>>(partial, nparts,
                                               kind == 0 ? 0.5 : 1.0, out);
  return (int)cudaGetLastError();
}
