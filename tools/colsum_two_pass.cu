// Kernel 11 (the column sums) as it stood before its redesign for Hopper,
// its two passes verbatim from csrc/elementwise.cu at 5d93548: a
// (ceil(m / 256), ceil(n / 32)) grid of partial column sums, then one thread
// a column adding the partials in block order.  Built on its own so that the
// passes can be timed apart (tools/time_colsum.py, chip_smoke.py phase
// kernels_colsum):
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC \
//        -o libcolsum_two_pass.so tools/colsum_two_pass.cu

#include <cuda_runtime.h>
#include <stdint.h>

#define EW_NT 256
#define COLSUM_ROWS 256
#define COLSUM_WARPS (EW_NT / 32)

__global__ void __launch_bounds__(EW_NT)
colsum_partial_kernel(const float* __restrict__ A, double* __restrict__ partial,
                      int m, int n) {
  __shared__ double warp_sum[COLSUM_WARPS][32];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  const int r0 = blockIdx.x * COLSUM_ROWS;
  const int r1 = min(m, r0 + COLSUM_ROWS);
  double s = 0.0;
  if (c < n) {
#pragma unroll 4
    for (int r = r0 + w; r < r1; r += COLSUM_WARPS) s += (double)A[(size_t)r * n + c];
  }
  warp_sum[w][lane] = s;
  __syncthreads();
  if (w == 0 && c < n) {
    double tot = 0.0;
    for (int v = 0; v < COLSUM_WARPS; ++v) tot += warp_sum[v][lane];
    partial[(size_t)blockIdx.x * n + c] = tot;
  }
}

__global__ void __launch_bounds__(EW_NT)
colsum_finish_kernel(const double* __restrict__ partial, float* __restrict__ out,
                     int nblocks, int n) {
  const int c = blockIdx.x * EW_NT + threadIdx.x;
  if (c >= n) return;
  double s = 0.0;
  for (int b = 0; b < nblocks; ++b) s += partial[(size_t)b * n + c];
  out[c] = (float)s;
}

// partial: ceil(m / COLSUM_ROWS) * n doubles
extern "C" int two_pass_colsum_partial(const float* A, double* partial, int m, int n,
                                   void* stream) {
  const int nblocks = (m + COLSUM_ROWS - 1) / COLSUM_ROWS;
  colsum_partial_kernel<<<dim3(nblocks, (n + 31) / 32), EW_NT, 0,
                          (cudaStream_t)stream>>>(A, partial, m, n);
  return (int)cudaGetLastError();
}

extern "C" int two_pass_colsum_finish(const double* partial, float* out, int m, int n,
                                  void* stream) {
  const int nblocks = (m + COLSUM_ROWS - 1) / COLSUM_ROWS;
  colsum_finish_kernel<<<(n + EW_NT - 1) / EW_NT, EW_NT, 0, (cudaStream_t)stream>>>(
      partial, out, nblocks, n);
  return (int)cudaGetLastError();
}
