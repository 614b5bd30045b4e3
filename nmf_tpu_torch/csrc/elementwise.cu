// The elementwise kernels: projection onto the non-negative orthant and the
// column normalisation of a factor.
//
// Replaces the TPU kernels of nmf_tpu/ops/pallas/elementwise.py:
//   projectnn_pallas (_proj_kernel):           out = max(A, 0)
//   normalize1_cols_pallas (_colsum_kernel):   sums = column sums of A (m x n)
//   normalize1_cols_pallas (_scale_kernel):    out = A / sums, column by column
// XLA fuses these into the ops around them on the TPU; PyTorch launches
// every elementwise op on its own, so in this build they stand at the end of
// every GreedyCD half-step (projectnn) and in every normalised random start
// (the other two), the boundary the TPU kernels were written for.
//
// What bounds them on an H100: bytes.  projectnn and the scaling read A once
// and write it once (8 bytes an entry, 0 or 1 flop); the column sums read A
// once and write n floats.
//
// projectnn.  A flat pass over the entries, four at a time where both
// pointers are 16-byte aligned, the ragged end one at a time; nothing is
// padded or copied.  An entry is kept unless it is below zero, so NaN passes
// through and -0.0 stays -0.0: the bits of A.clamp_min(0).
//
// Column sums.  The TPU kernel adds every 512-row block into one (1, n)
// output that its sequential grid revisits.  Here thread blocks run in no
// order, and no atomics are used: a block of 8 warps owns COLSUM_ROWS rows
// and 32 columns; lane c of every warp reads column c, so a warp reads 128
// contiguous bytes of a row at a time, and warp w takes rows w, w + 8, ...,
// adding them into a double in increasing row order.  The block adds its 8
// warps in order and writes one double per column into a (blocks, n)
// partial; a second kernel adds the partials of a column in increasing
// block order and rounds once to float.  A fixed order throughout: the same
// bits from run to run, and the float64 sum rounded once.
//
// Scaling.  A flat pass like projectnn; each entry divides by its column's
// sum with IEEE division (the build takes no fast-math flag), so given the
// same sums it gives the bits of a / s.

#include <cuda_runtime.h>
#include <stdint.h>

#define EW_NT 256
#define EW_MAX_BLOCKS 8192
#define COLSUM_ROWS 256
#define COLSUM_WARPS (EW_NT / 32)

__device__ __forceinline__ float proj(float x) { return !(x < 0.f) ? x : 0.f; }

static unsigned flat_grid(size_t items) {
  const size_t b = (items + EW_NT - 1) / EW_NT;
  return (unsigned)(b < 1 ? 1 : (b > EW_MAX_BLOCKS ? EW_MAX_BLOCKS : b));
}

__global__ void __launch_bounds__(EW_NT)
projectnn_kernel(const float* __restrict__ A, float* __restrict__ out,
                 size_t count, int vec) {
  const size_t stride = (size_t)gridDim.x * EW_NT;
  const size_t first = (size_t)blockIdx.x * EW_NT + threadIdx.x;
  size_t done = 0;
  if (vec) {
    const size_t n4 = count / 4;
    for (size_t q = first; q < n4; q += stride) {
      float4 v = reinterpret_cast<const float4*>(A)[q];
      v.x = proj(v.x); v.y = proj(v.y); v.z = proj(v.z); v.w = proj(v.w);
      reinterpret_cast<float4*>(out)[q] = v;
    }
    done = 4 * n4;
  }
  for (size_t e = done + first; e < count; e += stride) out[e] = proj(A[e]);
}

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

__global__ void __launch_bounds__(EW_NT)
scale_cols_kernel(const float* __restrict__ A, const float* __restrict__ sums,
                  float* __restrict__ out, size_t count, int n, int vec) {
  const size_t stride = (size_t)gridDim.x * EW_NT;
  const size_t first = (size_t)blockIdx.x * EW_NT + threadIdx.x;
  if (vec) {  // n % 4 == 0: a float4 never crosses a row
    const size_t n4 = count / 4;
    for (size_t q = first; q < n4; q += stride) {
      const int j = (int)((4 * q) % (size_t)n);
      float4 v = reinterpret_cast<const float4*>(A)[q];
      v.x = v.x / sums[j];
      v.y = v.y / sums[j + 1];
      v.z = v.z / sums[j + 2];
      v.w = v.w / sums[j + 3];
      reinterpret_cast<float4*>(out)[q] = v;
    }
    return;
  }
  for (size_t e = first; e < count; e += stride) out[e] = A[e] / sums[e % (size_t)n];
}

// out = max(A, 0) over ``count`` floats; ``vec``: A and out 16-byte aligned.
// Returns the CUDA error code of the launch (0 = success).
extern "C" int nmf_projectnn(const float* A, float* out, size_t count, int vec,
                             void* stream) {
  if (count == 0) return 0;
  projectnn_kernel<<<flat_grid(vec ? count / 4 + 1 : count), EW_NT, 0,
                     (cudaStream_t)stream>>>(A, out, count, vec);
  return (int)cudaGetLastError();
}

// out (n floats) = column sums of A (m x n, row-major); ``partial`` holds
// ceil(m / COLSUM_ROWS) * n doubles of scratch.
extern "C" int nmf_colsum(const float* A, double* partial, float* out, int m,
                          int n, void* stream) {
  if (m <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int nblocks = (m + COLSUM_ROWS - 1) / COLSUM_ROWS;
  colsum_partial_kernel<<<dim3(nblocks, (n + 31) / 32), EW_NT, 0, st>>>(
      A, partial, m, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  colsum_finish_kernel<<<(n + EW_NT - 1) / EW_NT, EW_NT, 0, st>>>(partial, out,
                                                                 nblocks, n);
  return (int)cudaGetLastError();
}

// out = A / sums, column j divided by sums[j]; A and out (m x n) row-major,
// ``count`` = m * n; ``vec``: n % 4 == 0 and A, out 16-byte aligned.
extern "C" int nmf_scale_cols(const float* A, const float* sums, float* out,
                              size_t count, int n, int vec, void* stream) {
  if (count == 0) return 0;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  scale_cols_kernel<<<flat_grid(vec ? count / 4 : count), EW_NT, 0,
                      (cudaStream_t)stream>>>(A, sums, out, count, n, vec);
  return (int)cudaGetLastError();
}
