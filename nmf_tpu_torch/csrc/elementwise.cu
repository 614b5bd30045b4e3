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
// Column sums (kernel 11).  The TPU kernel adds every 512-row block into one
// (1, n) output that its sequential grid revisits.  Here thread blocks run
// in no order and no atomics add the sums.  One launch: a grid the size of
// the card (``colsum_plan`` in ops/cuda/elementwise.py: one block of
// COLSUM_NT threads an SM, fewer for a short matrix), each block owning a
// contiguous range of rows across all n columns.  A thread owns a unit of
// columns (four, read as one 16-byte load, where n % 4 == 0 and A is
// 16-byte aligned; else one) and one of the R = COLSUM_NT / w sub-rows of a
// step (w: the units of a pass over at most COLSUM_NT units), adds rows r0 +
// sub, r0 + sub + R, ... into doubles in increasing order, COLSUM_UNROLL
// loads in flight (about 128 KB an SM at n = 128; the launch bounds' least
// block count lets ptxas keep them: without it, it aims at two blocks an SM,
// 32 registers, and keeps one load in flight).  The block adds its R
// sub-rows in order into one double a column of a (blocks, n) partial in
// the call's scratch.  Then each block takes a ticket (``atomicInc`` on a
// word of the same scratch, after ``__threadfence``); the last block adds
// the partials with all its threads: for each column, S = COLSUM_NT / w
// stripes of consecutive blocks, each stripe's blocks in increasing order,
// then the stripes in order, rounded once to float.  The order depends only
// on (m, n, the grid), so the same inputs give the same bits on every call
// and stream of one card.  The ticket word is zeroed by a 4-byte
// ``cudaMemsetAsync`` on the call's stream before the kernel (the scratch
// comes from PyTorch's allocator), and ``atomicInc`` leaves it at 0 again.
// Bound by bytes: A read once, n floats written.

// Scaling.  A flat pass like projectnn; each entry divides by its column's
// sum with IEEE division (the build takes no fast-math flag), so given the
// same sums it gives the bits of a / s.

#include <cuda_runtime.h>
#include <stdint.h>

#define EW_NT 256
#define EW_MAX_BLOCKS 8192
#define COLSUM_NT 1024       // threads a block of the column sums
#define COLSUM_BPS 1         // blocks an SM: the grid's and the launch bounds'
#define COLSUM_UNROLL 8      // rows of loads a thread keeps in flight
#define COLSUM_FIN_UNROLL 8  // partials a thread of the last block keeps in flight

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

__device__ __forceinline__ void add_cols(double* s, float4 x) {
  s[0] += (double)x.x; s[1] += (double)x.y; s[2] += (double)x.z; s[3] += (double)x.w;
}
__device__ __forceinline__ void add_cols(double* s, float x) { s[0] += (double)x; }
// a whole 512-byte row of a warp at n = 128: evict-first (ld.global.cs), so
// that the lines A brings into L2 go before the ones already there (dirty
// ones written by the kernel before, which a normalised start reads next);
// a one-column load shares its lines with the neighbouring warps' and keeps
// the default policy
__device__ __forceinline__ float4 load_cols(const float4* p) { return __ldcs(p); }
__device__ __forceinline__ float load_cols(const float* p) { return *p; }

// V columns a unit: 4 (float4 loads; n % 4 == 0, A 16-byte aligned) or 1
template <int V, typename Vec>
__global__ void __launch_bounds__(COLSUM_NT, COLSUM_BPS)
colsum_kernel(const float* __restrict__ A, double* __restrict__ partial,
              unsigned* __restrict__ ticket, float* __restrict__ out, int m,
              int n, int rows) {
  __shared__ double red[COLSUM_NT * V];
  __shared__ unsigned taken;
  const int t = threadIdx.x;
  const int r0 = blockIdx.x * rows, r1 = min(m, r0 + rows);
  const int units = n / V;
  double* mine = partial + (size_t)blockIdx.x * n;
  for (int u0 = 0; u0 < units; u0 += COLSUM_NT) {
    const int w = min(COLSUM_NT, units - u0);  // units of this pass
    const int R = COLSUM_NT / w;               // rows a step
    const int sub = t / w, u = t - sub * w;
    if (sub < R) {
      double s[V];
#pragma unroll
      for (int v = 0; v < V; ++v) s[v] = 0.0;
      const Vec* p = reinterpret_cast<const Vec*>(A + (size_t)(r0 + sub) * n) + u0 + u;
      const size_t step = (size_t)R * units;  // Vecs between a thread's rows
      int r = r0 + sub;
      for (; r + (COLSUM_UNROLL - 1) * R < r1; r += COLSUM_UNROLL * R) {
        Vec x[COLSUM_UNROLL];
#pragma unroll
        for (int j = 0; j < COLSUM_UNROLL; ++j) x[j] = load_cols(p + j * step);
#pragma unroll
        for (int j = 0; j < COLSUM_UNROLL; ++j) add_cols(s, x[j]);
        p += COLSUM_UNROLL * step;
      }
      for (; r < r1; r += R, p += step) add_cols(s, load_cols(p));
#pragma unroll
      for (int v = 0; v < V; ++v) red[(sub * w + u) * V + v] = s[v];
    }
    __syncthreads();
    for (int c = t; c < w * V; c += COLSUM_NT) {  // the sub-rows in order
      double tot = 0.0;
      for (int j = 0; j < R; ++j) tot += red[j * w * V + c];
      mine[u0 * V + c] = tot;
    }
    __syncthreads();
  }

  // the last block to finish adds every block's partial
  __threadfence();
  __syncthreads();
  if (t == 0) taken = atomicInc(ticket, gridDim.x - 1);
  __syncthreads();
  if (taken != gridDim.x - 1) return;
  __threadfence();
  const int nb = gridDim.x;
  for (int c0 = 0; c0 < n; c0 += COLSUM_NT) {
    const int w = min(COLSUM_NT, n - c0);  // columns of this pass
    const int S = COLSUM_NT / w;           // stripes of blocks
    const int per = (nb + S - 1) / S;      // blocks a stripe
    const int st = t / w, c = t - st * w;
    if (st < S) {
      const int b1 = min(nb, (st + 1) * per);
      int b = st * per;
      const double* q = partial + (size_t)b * n + c0 + c;
      double s = 0.0;
      for (; b + COLSUM_FIN_UNROLL <= b1; b += COLSUM_FIN_UNROLL) {
        double x[COLSUM_FIN_UNROLL];
#pragma unroll
        for (int j = 0; j < COLSUM_FIN_UNROLL; ++j) x[j] = __ldcg(q + (size_t)j * n);
#pragma unroll
        for (int j = 0; j < COLSUM_FIN_UNROLL; ++j) s += x[j];
        q += (size_t)COLSUM_FIN_UNROLL * n;
      }
      for (; b < b1; ++b, q += n) s += __ldcg(q);
      red[t] = s;
    }
    __syncthreads();
    if (t < w) {  // the stripes in order
      double tot = 0.0;
      for (int j = 0; j < S; ++j) tot += red[j * w + t];
      out[c0 + t] = (float)tot;
    }
    __syncthreads();
  }
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

// out (n floats) = column sums of A (m x n, row-major) in one launch of
// ``blocks`` blocks of ``rows`` rows each (the last may take fewer; from
// colsum_plan); ``scratch`` holds blocks * n doubles of partials and then
// the ticket word; ``vec``: n % 4 == 0 and A 16-byte aligned.
extern "C" int nmf_colsum(const float* A, double* scratch, float* out, int m,
                          int n, int blocks, int rows, int vec, void* stream) {
  if (m <= 0 || n <= 0 || blocks <= 0 || rows <= 0 ||
      (long long)blocks * rows < m || (long long)(blocks - 1) * rows >= m ||
      (vec && n % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* ticket = reinterpret_cast<unsigned*>(scratch + (size_t)blocks * n);
  cudaError_t e = cudaMemsetAsync(ticket, 0, sizeof(unsigned), st);
  if (e != cudaSuccess) return (int)e;
  if (vec)
    colsum_kernel<4, float4><<<blocks, COLSUM_NT, 0, st>>>(A, scratch, ticket, out,
                                                          m, n, rows);
  else
    colsum_kernel<1, float><<<blocks, COLSUM_NT, 0, st>>>(A, scratch, ticket, out,
                                                         m, n, rows);
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
