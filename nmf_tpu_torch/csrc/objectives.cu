// The dense objectives without the p x n product in device memory:
//   kind 0:  0.5 * sum((X - W @ H)^2)
//   kind 1:  gkldiv(X, W @ H) = sum(x * (log x - log wh) - x + wh), an entry
//            with x = 0 adding wh, and log wh read as 0 where wh <= 0
//
// Replaces the TPU kernel nmf_tpu/ops/pallas/objectives.py:_obj_kernel
// (launched by _objective_pallas): one body, a template on the kind.
//
// What bounds it on an H100: operations, 2 * p * n * k flops over X read
// once (k = 64: 32 flops a byte, above the card's 20), plus the term of
// each entry (for kind 1 a logf, not an approximation, and a division: one
// block an SM issues the term's instructions on the slots the W @ H FMAs
// use, so the KL term is taken as x * log(x / wh), one logf fewer than log
// x - log wh; the timings are in PERF.md).
//
// Design: the W @ H tile of the divergence products (quotient_tile.cuh,
// mu.cu's wtq without its second product).  A thread block owns QT_L = 256
// columns: H's columns are staged once for the walk (k <= QT_KS), and the
// block walks the rows of X in steps of QT_S = 64, the next step's X tile
// and W rows in flight with cp.async while the current step's tile is
// formed.  Each thread forms an 8 x 8 piece of W @ H, summed over k in
// increasing order, and the terms of its 64 entries with X read from shared
// memory.  The 64 terms of a step are summed in float32 in a fixed order
// and added to the thread's double once a step (each term added to the
// double cost more: PERF.md).  The block sums its 256
// doubles in a fixed order (shuffles inside a warp, then the 8 warps in
// turn) and writes one partial; a second, one-block kernel sums the partials
// in a fixed order, in double, and writes the float result.  No atomics:
// two runs give the same bits.  Rows and columns past the edge read as x =
// 0, wh = 0, where both terms vanish.  Above QT_KS the W @ H tile is
// summed over k one slab at a time (wh_rows_slabs), so any k fits.  A
// misaligned X or n % 4 != 0 takes 4-byte copies.
//
// With few column panels (40 at n = 10,000) the caller cuts the walk over
// the rows into ``splits`` runs of whole steps (grid.z), each with its own
// partial; the cut follows the rule of wtq's walk (ops/cuda/mu.py:
// walk_splits).

#include <cfloat>

#include "quotient_tile.cuh"

// the H slab, two W slabs, two X tiles
#define OBJ_SMEM ((QT_KS * QT_L + 2 * QT_S * QT_LDS + 2 * QT_S * QT_L) * 4)

namespace {

using namespace quotient_tile;

// The term of one entry: x the entry of X, w that of W @ H.  KL: where x >
// 0, x * (log x - log w) - x + w with w <= 0 read as 1; x = 0 (or NaN) adds
// w.  RATIO takes that as x * log(x / w) - x + w: one logf of the quotient
// (divided without a branch, div_rn) in place of two, the same function
// with fewer instructions.  div_rn's range flag (both operands within
// 2^-64 .. 2^64, where the quotient itself is used) is not read: the term
// uses only the quotient's logarithm, times x.  Where the division fails (w
// subnormal or above 2^126, x / w overflowing or rounding to 0) the
// quotient is 0, inf or NaN, the term is not finite, and the caller takes
// the other form.  A subnormal quotient keeps fewer bits: an error in the
// term of about w * 2^-149 at most, far below its w.  The card tests hold
// the objective at operands outside 2^-64 .. 2^64 (tests/test_torch_gpu.py).
// Both forms take the logarithm outside the select, so that no entry
// branches and the 64 terms of a step interleave.
template <int KIND, bool RATIO>
__device__ __forceinline__ float term(float x, float w) {
  if (KIND == 0) {
    const float d = x - w;
    return d * d;
  }
  const float a = x > 0.f ? x : 1.f, y = w > 0.f ? w : 1.f;
  if (RATIO) {
    bool unused = true;  // the range flag: see above
    const float l = logf(div_rn(a, y, unused));
    return x > 0.f ? x * l - x + w : w;
  }
  const float lx = logf(a), lw = logf(y);
  return x > 0.f ? x * (lx - lw) - x + w : w;
}

// The sum of the thread's 64 terms of a step, in a fixed order: X's entries
// from the step's tile, W @ H's from the thread's piece; two running sums
// (the first two and the last two entries of each float4), so that twice
// as many additions are independent.
template <int KIND, bool RATIO>
__device__ __forceinline__ float step_terms(const float* Xb, const float (&wh)[8][8],
                                            int ty, int tx) {
  float t = 0.f, t1 = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 x = ld4(Xb + Wide::at(ty + 8 * u, h ? 32 + tx : tx));
      t += term<KIND, RATIO>(x.x, wh[u][4 * h]);
      t += term<KIND, RATIO>(x.y, wh[u][4 * h + 1]);
      t1 += term<KIND, RATIO>(x.z, wh[u][4 * h + 2]);
      t1 += term<KIND, RATIO>(x.w, wh[u][4 * h + 3]);
    }
  return t + t1;
}

// The thread's double sum of its terms over the walk of the rows begin ..
// begin + QT_S steps of the block's 256 columns j0.., staging included;
// ``finite`` is cleared where a step's sum is not finite.  Thread (ty, tx)
// as wtq's: W @ H rows ty + 8 u (u < 8), columns 4 tx + v and 128 + 4 tx +
// v (v < 4).  ONE: k <= QT_KS.
template <bool ONE, int KIND, bool RATIO>
__device__ __forceinline__ double walk(const float* X, const float* W,
                                       const float* H, int p, int n, int k,
                                       int vec, int begin, int steps, int j0,
                                       float* sm, int ty, int tx, bool& finite) {
  float* Hs = sm;                      // QT_KS x QT_L: a k-slab of H's columns
  float* Ws = Hs + QT_KS * QT_L;       // 2 x QT_S x QT_LDS: W rows, a k-slab
  float* Xs = Ws + 2 * QT_S * QT_LDS;  // 2 x QT_S x QT_L: X tiles
  const bool xv = vec & 1, wv = vec & 2, hv = vec & 4;
  if (ONE) {  // H for the whole walk, the first step's W rows
    stage<QT_KS, QT_L, Wide>(Hs, H, n, 0, k, j0, n, hv);
    stage<QT_S, QT_KS, Slab>(Ws, W, k, begin, p, 0, k, wv);
  }
  stage<QT_S, QT_L, Wide>(Xs, X, n, begin, p, j0, n, xv);
  cp_commit();
  double s = 0.0;
  for (int st = 0; st < steps; ++st) {
    const int i0 = begin + st * QT_S, nb = (st + 1) & 1;
    const float* Xb = Xs + (st & 1) * QT_S * QT_L;
    cp_wait<0>();
    __syncthreads();  // step st's tiles are in; step st - 1 is done
    if (st + 1 < steps) {
      if (ONE)
        stage<QT_S, QT_KS, Slab>(Ws + nb * QT_S * QT_LDS, W, k, i0 + QT_S, p,
                                 0, k, wv);
      stage<QT_S, QT_L, Wide>(Xs + nb * QT_S * QT_L, X, n, i0 + QT_S, p, j0,
                              n, xv);
      cp_commit();
    }
    float wh[8][8];
    zero8(wh);
    if (ONE)  // QT_KS deep: the slabs are zero past k
      piece_rows<Slab, Wide>(wh, Ws + (st & 1) * QT_S * QT_LDS, ty, Hs, tx,
                             32 + tx, QT_KS);
    else  // no slab is the block's own components: the first buffer only
      wh_rows_slabs(wh, Ws, Hs, W, H, i0, j0, p, n, k, -1, ty, tx, wv, hv);
    const float t = step_terms<KIND, RATIO>(Xb, wh, ty, tx);
    finite &= fabsf(t) <= FLT_MAX;
    s += (double)t;
  }
  cp_wait<0>();
  return s;
}

// One partial a block: the walk over rows begin .. begin + run of the block's
// 256 columns j0 = QT_L blockIdx.x.. .  KL walks with the quotient form; a
// block with a step sum that is not finite (a quotient div_rn could not
// form, or an inf or NaN in X or W @ H) walks its run again with two logf,
// as the plain version forms the term.  vec: quotient_tile.cuh's vec_bits.
template <bool ONE, int KIND>
__global__ void __launch_bounds__(QT_NT, 1)
objective_kernel(const float* __restrict__ X, const float* __restrict__ W,
                 const float* __restrict__ H, double* __restrict__ partial,
                 int p, int n, int k, int vec, int run) {
  extern __shared__ __align__(16) float sm[];
  __shared__ double warp_sum[QT_NT / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ty = 4 * (warp & 1) + (lane >> 3);
  const int tx = 8 * (warp >> 1) + (lane & 7);
  const int j0 = blockIdx.x * QT_L;
  const int begin = blockIdx.z * run, end = min(p, begin + run);
  const int steps = end > begin ? (end - begin + QT_S - 1) / QT_S : 0;
  bool finite = true;
  double s = walk<ONE, KIND, KIND == 1>(X, W, H, p, n, k, vec, begin, steps,
                                        j0, sm, ty, tx, finite);
  if (KIND == 1 && __syncthreads_or(!finite))
    s = walk<ONE, KIND, false>(X, W, H, p, n, k, vec, begin, steps, j0, sm, ty,
                               tx, finite);

#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (lane == 0) warp_sum[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < QT_NT / 32; ++w) tot += warp_sum[w];
    partial[blockIdx.z * gridDim.x + blockIdx.x] = tot;
  }
}

__global__ void __launch_bounds__(QT_NT)
objective_reduce_kernel(const double* __restrict__ partial, int nparts,
                        double scale, float* __restrict__ out) {
  __shared__ double sh[QT_NT];
  double s = 0.0;
  for (int i = threadIdx.x; i < nparts; i += QT_NT) s += partial[i];
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int half = QT_NT / 2; half; half >>= 1) {
    if (threadIdx.x < half) sh[threadIdx.x] += sh[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)(scale * sh[0]);
}

typedef void (*ObjectiveKernel)(const float*, const float*, const float*,
                                double*, int, int, int, int, int);

}  // namespace

// out[0] = the objective of the given kind (0 mse, 1 kl).  X (p x n), W (p
// x k), H (k x n), all row-major; the walk over the rows is cut into
// ``splits`` runs, and ``partial`` holds ceil(n / 256) * splits doubles of
// scratch.  ``xvec``: n % 4 == 0 and X 16-byte aligned.  Returns the CUDA
// error code of the launches (0 = success).
extern "C" int nmf_dense_objective(const float* X, const float* W,
                                   const float* H, double* partial, float* out,
                                   int p, int n, int k, int kind, int xvec,
                                   int splits, void* stream) {
  if (p <= 0 || n <= 0 || k <= 0 || splits <= 0 || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  const bool one = k <= QT_KS;
  ObjectiveKernel kernel =
      kind == 0 ? (one ? objective_kernel<true, 0> : objective_kernel<false, 0>)
                : (one ? objective_kernel<true, 1> : objective_kernel<false, 1>);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, OBJ_SMEM);
  if (e != cudaSuccess) return (int)e;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((n + QT_L - 1) / QT_L, 1, splits);
  kernel<<<grid, QT_NT, OBJ_SMEM, st>>>(X, W, H, partial, p, n, k,
                                        vec_bits(W, H, nullptr, n, k, xvec),
                                        run_length(p, splits));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  objective_reduce_kernel<<<1, QT_NT, 0, st>>>(partial, (int)(grid.x * splits),
                                               kind == 0 ? 0.5 : 1.0, out);
  return (int)cudaGetLastError();
}
