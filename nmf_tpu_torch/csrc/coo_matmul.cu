// COO band product:  out += X_band @ D.
//
// The band is not a Pallas kernel in the reference: nmf_tpu/ops/pallas/
// sparse.py:_coo_matmul computes it as a gather and a sorted segment_sum
// (XLA), and adds it once to the finished product of the other store
// classes.  This kernel keeps that order: each row's band entries are summed
// in band order (the band is sorted by row, ops/sparse_format.py), starting
// from zero, and the row's sum is then added to out once.  No atomics: the
// same inputs give the same bits on every run.
//
// What bounds it on an H100: bytes, and the latency of the gathers.  A band
// entry is 8 bytes of store and one gathered row of D (4k bytes) for 2k
// flops; at ttt4 the band is 160,910 entries (82 MB of gathered rows at
// k = 128, mostly from L2).
//
// Design: one warp a row.  Its lanes own V adjacent columns each (V = 4
// where k % 4 == 0 and D and out are 16-byte aligned, 2 where they are
// 8-byte aligned and k is even, else 1), 32 V columns a slice of k; for each
// slice the warp loads up to 32 of the row's (column, value) pairs at once,
// one a lane, and walks them in order from shuffles, the sums in registers.
// Products and sums are rounded apart (no fused multiply-add), as the plain
// version's scale-then-add.  Rows without band entries are left as they are.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define WARPS 8  // a block

namespace {

template <int V> struct Vec;
template <> struct Vec<1> {
  using T = float;
  static __device__ __forceinline__ T zero() { return 0.f; }
  static __device__ __forceinline__ void axpy(T& a, float w, T x) {
    a = __fadd_rn(a, __fmul_rn(w, x));
  }
  static __device__ __forceinline__ void add(T& o, T a) { o = __fadd_rn(o, a); }
};
template <> struct Vec<2> {
  using T = float2;
  static __device__ __forceinline__ T zero() { return make_float2(0.f, 0.f); }
  static __device__ __forceinline__ void axpy(T& a, float w, T x) {
    a.x = __fadd_rn(a.x, __fmul_rn(w, x.x));
    a.y = __fadd_rn(a.y, __fmul_rn(w, x.y));
  }
  static __device__ __forceinline__ void add(T& o, T a) {
    o.x = __fadd_rn(o.x, a.x);
    o.y = __fadd_rn(o.y, a.y);
  }
};
template <> struct Vec<4> {
  using T = float4;
  static __device__ __forceinline__ T zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void axpy(T& a, float w, T x) {
    a.x = __fadd_rn(a.x, __fmul_rn(w, x.x));
    a.y = __fadd_rn(a.y, __fmul_rn(w, x.y));
    a.z = __fadd_rn(a.z, __fmul_rn(w, x.z));
    a.w = __fadd_rn(a.w, __fmul_rn(w, x.w));
  }
  static __device__ __forceinline__ void add(T& o, T a) {
    o.x = __fadd_rn(o.x, a.x);
    o.y = __fadd_rn(o.y, a.y);
    o.z = __fadd_rn(o.z, a.z);
    o.w = __fadd_rn(o.w, a.w);
  }
};

template <int V>
__global__ void __launch_bounds__(WARPS * 32)
coo_row_kernel(const int* __restrict__ coo_ptr, const int* __restrict__ coo_cols,
               const float* __restrict__ coo_vals, const float* __restrict__ D,
               float* __restrict__ out, int rows, int k) {
  using T = typename Vec<V>::T;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int beg = coo_ptr[row], end = coo_ptr[row + 1];
  if (beg == end) return;
  const int lane = threadIdx.x & 31;
  const int kv = k / V;
  for (int jv = lane; jv - lane < kv; jv += 32) {  // the same trips warp-wide
    T acc = Vec<V>::zero();
    for (int e0 = beg; e0 < end; e0 += 32) {
      const int n = min(32, end - e0);
      const int my = e0 + lane < end ? e0 + lane : beg;
      const int c = coo_cols[my];
      const float v = coo_vals[my];
      for (int u = 0; u < n; ++u) {
        const int cu = __shfl_sync(FULL_MASK, c, u);
        const float vu = __shfl_sync(FULL_MASK, v, u);
        if (jv < kv)
          Vec<V>::axpy(acc, vu,
                       reinterpret_cast<const T*>(D + (size_t)cu * k)[jv]);
      }
    }
    if (jv < kv) Vec<V>::add(reinterpret_cast<T*>(out + (size_t)row * k)[jv], acc);
  }
}

template <int V>
int launch_rows(const int* coo_ptr, const int* coo_cols, const float* coo_vals,
                const float* D, float* out, int rows, int k,
                cudaStream_t stream) {
  coo_row_kernel<V><<<(rows + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      coo_ptr, coo_cols, coo_vals, D, out, rows, k);
  return (int)cudaGetLastError();
}

}  // namespace

// out (rows x k) += band @ D (cols x k); coo_ptr (rows + 1) points into the
// band's columns and values.  Returns the CUDA error code of the launch
// (0 = success).
extern "C" int nmf_coo_matmul(const int* coo_ptr, const int* coo_cols,
                              const float* coo_vals, const float* D, float* out,
                              int rows, int k, void* stream) {
  if (rows <= 0 || k <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t a = (uintptr_t)D | (uintptr_t)out;
  if (k % 4 == 0 && a % 16 == 0)
    return launch_rows<4>(coo_ptr, coo_cols, coo_vals, D, out, rows, k, s);
  if (k % 2 == 0 && a % 8 == 0)
    return launch_rows<2>(coo_ptr, coo_cols, coo_vals, D, out, rows, k, s);
  return launch_rows<1>(coo_ptr, coo_cols, coo_vals, D, out, rows, k, s);
}
