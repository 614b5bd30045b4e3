// Asynchronous copies from device memory to shared memory (cp.async, sm_80
// and later), shared by the dense-tile product (dense_matmul.cu) and the
// divergence products (mu.cu).  A copy of n < size bytes fills the rest of
// its destination with zeros; n = 0 reads nothing, so a copy past an edge
// passes any valid pointer with n = 0.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace cp_async {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// n bytes from src (0: zero fill; src is then not read); both 16-byte aligned
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// until at most N of this thread's groups are in flight
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace cp_async
