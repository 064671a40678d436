// Helpers of the float32 (bank_read.cu) and bf16 (bank_read_bf16.cu) bank
// kernels: shapes, the occupancy bound and quad reductions (both), cp.async
// (the float32 kernels).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DK = 128;
constexpr int DV = 512;
constexpr float NEG = -1e30f;   // masked score, as in the JAX kernels
constexpr int QT = 64;          // query rows per tile (4 warps x 16 rows)

// Occupancy bound (the semantics of vfloodnet_tpu/ops/attention.py
// _xla_read_occ): with c = min(chunk, N), only the first
// clip(ceil(occ/c), 1, ceil(N/c)) chunks of c slots are visited. Without a
// bound every one of the N slots is visited.
__device__ __forceinline__ int visited_slots(const int* occ_bound, int n,
                                             int chunk) {
  if (occ_bound == nullptr) return n;
  const int c = min(chunk, n);
  const int n_chunks = (n + c - 1) / c;
  const int occ = max(*occ_bound, 0);
  const int it = max(1, min((occ + c - 1) / c, n_chunks));
  return it * c;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = pred ? 16 : 0;   // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(PENDING) : "memory");
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
