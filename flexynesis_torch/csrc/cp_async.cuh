// Helpers shared by the port's kernels: cp.async copies from global to
// shared memory (sm_80 and later), float4 components and a fixed-order warp
// sum.
#pragma once

namespace fxk {

// 16-byte asynchronous copy; `src_bytes` < 16 zero-fills the rest, so 0
// reads nothing and writes zeros (the source must still be a valid address).
// Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

// 4-byte asynchronous copy, for rows whose stride is not a multiple of 16
// bytes; `src_bytes` 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// component q (0..3, a constant after unrolling) of a float4
__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Sum over the 32 lanes by an xor butterfly: the same order in every call,
// and every lane ends with the same bits (each step adds a commuted pair).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace fxk
