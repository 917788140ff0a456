// What the fp32 SIMT kernel of this directory (conv3x3_f32.cu) is built
// from: asynchronous copies into shared memory with zero
// fill (cp.async, sm_80 and later), a SiLU without the IEEE division's slow
// path, and the one-time raise of a kernel's dynamic shared memory limit.
// ops/build.py hashes this file with every source that includes it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace simt {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes where `valid` is
// false (src-size 0: nothing is read; `src` must still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, or a zero where `valid` is false.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// SiLU in fp32: x / (1 + e^-x) with the fast division (an IEEE division
// takes its slow path on every zero input; -x large gives e^-x = inf and 0).
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// Raise `kernel`'s dynamic shared memory limit to `bytes` once per device
// (a bit per device in `configured`, one variable per kernel instance).
template <typename Kernel>
inline int allow_smem(Kernel kernel, int bytes, unsigned long long& configured) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!(configured >> (device & 63) & 1)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured |= 1ull << (device & 63);
  }
  return 0;
}

}  // namespace simt
