// Helpers shared by the port's CUDA kernels (sm_90a): cp.async copies, the
// 3xTF32 split and the dynamic shared-memory attribute.  Each kernel source
// includes this header and is built into a library of its own, so everything
// here sits in an anonymous namespace.
#pragma once

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; with `full` false the 16 bytes are zeroed
// (src-size 0) and `src` is not read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna.tf32's
// rounding): add half the weight of the 13 low mantissa bits, then clear
// them.  An add and a mask on the integer pipe; cvt.rna.tf32 in their place
// runs on the much slower conversion pipe, which then bounds the kernel.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small + r, |r| <= 2^-22 |x|: big is x rounded to TF32, small the
// rest (exact in fp32) rounded to TF32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = round_tf32(x);
  small = round_tf32(x - __uint_as_float(big));
}

// split_tf32 as (big, small) in one uint2.
__device__ __forceinline__ uint2 split_tf32(float x) {
  uint2 p;
  split_tf32(x, p.x, p.y);
  return p;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on `device` unless
// an earlier call raised it as far; `done` (one per kernel, static, so zero
// at start) holds the bytes set per device, so later launches make no
// attribute call.
template <typename Kernel>
cudaError_t allow_smem(std::atomic<int> (&done)[64], Kernel* kernel, int bytes,
                       int device) {
  if (device < 64 && done[device].load(std::memory_order_acquire) >= bytes)
    return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < 64)
    done[device].store(bytes, std::memory_order_release);
  return err;
}

}  // namespace
