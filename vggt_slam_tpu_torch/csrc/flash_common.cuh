// Helpers shared by the port's kernels: the launch attributes, the shared
// address of a pointer, bf16 packing and int8 rounding.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace flash {

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Raise `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device, once per device (the attribute lives in the device's context):
// `done` is the caller's static for this kernel, a bit per device. Writes
// the current device to *dev.
template <typename Kernel>
inline int smem_limit_once(Kernel kernel, int bytes,
                           std::atomic<uint64_t>& done, int* dev) {
  cudaError_t e = cudaGetDevice(dev);
  if (e != cudaSuccess) return int(e);
  const uint64_t bit = *dev < 64 ? uint64_t(1) << *dev : 0;
  if (done.load(std::memory_order_acquire) & bit) return 0;
  e = cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return int(e);
  done.fetch_or(bit, std::memory_order_acq_rel);
  return 0;
}

// The SM count of device `dev`, asked of the runtime once per device (0 if
// it fails, which the launch then refuses).
inline int sm_count(int dev) {
  static std::atomic<int> cached[64];
  const bool slot = dev >= 0 && dev < 64;
  if (slot && cached[dev].load(std::memory_order_relaxed) > 0)
    return cached[dev].load(std::memory_order_relaxed);
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (slot) cached[dev].store(n, std::memory_order_relaxed);
  return n;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Round-half-even quantization of x * inv to [-127, 127] (`_quant_i8`).
__device__ __forceinline__ int8_t quant_i8(float x, float inv) {
  const int q = __float2int_rn(__fmul_rn(x, inv));
  return static_cast<int8_t>(max(-127, min(127, q)));
}

}  // namespace flash
