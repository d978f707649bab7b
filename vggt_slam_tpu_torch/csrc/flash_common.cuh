// Helpers shared by the port's kernels: the launch attributes, bf16
// packing and int8 rounding of the flash-attention kernels, and the
// mma.sync fragment helpers of the DPT tail (dpt_tail.cu).
//
// Conventions of mma.sync m16n8k16 (row.col, bf16 in, f32 accumulate), with
// g = lane / 4 and t = lane % 4:
//   A (16x16): a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//              a2 (row g, cols 2t+8..), a3 (row g+8, cols 2t+8..);
//   B (16x8):  b0 (k 2t..2t+1, col g), b1 (k 2t+8..2t+9, col g);
//   C (16x8):  c0,c1 (row g, cols 2t, 2t+1), c2,c3 (row g+8, same cols).
// Tiles in shared memory are 64 rows of D bf16 with a row stride of D + 8,
// which keeps ldmatrix free of bank conflicts.
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// D(16x8 f32) += A(16x16 bf16, row) * B(16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A fragment of rows [row0, row0 + 16) and cols [col0, col0 + 16) of a
// shared tile with row stride LD.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int row0,
                                       int col0, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldmatrix_x4(a, tile + (row0 + (m % 2) * 8 + r) * LD + col0 + (m / 2) * 8);
}

// B fragments of X for two 8-col n-tiles: rows [row0, row0 + 16) of the
// tile are the k index, cols [col0, col0 + 16) the n index. b[0], b[1] feed
// n-tile col0 / 8, b[2], b[3] n-tile col0 / 8 + 1 (the O += P V pattern).
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4],
                                       const __nv_bfloat16* tile, int row0,
                                       int col0, int lane) {
  const int m = lane / 8, r = lane % 8;
  ldmatrix_x4_trans(b, tile + (row0 + (m % 2) * 8 + r) * LD + col0 +
                           (m / 2) * 8);
}

// Round-half-even quantization of x * inv to [-127, 127] (`_quant_i8`).
__device__ __forceinline__ int8_t quant_i8(float x, float inv) {
  const int q = __float2int_rn(__fmul_rn(x, inv));
  return static_cast<int8_t>(max(-127, min(127, q)));
}

}  // namespace flash
