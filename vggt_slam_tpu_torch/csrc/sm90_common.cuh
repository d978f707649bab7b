// Hopper helpers shared by flash_sm90.cuh, flash_bwd_sm90.cuh,
// bench_attention.cu, bench_matmul_shapes.cu and global_sm90.cuh:
// mbarriers, TMA loads and stores, the swizzled tile layout and its wgmma
// descriptors, wgmma issue and sync, register-A and shared-A products,
// the int8 QK^T, exp2 on MUFU.EX2, and the 4-D maps of (B, N, H*D) and 3-D
// maps of (B, rows, cols) tensors. A tile row is D bf16 (256, 128, 64
// bytes at D 128, 64, 32; 128- and 64-byte swizzles) or D int8 (32-byte
// swizzle); rows wider than the 128-byte atom are panels (`panel`).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Shared memory a block may take on an H100 (dynamic, after the attribute).
constexpr size_t SM90_SMEM_MAX = 232448;

// The bytes of a row of a tile's panel: a tile of R rows of ROW bytes is ROW /
// panel(ROW) panels of R rows, each one swizzle atom and one TMA box wide; at
// ROW = 256 panel p holds bytes [128p, 128p + 128) of every row.
__host__ __device__ constexpr int panel(int row) {
  return row < 128 ? row : 128;
}

// Byte offset of 16-byte chunk c of row r in a swizzled tile: the chunk index
// in its panel row XORs with address bits 7 and up (Swizzle<3,4,3> at 128-byte
// rows, c ^ (r & 7); Swizzle<2,4,3> at 64, c ^ ((r >> 1) & 3)), as TMA writes
// it and wgmma reads it.
template <int D, int R = 128>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  constexpr int PR = panel(2 * D), PC = PR / 16;   // chunks of a panel row
  return (c / PC) * (R * PR) + r * PR +
         (((c % PC) ^ ((r * PR >> 7) & (PC - 1))) << 4);
}

// Shared address of byte x of row r in a tile of R rows of ROW bytes at
// `tile` (panel x / panel(ROW)): a descriptor's start where r is a multiple
// of 8 and the bytes it spans lie in one panel.
template <int ROW, int R>
__device__ __forceinline__ uint32_t at_row(uint32_t tile, int r, int x) {
  constexpr int PR = panel(ROW);
  return tile + (x / PR) * (R * PR) + r * PR + x % PR;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A phase that never
// completes (a fault in the barrier protocol) traps after 2^30 polls, so
// the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (polls == (1u << 30)) __trap();
  }
}

// Keys [k0, k0 + SM90_BK) of kv_bias (a 1-D map) into shared memory.
__device__ __forceinline__ void tma_load_bias(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int k0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(k0) : "memory");
}

// Rows [row, row + box) of columns [c, c + box) of head h of batch b into
// a swizzled tile.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c, int h, int row,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c), "r"(h),
      "r"(row), "r"(b) : "memory");
}

// Box (c0, c1, c2) of a 3-D map (`encode_rows`) into a swizzled tile.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2) : "memory");
}

// A swizzled tile at src to box (c0, c1, c2) of a 3-D map, in this
// thread's open bulk group; elements past the map's extent are not
// written. The writes into src must precede a fence_proxy_async.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2) : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// At most N of this thread's bulk groups still reading shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

// Every bulk group of this thread complete.
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// This thread's shared-memory writes visible to the async proxy (TMA).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Warpgroup w alone (named barrier 2 + w; 1 is the backward's consumers).
__device__ __forceinline__ void warpgroup_sync(int w) {
  asm volatile("bar.sync %0, 128;" ::"r"(2 + w) : "memory");
}

// Rows [row, row + R) of head h of batch b, D elements of ESZ bytes each,
// into a tile of R rows (`encode_heads`' map): one box per panel.
template <int D, int R, int ESZ = 2>
__device__ __forceinline__ void tma_load_tile(uint32_t dst,
                                              const CUtensorMap* map,
                                              uint32_t bar, int h, int row,
                                              int b) {
  constexpr int PR = panel(ESZ * D);
#pragma unroll
  for (int p = 0; p < ESZ * D / PR; ++p)
    tma_load(dst + p * R * PR, map, bar, p * PR / ESZ, h, row, b);
}

// wgmma descriptor of a tile of ROW-byte rows swizzled by the row's width
// (start >> 4 in bits 0-13, leading byte offset >> 4 in 16-29, stride byte
// offset >> 4 in 32-45, swizzle in 62-63: 1 = 128B, 2 = 64B, 3 = 32B). The
// stride offset steps over an 8-row atom (1024, 512 or 256 bytes); the leading
// offset is unused: the operand's contiguous extent is one panel row.
template <int ROW>
__device__ __forceinline__ uint64_t row_desc(uint32_t addr) {
  static_assert(ROW == 32 || ROW == 64 || ROW == 128, "row of 32-128 bytes");
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(8 * ROW / 16) << 32) |
         (uint64_t(ROW == 128 ? 1 : ROW == 64 ? 2 : 3) << 62);
}

// An MN-major operand of several 128-byte panels (64 bf16 of N each) whose
// 8-row K groups lie 1024 bytes apart: the leading byte offset steps panel to
// panel (`stride`), so one instruction reads N = 64 x panels (CUTLASS's
// canonical MN-major SW128 layout).
__device__ __forceinline__ uint64_t mn_desc(uint32_t addr, uint32_t stride) {
  return (row_desc<128>(addr) & ~(uint64_t(0x3FFF) << 16)) |
         (uint64_t(stride >> 4) << 16);
}

// The descriptor of a tile of D-wide bf16 rows (its panel at D = 128).
template <int D>
__device__ __forceinline__ uint64_t sw_desc(uint32_t addr) {
  return row_desc<panel(2 * D)>(addr);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma region.
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
  }
}
template <int N>
__device__ __forceinline__ void reg_fence(int (&d)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(d[j][e])::"memory");
  }
}

#define SM90_F4(d, j) \
  "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])

// d (64 x 64 per warpgroup) += A (64 x 16, registers) B (16 x 64, smem,
// MN-major).
__device__ __forceinline__ void wgmma_pv(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1), SM90_F4(d, 2), SM90_F4(d, 3),
        SM90_F4(d, 4), SM90_F4(d, 5), SM90_F4(d, 6), SM90_F4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32 per warpgroup) += A (64 x 16, registers) B (16 x 32, smem,
// MN-major).
__device__ __forceinline__ void wgmma_pv(float (&d)[4][4],
                                         const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1), SM90_F4(d, 2), SM90_F4(d, 3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x D per warpgroup) += A (64 x 16, registers) B (16 x D: rows [r0,
// r0 + 16) of a tile of R rows of D bf16 at `tile`, MN-major), one product
// per panel (at D = 128 two m64n64k16, each on its half of d's n-tiles).
template <int D, int R>
__device__ __forceinline__ void wgmma_pv_rows(float (&d)[D / 8][4],
                                              const uint32_t (&a)[4],
                                              uint32_t tile, int r0) {
  constexpr int PR = panel(2 * D), NT = PR / 16;   // 8-dim n-tiles a panel
#pragma unroll
  for (int p = 0; p < D / 8 / NT; ++p)
    wgmma_pv(*reinterpret_cast<float(*)[NT][4]>(d[p * NT]), a,
             sw_desc<D>(tile + p * R * PR + r0 * PR));
}

// d (64 x 8N per warpgroup) = or += A (64 x 16, smem) B^T (8N x 16, smem),
// both K-major (QK^T of bf16 tiles): wgmma m64n{128,64,32}k16.
__device__ __forceinline__ void wgmma_qk(float (&d)[16][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1), SM90_F4(d, 2), SM90_F4(d, 3),
        SM90_F4(d, 4), SM90_F4(d, 5), SM90_F4(d, 6), SM90_F4(d, 7),
        SM90_F4(d, 8), SM90_F4(d, 9), SM90_F4(d, 10), SM90_F4(d, 11),
        SM90_F4(d, 12), SM90_F4(d, 13), SM90_F4(d, 14), SM90_F4(d, 15)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_qk(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1), SM90_F4(d, 2), SM90_F4(d, 3),
        SM90_F4(d, 4), SM90_F4(d, 5), SM90_F4(d, 6), SM90_F4(d, 7)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_qk(float (&d)[4][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1), SM90_F4(d, 2), SM90_F4(d, 3)
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x N per warpgroup) = or += A (64 x 16, smem, K-major) B (16 x N,
// smem, MN-major: `mn_desc`): wgmma m64n{256,128}k16, transpose bit of B
// set.
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[32][4], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "%128, %129, p, 1, 1, 0, 1;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1), SM90_F4(d, 2), SM90_F4(d, 3),
        SM90_F4(d, 4), SM90_F4(d, 5), SM90_F4(d, 6), SM90_F4(d, 7),
        SM90_F4(d, 8), SM90_F4(d, 9), SM90_F4(d, 10), SM90_F4(d, 11),
        SM90_F4(d, 12), SM90_F4(d, 13), SM90_F4(d, 14), SM90_F4(d, 15),
        SM90_F4(d, 16), SM90_F4(d, 17), SM90_F4(d, 18), SM90_F4(d, 19),
        SM90_F4(d, 20), SM90_F4(d, 21), SM90_F4(d, 22), SM90_F4(d, 23),
        SM90_F4(d, 24), SM90_F4(d, 25), SM90_F4(d, 26), SM90_F4(d, 27),
        SM90_F4(d, 28), SM90_F4(d, 29), SM90_F4(d, 30), SM90_F4(d, 31)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_mn(float (&d)[16][4], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1), SM90_F4(d, 2), SM90_F4(d, 3),
        SM90_F4(d, 4), SM90_F4(d, 5), SM90_F4(d, 6), SM90_F4(d, 7),
        SM90_F4(d, 8), SM90_F4(d, 9), SM90_F4(d, 10), SM90_F4(d, 11),
        SM90_F4(d, 12), SM90_F4(d, 13), SM90_F4(d, 14), SM90_F4(d, 15)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define SM90_R4(d, j) \
  "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3])

// wgmma_qk on int8 tiles (K = 32 bytes a step), s32 sums, both operands
// K-major as PTX requires of 8-bit ones: wgmma m64n{128,64,32}k32.
__device__ __forceinline__ void wgmma_qk(int (&d)[16][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : SM90_R4(d, 0), SM90_R4(d, 1), SM90_R4(d, 2), SM90_R4(d, 3),
        SM90_R4(d, 4), SM90_R4(d, 5), SM90_R4(d, 6), SM90_R4(d, 7),
        SM90_R4(d, 8), SM90_R4(d, 9), SM90_R4(d, 10), SM90_R4(d, 11),
        SM90_R4(d, 12), SM90_R4(d, 13), SM90_R4(d, 14), SM90_R4(d, 15)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_qk(int (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p;\n}\n"
      : SM90_R4(d, 0), SM90_R4(d, 1), SM90_R4(d, 2), SM90_R4(d, 3),
        SM90_R4(d, 4), SM90_R4(d, 5), SM90_R4(d, 6), SM90_R4(d, 7)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_qk(int (&d)[4][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p;\n}\n"
      : SM90_R4(d, 0), SM90_R4(d, 1), SM90_R4(d, 2), SM90_R4(d, 3)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 s32 a warpgroup) = or += A (64 x 32 int8, registers) B (32 x 64
// int8, smem, K-major): wgmma m64n64k32; A in mma.sync m16n8k32's layout
// (a[0]: row g, bytes 4t..; a[1]: row g + 8; a[2], a[3]: bytes 16 + 4t..).
__device__ __forceinline__ void wgmma_pv8(int (&d)[8][4],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : SM90_R4(d, 0), SM90_R4(d, 1), SM90_R4(d, 2), SM90_R4(d, 3),
        SM90_R4(d, 4), SM90_R4(d, 5), SM90_R4(d, 6), SM90_R4(d, 7)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// 2^x in one MUFU.EX2: exp2f's own instruction without the three that
// keep results below 2^-126 subnormal; those flush to 0 here. Below a row's
// running max that is invisible (l >= 1, P rounds to bf16); with the static
// bound it zeroes keys more than 126 below the bound.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cuTensorMapEncodeTiled, looked up in libcuda at run time: the library
// is linked without -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault) != cudaSuccess)
      f = nullptr;
#endif
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// 4-D map (D, H, n, B) of a packed (B, N, H*D) tensor of ESZ-byte
// elements (bf16, or int8 with ESZ = 1), cut at n <= N rows: a box is
// `rows` rows of one panel of one head (the whole row at D * ESZ <= 128
// bytes) of `batches` consecutive batches, batch-major, swizzled by the
// panel row's width (as swz<D> for bf16); rows at or past n read as zeros.
template <int D, int ESZ = 2>
int encode_heads(CUtensorMap* map, const void* ptr, int B, int N, int n,
                 int H, int rows, int batches = 1) {
  constexpr cuuint64_t ROW = ESZ * D;
  constexpr cuuint32_t PR = panel(ROW);
  static_assert(ROW == 32 || ROW == 64 || ROW == 128 || ROW == 256,
                "row of 32-256 bytes");
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  const cuuint64_t dims[4] = {D, cuuint64_t(H), cuuint64_t(n),
                              cuuint64_t(B)};
  const cuuint64_t strides[3] = {ROW, ROW * H, ROW * H * N};
  const cuuint32_t box[4] = {PR / ESZ, 1, cuuint32_t(rows),
                            cuuint32_t(batches)};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map,
      ESZ == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      4, const_cast<void*>(ptr), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      PR == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : PR == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                 : CU_TENSOR_MAP_SWIZZLE_32B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// 3-D map (cols, rows, B) of a contiguous (B, batch_rows, cols) tensor of
// ESZ-byte elements (bf16, or int8 with ESZ = 1), cut at rows <= batch_rows
// (default rows): a box is `box_rows` rows of 64 columns (one 128-byte
// panel of bf16, 128-byte swizzled; 64 bytes of int8, 64-byte swizzled) of
// one batch; elements past an edge read as zeros and are not written by a
// store. The batch is a dimension of its own, so a box never reaches into
// the next batch.
template <int ESZ = 2>
int encode_rows(CUtensorMap* map, const void* ptr, int B, int rows, int cols,
                int box_rows, int batch_rows = 0) {
  static_assert(ESZ == 1 || ESZ == 2, "bf16 or int8 elements");
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0 || cols * ESZ % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  if (batch_rows < rows) batch_rows = rows;
  const cuuint64_t dims[3] = {cuuint64_t(cols), cuuint64_t(rows),
                              cuuint64_t(B)};
  const cuuint64_t strides[2] = {cuuint64_t(ESZ) * cols,
                                 cuuint64_t(ESZ) * cols * batch_rows};
  const cuuint32_t box[3] = {64, cuuint32_t(box_rows), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      ESZ == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8,
      3, const_cast<void*>(ptr), dims, strides, box, step,
      CU_TENSOR_MAP_INTERLEAVE_NONE,
      ESZ == 2 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

}  // namespace
