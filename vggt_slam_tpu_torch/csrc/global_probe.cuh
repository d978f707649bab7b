// Building blocks of the global-shape softmax-variants probe
// (bench_softmax_variants.cu), the first design of the port's probes
// (bench_global_attention.cu and bench_int8_inkernel.cu run global_sm90.cuh
// since). It runs one CTA of BQ / 16 warps per BQ-row q tile of one
// (batch, head) problem of contiguous (BH, N, 64) tensors: every warp owns
// 16 q rows, whose A fragments stay in registers for the whole key sweep;
// BK-key K and V tiles are staged in shared memory between two barriers;
// QK^T and PV run on mma.sync with register accumulators in the layout of
// flash_common.cuh (rows g and g + 8 of the warp's 16, g = lane / 4;
// columns 2t, 2t + 1 of each 8-column n-tile, t = lane % 4). The loads are
// synchronous and single-buffered.
#pragma once

#include "flash_common.cuh"

namespace probe {

using namespace flash;

constexpr int D = 64;          // the head dim the probes are built for
constexpr int LD = D + 8;      // bf16 tile row stride (elements)
constexpr int LDB = D + 16;    // int8 tile row stride (bytes)
constexpr int KS = D / 16;     // k-steps of a bf16 QK^T
constexpr int KS8 = D / 32;    // k-steps of an int8 QK^T
constexpr int DT = D / 8;      // 8-column n-tiles of O
constexpr uint32_t ONES_BF16X2 = 0x3F803F80u;   // two bf16 1.0

// Rows [row0, row0 + ROWS) of a (rows, D) bf16 matrix into a tile of row
// stride LD, 16 bytes a load.
template <int ROWS, int NTHREAD>
__device__ __forceinline__ void stage(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, int row0) {
  for (int i = threadIdx.x; i < ROWS * (D / 8); i += NTHREAD) {
    const int r = i / (D / 8), c = i % (D / 8);
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) =
        *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * D + c * 8);
  }
}

// The same for a (rows, D) int8 matrix into a byte tile of row stride LDB.
template <int ROWS, int NTHREAD>
__device__ __forceinline__ void stage_i8(int8_t* dst, const int8_t* src,
                                         int row0) {
  for (int i = threadIdx.x; i < ROWS * (D / 16); i += NTHREAD) {
    const int r = i / (D / 16), c = i % (D / 16);
    *reinterpret_cast<uint4*>(dst + r * LDB + c * 16) =
        *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * D + c * 16);
  }
}

// This warp's 16 rows of a staged q tile as A fragments.
__device__ __forceinline__ void load_q(uint32_t (&qa)[KS][4],
                                       const __nv_bfloat16* Qs, int warp,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    load_a<LD>(qa[ks], Qs, warp * 16, ks * 16, lane);
}

__device__ __forceinline__ void load_q8(uint32_t (&qa)[KS8][4],
                                        const int8_t* Q8, int warp,
                                        int lane) {
#pragma unroll
  for (int ks = 0; ks < KS8; ++ks)
    load_a8<LDB>(qa[ks], Q8, warp * 16, ks * 32, lane);
}

// S = Q_w K^T over a staged bf16 K tile of NT * 8 keys (f32 accumulators).
template <int NT>
__device__ __forceinline__ void qk_bf16(float (&s)[NT][4],
                                        const uint32_t (&qa)[KS][4],
                                        const __nv_bfloat16* Ks, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t kb[4];
      load_bt<LD>(kb, Ks, j * 8, ks * 16, lane);
      mma_bf16(s[j], qa[ks], kb[0], kb[1]);
      mma_bf16(s[j + 1], qa[ks], kb[2], kb[3]);
    }
  }
}

// S = Q8_w K8^T over a staged int8 K tile (s32 accumulators, exact).
template <int NT>
__device__ __forceinline__ void qk_s8(int (&s)[NT][4],
                                      const uint32_t (&qa)[KS8][4],
                                      const int8_t* K8, int lane) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0;
#pragma unroll
  for (int ks = 0; ks < KS8; ++ks) {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t kb[4];
      load_bt8<LDB>(kb, K8, j * 8, ks * 32, lane);
      mma_s8(s[j], qa[ks], kb[0], kb[1]);
      mma_s8(s[j + 1], qa[ks], kb[2], kb[3]);
    }
  }
}

// f32(s32) * scale, rounded once (no fma with what follows).
template <int NT>
__device__ __forceinline__ void dequant(float (&s)[NT][4],
                                        const int (&acc)[NT][4],
                                        float scale) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = __fmul_rn(static_cast<float>(acc[j][e]), scale);
  }
}

template <int NT>
__device__ __forceinline__ void scale_by(float (&s)[NT][4], float scale) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = __fmul_rn(s[j][e], scale);
  }
}

// O += bf16(P) V over a staged BK = NT * 8 key V tile, P the S fragments
// repacked as A fragments in registers. With ONES, n-tiles [DT, 2 DT) of O
// take a block of ones in place of V: the V widened to 128 columns of
// bench_softmax_variants' "staticfused", each of those columns the row sum
// of bf16(P).
template <int NT, bool ONES = false>
__device__ __forceinline__ void pv_bf16(float (&o)[ONES ? 2 * DT : DT][4],
                                        const float (&p)[NT][4],
                                        const __nv_bfloat16* Vs, int lane) {
#pragma unroll
  for (int kk = 0; kk < NT / 2; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int i = 0; i < DT; i += 2) {
      uint32_t vb[4];
      load_b<LD>(vb, Vs, kk * 16, i * 8, lane);
      mma_bf16(o[i], pa, vb[0], vb[1]);
      mma_bf16(o[i + 1], pa, vb[2], vb[3]);
    }
    if constexpr (ONES) {
#pragma unroll
      for (int i = DT; i < 2 * DT; ++i)
        mma_bf16(o[i], pa, ONES_BF16X2, ONES_BF16X2);
    }
  }
}

// Row max of a tile of S fragments over the 4 lanes that share a row.
template <int NT>
__device__ __forceinline__ void row_max(const float (&s)[NT][4], float& lo,
                                        float& hi) {
  lo = hi = NEG_INF;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    lo = fmaxf(lo, fmaxf(s[j][0], s[j][1]));
    hi = fmaxf(hi, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    lo = fmaxf(lo, __shfl_xor_sync(0xffffffffu, lo, off));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, off));
  }
}

template <bool NATURAL>
__device__ __forceinline__ float ex(float x) {
  if constexpr (NATURAL) return __expf(x);   // ex2.approx(x log2 e)
  else return exp2f(x);
}

// One step of the online softmax (the reference kernels' order): m_new =
// max(m, rowmax(s)), alpha = ex(m - m_new), p = ex(s - m_new), l = alpha l +
// sum p (this lane's partial sums), o *= alpha; s is replaced by p. m and l
// hold rows g ([0]) and g + 8 ([1]).
template <bool NATURAL, int NT, int NO>
__device__ __forceinline__ void online_step(float (&s)[NT][4],
                                            float (&o)[NO][4], float (&m)[2],
                                            float (&l)[2]) {
  float mx_lo, mx_hi;
  row_max(s, mx_lo, mx_hi);
  const float n_lo = fmaxf(m[0], mx_lo), n_hi = fmaxf(m[1], mx_hi);
  const float c_lo = ex<NATURAL>(m[0] - n_lo), c_hi = ex<NATURAL>(m[1] - n_hi);
  m[0] = n_lo;
  m[1] = n_hi;
  float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = ex<NATURAL>(s[j][0] - n_lo);
    s[j][1] = ex<NATURAL>(s[j][1] - n_lo);
    s[j][2] = ex<NATURAL>(s[j][2] - n_hi);
    s[j][3] = ex<NATURAL>(s[j][3] - n_hi);
    sum_lo += s[j][0] + s[j][1];
    sum_hi += s[j][2] + s[j][3];
  }
  l[0] = c_lo * l[0] + sum_lo;
  l[1] = c_hi * l[1] + sum_hi;
#pragma unroll
  for (int i = 0; i < NO; ++i) {
    o[i][0] *= c_lo;
    o[i][1] *= c_lo;
    o[i][2] *= c_hi;
    o[i][3] *= c_hi;
  }
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// bf16(o / den) for this warp's rows of the q tile at q0 of a (rows, D)
// output (only O's first DT n-tiles).
template <int NO>
__device__ __forceinline__ void store(const float (&o)[NO][4], float den_lo,
                                      float den_hi, __nv_bfloat16* out,
                                      int q0, int warp, int lane) {
  const int g = lane / 4, t = lane % 4;
  __nv_bfloat16* lo = out + size_t(q0 + warp * 16 + g) * D;
  __nv_bfloat16* hi = lo + 8 * D;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = i * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(lo + d) =
        __floats2bfloat162_rn(o[i][0] / den_lo, o[i][1] / den_lo);
    *reinterpret_cast<__nv_bfloat162*>(hi + d) =
        __floats2bfloat162_rn(o[i][2] / den_hi, o[i][3] / den_hi);
  }
}

// Set the kernel's dynamic shared memory and launch it on `st`.
template <typename Kernel, typename Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t bytes,
           cudaStream_t st, const Args& args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  kernel<<<grid, threads, bytes, st>>>(args);
  return int(cudaGetLastError());
}

}  // namespace probe
