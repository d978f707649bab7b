// Hopper design of the flash-attention forward: flash_{single,multi}_fwd
// (bf16 QK^T) and flash_{single,multi}_i8_fwd (int8, I8) at D 32, 64, 128,
// included by flash_attention.cu; its formula with prep_row's roundings;
// weights below 2^-126 flush to zero (ex2). Bound: the tensor cores (2.59e-13
// s a logit against the exp units' 2.39e-13 at D 64), the exp units at D
// 32 (1.85x), the bytes at D 128 (the camera trunk).
//
// A persistent grid; an item is (128-row q tile, batch * head); two
// consumer warpgroups (rows [64w, 64w + 64)) and a producer warpgroup that
// hands them its registers (setmaxnreg).
// - A producer lane TMA-loads Q (two buffers) and K, V tiles of SM90_BK
//   keys (a ring of Sm90Cfg::STAGES) ahead across items; 4-D maps of one
//   head, K and V ending at valid_len; kv_bias with its K tile; "full"
//   (expect_tx) and "empty" mbarriers. 128-byte swizzle at D 64, 64-byte
//   at D 32; at D 128 two 64-column panels (`panel`), a ring of 2 (I8: 3).
// - q with LN or rope comes prepared by prep_rows_kernel into the output
//   buffer; else the kernel scales Q in place.
// - S = Q K^T on m64n128k16 (K-major, smem), f32 sums in mma.sync's m16n8
//   layout, so bias, mask and the softmax act on fragments as
//   FlashAttention-2's; O += P V on m64nDk16 (D 128: one a panel), P in
//   registers, V MN-major.
// - QK^T of tile t + 1 before PV of t; the softmax of t + 1 overlaps PV(t);
//   the warpgroups issue in turns (ping-pong).
// - Epilogue: O / max(l, 1e-30) as bf16 from registers; m, l when asked.
// - I8: int8 q, k from the pre-pass (dispatch_i8), S on m64n128k32 s8, each
//   logit its exact f32 value times the (batch, head) scale, rounded once.

#pragma once

#include "sm90_common.cuh"

namespace {

using namespace flash;

constexpr int SM90_BQ = 128;            // q rows per CTA
constexpr int SM90_BK = 128;            // keys per tile
constexpr int SM90_THREADS = 384;       // 2 consumer warpgroups, 1 producer
constexpr int SM90_BIAS = SM90_BK * 4;  // bytes of one kv_bias tile

// Shared memory of a CTA with Q and K tiles of qk_tile bytes, V tiles of
// `tile` and a ring `stages` deep: 1 KB of alignment slack, two Q buffers,
// the K, V and kv_bias rings, 3 barriers a ring slot and 2 a Q buffer.
__host__ __device__ constexpr size_t sm90_smem(int qk_tile, int tile,
                                              int stages) {
  return 1024 + 2 * size_t(qk_tile) +
         stages * size_t(qk_tile + tile + SM90_BIAS) + 8 * (3 * stages + 4);
}

// What D and the QK^T type set: the bytes of a V row (D bf16), a Q or K row (D
// bf16, or D int8 with I8) and their 128-row tiles, the swizzle (128B, 64B or
// 32B) and the ring depth, 3 where it fits.
template <int D, bool I8>
struct Sm90Cfg {
  static_assert(D == 32 || D == 64 || D == 128,
                "flash_fwd_sm90 takes D = 32, 64 or 128");
  static constexpr int ROW = 2 * D;             // V
  static constexpr int QK_ROW = I8 ? D : 2 * D;
  static constexpr int TILE = 128 * ROW;
  static constexpr int QK_TILE = 128 * QK_ROW;
  static constexpr int STAGES =
      sm90_smem(QK_TILE, TILE, 3) <= SM90_SMEM_MAX ? 3 : 2;
  static constexpr size_t SMEM = sm90_smem(QK_TILE, TILE, STAGES);
};

template <bool I8>
struct ParamsSm90 {
  CUtensorMap tq, tk, tv, tb;   // tb: kv_bias, where given
  ParamsOf<I8> a;
  int n_qt, items;   // q tiles per (batch, head); work items (q tile, b*h)
};

// Shared memory of one CTA: the 1 KB-aligned base of the Q buffers, the
// rings after them, the barriers last.
template <int D, bool I8>
struct Sm90Smem {
  using C = Sm90Cfg<D, I8>;
  static constexpr int S = C::STAGES;
  uint32_t q, k, v, bias, full_k, full_v, empty, q_full, q_empty;
  __device__ explicit Sm90Smem(uint32_t base)
      : q(base), k(base + 2 * C::QK_TILE), v(k + S * C::QK_TILE),
        bias(v + S * C::TILE), full_k(bias + S * SM90_BIAS),
        full_v(full_k + 8 * S), empty(full_v + 8 * S),
        q_full(empty + 8 * S), q_empty(q_full + 16) {}
};

#undef SM90_F4
#undef SM90_R4

// Bias, mask and softmax of an S tile: updates m and the partial l, sets c to
// O's rescale factor before this tile's PV, leaves p = exp2(s - m) in s.
// `bias`: the tile's kv_bias in shared memory (null without).
template <bool STATIC, int NT>
__device__ __forceinline__ void softmax_tile(
    float (&s)[NT][4], int k0, int vl, const float* bias, int t,
    float& m_lo, float& m_hi, float& l_lo, float& l_hi, float& c_lo,
    float& c_hi) {
  // Each check is taken once per tile, so the unrolled loops stay
  // straight-line code.
  if (bias != nullptr) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {   // keys 2t, 2t + 1 of n-tile j
      const float2 bb = *reinterpret_cast<const float2*>(bias + j * 8 + 2 * t);
      s[j][0] += bb.x * LOG2E;
      s[j][1] += bb.y * LOG2E;
      s[j][2] += bb.x * LOG2E;
      s[j][3] += bb.y * LOG2E;
    }
  }
  if (k0 + NT * 8 > vl) {   // the last tile: mask keys at or past vl
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + j * 8 + 2 * t + (e & 1) >= vl) s[j][e] = NEG_INF;
    }
  }
  float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
  }
  c_lo = c_hi = 1.f;
  if (!STATIC) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
    }
    const float n_lo = fmaxf(m_lo, mx_lo), n_hi = fmaxf(m_hi, mx_hi);
    c_lo = ex2(m_lo - n_lo);
    c_hi = ex2(m_hi - n_hi);
    m_lo = n_lo;
    m_hi = n_hi;
    l_lo *= c_lo;
    l_hi *= c_hi;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = ex2(s[j][0] - m_lo);
    s[j][1] = ex2(s[j][1] - m_lo);
    s[j][2] = ex2(s[j][2] - m_hi);
    s[j][3] = ex2(s[j][3] - m_hi);
    l_lo += s[j][0] + s[j][1];
    l_hi += s[j][2] + s[j][3];
  }
}

// Ping-pong: the two consumer warpgroups take turns to issue their wgmma
// groups (named barriers 3 and 4; warpgroup 1 hands warpgroup 0 the first
// turn), so one's softmax overlaps the other's products.
#define SM90_TURN() \
  asm volatile("bar.sync %0, 256;" ::"r"(3 + warp / 4) : "memory")
#define SM90_PASS() \
  asm volatile("bar.arrive %0, 256;" ::"r"(4 - warp / 4) : "memory")

// The QK^T accumulator: the s32 logits with int8 operands, else S itself.
template <bool I8, typename A, typename B>
__device__ __forceinline__ auto& qk_acc(A& s32, B& s) {
  if constexpr (I8) return s32;
  else return s;
}

// The consumer warps' part of flash_fwd_sm90: for each work item, q
// preparation, the key sweep and the epilogue.
template <int D, bool STATIC, bool I8>
__device__ __forceinline__ void consume(const ParamsSm90<I8>& P,
                                        unsigned char* Q0,
                                        const Sm90Smem<D, I8>& sm, int warp,
                                        int lane) {
  using C = Sm90Cfg<D, I8>;
  constexpr int NT = SM90_BK / 8;    // 8-key n-tiles of S
  constexpr int DT = D / 8;          // 8-dim n-tiles of O
  constexpr int S = C::STAGES, TILE = C::TILE;
  constexpr int QK_TILE = C::QK_TILE, QK_ROW = C::QK_ROW;
  constexpr int QK_PR = panel(QK_ROW);   // a Q or K panel row
  constexpr int PAIRS = D / 2;       // bf16 pairs of a q row
  const auto& p = P.a;
  const int g = lane / 4, t = lane % 4;     // fragment coordinates
  const int vl = min(p.valid_len, p.Nk);
  const int ntiles = (vl + SM90_BK - 1) / SM90_BK;
  float o[DT][4], s[NT][4];
  int si[NT][4];                  // int8 QK^T: the s32 logits
  auto& acc = qk_acc<I8>(si, s);  // QK^T's accumulator
  uint32_t pa[SM90_BK / 16][4];   // P as A fragments, one per 16-key step
  float m_lo, m_hi, l_lo, l_hi, c_lo, c_hi;

  if (warp / 4 == 1 && ntiles > 0 && blockIdx.x < P.items)
    asm volatile("bar.arrive 3, 256;" ::: "memory");
  int it = 0;
  for (int item = blockIdx.x; item < P.items; item += gridDim.x, ++it) {
    const int bh = item / P.n_qt, q0 = (item % P.n_qt) * SM90_BQ;
    const int b = bh / p.H, h = bh % p.H;
    const int qb = it % 2;                    // Q buffer
    unsigned char* Qs = Q0 + qb * QK_TILE;
    // this warpgroup's 64 rows of the Q buffer (in each panel)
    const uint32_t q_w = at_row<QK_ROW, SM90_BQ>(sm.q + qb * QK_TILE,
                                                 (warp / 4) * 64, 0);
    const int kv0 = it * ntiles;   // ring index of the item's first tile
    float sc2 = 0.f;               // int8: the (batch, head) dequant scale
    if constexpr (I8) sc2 = p.scales[2 * (P.items / P.n_qt) + bh];

    // q arrives prepared (launch_sm90; int8: quantized) or needs only the
    // softmax scale, applied here in place: warp i its 16 rows, lane l pairs
    // l, l + 32, ... (pair c: dims 2c, 2c + 1, bytes 4 (c % 4) of chunk c /
    // 4), rounded to bf16 as prep_row; each warpgroup reads only its rows.
    mbar_wait(sm.q_full + 8 * qb, (it / 2) & 1);
    if constexpr (!I8) {
      if (p.q_scale != 1.f) {
#pragma unroll
        for (int i = 0; i < 16 * PAIRS / 32; ++i) {
          const int x = i * 32 + lane;
          const int r = warp * 16 + x / PAIRS, c = x % PAIRS;
          auto* cell = reinterpret_cast<__nv_bfloat162*>(
              Qs + swz<D, SM90_BQ>(r, c / 4) + (c % 4) * 4);
          const float2 f = __bfloat1622float2(*cell);
          *cell = __floats2bfloat162_rn(f.x * p.q_scale, f.y * p.q_scale);
        }
      }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + warp / 4) : "memory");

#pragma unroll
    for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
    m_lo = m_hi = STATIC ? p.smax[bh] : NEG_INF;
    l_lo = l_hi = 0.f;

    // S = Q_w K^T of `tile` into s (int8: si), issued (asynchronous,
    // committed).
    auto issue_qk = [&](int tile) {
      const int i = (kv0 + tile) % S;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
      mbar_wait(sm.full_k + 8 * i, ((kv0 + tile) / S) & 1);
      reg_fence(acc);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < QK_ROW / 32; ++ks)   // 32 bytes of each row a step
        wgmma_qk(acc, row_desc<QK_PR>(at_row<QK_ROW, SM90_BQ>(q_w, 0, ks * 32)),
                 row_desc<QK_PR>(at_row<QK_ROW, SM90_BK>(sm.k + i * QK_TILE,
                                                         0, ks * 32)),
                 ks);
      wgmma_commit();
    };
    // The finished QK^T in s: int8's s32 logits, exact in f32, times sc2.
    auto take_s = [&]() {
      if constexpr (I8) {
        reg_fence(si);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[j][e] = __fmul_rn(static_cast<float>(si[j][e]), sc2);
        }
      } else {
        reg_fence(s);
      }
    };
    // O += P V of `tile`, issued (asynchronous, committed).
    auto issue_pv = [&](int tile) {
      const int i = (kv0 + tile) % S;
      mbar_wait(sm.full_v + 8 * i, ((kv0 + tile) / S) & 1);
      reg_fence(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < SM90_BK / 16; ++kk)   // 16 rows of V a step
        wgmma_pv_rows<D, SM90_BK>(o, pa[kk], sm.v + i * TILE, kk * 16);
      wgmma_commit();
    };
    // p (in s) as bf16 A fragments: keys 16kk + 2t.. in n-tile 2kk, + 8 in
    // n-tile 2kk + 1.
    auto pack_p = [&]() {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        pa[j / 2][2 * (j % 2)] = pack_bf16(s[j][0], s[j][1]);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[j][2], s[j][3]);
      }
    };
    // The kv_bias of `tile` (arrived with its K tile), or null.
    auto bias_tile = [&](int tile) -> const float* {
      if (p.kv_bias == nullptr) return nullptr;
      return reinterpret_cast<const float*>(
          Q0 + (sm.bias - sm.q) + ((kv0 + tile) % S) * SM90_BIAS);
    };
    // Release a ring slot: the producer refills it once all eight consumer
    // warps are done with it.
    auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // Software pipeline: while PV(tile) runs, QK^T of tile + 1 is already
    // issued and its softmax runs on the SM; no branch around a wgmma in the
    // steady state, so ptxas keeps both groups in flight; the last PV follows.
    if (ntiles > 0) {
      SM90_TURN();
      issue_qk(0);
      SM90_PASS();
      wgmma_wait<0>();
      take_s();
      softmax_tile<STATIC>(s, 0, vl, bias_tile(0), t, m_lo, m_hi, l_lo,
                           l_hi, c_lo, c_hi);
      pack_p();
      for (int tile = 0; tile + 1 < ntiles; ++tile) {
        SM90_TURN();
        issue_qk(tile + 1);
        issue_pv(tile);
        SM90_PASS();
        // QK^T of tile + 1 is done (committed before PV, the one group
        // that may still run)
        wgmma_wait<1>();
        take_s();
        softmax_tile<STATIC>(s, (tile + 1) * SM90_BK, vl, bias_tile(tile + 1),
                             t, m_lo, m_hi, l_lo, l_hi, c_lo, c_hi);
        wgmma_wait<0>();
        reg_fence(o);
        release(sm.empty + 8 * ((kv0 + tile) % S));
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          o[d][0] *= c_lo;
          o[d][1] *= c_lo;
          o[d][2] *= c_hi;
          o[d][3] *= c_hi;
        }
        pack_p();
      }
      SM90_TURN();
      issue_pv(ntiles - 1);
      // warpgroup 1's last turn passes none: warpgroup 0 has no more
      if (warp / 4 == 0 || item + gridDim.x < P.items) SM90_PASS();
      wgmma_wait<0>();
      reg_fence(o);
      release(sm.empty + 8 * ((kv0 + ntiles - 1) % S));
    }
    release(sm.q_empty + 8 * qb);   // the Q buffer too

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
      l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
    }
    const float r_lo = 1.f / fmaxf(l_lo, 1e-30f);
    const float r_hi = 1.f / fmaxf(l_hi, 1e-30f);
    const int n_lo = q0 + warp * 16 + g, n_hi = n_lo + 8;
    if (p.m_out != nullptr && t == 0) {
      const size_t row = size_t(bh) * p.Nq;
      if (n_lo < p.Nq) {
        p.m_out[row + n_lo] = m_lo;
        p.l_out[row + n_lo] = l_lo;
      }
      if (n_hi < p.Nq) {
        p.m_out[row + n_hi] = m_hi;
        p.l_out[row + n_hi] = l_hi;
      }
    }
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      const int d = i * 8 + 2 * t;
      if (n_lo < p.Nq)
        *reinterpret_cast<__nv_bfloat162*>(
            p.o + ((size_t(b) * p.Nq + n_lo) * p.H + h) * D + d) =
            __floats2bfloat162_rn(o[i][0] * r_lo, o[i][1] * r_lo);
      if (n_hi < p.Nq)
        *reinterpret_cast<__nv_bfloat162*>(
            p.o + ((size_t(b) * p.Nq + n_hi) * p.H + h) * D + d) =
            __floats2bfloat162_rn(o[i][2] * r_hi, o[i][3] * r_hi);
    }
  }
}

// A persistent grid: CTA c takes work items c, c + gridDim.x, ..., item =
// q tile + n_qt * (batch * head), so neighbouring CTAs share K and V in L2.
template <int D, bool STATIC, bool I8>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_fwd_sm90(const __grid_constant__ ParamsSm90<I8> P) {
  using C = Sm90Cfg<D, I8>;
  constexpr int S = C::STAGES, TILE = C::TILE, QK_TILE = C::QK_TILE;
  constexpr int QK_ESZ = I8 ? 1 : 2;
  const auto& p = P.a;
  extern __shared__ unsigned char sm90_raw[];
  const uint32_t raw = smem_addr(sm90_raw);
  // 1 KB aligned, as the 128B swizzle's 8-row atom (64B: 512 bytes; 32B:
  // 256)
  const Sm90Smem<D, I8> sm((raw + 1023) & ~1023u);
  unsigned char* Q0 = sm90_raw + (sm.q - raw);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int vl = min(p.valid_len, p.Nk);
  const int ntiles = (vl + SM90_BK - 1) / SM90_BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(sm.full_k + 8 * i, 1);
      mbar_init(sm.full_v + 8 * i, 1);
      mbar_init(sm.empty + 8 * i, 8);     // one arrival per consumer warp
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(sm.q_full + 8 * i, 1);
      mbar_init(sm.q_empty + 8 * i, 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Warp specialisation: the producer warpgroup hands registers to the two
  // consumer warpgroups (128 threads each at 40, 232 and 232: 64,512 of the
  // SM's 65,536); their paths never meet again.
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && lane == 0) {   // one lane issues every load
      int it = 0;
      for (int item = blockIdx.x; item < P.items; item += gridDim.x, ++it) {
        const int bh = item / P.n_qt, q0 = (item % P.n_qt) * SM90_BQ;
        const int b = bh / p.H, h = bh % p.H;
        const int qb = it % 2;
        if (it >= 2) mbar_wait(sm.q_empty + 8 * qb, ((it / 2) & 1) ^ 1);
        mbar_expect_tx(sm.q_full + 8 * qb, QK_TILE);
        tma_load_tile<D, SM90_BQ, QK_ESZ>(sm.q + qb * QK_TILE, &P.tq,
                                          sm.q_full + 8 * qb, h, q0, b);
        for (int tile = 0; tile < ntiles; ++tile) {
          const int kv = it * ntiles + tile, i = kv % S;
          if (kv >= S) mbar_wait(sm.empty + 8 * i, ((kv / S) & 1) ^ 1);
          mbar_expect_tx(sm.full_k + 8 * i,
                         QK_TILE + (p.kv_bias ? SM90_BIAS : 0));
          tma_load_tile<D, SM90_BK, QK_ESZ>(sm.k + i * QK_TILE, &P.tk,
                                            sm.full_k + 8 * i, h,
                                            tile * SM90_BK, b);
          if (p.kv_bias != nullptr)
            tma_load_bias(sm.bias + i * SM90_BIAS, &P.tb, sm.full_k + 8 * i,
                          tile * SM90_BK);
          mbar_expect_tx(sm.full_v + 8 * i, TILE);
          tma_load_tile<D, SM90_BK>(sm.v + i * TILE, &P.tv,
                                    sm.full_v + 8 * i, h, tile * SM90_BK, b);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    consume<D, STATIC, I8>(P, Q0, sm, warp, lane);
  }
}

// 1-D map of kv_bias cut at vl keys: a box is one key tile; keys at or past
// vl read as zeros.
int encode_bias(CUtensorMap* map, const float* ptr, int vl) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  if (reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  const cuuint64_t dims[1] = {cuuint64_t(vl)}, strides[1] = {0};  // unused
  const cuuint32_t box[1] = {SM90_BK}, step[1] = {1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<float*>(ptr), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// bf16: q with LN or rope is prepared by prep_rows_kernel into the output
// buffer; each item reads its q rows before writing them, and touches no other
// item's. I8: a.q is the pre-pass's quantized q, a buffer of q's shape (int8
// rows at half o's stride would overlap other items' rows).
template <int D, bool STATIC, bool I8>
int launch_sm90(const ParamsOf<I8>& a, int B, cudaStream_t stream) {
  constexpr size_t SMEM = Sm90Cfg<D, I8>::SMEM;
  constexpr int QK_ESZ = I8 ? 1 : 2;
  ParamsSm90<I8> P{};
  P.a = a;
  const void* q = a.q;
  if constexpr (!I8) {
    if (a.ln_g != nullptr || a.cos_q != nullptr) {
      const int err = launch_prep<D>(a.q, a.o, B, a.Nq, a.H, a.ln_g, a.ln_b,
                                     a.ln_eps, a.cos_q, a.sin_q, a.q_scale,
                                     stream);
      if (err != 0) return err;
      q = P.a.q = a.o;
      P.a.ln_g = P.a.ln_b = P.a.cos_q = P.a.sin_q = nullptr;
      P.a.q_scale = 1.f;
    }
  }
  const int vl = a.valid_len < a.Nk ? a.valid_len : a.Nk;
  int err = encode_heads<D, QK_ESZ>(&P.tq, q, B, a.Nq, a.Nq, a.H, SM90_BQ);
  if (err == 0 && vl > 0)
    err = encode_heads<D, QK_ESZ>(&P.tk, a.k, B, a.Nk, vl, a.H, SM90_BK);
  if (err == 0 && vl > 0)
    err = encode_heads<D>(&P.tv, a.v, B, a.Nk, vl, a.H, SM90_BK);
  if (err == 0 && vl > 0 && a.kv_bias != nullptr)
    err = encode_bias(&P.tb, a.kv_bias, vl);
  if (err != 0) return err;
  const auto kernel = flash_fwd_sm90<D, STATIC, I8>;
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  err = smem_limit_once(kernel, int(SMEM), attr_set, &dev);
  if (err != 0) return err;
  P.n_qt = (a.Nq + SM90_BQ - 1) / SM90_BQ;
  P.items = P.n_qt * B * a.H;
  const int sms = sm_count(dev);
  const int grid = P.items < sms ? P.items : sms;
  kernel<<<grid, SM90_THREADS, SMEM, stream>>>(P);
  return counted_launch();
}

}  // namespace
