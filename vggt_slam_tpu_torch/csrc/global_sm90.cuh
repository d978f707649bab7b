// global_sm90: the Hopper design of the global-shape probes
// (bench_global_attention.cu: bf16, int8, matmul; bench_int8_inkernel.cu:
// bf16, qk8, qk8av8; bench_softmax_variants.cu: matmul, online, static,
// staticfused, staticint8) and bench_attention.cu's matmul-only floor, on
// (BH, rows, 64) tensors: a CTA takes a BQ-row q tile of one problem and
// sweeps its keys in BK-key tiles. Bound at (BH 16, N 34816): the products
// (5.0 ms) and the exps (4.6 ms) nearly equal; L2 rereads close too.
// - BQ / 64 consumer warpgroups, no producer; the ring fits two CTAs an SM
//   (64 x 64 without in-kernel quantization four, matmul three; 128 x 128
//   one); grid (Nq / BQ, BH), so CTAs in flight share K, V in L2.
// - Thread 0 TMA-loads Q and the first STAGES key tiles (3-D maps; K, V end
//   at Nk); the last warp to release a slot issues its next load.
// - S on m64nBKk16 (bf16) or m64nBKk32 s8; O += P V on m64n64k16, P in
//   registers; qk8av8's PV on m64n64k32 s8 with V8 transposed and keys
//   permuted by key_pos. QK^T of tile t + 1 before PV of t; ping-pong at
//   128 x 128.
// - qk8, qk8av8 quantize in the kernel (half to even): Q once an item, each
//   K (V) tile once a CTA, two tiles ahead, into swizzled int8 tiles.
// - exp: __expf in the global probe, `ex2` (ex2.approx.ftz) elsewhere;
//   static modes p = exp2(s - smax); staticfused's l a second product of P
//   on a panel of ones.

#pragma once

#include <type_traits>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace flash;

// The modes of the three probes, numbered apart so that every instance's
// name (global_sm90<BQ, BK, MODE>) is its own in the ptxas report.
enum GMode { G_BF16 = 0, G_INT8 = 1, G_MATMUL = 2,
             IK_BF16 = 3, IK_QK8 = 4, IK_QK8AV8 = 5,
             SV_MATMUL = 6, SV_ONLINE = 7, SV_STATIC = 8, SV_STATICFUSED = 9,
             SV_STATICINT8 = 10 };

template <int MODE>
struct ModeOf {
  static constexpr bool SOFTMAX = MODE != G_MATMUL && MODE != SV_MATMUL;
  static constexpr bool NATURAL = MODE <= G_MATMUL;  // global: exp, else exp2
  static constexpr bool STATIC = MODE >= SV_STATIC;  // exp2(s - smax), no max
  static constexpr bool ONES = MODE == SV_STATICFUSED;  // l from a ones panel
  // q, k int8 from the caller
  static constexpr bool I8_IN = MODE == G_INT8 || MODE == SV_STATICINT8;
  static constexpr bool QUANT = MODE == IK_QK8 || MODE == IK_QK8AV8;
  static constexpr bool S8 = I8_IN || QUANT;        // QK^T on s8 wgmma
  static constexpr bool AV8 = MODE == IK_QK8AV8;    // PV on s8 wgmma
  static constexpr bool SCALES = MODE >= IK_BF16 && MODE <= IK_QK8AV8;
  // the variants' raw bf16 logits: s = f32(sum), no multiply by 1 (which
  // cost their bf16 modes 4-8%, up to 12%, at the global shape; staticint8,
  // whose code it leaves alone, read within 0.6%)
  static constexpr bool RAW = MODE >= SV_MATMUL && !I8_IN;
  static constexpr bool CLAMP = MODE >= SV_ONLINE;  // O / max(l, 1e-30)
};

constexpr int G_D = 64;            // the head dim the probes are built for
constexpr int G_MAX_STAGES = 8;
constexpr int G_SM_SMEM = 233472;  // an SM's shared memory, 1 KB of it a CTA's

template <int BQ, int BK, int MODE>
struct GCfg {
  using M = ModeOf<MODE>;
  static_assert(BQ == 64 || BQ == 128, "BQ of 64 or 128");
  static_assert(BK == 32 || BK == 64 || BK == 128, "BK of 32, 64 or 128");
  static_assert(!M::QUANT || BK == 64, "in-kernel quantization at BK 64");
  static constexpr int NTHREAD = BQ * 2;      // BQ / 64 warpgroups
  static constexpr int NWARP = BQ / 16;
  static constexpr int ROW = M::I8_IN ? 64 : 128;   // a loaded q or k row
  static constexpr int QBYTES = BQ * ROW, KBYTES = BK * ROW;
  static constexpr int SLOT = KBYTES + BK * 128;    // K and V of a key tile
  static constexpr int Q8BYTES = M::QUANT ? BQ * 64 : 0;
  static constexpr int T8 = BK * 64;          // an int8 K or transposed V tile
  static constexpr int NK8 = M::QUANT ? 3 : 0, NV8 = M::AV8 ? 4 : 0;
  static constexpr int ONESB = M::ONES ? 16 * 128 : 0;   // 16 rows of ones
  // CTAs an SM is sized for (ptxas's limit follows at BQ = 64): at 64 x 64
  // four (2-slot ring) took 9-10% off the softmax modes and added 12% to
  // matmul against three (4 slots); the in-kernel int8 rings leave three too
  // small a key ring; staticfused's 32 more registers do not fit four
  static constexpr int CTAS =
      BK > 64 ? (BQ == 64 ? 2 : 1)
      : BQ == 64 && !M::QUANT ? (M::SOFTMAX && !M::ONES ? 4 : 3)
                              : 2;
  static constexpr int MINB = BQ == 64 ? CTAS : 1;
  static constexpr int FIXED =
      1024 + QBYTES + ONESB + Q8BYTES + (NK8 + NV8) * T8 + 8;
  static constexpr int BUDGET = G_SM_SMEM / CTAS - 1024;
  static constexpr int FIT = (BUDGET - FIXED) / (SLOT + 20);
  static constexpr int STAGES = FIT < G_MAX_STAGES ? FIT : G_MAX_STAGES;
  static_assert(STAGES >= (M::QUANT ? 3 : 2), "a ring deep enough");
  static constexpr size_t SMEM = FIXED + size_t(STAGES) * (SLOT + 20);
};

struct GParams {
  CUtensorMap tq, tk, tv;
  __nv_bfloat16* o;
  const float* sc;   // in-kernel: (5, BH) scales
  float scale;       // global: the logit scale; staticint8: the dequant
  float smax;        // static modes: the fixed max p = exp2(s - smax) takes
  int BH, Nq, Nk;
};

// Element e of eight bf16 packed in a uint4, as f32 (exact).
__device__ __forceinline__ float bf16_at(const uint4& raw, int e) {
  const uint32_t w = e < 2 ? raw.x : e < 4 ? raw.y : e < 6 ? raw.z : raw.w;
  return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
}

// Byte x of row r of a tile of 64-byte rows, 64-byte swizzled.
__device__ __forceinline__ int swz64(int r, int x) {
  return r * 64 + ((((x >> 4) ^ (r >> 1)) & 3) << 4) + (x & 15);
}

// The 16-byte chunk c (8 bf16) of row r of a 128-byte-swizzled bf16 tile.
__device__ __forceinline__ uint4 chunk128(const unsigned char* tile, int r,
                                          int c) {
  return *reinterpret_cast<const uint4*>(tile + r * 128 +
                                         ((c ^ (r & 7)) << 4));
}

// Quantization on the FP32 pipe (F2I issues at a quarter of its rate and was
// the in-kernel int8 modes' largest cost): the low byte of the bits of
// round(y) + 1.5 * 2^23, |y| <= 127, is round(y) (half to even) as int8. (The
// s32 sums keep I2F: the mantissa trick took 4% longer there.)
__device__ __forceinline__ uint32_t rne_bits(float y) {
  return __float_as_uint(__fadd_rn(y, 12582912.f));
}
// quant_i8(x, inv) as rne_bits: clip(round(x * inv), -127, 127).
__device__ __forceinline__ uint32_t q8_bits(float x, float inv) {
  return rne_bits(fminf(fmaxf(__fmul_rn(x, inv), -127.f), 127.f));
}
// The low bytes of a, b, c, d as one word.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// Rows [r0, r0 + ROWS) of a 128B-swizzled tile of 64-wide bf16 rows
// quantized by inv into an int8 tile of 64-byte rows, 64-byte swizzled:
// thread `tid` of NTH takes chunks tid, tid + NTH, ... (a warp 4 rows).
template <int ROWS, int NTH>
__device__ __forceinline__ void quant_rows(unsigned char* dst,
                                           const unsigned char* src, int r0,
                                           int tid, float inv) {
#pragma unroll
  for (int n = 0; n < ROWS * 8 / NTH; ++n) {
    const int i = tid + n * NTH, r = r0 + i / 8, c = i % 8;
    const uint4 raw = chunk128(src, r, c);
    uint32_t w[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w[h] = pack4(q8_bits(bf16_at(raw, 4 * h), inv),
                   q8_bits(bf16_at(raw, 4 * h + 1), inv),
                   q8_bits(bf16_at(raw, 4 * h + 2), inv),
                   q8_bits(bf16_at(raw, 4 * h + 3), inv));
    *reinterpret_cast<uint2*>(dst + swz64(r, 8 * c)) = make_uint2(w[0], w[1]);
  }
}

// Byte of key `key` of a transposed V8 row: in its group of 32, key 8 j + 2 t
// + i goes to byte 16 (j / 2) + 4 t + 2 (j % 2) + i, where wgmma_pv8's
// register A fragment holds its p8.
__device__ __forceinline__ int key_pos(int key) {
  const int w = key & 7;
  return (key & ~31) + ((key >> 4) & 1) * 16 + (w >> 1) * 4 +
         ((key >> 3) & 1) * 2 + (w & 1);
}

// The 64 x 64 bf16 V tile at src (128B swizzle) quantized into the transposed
// int8 tile at dst (64 dims of 64 key bytes at key_pos, 64-byte swizzle). A
// row word holds keys k, k + 1, k + 8, k + 9 (k = 32 g + 16 h + 2 t): unit u
// of 128 (thread u % NTH) takes quad u % 16 at dims 8c .. 8c + 7 (c = u / 16),
// one word store a dim.
template <int NTH>
__device__ __forceinline__ void quant_vt(unsigned char* dst,
                                         const unsigned char* src, int tid,
                                         float inv) {
#pragma unroll
  for (int n = 0; n < 128 / NTH; ++n) {
    const int u = tid + n * NTH, qd = u % 16, c = u / 16;
    const int k = 32 * (qd / 8) + 16 * ((qd / 4) % 2) + 2 * (qd % 4);
    const uint4 r0 = chunk128(src, k, c), r1 = chunk128(src, k + 1, c);
    const uint4 r8 = chunk128(src, k + 8, c), r9 = chunk128(src, k + 9, c);
    const int p = key_pos(k);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      *reinterpret_cast<uint32_t*>(dst + swz64(8 * c + e, p)) =
          pack4(q8_bits(bf16_at(r0, e), inv), q8_bits(bf16_at(r1, e), inv),
                q8_bits(bf16_at(r8, e), inv), q8_bits(bf16_at(r9, e), inv));
  }
}

// clip(round(p * 127), 0, 127) for the four softmax weights p in [0, 1]
// (exp2 of s - m <= 0), so the clip never acts.
__device__ __forceinline__ uint32_t pack_p8(float a, float b, float c,
                                            float d) {
  return pack4(rne_bits(__fmul_rn(a, 127.f)), rne_bits(__fmul_rn(b, 127.f)),
               rne_bits(__fmul_rn(c, 127.f)), rne_bits(__fmul_rn(d, 127.f)));
}

template <bool NATURAL>
__device__ __forceinline__ float g_exp(float x) {
  if constexpr (NATURAL) return __expf(x);   // ex2.approx(x log2 e)
  else return ex2(x);
}

template <int BQ, int BK, int MODE>
__global__ void __launch_bounds__(GCfg<BQ, BK, MODE>::NTHREAD,
                                  GCfg<BQ, BK, MODE>::MINB)
    global_sm90(const __grid_constant__ GParams P) {
  using C = GCfg<BQ, BK, MODE>;
  using M = ModeOf<MODE>;
  using Acc = std::conditional_t<M::S8, int, float>;
  constexpr int S = C::STAGES, NT = BK / 8, DT = G_D / 8;
  extern __shared__ unsigned char g_raw[];
  const uint32_t raw = smem_addr(g_raw);
  // 1 KB aligned, as the 128B swizzle's 8-row atom
  const uint32_t sq = (raw + 1023) & ~1023u, sones = sq + C::QBYTES;
  const uint32_t sq8 = sones + C::ONESB;
  const uint32_t ring = sq8 + C::Q8BYTES, sk8 = ring + S * C::SLOT;
  const uint32_t sv8 = sk8 + C::NK8 * C::T8;
  const uint32_t full_k = sv8 + C::NV8 * C::T8, full_v = full_k + 8 * S;
  const uint32_t q_full = full_v + 8 * S;
  unsigned char* gen = g_raw + (sq - raw);   // generic address of sq
  unsigned* released = reinterpret_cast<unsigned*>(gen + (q_full + 8 - sq));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y, ntiles = P.Nk / BK;

  // Key tile t (its K and V) into ring slot t % S.
  auto load_kv = [&](int t) {
    if (t >= ntiles) return;
    const int i = t % S;
    const uint32_t slot = ring + i * C::SLOT;
    mbar_expect_tx(full_k + 8 * i, C::KBYTES);
    tma_load_3d(slot, &P.tk, full_k + 8 * i, 0, t * BK, bh);
    mbar_expect_tx(full_v + 8 * i, BK * 128);
    tma_load_3d(slot + C::KBYTES, &P.tv, full_v + 8 * i, 0, t * BK, bh);
  };
  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full_k + 8 * i, 1);
      mbar_init(full_v + 8 * i, 1);
      released[i] = 0;
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(q_full, C::QBYTES);
    tma_load_3d(sq, &P.tq, q_full, 0, q0, bh);
    for (int t = 0; t < S; ++t) load_kv(t);
  }
  if constexpr (M::ONES) {   // bf16 ones (any swizzle reads them as ones)
    for (int i = threadIdx.x; i < C::ONESB / 4; i += C::NTHREAD)
      reinterpret_cast<uint32_t*>(gen + C::QBYTES)[i] = 0x3F803F80u;
    fence_proxy_async();
  }
  __syncthreads();

  // This warp is done with key tile t: the last warp to say so loads tile
  // t + S into its slot at once.
  auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(released + t % S, 1u) % C::NWARP == C::NWARP - 1) {
        __threadfence_block();
        fence_proxy_async();
        load_kv(t + S);
      }
    }
    __syncwarp();
  };

  float scale = P.scale, inv_k = 0.f, inv_v = 0.f, dv = 0.f;
  if constexpr (M::SCALES) {
    scale = P.sc[3 * P.BH + bh];
    inv_k = P.sc[P.BH + bh];
    inv_v = P.sc[2 * P.BH + bh];
    dv = P.sc[4 * P.BH + bh];
  }
  // K tile t (and V tile t) of the bf16 slot into the int8 rings, by all
  // threads; the caller fences and syncs.
  auto quant_kv = [&](int t) {
    const int i = t % S, ph = (t / S) & 1;
    const unsigned char* slot = gen + (ring + i * C::SLOT - sq);
    mbar_wait(full_k + 8 * i, ph);
    unsigned char* k8 = gen + (sk8 + (t % 3) * C::T8 - sq);
    if constexpr (!M::AV8) {
      quant_rows<BK, C::NTHREAD>(k8, slot, 0, threadIdx.x, inv_k);
    } else if (C::NTHREAD == 128 || wg == 1) {
      // with two warpgroups, one quantizes K and the other V (the same
      // number of elements)
      quant_rows<BK, 128>(k8, slot, 0, threadIdx.x % 128, inv_k);
    }
    if constexpr (M::AV8) {
      if (C::NTHREAD == 128 || wg == 0) {
        mbar_wait(full_v + 8 * i, ph);
        quant_vt<128>(gen + (sv8 + (t % 4) * C::T8 - sq), slot + C::KBYTES,
                      threadIdx.x % 128, inv_v);
      }
    }
  };

  // This warpgroup's 64 rows of Q (int8 rows of 64 bytes where S8).
  mbar_wait(q_full, 0);
  if constexpr (M::QUANT) {
    quant_rows<64, 128>(gen + (sq8 - sq), gen, 64 * wg, threadIdx.x % 128,
                        P.sc[bh]);
    fence_proxy_async();
    warpgroup_sync(wg);
  }
  const uint32_t qa = (M::QUANT ? sq8 : sq) + wg * 64 * (M::S8 ? 64 : 128);

  Acc acc[NT][4];
  float s[NT][4], o[DT][4];
  float o1[M::ONES ? DT : 1][4];                 // staticfused: P times ones
  int acc8[DT][4];                               // qk8av8: PV's s32 sums
  uint32_t pa[M::AV8 ? BK / 32 : BK / 16][4];    // P as A fragments
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f}, c[2] = {1.f, 1.f};
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
#pragma unroll
  for (int i = 0; i < (M::ONES ? DT : 1); ++i)
    o1[i][0] = o1[i][1] = o1[i][2] = o1[i][3] = 0.f;

  // S = Q_w K^T of tile t into acc, issued (asynchronous, committed).
  auto issue_qk = [&](int t) {
    const int i = t % S;
#pragma unroll
    for (int j = 0; j < NT; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
    if constexpr (!M::QUANT) mbar_wait(full_k + 8 * i, (t / S) & 1);
    reg_fence(acc);
    wgmma_fence();
    if constexpr (M::S8) {
      const uint32_t kb = M::QUANT ? sk8 + (t % 3) * C::T8 : ring + i * C::SLOT;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)   // 32 bytes of each row a step
        wgmma_qk(acc, row_desc<64>(qa + ks * 32), row_desc<64>(kb + ks * 32),
                 ks);
    } else {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
        wgmma_qk(acc, row_desc<128>(qa + ks * 32),
                 row_desc<128>(ring + i * C::SLOT + ks * 32), ks);
    }
    wgmma_commit();
  };
  // O += P V of tile t, issued (asynchronous, committed).
  auto issue_pv = [&](int t) {
    if constexpr (M::AV8) {
      reg_fence(acc8);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 32; ++kk)   // 32 keys a step
        wgmma_pv8(acc8, pa[kk],
                  row_desc<64>(sv8 + (t % 4) * C::T8 + kk * 32), kk);
    } else {
      const int i = t % S;
      mbar_wait(full_v + 8 * i, (t / S) & 1);
      reg_fence(o);
      if constexpr (M::ONES) reg_fence(o1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {   // 16 rows of V a step
        wgmma_pv_rows<G_D, BK>(o, pa[kk], ring + i * C::SLOT + C::KBYTES,
                               kk * 16);
        if constexpr (M::ONES) wgmma_pv(o1, pa[kk], row_desc<128>(sones));
      }
    }
    wgmma_commit();
  };
  // The finished QK^T: s = f32(acc) * scale, rounded once (the variants' bf16
  // modes: f32(acc)); then the online step in the reference's order (m_new =
  // max(m, row max), c = exp(m - m_new), p = exp(s - m_new), l = c l + sum p)
  // or the static one (p = exp2(s - smax), l += sum p; staticfused on the
  // tensor cores), p left in s.
  auto softmax = [&]() {
    reg_fence(acc);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = M::RAW ? static_cast<float>(acc[j][e])
                         : __fmul_rn(static_cast<float>(acc[j][e]), scale);
    }
    if constexpr (M::STATIC) {
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = ex2(s[j][e] - P.smax);
          if constexpr (!M::ONES) sum[e / 2] += s[j][e];
        }
      }
      l[0] += sum[0];
      l[1] += sum[1];
    } else if constexpr (M::SOFTMAX) {
      float mx[2] = {NEG_INF, NEG_INF}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
        const float n = fmaxf(m[r], mx[r]);
        c[r] = g_exp<M::NATURAL>(m[r] - n);
        m[r] = n;
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = g_exp<M::NATURAL>(s[j][e] - m[e / 2]);
          sum[e / 2] += s[j][e];
        }
      }
      l[0] = c[0] * l[0] + sum[0];
      l[1] = c[1] * l[1] + sum[1];
    }
  };
  // PV of the previous tile is done: add qk8av8's s32 sums, rescale O by
  // c, then p (in s) as PV's A fragments: bf16 keys 16kk + 2t.. in n-tile
  // 2kk, + 8 in 2kk + 1; p8 by key_pos (4 n-tiles a 32-key step).
  auto rescale_pack = [&]() {
    if constexpr (M::AV8) {
#pragma unroll
      for (int i = 0; i < DT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[i][e] += __fmul_rn(static_cast<float>(acc8[i][e]), dv);
      }
    }
    // skipped where no row of the warp moved its max (c = 1: exact)
    if (M::SOFTMAX && !M::STATIC &&
        __any_sync(0xffffffffu, c[0] != 1.f || c[1] != 1.f)) {
#pragma unroll
      for (int i = 0; i < DT; ++i) {
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] *= c[e / 2];
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if constexpr (M::AV8) {
        if (j % 2 == 0) {
          pa[j / 4][2 * ((j / 2) % 2)] =
              pack_p8(s[j][0], s[j][1], s[j + 1][0], s[j + 1][1]);
          pa[j / 4][2 * ((j / 2) % 2) + 1] =
              pack_p8(s[j][2], s[j][3], s[j + 1][2], s[j + 1][3]);
        }
      } else {
        pa[j / 2][2 * (j % 2)] = pack_bf16(s[j][0], s[j][1]);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[j][2], s[j][3]);
      }
    }
  };

  // Ping-pong at BQ = BK = 128: the warpgroups take turns to issue (named
  // barriers 4 and 5; warpgroup 0 first), so one's softmax overlaps the
  // other's products: 3-8% off each mode at BK 128, nothing or +7% at 64, 32.
  constexpr bool PING = BQ == 128 && BK == 128;
  auto turn = [&]() {
    if constexpr (PING)
      asm volatile("bar.sync %0, 256;" ::"r"(4 + wg) : "memory");
  };
  auto pass = [&]() {
    if constexpr (PING)
      asm volatile("bar.arrive %0, 256;" ::"r"(5 - wg) : "memory");
  };
  if (PING && wg == 1) asm volatile("bar.arrive 4, 256;" ::: "memory");
  if constexpr (M::QUANT) {
    quant_kv(0);
    if (ntiles > 1) quant_kv(1);
    fence_proxy_async();
    __syncthreads();
  }
  if constexpr (M::AV8) {
#pragma unroll
    for (int i = 0; i < DT; ++i)
      acc8[i][0] = acc8[i][1] = acc8[i][2] = acc8[i][3] = 0;
  }
  turn();
  issue_qk(0);
  pass();
  wgmma_wait<0>();
  softmax();
  rescale_pack();   // O is zero: only the packing matters
  for (int t = 0; t + 1 < ntiles; ++t) {
    turn();
    issue_qk(t + 1);
    issue_pv(t);
    pass();
    if constexpr (M::QUANT) {
      if (t + 2 < ntiles) {   // two tiles ahead, while the products run
        quant_kv(t + 2);
        fence_proxy_async();
        __syncthreads();
      }
    }
    wgmma_wait<1>();   // QK^T of tile t + 1 (PV of t may still run)
    softmax();
    wgmma_wait<0>();
    if constexpr (M::AV8) reg_fence(acc8);
    else reg_fence(o);
    release(t);
    rescale_pack();
  }
  turn();
  issue_pv(ntiles - 1);
  if (wg == 0) pass();   // warpgroup 1's last pass would find no turn
  wgmma_wait<0>();
  if constexpr (M::AV8) {
    reg_fence(acc8);
#pragma unroll
    for (int i = 0; i < DT; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[i][e] += __fmul_rn(static_cast<float>(acc8[i][e]), dv);
    }
  } else {
    reg_fence(o);
    if constexpr (M::ONES) reg_fence(o1);
  }
  release(ntiles - 1);

  // O / l (l summed over the 4 lanes of a row) in bf16, rows g and g + 8
  // of the warp's 16.
  float den[2] = {1.f, 1.f};
  if constexpr (M::ONES) {
    // every column of o1 is the row sum of bf16(p); their max reads them all
    den[0] = o1[0][0];
    den[1] = o1[0][2];
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      den[0] = fmaxf(den[0], fmaxf(o1[i][0], o1[i][1]));
      den[1] = fmaxf(den[1], fmaxf(o1[i][2], o1[i][3]));
    }
  } else if constexpr (M::SOFTMAX) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      den[r] = l[r];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        den[r] += __shfl_xor_sync(0xffffffffu, den[r], off);
    }
  }
  if constexpr (M::CLAMP) {
    den[0] = fmaxf(den[0], 1e-30f);
    den[1] = fmaxf(den[1], 1e-30f);
  }
  __nv_bfloat16* lo =
      P.o + (size_t(bh) * P.Nq + q0 + warp * 16 + lane / 4) * G_D;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = i * 8 + 2 * (lane % 4);
    *reinterpret_cast<__nv_bfloat162*>(lo + d) =
        __floats2bfloat162_rn(o[i][0] / den[0], o[i][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(lo + 8 * G_D + d) =
        __floats2bfloat162_rn(o[i][2] / den[1], o[i][3] / den[1]);
  }
}

// global_sm90 launches since the library loaded, counted where the kernel
// is launched; read by the library's *_design_launches entry.
std::atomic<long long> design_launches{0};

// q (BH, Nq, 64), k, v (BH, k_rows, 64), o (BH, Nq, 64), contiguous; q, k int8
// in G_INT8 and SV_STATICINT8, else bf16; the first Nk keys. sc: the in-kernel
// modes' (5, BH) scales; smax: the static modes' max.
template <int BQ, int BK, int MODE>
int launch_global_sm90(const void* q, const void* k, const void* v, void* o,
                       const float* sc, float scale, int BH, int Nq, int Nk,
                       int k_rows, cudaStream_t st, float smax = 0.f) {
  using C = GCfg<BQ, BK, MODE>;
  constexpr int ESZ = ModeOf<MODE>::I8_IN ? 1 : 2;
  if (Nq % BQ != 0 || Nk % BK != 0 || Nk > k_rows)
    return int(cudaErrorInvalidValue);
  GParams P{};
  int err = encode_rows<ESZ>(&P.tq, q, BH, Nq, G_D, BQ);
  if (err == 0) err = encode_rows<ESZ>(&P.tk, k, BH, Nk, G_D, BK, k_rows);
  if (err == 0) err = encode_rows(&P.tv, v, BH, Nk, G_D, BK, k_rows);
  if (err != 0) return err;
  const auto kernel = global_sm90<BQ, BK, MODE>;
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  err = smem_limit_once(kernel, int(C::SMEM), attr_set, &dev);
  if (err != 0) return err;
  P.o = static_cast<__nv_bfloat16*>(o);
  P.sc = sc;
  P.scale = scale;
  P.smax = smax;
  P.BH = BH;
  P.Nq = Nq;
  P.Nk = Nk;
  kernel<<<dim3(Nq / BQ, BH), C::NTHREAD, C::SMEM, st>>>(P);
  err = int(cudaGetLastError());
  if (err == 0) design_launches.fetch_add(1, std::memory_order_relaxed);
  return err;
}

}  // namespace
