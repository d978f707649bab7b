// Hopper design of the bf16 flash-attention backward at head dims 32, 64
// and 128: one kernel that computes what the TPU kernels _flash_bwd_dq_kernel
// and _flash_bwd_dkv_kernel (vggt_slam_tpu/ops/attention.py:1106, :1138)
// compute together, with the formula and roundings of the header of
// flash_attention_bwd.cu, except that a p below 2^-126 before its
// 1 / l factor flushes to zero (ex2, sm90_common.cuh), as in the forward.
// Included by flash_attention_bwd.cu, whose flash_bwd entry runs
// bwd_prep_kernel, this kernel, then bwd_dq_kernel.
//
// What bounds it: five products of 2 Nq Nk D flops per head (S^T, dP^T,
// dV, dK, dQ; P is recomputed, never stored) and one exp2 per valid logit,
// on ~(3 Nq + 2 Nk) D bf16 bytes, far above the H100's ridge: the tensor
// cores at D = 64 (989 TFLOP/s, reached only through wgmma), the exp units
// at D = 32 (~4.18e12 exp2/s); at D = 128 (the camera trunk, 4-18 tokens,
// one key tile) the bytes. Splitting dq from dk/dv, as the TPU kernels do,
// would compute S, dP and the exp twice.
//
// Design (FlashAttention-3's backward). One CTA per (key tile, batch *
// head); BwdCfg<D>::NW consumer warpgroups, warpgroup w owning keys [64w,
// 64w + 64) of the tile (wgmma's M), and one producer warpgroup. At D = 32
// and 64 two consumer warpgroups (128-key tiles), to which the producer
// hands its registers (setmaxnreg: 40, 232, 232). At D = 128 one (64-key
// tiles, 256 threads, up to 255 registers each): a consumer thread holds
// dK and dV at 64 f32 each and S^T and dP^T at 32 each, which under two
// consumer warpgroups' 168 registers spilled (1,280 bytes) and serialized
// the wgmma; the camera trunk's 4-18 keys are one tile either way.
// - Loads: one producer lane brings the tile's K and V once, then each
//   64-row q tile's Q and dO (TMA, 4-D (D, H, N, B) maps of one head, so
//   rows past N read as zeros) and its 768 bytes of row stats (m, w =
//   1 / max(l, 1e-30) and delta, 0 past Nq, written by bwd_prep_kernel;
//   one bulk copy) into a ring of BwdCfg<D>::STAGES (3) slots with full
//   and empty mbarriers. K's and V's maps end at valid_len; a key tile
//   wholly past it loads nothing and stores exact zeros. At D = 128 a
//   256-byte row is two panels of 64 columns (sm90_common.cuh `panel`),
//   one TMA box each.
// - Per q tile, each consumer warpgroup: S^T = K Q^T and dP^T = V dO^T (wgmma
//   m64n64k16, both operands K-major from shared memory); P^T and dL^T in
//   registers (the one exp2 per logit; keys at or past valid_len give 0);
//   dV += bf16(P^T) dO and dK += bf16(dL^T) Q (register A operand, Q and dO
//   MN-major, as V in the forward's PV; one product per panel); dL^T
//   stored once to shared memory as bf16, 128-byte rows of 64 queries in
//   the 128-byte swizzle; then, after every warpgroup stored its own,
//   dQ = dL K over all the tile's keys with both operands MN-major from
//   shared memory (transpose bits), in halves of D / 2 dims (at D = 128
//   one panel of K each): warpgroup w of two computes half w, the one
//   warpgroup at D = 128 both, one after the other. dL^T has two buffers,
//   by the parity of the q tile: the other warpgroup's dQ of tile qt may
//   still read buffer qt & 1 while this one writes tile qt + 1's, and the
//   barrier of tile qt + 1 orders both reads of it before tile qt + 2's
//   writes.
// - dq across key tiles: each warpgroup stores its f32 halves of the dQ
//   tile to shared memory (two buffers) in the accumulator's layout
//   (acc_off: the halves apart, 8-float chunks swizzled so that the stores
//   are free of bank conflicts), and one of its threads adds it to the f32
//   accumulator in global memory with one bulk reduce (cp.reduce.async
//   .bulk .add.f32); bwd_dq_kernel then writes dq = bf16(acc / sqrt(D)).
//   The atomic adds sum in a varying order, so dq's low bits vary from run
//   to run.
// - Epilogue: dK / sqrt(D) and dV stored as bf16 straight from registers,
//   rows masked at Nk.
#pragma once

#include "sm90_common.cuh"

namespace {

using namespace flash;

constexpr int BW_BQ = 64;             // q rows per tile
constexpr int BW_STATS = 3 * BW_BQ * 4;  // m, w, delta of one q tile

// Shared memory of a CTA at head dim D with `bk` keys and a ring `stages`
// deep: 1 KB of alignment slack, K, V, two dL^T buffers (bk keys x 64 bf16
// queries), the Q, dO and stats rings, two f32 dQ buffers, 2 barriers a
// ring slot and one for K/V.
__host__ __device__ constexpr size_t bwd_smem(int D, int bk, int stages) {
  return 1024 + 2 * size_t(bk) * 2 * D + 2 * size_t(bk) * 128 +
         stages * size_t(2 * BW_BQ * 2 * D + BW_STATS) + 2 * BW_BQ * D * 4 +
         8 * (2 * stages + 1);
}

// What the head dim sets: the consumer warpgroups (64 keys each), the keys
// and threads of a CTA, the tiles' bytes and the ring depth, 3 where it
// fits.
template <int D>
struct BwdCfg {
  static_assert(D == 32 || D == 64 || D == 128,
                "flash_bwd_sm90 takes D = 32, 64 or 128");
  static constexpr int NW = D == 128 ? 1 : 2;   // consumer warpgroups
  static constexpr int BK = 64 * NW;            // keys per CTA
  static constexpr int THREADS = 128 * (NW + 1);
  static constexpr int ROW = 2 * D;
  static constexpr int KV = BK * ROW;       // one K or V tile
  static constexpr int QT = BW_BQ * ROW;    // one Q or dO tile
  static constexpr int DQ = BW_BQ * D * 4;  // one f32 dQ tile
  static constexpr int DL = BK * 128;       // one dL^T buffer
  static constexpr int STAGES = bwd_smem(D, BK, 3) <= SM90_SMEM_MAX ? 3 : 2;
  static constexpr size_t SMEM = bwd_smem(D, BK, STAGES);
};

struct BwdSm90 {
  CUtensorMap tq, tk, tv, tdo;
  const float* work;     // (B*H, n_qt, 3, 64): m, w, delta per q tile
  float* dq_acc;         // (B*H, n_qt, 64 * D) in acc_off's layout, zeroed
                         // by bwd_prep_kernel
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int H, Nk, vl, n_qt;
  float c_scale, inv_sqrt_d;
};

// Shared memory of one CTA from its 1 KB-aligned base.
template <int D>
struct BwdSmem {
  using C = BwdCfg<D>;
  static constexpr int S = C::STAGES;
  uint32_t k, v, dl, q, dout, st, dq, full, empty, kv_full;
  __device__ explicit BwdSmem(uint32_t base)
      : k(base), v(k + C::KV), dl(v + C::KV), q(dl + 2 * C::DL),
        dout(q + S * C::QT), st(dout + S * C::QT), dq(st + S * BW_STATS),
        full(dq + 2 * C::DQ), empty(full + 8 * S), kv_full(empty + 8 * S) {}
};

// Floats of flash_bwd's scratch: `work`, the q tiles' m,
// w and delta rows (B*H, n_qt, 3, 64), and `acc`, the f32 dq accumulator
// (B*H, n_qt, 64 * D).
inline void bwd_sm90_scratch(int B, int H, int Nq, int D, long long* work,
                             long long* acc) {
  const long long tiles = (long long)B * H * ((Nq + BW_BQ - 1) / BW_BQ);
  *work = tiles * (BW_STATS / 4);
  *acc = tiles * BW_BQ * D;
}

// Float offset of dims [8j, 8j + 8) of half `half` (dims [half D / 2,
// (half + 1) D / 2), one dQ product's) of row r of a q tile in the
// dq accumulator: the halves apart, each 64 rows of D / 2 floats, and the
// 8-float chunks of a row XOR-swizzled so that a warp's float2 stores to 8
// rows hit distinct banks.
template <int D>
__host__ __device__ __forceinline__ int acc_off(int r, int half, int j) {
  constexpr int HD = D / 2;
  return half * BW_BQ * HD + r * HD +
         8 * (j ^ ((r >> (HD == 32 ? 0 : 1)) & (HD / 8 - 1)));
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// dst[i] += src[i] in global memory, f32, asynchronously (bulk group).
__device__ __forceinline__ void bulk_reduce_add(float* dst, uint32_t src,
                                                int bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 "
      "[%0], [%1], %2;" ::"l"(reinterpret_cast<uint64_t>(dst)), "r"(src),
      "r"(bytes) : "memory");
}

// The NW consumer warpgroups (named barrier 1).
template <int NW>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(128 * NW) : "memory");
}

// d (64 x 32 per warpgroup) = or += A (64 x 16) B (16 x 32), both from
// shared memory MN-major (transpose bits set).
__device__ __forceinline__ void wgmma_tt(float (&d)[4][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 1, 1;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1), SM90_F4(d, 2), SM90_F4(d, 3)
      : "l"(da), "l"(db), "r"(accumulate));
}

// The same at N = 64 and at N = 16.
__device__ __forceinline__ void wgmma_tt(float (&d)[8][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 1, 1;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1), SM90_F4(d, 2), SM90_F4(d, 3),
        SM90_F4(d, 4), SM90_F4(d, 5), SM90_F4(d, 6), SM90_F4(d, 7)
      : "l"(da), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tt(float (&d)[2][4], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 1;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef SM90_F4

// The consumer warps' part of flash_bwd_sm90: the q-tile sweep, then the
// dK and dV epilogue.
template <int D>
__device__ __forceinline__ void bwd_consume(const BwdSm90& P,
                                            unsigned char* base_ptr,
                                            const BwdSmem<D>& sm, int warp,
                                            int lane, bool sweep) {
  using C = BwdCfg<D>;
  constexpr int S = C::STAGES, ROW = C::ROW, BK = C::BK;
  constexpr int DT = D / 8;          // 8-dim n-tiles of dK and dV
  constexpr int QN = D / 16;         // 8-dim n-tiles of a half dQ tile
  constexpr int NH = 2 / C::NW;      // dQ halves a warpgroup computes
  const int w = warp / 4, wi = warp % 4;    // warpgroup, warp within it
  const int g = lane / 4, t = lane % 4;     // fragment coordinates
  const int bh = blockIdx.y, b = bh / P.H, h = bh % P.H;
  const int k0 = blockIdx.x * BK;
  const int r_lo = 64 * w + 16 * wi + g;    // key rows of this thread
  const int key_lo = k0 + r_lo, key_hi = key_lo + 8;
  const bool ok_lo = key_lo < P.vl, ok_hi = key_hi < P.vl;
  // this warpgroup's 64 rows of K and V (in each panel)
  const uint32_t k_w = at_row<ROW, BK>(sm.k, 64 * w, 0);
  const uint32_t v_w = at_row<ROW, BK>(sm.v, 64 * w, 0);
  unsigned char* gen = base_ptr - sm.k;     // generic = gen + smem address
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  if (sweep) {
    mbar_wait(sm.kv_full, 0);
    for (int qt = 0; qt < P.n_qt; ++qt) {
      const int slot = qt % S;
      const uint32_t q_s = sm.q + slot * C::QT, do_s = sm.dout + slot * C::QT;
      mbar_wait(sm.full + 8 * slot, (qt / S) & 1);

      // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries each.
      float s[8][4], dp[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      reg_fence(s);
      reg_fence(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)   // 32 bytes of each row a step
        wgmma_qk(s, sw_desc<D>(at_row<ROW, BK>(k_w, 0, ks * 32)),
                   sw_desc<D>(at_row<ROW, BW_BQ>(q_s, 0, ks * 32)), ks);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_qk(dp, sw_desc<D>(at_row<ROW, BK>(v_w, 0, ks * 32)),
                   sw_desc<D>(at_row<ROW, BW_BQ>(do_s, 0, ks * 32)), ks);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);

      // P^T and dL^T = P^T (dP^T - delta) as bf16 A fragments (keys 16kk +
      // 2t.. of n-tile 2kk, + 8 in n-tile 2kk + 1, as the forward packs P),
      // and dL^T into its buffer: row r, queries 8j + 2t.. are bytes 4t of
      // 16-byte chunk j.
      const float* st = reinterpret_cast<const float*>(
          gen + sm.st + slot * BW_STATS);
      const uint32_t dl_s = sm.dl + (qt & 1) * C::DL;
      unsigned char* dl = gen + dl_s;
      uint32_t pa[4][4], la[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * t;
        const float2 mm = *reinterpret_cast<const float2*>(st + c);
        const float2 ww = *reinterpret_cast<const float2*>(st + 64 + c);
        const float2 dd = *reinterpret_cast<const float2*>(st + 128 + c);
        const float p0 = ok_lo ? ex2(fmaf(s[j][0], P.c_scale, -mm.x)) * ww.x
                               : 0.f;
        const float p1 = ok_lo ? ex2(fmaf(s[j][1], P.c_scale, -mm.y)) * ww.y
                               : 0.f;
        const float p2 = ok_hi ? ex2(fmaf(s[j][2], P.c_scale, -mm.x)) * ww.x
                               : 0.f;
        const float p3 = ok_hi ? ex2(fmaf(s[j][3], P.c_scale, -mm.y)) * ww.y
                               : 0.f;
        pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
        const uint32_t l_lo = pack_bf16(p0 * (dp[j][0] - dd.x),
                                        p1 * (dp[j][1] - dd.y));
        const uint32_t l_hi = pack_bf16(p2 * (dp[j][2] - dd.x),
                                        p3 * (dp[j][3] - dd.y));
        la[j / 2][2 * (j % 2)] = l_lo;
        la[j / 2][2 * (j % 2) + 1] = l_hi;
        *reinterpret_cast<uint32_t*>(dl + swz<64>(r_lo, j) + 4 * t) = l_lo;
        *reinterpret_cast<uint32_t*>(dl + swz<64>(r_lo + 8, j) + 4 * t) =
            l_hi;
      }

      // dV += bf16(P^T) dO and dK += bf16(dL^T) Q, 16 queries a step.
      reg_fence(dv);
      reg_fence(dk);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv_rows<D, BW_BQ>(dv, pa[kk], do_s, kk * 16);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv_rows<D, BW_BQ>(dk, la[kk], q_s, kk * 16);
      wgmma_commit();

      // Every warpgroup's dL^T stored; the dQ buffer of this tile free (the
      // bulk reduces two tiles ago done reading).
      fence_proxy_async();
      if (threadIdx.x % 128 == 0) bulk_wait_read<1>();
      consumers_sync<C::NW>();

      // This warpgroup's halves of dQ (64 queries x D / 2 dims each) = dL
      // K[:, half], 16 keys a step, each stored to the tile's f32 buffer in
      // the accumulator's layout; then one bulk reduce of them into the
      // accumulator.
      const uint32_t dq_s = sm.dq + (qt & 1) * C::DQ;
      float* dqb = reinterpret_cast<float*>(gen + dq_s);
#pragma unroll
      for (int i = 0; i < NH; ++i) {
        const int half = w * NH + i;
        const uint32_t k_half = at_row<ROW, BK>(sm.k, 0, half * D);
        float dq[QN][4];
#pragma unroll
        for (int j = 0; j < QN; ++j)
          dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
        reg_fence(dq);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_tt(dq, sw_desc<64>(dl_s + kk * 16 * 128),
                   sw_desc<D>(k_half + kk * 16 * panel(ROW)), kk);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq);
        reg_fence(dk);
        reg_fence(dv);
        if (i == NH - 1) {   // every read of the Q, dO and stats slot done
          __syncwarp();
          if (lane == 0) mbar_arrive(sm.empty + 8 * slot);
        }
#pragma unroll
        for (int j = 0; j < QN; ++j) {
          const int r = 16 * wi + g;
          *reinterpret_cast<float2*>(dqb + acc_off<D>(r, half, j) + 2 * t) =
              make_float2(dq[j][0], dq[j][1]);
          *reinterpret_cast<float2*>(dqb + acc_off<D>(r + 8, half, j) +
                                     2 * t) = make_float2(dq[j][2], dq[j][3]);
        }
      }
      fence_proxy_async();
      warpgroup_sync(w);
      if (threadIdx.x % 128 == 0) {
        const int first = acc_off<D>(0, w * NH, 0);
        bulk_reduce_add(P.dq_acc + (size_t(bh) * P.n_qt + qt) * BW_BQ * D +
                            first,
                        dq_s + 4 * first, C::DQ / 2 * NH);
        bulk_commit();
      }
    }
    if (threadIdx.x % 128 == 0)
      bulk_wait_all();
  }

  const float sc = P.inv_sqrt_d;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = i * 8 + 2 * t;
    if (key_lo < P.Nk) {
      const size_t off = ((size_t(b) * P.Nk + key_lo) * P.H + h) * D + d;
      *reinterpret_cast<__nv_bfloat162*>(P.dk + off) =
          __floats2bfloat162_rn(dk[i][0] * sc, dk[i][1] * sc);
      *reinterpret_cast<__nv_bfloat162*>(P.dv + off) =
          __floats2bfloat162_rn(dv[i][0], dv[i][1]);
    }
    if (key_hi < P.Nk) {
      const size_t off = ((size_t(b) * P.Nk + key_hi) * P.H + h) * D + d;
      *reinterpret_cast<__nv_bfloat162*>(P.dk + off) =
          __floats2bfloat162_rn(dk[i][2] * sc, dk[i][3] * sc);
      *reinterpret_cast<__nv_bfloat162*>(P.dv + off) =
          __floats2bfloat162_rn(dv[i][2], dv[i][3]);
    }
  }
}

// Grid (key tiles, B * H).
template <int D>
__global__ void __launch_bounds__(BwdCfg<D>::THREADS, 1)
    flash_bwd_sm90(const __grid_constant__ BwdSm90 P) {
  using C = BwdCfg<D>;
  constexpr int S = C::STAGES, NW = C::NW;
  extern __shared__ unsigned char bw_raw[];
  const uint32_t raw = smem_addr(bw_raw);
  // 1 KB aligned, as the 128B swizzle's 8-row atom (64B: 512 bytes)
  const BwdSmem<D> sm((raw + 1023) & ~1023u);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = blockIdx.x * C::BK;
  const bool sweep = k0 < P.vl;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(sm.full + 8 * i, 1);
      mbar_init(sm.empty + 8 * i, 4 * NW);   // one arrival a consumer warp
    }
    mbar_init(sm.kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // Two consumer warpgroups take the producer's registers (128 threads
  // each at 40, 232 and 232); one has 255 without.
  if (warp >= 4 * NW) {
    if constexpr (NW == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 4 * NW && lane == 0 && sweep) {   // one lane issues the loads
      const int bh = blockIdx.y, b = bh / P.H, h = bh % P.H;
      mbar_expect_tx(sm.kv_full, 2 * C::KV);
      tma_load_tile<D, C::BK>(sm.k, &P.tk, sm.kv_full, h, k0, b);
      tma_load_tile<D, C::BK>(sm.v, &P.tv, sm.kv_full, h, k0, b);
      for (int qt = 0; qt < P.n_qt; ++qt) {
        const int i = qt % S;
        if (qt >= S) mbar_wait(sm.empty + 8 * i, ((qt / S) & 1) ^ 1);
        mbar_expect_tx(sm.full + 8 * i, 2 * C::QT + BW_STATS);
        tma_load_tile<D, BW_BQ>(sm.q + i * C::QT, &P.tq, sm.full + 8 * i, h,
                                qt * BW_BQ, b);
        tma_load_tile<D, BW_BQ>(sm.dout + i * C::QT, &P.tdo, sm.full + 8 * i,
                                h, qt * BW_BQ, b);
        bulk_load(sm.st + i * BW_STATS,
                  P.work + (size_t(bh) * P.n_qt + qt) * (BW_STATS / 4),
                  BW_STATS, sm.full + 8 * i);
      }
    }
  } else {
    if constexpr (NW == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    bwd_consume<D>(P, bw_raw + (sm.k - raw), sm, warp, lane, sweep);
  }
}

// delta = rowsum(dO * O) of each (b, n, h) row, D / 8 lanes a row at 16
// bytes each, and the rows' m, w = 1 / max(l, 1e-30) and delta into `work`
// as (B*H, n_qt, 3, 64), zeros for the rows in [Nq, n_qt * 64); the
// threads also zero `acc` (n4 float4s).
template <int D>
__global__ void bwd_prep_kernel(const __nv_bfloat16* dout,
                                const __nv_bfloat16* out, const float* m,
                                const float* l, float* work, float4* acc,
                                size_t n4, int B, int H, int Nq, int n_qt) {
  constexpr int LPR = D / 8;
  const size_t gid = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = gid; i < n4; i += size_t(gridDim.x) * blockDim.x)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int rows = n_qt * BW_BQ;   // rows per (b, h)
  const size_t row = gid / LPR;
  const int part = int(gid % LPR);
  const int h = int(row % H);
  const int n = int((row / H) % rows);
  const int b = int(row / (size_t(H) * rows));
  const bool in = b < B && n < Nq;
  float sum = 0.f;
  if (in) {
    const size_t off = ((size_t(b) * Nq + n) * H + h) * D + part * 8;
    const uint4 x = *reinterpret_cast<const uint4*>(dout + off);
    const uint4 y = *reinterpret_cast<const uint4*>(out + off);
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 u = __bfloat1622float2(xa[i]), v = __bfloat1622float2(ya[i]);
      sum = fmaf(u.x, v.x, fmaf(u.y, v.y, sum));
    }
  }
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (part != 0 || b >= B) return;
  const size_t bhn = size_t(b * H + h);
  float* t = work + (bhn * n_qt + n / BW_BQ) * (BW_STATS / 4) + n % BW_BQ;
  t[0] = in ? m[bhn * Nq + n] : 0.f;
  t[BW_BQ] = in ? 1.f / fmaxf(l[bhn * Nq + n], 1e-30f) : 0.f;
  t[2 * BW_BQ] = in ? sum : 0.f;
}

// dq = bf16(acc * inv_sqrt_d) in the packed layout, 8 dims a thread, from
// the accumulator's layout (acc_off).
template <int D>
__global__ void bwd_dq_kernel(const float* acc, __nv_bfloat16* dq, int B,
                              int H, int Nq, int n_qt, float inv_sqrt_d) {
  const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
  const size_t row = i / (D / 8);        // (b, n, h) of the packed layout
  if (row >= size_t(B) * Nq * H) return;
  const int d = int(i % (D / 8)) * 8;
  const int h = int(row % H), n = int((row / H) % Nq);
  const int b = int(row / (size_t(H) * Nq));
  const float4* src = reinterpret_cast<const float4*>(
      acc + ((size_t(b) * H + h) * n_qt + n / BW_BQ) * BW_BQ * D +
      acc_off<D>(n % BW_BQ, d / (D / 2), d % (D / 2) / 8));
  const float4 x = src[0], y = src[1];
  uint4 o;
  o.x = pack_bf16(x.x * inv_sqrt_d, x.y * inv_sqrt_d);
  o.y = pack_bf16(x.z * inv_sqrt_d, x.w * inv_sqrt_d);
  o.z = pack_bf16(y.x * inv_sqrt_d, y.y * inv_sqrt_d);
  o.w = pack_bf16(y.z * inv_sqrt_d, y.w * inv_sqrt_d);
  *reinterpret_cast<uint4*>(dq + row * D + d) = o;
}

template <int D>
int launch_bwd_prep(const __nv_bfloat16* dout, const __nv_bfloat16* out,
                    const float* m, const float* l, float* work, float* acc,
                    int B, int H, int Nq, int n_qt, cudaStream_t stream) {
  const size_t rows = size_t(B) * H * n_qt * BW_BQ;
  const size_t threads = rows * (D / 8);
  const size_t n4 = rows * D / 4;
  bwd_prep_kernel<D><<<unsigned((threads + 255) / 256), 256, 0, stream>>>(
      dout, out, m, l, work, reinterpret_cast<float4*>(acc), n4, B, H, Nq,
      n_qt);
  return int(cudaGetLastError());
}

// flash_bwd_sm90, then bwd_dq_kernel; `work` and `acc` as bwd_prep_kernel
// left them.
template <int D>
int launch_bwd_sm90(const void* q, const void* k, const void* v,
                    const void* dout, const float* work, float* acc,
                    void* dq, void* dk, void* dv, int B, int H, int Nq,
                    int Nk, int valid_len, float c_scale, float inv_sqrt_d,
                    cudaStream_t stream) {
  using C = BwdCfg<D>;
  BwdSm90 P{};
  P.vl = valid_len < Nk ? valid_len : Nk;
  P.n_qt = (Nq + BW_BQ - 1) / BW_BQ;
  int err = encode_heads<D>(&P.tq, q, B, Nq, Nq, H, BW_BQ);
  if (err == 0) err = encode_heads<D>(&P.tdo, dout, B, Nq, Nq, H, BW_BQ);
  if (err == 0 && P.vl > 0)
    err = encode_heads<D>(&P.tk, k, B, Nk, P.vl, H, C::BK);
  if (err == 0 && P.vl > 0)
    err = encode_heads<D>(&P.tv, v, B, Nk, P.vl, H, C::BK);
  if (err != 0) return err;
  P.work = work;
  P.dq_acc = acc;
  P.dk = static_cast<__nv_bfloat16*>(dk);
  P.dv = static_cast<__nv_bfloat16*>(dv);
  P.H = H;
  P.Nk = Nk;
  P.c_scale = c_scale;
  P.inv_sqrt_d = inv_sqrt_d;
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  err = smem_limit_once(flash_bwd_sm90<D>, int(C::SMEM), attr_set, &dev);
  if (err != 0) return err;
  const dim3 grid((Nk + C::BK - 1) / C::BK, B * H);
  flash_bwd_sm90<D><<<grid, C::THREADS, C::SMEM, stream>>>(P);
  err = int(cudaGetLastError());
  if (err != 0) return err;
  const size_t threads = size_t(B) * Nq * H * (D / 8);
  bwd_dq_kernel<D><<<unsigned((threads + 255) / 256), 256, 0, stream>>>(
      acc, static_cast<__nv_bfloat16*>(dq), B, H, Nq, P.n_qt, inv_sqrt_d);
  return int(cudaGetLastError());
}

}  // namespace
