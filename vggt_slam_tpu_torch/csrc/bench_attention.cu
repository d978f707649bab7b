// Probe kernels of the frame-attention microbenchmark (sm_90a, ctypes),
// each replacing a diagnostic TPU kernel of scripts/bench_attention.py on
// contiguous (BH, Np, D = 64) bf16 tensors, Np a multiple of 128:
//   bench_matmul_only   _matmul_only_kernel (:45): o = bf16(q k^T) v, the
//                       tensor-core floor, on global_sm90's matmul mode.
//   bench_softmax_only  _softmax_only_kernel (:57): row r's logits are
//                       q[r, 0] * 0.01; o = exp2(s - m)[:, :D] / l: the
//                       softmax floor (4-warp CTAs, mma.sync's layout).
//   bench_grouped       _grouped_kernel (:70): G problems a work item,
//                       exp2 attention on pre-scaled q, o = bf16(p) v /
//                       max(l, 1e-30), padded keys unmasked; straight or
//                       interleaved.
//   bench_pipelined     _pipelined_kernel (:101): QK^T of problem g + 1
//                       issued before the softmax and PV of g.
//
// grouped_sm90<G, SCHED> is flash_sm90.cuh's design without ping-pong: a
// persistent grid; two consumer warpgroups, no producer (a third warp on a
// scheduler caps ptxas at 168 registers); TMA loads into buffers whose
// eighth releasing warp issues the refill; S on m64nBKk16, O += P V on
// m64n64k16 with P in registers; the running max per key tile, as
// exp2_attention_ref(block_k=BK). Schedules (wgmma group orders per key
// tile): straight, no overlap; interleaved, all QK^T committed, each
// softmax + PV waiting for its own; pipelined, QK^T of g + 1 before g's
// softmax and PV (= interleaved at G 2). Live registers set the instances
// (GsCfg): straight BK 128, G 2 BK 64, G 4 BK 32, G 8 split between the
// warpgroups at BK 32; the ring takes 2-4 key steps.
//
// Bounds: matmul-only 4 BH Np^2 D flops; softmax-only BH Np^2 exp2 (each
// logit x + col * z, z = 0 passed in so the exp2 is not hoisted).
// ex2_rate calibrates ex2.approx with independent chains x <- 2^-x.

#include "global_sm90.cuh"
#include "sm90_common.cuh"

namespace {

using namespace flash;

constexpr int D = 64;                 // the frame attention's head dim
constexpr int BQ = 64;                // query rows per CTA (softmax-only)
constexpr int BK = 64;                // keys per tile (softmax-only)
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;
constexpr int NT = BK / 8;            // 8-key n-tiles of S
constexpr int DT = D / 8;             // 8-dim n-tiles of O
// matmul-only's global_sm90 tiling, the fastest of the five at the frame
// shape (BH 288, Np 1152; 64 x 64 took 1.13x as long, 128 x 32 1.35x)
constexpr int MO_BQ = 128, MO_BK = 64;

enum Schedule { STRAIGHT = 0, INTERLEAVED = 1, PIPELINED = 2 };

// One problem's softmax state for this warp's rows g and g + 8: the output
// accumulator, the running max, and this lane's partial row sums.
struct RowState {
  float o[DT][4];
  float m_lo, m_hi, l_lo, l_hi;
};

__device__ __forceinline__ void init(RowState& st) {
#pragma unroll
  for (int i = 0; i < DT; ++i) st.o[i][0] = st.o[i][1] = st.o[i][2] = st.o[i][3] = 0.f;
  st.m_lo = st.m_hi = NEG_INF;
  st.l_lo = st.l_hi = 0.f;
}

// Online softmax over one tile of exp2-domain logits: fold the tile's row
// max into the running max (rescaling o and l), then s <- exp2(s - m) and
// l += s. The per-logit work of flash_single's softmax, without the mask.
__device__ __forceinline__ void softmax_tile(RowState& st, float (&s)[NT][4]) {
  float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
    mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
  }
  const float n_lo = fmaxf(st.m_lo, mx_lo), n_hi = fmaxf(st.m_hi, mx_hi);
  const float c_lo = exp2f(st.m_lo - n_lo), c_hi = exp2f(st.m_hi - n_hi);
  st.m_lo = n_lo;
  st.m_hi = n_hi;
  st.l_lo *= c_lo;
  st.l_hi *= c_hi;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    st.o[i][0] *= c_lo;
    st.o[i][1] *= c_lo;
    st.o[i][2] *= c_hi;
    st.o[i][3] *= c_hi;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    s[j][0] = exp2f(s[j][0] - n_lo);
    s[j][1] = exp2f(s[j][1] - n_lo);
    s[j][2] = exp2f(s[j][2] - n_hi);
    s[j][3] = exp2f(s[j][3] - n_hi);
    st.l_lo += s[j][0] + s[j][1];
    st.l_hi += s[j][2] + s[j][3];
  }
}

// Write o / den in bf16 for this warp's rows of the q tile at q0 of
// problem bh.
__device__ __forceinline__ void store(const float (&o)[DT][4], float den_lo,
                                      float den_hi, __nv_bfloat16* out,
                                      int bh, int Np, int q0, int warp,
                                      int lane) {
  const int g = lane / 4, t = lane % 4;
  const size_t lo = (size_t(bh) * Np + q0 + warp * 16 + g) * D;
  const size_t hi = lo + 8 * D;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = i * 8 + 2 * t;
    *reinterpret_cast<__nv_bfloat162*>(out + lo + d) =
        __floats2bfloat162_rn(o[i][0] / den_lo, o[i][1] / den_lo);
    *reinterpret_cast<__nv_bfloat162*>(out + hi + d) =
        __floats2bfloat162_rn(o[i][2] / den_hi, o[i][3] / den_hi);
  }
}

// o / max(l, 1e-30), l summed over the 4 lanes that share a row.
__device__ __forceinline__ void finish(RowState& st, __nv_bfloat16* out,
                                       int bh, int Np, int q0, int warp,
                                       int lane) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    st.l_lo += __shfl_xor_sync(0xffffffffu, st.l_lo, off);
    st.l_hi += __shfl_xor_sync(0xffffffffu, st.l_hi, off);
  }
  store(st.o, fmaxf(st.l_lo, 1e-30f), fmaxf(st.l_hi, 1e-30f), out, bh, Np,
        q0, warp, lane);
}

__global__ void __launch_bounds__(NTHREAD)
    softmax_only_kernel(const __nv_bfloat16* q, __nv_bfloat16* out, int Np,
                        float z) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t row = size_t(bh) * Np + q0 + warp * 16 + g;
  const float x_lo = __bfloat162float(q[row * D]) * 0.01f;
  const float x_hi = __bfloat162float(q[(row + 8) * D]) * 0.01f;
  RowState st;
  init(st);
  for (int tile = 0; tile < Np / BK; ++tile) {
    // the logits in the accumulator's fragment layout
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float c = float(tile * BK + j * 8 + 2 * t);
      s[j][0] = x_lo + c * z;
      s[j][1] = x_lo + (c + 1.f) * z;
      s[j][2] = x_hi + c * z;
      s[j][3] = x_hi + (c + 1.f) * z;
    }
    softmax_tile(st, s);
    // o holds p[:, :D]: columns [0, D) are the first tile's p (rescaled
    // with the running max from then on, like an accumulator)
#pragma unroll
    for (int tt = 0; tt * BK < D; ++tt) {
      if (tile == tt) {
#pragma unroll
        for (int j = 0; j < NT && tt * NT + j < DT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) st.o[tt * NT + j][e] = s[j][e];
        }
      }
    }
  }
  finish(st, out, bh, Np, q0, warp, lane);
}


// grouped_sm90: bench_grouped and bench_pipelined on TMA and wgmma

constexpr int ROWB = 2 * D;        // bytes of a q, k or v row: a 128B swizzle row
constexpr int GS_THREADS = 256;    // two consumer warpgroups

// Shared memory of nq Q buffers of qbuf bytes and a ring of `stages` slots
// of `slot` bytes (a key step's K and V): 1 KB of alignment slack, the
// buffers, 2 barriers and a release count a slot, 1 and 1 a Q buffer.
__host__ __device__ constexpr size_t gs_smem(int qbuf, int nq, int slot,
                                            int stages) {
  return 1024 + size_t(nq) * qbuf + size_t(stages) * slot +
         20 * stages + 12 * nq;
}

// The deepest ring of at most 4 slots that fits.
__host__ __device__ constexpr int gs_stages(int qbuf, int nq, int slot) {
  int s = 4;
  while (s > 1 && gs_smem(qbuf, nq, slot, s) > SM90_SMEM_MAX) --s;
  return s;
}

// What G and the schedule set (the file header says why).
template <int G, int SCHED>
struct GsCfg {
  static_assert(G == 2 || G == 4 || G == 8, "G of 2, 4 or 8");
  // G = 8: warpgroup w takes problems w, w + 2, ... of 64-row q tiles
  static constexpr bool SPLIT = SCHED != STRAIGHT && G == 8;
  // problems a warpgroup keeps live (straight runs them one at a time)
  static constexpr int PW = SCHED == STRAIGHT ? 1 : SPLIT ? G / 2 : G;
  static constexpr int QR = SPLIT ? 64 : 128;   // q rows of a work item
  static constexpr int BK = SCHED == STRAIGHT ? 128 : PW == 2 ? 64 : 32;
  // score tiles live: one per problem interleaved, two pipelined
  static constexpr int NS = SCHED == INTERLEAVED ? PW
                            : SCHED == PIPELINED ? 2
                                                 : 1;
  static constexpr int NB = SCHED == STRAIGHT ? 1 : G;  // problems a load brings
  static constexpr int UNITS = G / NB;                  // key sweeps an item
  static constexpr int QBUF = NB * QR * ROWB;
  static constexpr int KT = NB * BK * ROWB;   // K (or V) bytes of a ring slot
  static constexpr int NQ =
      gs_smem(QBUF, 2, 2 * KT, 2) <= SM90_SMEM_MAX ? 2 : 1;
  static constexpr int STAGES = gs_stages(QBUF, NQ, 2 * KT);
  static_assert(STAGES >= 2, "two key steps in flight");
  static constexpr size_t SMEM = gs_smem(QBUF, NQ, 2 * KT, STAGES);
};

struct GsParams {
  CUtensorMap tq, tk, tv;
  __nv_bfloat16* o;
  int Np, n_qt, items;   // q tiles a problem; work items (q tile, group)
};

// wgmma.wait_group n, n a constant once the caller's loop is unrolled.
__device__ __forceinline__ void wgmma_wait_n(int n) {
  switch (n) {
    case 0: wgmma_wait<0>(); break;
    case 1: wgmma_wait<1>(); break;
    case 2: wgmma_wait<2>(); break;
    default: wgmma_wait<3>(); break;
  }
}

// Online softmax of one score tile (KN n-tiles of 8 keys; rows g and g + 8
// of the warp): fold the tile's row max into m, set c to the factor that O
// and l are rescaled by, leave p = exp2(s - m) in s and add it to l.
template <int KN>
__device__ __forceinline__ void online_tile(float (&s)[KN][4], float (&m)[2],
                                            float (&l)[2], float (&c)[2]) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    const float n = fmaxf(m[r], mx[r]);
    c[r] = ex2(m[r] - n);
    m[r] = n;
    l[r] *= c[r];
  }
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    s[j][0] = ex2(s[j][0] - m[0]);
    s[j][1] = ex2(s[j][1] - m[0]);
    s[j][2] = ex2(s[j][2] - m[1]);
    s[j][3] = ex2(s[j][3] - m[1]);
    l[0] += s[j][0] + s[j][1];
    l[1] += s[j][2] + s[j][3];
  }
}

// O *= c (rows g, g + 8), then p (in s) as bf16 A fragments of PV: keys
// 16kk + 2t.. in n-tile 2kk, + 8 in n-tile 2kk + 1.
template <int KN>
__device__ __forceinline__ void rescale_pack(float (&o)[8][4],
                                             const float (&c)[2],
                                             uint32_t (&pa)[KN / 2][4],
                                             const float (&s)[KN][4]) {
#pragma unroll
  for (int d = 0; d < 8; ++d) {
    o[d][0] *= c[0];
    o[d][1] *= c[0];
    o[d][2] *= c[1];
    o[d][3] *= c[1];
  }
#pragma unroll
  for (int j = 0; j < KN; ++j) {
    pa[j / 2][2 * (j % 2)] = pack_bf16(s[j][0], s[j][1]);
    pa[j / 2][2 * (j % 2) + 1] = pack_bf16(s[j][2], s[j][3]);
  }
}

template <int G, int SCHED>
__global__ void __launch_bounds__(GS_THREADS, 1)
    grouped_sm90(const __grid_constant__ GsParams P) {
  using C = GsCfg<G, SCHED>;
  constexpr int S = C::STAGES, NQ = C::NQ, PW = C::PW, BKT = C::BK;
  constexpr int KN = BKT / 8;   // 8-key n-tiles of a score tile
  extern __shared__ unsigned char gs_raw[];
  // 1 KB aligned, as the 128B swizzle's 8-row atom
  const uint32_t sq = (smem_addr(gs_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + NQ * C::QBUF, sv = sk + S * C::KT;
  const uint32_t full_k = sv + S * C::KT, full_v = full_k + 8 * S,
                 q_full = full_v + 8 * S, counts = q_full + 8 * NQ;
  // release counts: of ring slot i at [i], of Q buffer b at [S + b]
  unsigned* released =
      reinterpret_cast<unsigned*>(gs_raw + (counts - smem_addr(gs_raw)));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nkt = P.Np / BKT;

  // This CTA's loads in order: sweep m (item blockIdx.x + (m / UNITS)
  // gridDim.x, unit m % UNITS) its Q tiles into buffer m % NQ; key step kv
  // (sweep kv / nkt) its K, V tiles into ring slot kv % S.
  auto load_q = [&](int m) {
    const int item = blockIdx.x + (m / C::UNITS) * gridDim.x;
    if (item >= P.items) return;
    const int qb = m % NQ;
    mbar_expect_tx(q_full + 8 * qb, C::QBUF);
    tma_load(sq + qb * C::QBUF, &P.tq, q_full + 8 * qb, 0, 0,
             (item % P.n_qt) * C::QR, (item / P.n_qt) * G + m % C::UNITS);
  };
  auto load_kv = [&](int kv) {
    const int m = kv / nkt, item = blockIdx.x + (m / C::UNITS) * gridDim.x;
    if (item >= P.items) return;
    const int i = kv % S, row = (kv % nkt) * BKT;
    const int bh = (item / P.n_qt) * G + m % C::UNITS;
    mbar_expect_tx(full_k + 8 * i, C::KT);
    tma_load(sk + i * C::KT, &P.tk, full_k + 8 * i, 0, 0, row, bh);
    mbar_expect_tx(full_v + 8 * i, C::KT);
    tma_load(sv + i * C::KT, &P.tv, full_v + 8 * i, 0, 0, row, bh);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full_k + 8 * i, 1);
      mbar_init(full_v + 8 * i, 1);
    }
    for (int i = 0; i < NQ; ++i) mbar_init(q_full + 8 * i, 1);
    for (int i = 0; i < S + NQ; ++i) released[i] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int m = 0; m < NQ; ++m) load_q(m);
    for (int kv = 0; kv < S; ++kv) load_kv(kv);
  }
  __syncthreads();

  // The consumers: warpgroup wg, warp warp % 4 of it owning 16 of its 64
  // q rows (fragment rows g and g + 8).
  const int wg = warp / 4, g = lane / 4, t4 = lane % 4;
  const int row_w = C::SPLIT ? 0 : 64 * wg;   // its first row of the q tile
  // problem j of the warpgroup: its place among the problems of a load
  auto prob = [&](int j) { return C::SPLIT ? 2 * j + wg : j; };
  float o[PW][8][4], s[C::NS][KN][4], m[PW][2], l[PW][2], c[2];
  uint32_t pa[BKT / 16][4];
  // The warp is done with ring slot kv % S (key step kv) or Q buffer
  // qi % NQ (sweep qi): the eighth warp to say so loads the step S (the
  // sweep NQ) later into it at once.
  auto release = [&](int n, int at, bool q) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(released + at, 1u) % 8 == 7) {
        __threadfence_block();
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        if (q) load_q(n);
        else load_kv(n);
      }
    }
    __syncwarp();
  };
  auto release_kv = [&](int kv) { release(kv + S, kv % S, false); };
  auto release_q = [&](int qi) { release(qi + NQ, S + qi % NQ, true); };

  int kv = 0, qi = 0;
  for (int item = blockIdx.x; item < P.items; item += gridDim.x) {
    const int grp = item / P.n_qt, q0 = (item % P.n_qt) * C::QR;
#pragma unroll 1
    for (int u = 0; u < C::UNITS; ++u, ++qi) {
      const int qb = qi % NQ;
      const uint32_t qw = sq + qb * C::QBUF + row_w * ROWB;
#pragma unroll
      for (int j = 0; j < PW; ++j) {
#pragma unroll
        for (int d = 0; d < 8; ++d)
          o[j][d][0] = o[j][d][1] = o[j][d][2] = o[j][d][3] = 0.f;
        m[j][0] = m[j][1] = NEG_INF;
        l[j][0] = l[j][1] = 0.f;
      }
      mbar_wait(q_full + 8 * qb, (qi / NQ) & 1);

      // S = Q_j K_j^T of ring slot i into acc, issued and committed.
      auto issue_qk = [&](int j, float(&acc)[KN][4], int i) {
#pragma unroll
        for (int n = 0; n < KN; ++n)
          acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
        const uint32_t a = qw + prob(j) * C::QR * ROWB;
        const uint32_t b = sk + i * C::KT + prob(j) * BKT * ROWB;
        reg_fence(acc);
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < ROWB / 32; ++ks)   // 32 bytes of a row a step
          wgmma_qk(acc, row_desc<ROWB>(a + ks * 32),
                   row_desc<ROWB>(b + ks * 32), ks);
        wgmma_commit();
      };
      // O_j += P V_j of ring slot i, issued and committed.
      auto issue_pv = [&](int j, int i) {
        const uint32_t b = sv + i * C::KT + prob(j) * BKT * ROWB;
        reg_fence(o[j]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BKT / 16; ++kk)   // 16 rows of V a step
          wgmma_pv_rows<D, BKT>(o[j], pa[kk], b, kk * 16);
        wgmma_commit();
      };

      for (int t = 0; t < nkt; ++t, ++kv) {
        const int i = kv % S, ph = (kv / S) & 1;
        mbar_wait(full_k + 8 * i, ph);
        if constexpr (SCHED == STRAIGHT) {
          issue_qk(0, s[0], i);
          // PV of the previous key step is done: its slot is free (the
          // bookkeeping runs while QK^T is in flight)
          if (t > 0) release_kv(kv - 1);
          wgmma_wait<0>();
          reg_fence(s[0]);
          online_tile(s[0], m[0], l[0], c);
          rescale_pack(o[0], c, pa, s[0]);
          mbar_wait(full_v + 8 * i, ph);
          issue_pv(0, i);
          wgmma_wait<0>();
          reg_fence(o[0]);
        } else {
          if constexpr (SCHED == INTERLEAVED) {
#pragma unroll
            for (int j = 0; j < PW; ++j) issue_qk(j, s[j], i);
          } else {
            issue_qk(0, s[0], i);
          }
#pragma unroll
          for (int j = 0; j < PW; ++j) {
            auto& sj = s[SCHED == INTERLEAVED ? j : j & 1];
            if (SCHED == PIPELINED && j + 1 < PW)
              issue_qk(j + 1, s[(j + 1) & 1], i);
            // QK^T of problem j is done, with every group committed before
            // it; still running: interleaved the later QK^T and PV of
            // problem j - 1, pipelined PV of j - 1 and QK^T of j + 1
            wgmma_wait_n(SCHED == INTERLEAVED ? (j < 2 ? PW - 1 : 1)
                                              : (j + 1 < PW) + (j > 0));
            // the previous key step's PV is done: its slot is free
            if (j == 0 && t > 0) release_kv(kv - 1);
            reg_fence(sj);
            online_tile(sj, m[j], l[j], c);
            // PV of problem j - 1 is done: pa is free
            if (j > 0)
              wgmma_wait_n(SCHED == INTERLEAVED ? 0 : int(j + 1 < PW));
            reg_fence(o[j]);
            rescale_pack(o[j], c, pa, sj);
            if (j == 0) mbar_wait(full_v + 8 * i, ph);
            issue_pv(j, i);
          }
        }
      }
      if constexpr (SCHED != STRAIGHT) {
        wgmma_wait<0>();
#pragma unroll
        for (int j = 0; j < PW; ++j) reg_fence(o[j]);
      }
      release_kv(kv - 1);
      release_q(qi);

      // o / max(l, 1e-30) in bf16, l summed over the 4 lanes of a row
#pragma unroll
      for (int j = 0; j < PW; ++j) {
        const int bh = grp * G + (SCHED == STRAIGHT ? u : prob(j));
        float den[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float sum = l[j][r];
#pragma unroll
          for (int off = 1; off < 4; off <<= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
          den[r] = fmaxf(sum, 1e-30f);
        }
        const size_t lo =
            (size_t(bh) * P.Np + q0 + row_w + (warp % 4) * 16 + g) * D;
        const size_t hi = lo + 8 * D;
#pragma unroll
        for (int d = 0; d < 8; ++d) {
          const int x = d * 8 + 2 * t4;
          *reinterpret_cast<__nv_bfloat162*>(P.o + lo + x) =
              __floats2bfloat162_rn(o[j][d][0] / den[0], o[j][d][1] / den[0]);
          *reinterpret_cast<__nv_bfloat162*>(P.o + hi + x) =
              __floats2bfloat162_rn(o[j][d][2] / den[1], o[j][d][3] / den[1]);
        }
      }
    }
  }
}

constexpr int EX2_CHAINS = 8;
constexpr int EX2_THREADS = 256;

__global__ void __launch_bounds__(EX2_THREADS)
    ex2_rate_kernel(float* out, int iters) {
  float x[EX2_CHAINS];
#pragma unroll
  for (int i = 0; i < EX2_CHAINS; ++i) x[i] = 0.125f * i;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int i = 0; i < EX2_CHAINS; ++i) x[i] = ex2(-x[i]);
  }
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < EX2_CHAINS; ++i) sum += x[i];
  out[size_t(blockIdx.x) * EX2_THREADS + threadIdx.x] = sum;
}

bool bad_shape(int BH, int Np, int D_, int G) {
  return D_ != D || BH <= 0 || Np <= 0 || Np % BK != 0 || G <= 0 ||
         BH % G != 0 || BH / G > 65535;
}

// grouped_sm90 launches since the library loaded, counted where the kernel
// is launched. Read by bench_attention_design_launches (beside
// global_sm90.cuh's design_launches, matmul-only's).
std::atomic<long long> grouped_launches{0};

template <int G, int SCHED>
int launch_grouped(const void* q, const void* k, const void* v, void* o,
                   int BH, int Np, cudaStream_t stream) {
  using C = GsCfg<G, SCHED>;
  GsParams P{};
  int err = encode_heads<D>(&P.tq, q, BH, Np, Np, 1, C::QR, C::NB);
  if (err == 0) err = encode_heads<D>(&P.tk, k, BH, Np, Np, 1, C::BK, C::NB);
  if (err == 0) err = encode_heads<D>(&P.tv, v, BH, Np, Np, 1, C::BK, C::NB);
  if (err != 0) return err;
  const auto kernel = grouped_sm90<G, SCHED>;
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  err = smem_limit_once(kernel, int(C::SMEM), attr_set, &dev);
  if (err != 0) return err;
  P.o = static_cast<__nv_bfloat16*>(o);
  P.Np = Np;
  P.n_qt = Np / C::QR;
  P.items = P.n_qt * (BH / G);
  const int sms = sm_count(dev);
  if (sms <= 0) return int(cudaErrorInvalidValue);
  kernel<<<P.items < sms ? P.items : sms, GS_THREADS, C::SMEM, stream>>>(P);
  err = int(cudaGetLastError());
  if (err == 0) grouped_launches.fetch_add(1, std::memory_order_relaxed);
  return err;
}

template <int SCHED>
int dispatch_grouped(const void* q, const void* k, const void* v, void* o,
                     int BH, int Np, int D_, int G, void* stream) {
  if (D_ != D || BH <= 0 || Np <= 0 || Np % 128 != 0 || G <= 0 ||
      BH % G != 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 2: return launch_grouped<2, SCHED>(q, k, v, o, BH, Np, st);
    case 4: return launch_grouped<4, SCHED>(q, k, v, o, BH, Np, st);
    case 8: return launch_grouped<8, SCHED>(q, k, v, o, BH, Np, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <int SCHED>
int block_k_of(int G) {
  return G == 2 ? GsCfg<2, SCHED>::BK
         : G == 4 ? GsCfg<4, SCHED>::BK
         : G == 8 ? GsCfg<8, SCHED>::BK
                  : 0;
}

}  // namespace

extern "C" {

int bench_matmul_only(const void* q, const void* k, const void* v, void* o,
                      int BH, int Np, int D_, void* stream) {
  if (bad_shape(BH, Np, D_, 1)) return int(cudaErrorInvalidValue);
  return launch_global_sm90<MO_BQ, MO_BK, G_MATMUL>(
      q, k, v, o, nullptr, 1.f, BH, Np, Np, Np,
      static_cast<cudaStream_t>(stream));
}

// z must be 0: it only hides from the compiler that a row's logits are equal.
int bench_softmax_only(const void* q, void* o, int BH, int Np, int D_,
                       float z, void* stream) {
  if (bad_shape(BH, Np, D_, 1)) return int(cudaErrorInvalidValue);
  softmax_only_kernel<<<dim3(Np / BQ, BH), NTHREAD, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(o),
      Np, z);
  return int(cudaGetLastError());
}

int bench_grouped(const void* q, const void* k, const void* v, void* o,
                  int BH, int Np, int D_, int G, int interleave,
                  void* stream) {
  return interleave
             ? dispatch_grouped<INTERLEAVED>(q, k, v, o, BH, Np, D_, G, stream)
             : dispatch_grouped<STRAIGHT>(q, k, v, o, BH, Np, D_, G, stream);
}

int bench_pipelined(const void* q, const void* k, const void* v, void* o,
                    int BH, int Np, int D_, int G, void* stream) {
  return dispatch_grouped<PIPELINED>(q, k, v, o, BH, Np, D_, G, stream);
}

// The key tile of the grouped_sm90 instance of G and schedule (0 straight,
// 1 interleaved, 2 pipelined); 0 where there is none.
int bench_grouped_block_k(int G, int schedule) {
  switch (schedule) {
    case STRAIGHT: return block_k_of<STRAIGHT>(G);
    case INTERLEAVED: return block_k_of<INTERLEAVED>(G);
    case PIPELINED: return block_k_of<PIPELINED>(G);
    default: return 0;
  }
}

// out[0]: grouped_sm90 launches (bench_grouped, bench_pipelined); out[1]:
// global_sm90 launches (bench_matmul_only).
void bench_attention_design_launches(long long* out) {
  out[0] = grouped_launches.load(std::memory_order_relaxed);
  out[1] = design_launches.load(std::memory_order_relaxed);
}

// out: blocks * 256 floats, each the sum of 8 chains after `iters` steps.
int bench_ex2_rate(void* out, int blocks, int iters, void* stream) {
  if (blocks <= 0 || iters <= 0) return int(cudaErrorInvalidValue);
  ex2_rate_kernel<<<blocks, EX2_THREADS, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), iters);
  return int(cudaGetLastError());
}

const char* bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
