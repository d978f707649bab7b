// Probe kernels of the frame-attention microbenchmark for Hopper (sm_90a),
// bound to PyTorch through a plain C interface (ctypes).
//
// scripts/bench_attention.py splits the frame-attention problem (BH
// independent (frame, head) problems of N tokens at D = 64, zero-padded to
// Np, a multiple of 128) into diagnostic TPU kernels. Each entry point here
// replaces one of them and computes what it computes, on contiguous
// (BH, Np, D) bf16 tensors:
//
//   bench_matmul_only   _matmul_only_kernel (:45): o = bf16(q k^T) v with
//                       f32 accumulation and no softmax; the tensor-core
//                       floor.
//   bench_softmax_only  _softmax_only_kernel (:57): the logits of row r are
//                       q[r, 0] * 0.01 in every column; m = row max,
//                       p = exp2(s - m), l = sum p, o = p[:, :D] / l. No
//                       matmuls; the softmax floor (o is 1/Np everywhere).
//   bench_grouped       _grouped_kernel (:70): G problems per CTA of
//                       exp2-domain attention on pre-scaled q,
//                       o = bf16(p) v / max(l, 1e-30), padded keys unmasked
//                       (logit 0, v 0); straight or interleaved schedule.
//   bench_pipelined     _pipelined_kernel (:101): the same function, the
//                       QK^T of problem g + 1 issued before the softmax and
//                       PV of problem g.
//
// Tiling follows flash_attention.cu: one CTA of 4 warps per 64-row q tile
// and per problem (or group of G problems); 64-key K/V tiles staged in
// shared memory; QK^T and PV on mma.sync m16n8k16 bf16 with f32
// accumulators in registers; P repacked into A fragments in registers. Np
// is a multiple of 64, so no tile is ragged and nothing is masked.
//
// The softmax: the reference takes the row max over all Np keys before any
// exp2, but a 64 x Np f32 row block does not fit in registers. The grouped
// and pipelined kernels keep a running max instead (FlashAttention-2's
// online softmax, as flash_single does): the same function up to the bf16
// rounding of p, which is taken against the running max, not the final one.
//
// Schedules, per 64-key tile:
//   straight     problem by problem: each problem's whole key sweep, then
//                the next (one problem live, flash_single's registers);
//   interleaved  the G QK^T products of the tile, then the G softmax + PV
//                chains (G score tiles and G accumulators live);
//   pipelined    QK^T of problem g + 1, then softmax + PV of problem g (two
//                score tiles and G accumulators live).
// For G = 2 interleaved and pipelined are the same order, as in the
// reference. The order is the source's; ptxas may schedule independent
// instructions across it.
//
// What bounds them on this card: matmul-only does 4 BH Np^2 D flops on
// 4 BH Np D bf16 values (tensor cores); softmax-only does BH Np^2 exp2 on
// 2 BH Np D values (MUFU.EX2, 16 per SM per clock); the grouped kernels do
// both. They are probes: set beside flash_single's time, their times say
// which part bounds it. In softmax-only every logit of a row is equal, so
// each one is computed as x + col * z with z a kernel argument the caller
// passes as 0: the compiler cannot hoist the exp2 out of the column loop,
// and the result is unchanged.
//
// ex2_rate is a calibration of the card, not a port: independent chains
// x <- 2^-x on ex2.approx, to measure the MUFU.EX2 rate that the softmax
// bound is taken against.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int D = 64;                 // the frame attention's head dim
constexpr int BQ = 64;                // query rows per CTA
constexpr int BK = 64;                // keys per tile
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;
constexpr int LD = D + 8;             // bf16 tile row stride
constexpr int TILE = 64 * LD;         // bf16 elements of one staged tile
constexpr int KS = D / 16;            // k-steps of QK^T
constexpr int NT = BK / 8;            // 8-key n-tiles of S
constexpr int DT = D / 8;             // 8-dim n-tiles of O

enum Schedule { STRAIGHT = 0, INTERLEAVED = 1, PIPELINED = 2 };

// Rows [row0, row0 + 64) of problem bh of a (BH, Np, D) tensor.
__device__ __forceinline__ void load(__nv_bfloat16* dst,
                                     const __nv_bfloat16* src, int bh,
                                     int Np, int row0) {
  load_tile<D, NTHREAD>(dst, src, bh, 0, 1, Np, row0, Np);
}

// This warp's 16 q rows of a staged tile as A fragments.
__device__ __forceinline__ void load_q(uint32_t (&qa)[KS][4],
                                       const __nv_bfloat16* Qs, int warp,
                                       int lane) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) load_a<LD>(qa[ks], Qs, warp * 16, ks * 16, lane);
}

// S = Q_w K^T: 16 rows x the 64 keys of a staged K tile.
__device__ __forceinline__ void qk(float (&s)[NT][4],
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

// O += bf16(P) V over one 64-key tile, P the S fragments.
__device__ __forceinline__ void pv(float (&o)[DT][4], const float (&p)[NT][4],
                                   const __nv_bfloat16* Vs, int lane) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
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
  }
}

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
    matmul_only_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k,
                       const __nv_bfloat16* v, __nv_bfloat16* out, int Np) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + TILE;
  __nv_bfloat16* Vs = Ks + TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  load(Qs, q, bh, Np, q0);
  __syncthreads();
  uint32_t qa[KS][4];
  load_q(qa, Qs, warp, lane);
  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  for (int k0 = 0; k0 < Np; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load(Ks, k, bh, Np, k0);
    load(Vs, v, bh, Np, k0);
    __syncthreads();
    float s[NT][4];
    qk(s, qa, Ks, lane);
    pv(o, s, Vs, lane);   // S rounded to bf16 as the A operand
  }
  store(o, 1.f, 1.f, out, bh, Np, q0, warp, lane);
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

template <int G, int SCHED>
__global__ void __launch_bounds__(NTHREAD)
    grouped_kernel(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* out, int Np) {
  constexpr int NSET = SCHED == STRAIGHT ? 1 : G;   // problems staged at once
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + NSET * TILE;
  __nv_bfloat16* Vs = Ks + NSET * TILE;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh0 = blockIdx.y * G, q0 = blockIdx.x * BQ;

  if constexpr (SCHED == STRAIGHT) {
#pragma unroll 1
    for (int g = 0; g < G; ++g) {
      const int bh = bh0 + g;
      __syncthreads();  // the previous problem's tiles are consumed
      load(Qs, q, bh, Np, q0);
      __syncthreads();
      uint32_t qa[KS][4];
      load_q(qa, Qs, warp, lane);
      RowState st;
      init(st);
      for (int k0 = 0; k0 < Np; k0 += BK) {
        __syncthreads();
        load(Ks, k, bh, Np, k0);
        load(Vs, v, bh, Np, k0);
        __syncthreads();
        float s[NT][4];
        qk(s, qa, Ks, lane);
        softmax_tile(st, s);
        pv(st.o, s, Vs, lane);
      }
      finish(st, out, bh, Np, q0, warp, lane);
    }
  } else {
#pragma unroll
    for (int g = 0; g < G; ++g) load(Qs + g * TILE, q, bh0 + g, Np, q0);
    RowState st[G];
#pragma unroll
    for (int g = 0; g < G; ++g) init(st[g]);
    for (int k0 = 0; k0 < Np; k0 += BK) {
      __syncthreads();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        load(Ks + g * TILE, k, bh0 + g, Np, k0);
        load(Vs + g * TILE, v, bh0 + g, Np, k0);
      }
      __syncthreads();
      // q fragments come from shared memory at each use, to spare G x 16
      // registers
      if constexpr (SCHED == INTERLEAVED) {
        float s[G][NT][4];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          uint32_t qa[KS][4];
          load_q(qa, Qs + g * TILE, warp, lane);
          qk(s[g], qa, Ks + g * TILE, lane);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          softmax_tile(st[g], s[g]);
          pv(st[g].o, s[g], Vs + g * TILE, lane);
        }
      } else {
        float s[2][NT][4];
        {
          uint32_t qa[KS][4];
          load_q(qa, Qs, warp, lane);
          qk(s[0], qa, Ks, lane);
        }
#pragma unroll
        for (int g = 1; g < G; ++g) {
          uint32_t qa[KS][4];
          load_q(qa, Qs + g * TILE, warp, lane);
          qk(s[g & 1], qa, Ks + g * TILE, lane);
          softmax_tile(st[g - 1], s[(g - 1) & 1]);
          pv(st[g - 1].o, s[(g - 1) & 1], Vs + (g - 1) * TILE, lane);
        }
        softmax_tile(st[G - 1], s[(G - 1) & 1]);
        pv(st[G - 1].o, s[(G - 1) & 1], Vs + (G - 1) * TILE, lane);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) finish(st[g], out, bh0 + g, Np, q0, warp, lane);
  }
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
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
    for (int i = 0; i < EX2_CHAINS; ++i) x[i] = ex2_approx(-x[i]);
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

template <int G, int SCHED>
int launch_grouped(const __nv_bfloat16* q, const __nv_bfloat16* k,
                   const __nv_bfloat16* v, __nv_bfloat16* o, int BH, int Np,
                   cudaStream_t st) {
  constexpr int NSET = SCHED == STRAIGHT ? 1 : G;
  const size_t bytes = size_t(3) * NSET * TILE * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(
      grouped_kernel<G, SCHED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  grouped_kernel<G, SCHED>
      <<<dim3(Np / BQ, BH / G), NTHREAD, bytes, st>>>(q, k, v, o, Np);
  return int(cudaGetLastError());
}

template <int SCHED>
int dispatch_grouped(const void* q, const void* k, const void* v, void* o,
                     int BH, int Np, int D_, int G, void* stream) {
  if (bad_shape(BH, Np, D_, G)) return int(cudaErrorInvalidValue);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (G) {
    case 2: return launch_grouped<2, SCHED>(qp, kp, vp, op, BH, Np, st);
    case 4: return launch_grouped<4, SCHED>(qp, kp, vp, op, BH, Np, st);
    case 8: return launch_grouped<8, SCHED>(qp, kp, vp, op, BH, Np, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int bench_matmul_only(const void* q, const void* k, const void* v, void* o,
                      int BH, int Np, int D_, void* stream) {
  if (bad_shape(BH, Np, D_, 1)) return int(cudaErrorInvalidValue);
  const size_t bytes = size_t(3) * TILE * sizeof(__nv_bfloat16);  // < 48 KB
  matmul_only_kernel<<<dim3(Np / BQ, BH), NTHREAD, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Np);
  return int(cudaGetLastError());
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
