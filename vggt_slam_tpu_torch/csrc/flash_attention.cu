// Flash-attention forward kernels for Hopper (sm_90a), packed (B, N, H*D)
// bf16 layout, bound to PyTorch through a plain C interface (ctypes).
//
// Two entry points, one per TPU kernel of the JAX package:
//
//   flash_single_fwd  replaces vggt_slam_tpu/ops/attention.py
//                     _flash_single_kernel: exact softmax attention with a
//                     running row max (encoder, frame blocks, camera trunk).
//                     The TPU kernel holds all keys in one block; 1041 keys
//                     of K and V do not fit in 227 KB of shared memory, so
//                     this kernel walks 64-key tiles with an online softmax,
//                     which computes the same function.
//   flash_multi_fwd   replaces vggt_slam_tpu/ops/attention.py _flash_kernel
//                     in its default composite: static-max softmax (a
//                     per-(batch, head) bound replaces the running max, so
//                     there is no rescale), in-kernel qk-LayerNorm and rope,
//                     a per-key log-count bias and a valid_len key mask.
//
// Both compute, per (batch, head) and query row,
//     out = sum_j exp2(s_j - m) v_j / max(sum_j exp2(s_j - m), 1e-30)
// where s_j = q'.k'_j + kv_bias_j log2(e) for keys j < valid_len (masked
// keys get s = -1e30 and their v rows are zeroed), q' and k' are the
// prepared rows: optional fast-variance LayerNorm over the head dim
// (rounded to bf16), then rope x*C + [x2|x1]*S' with the softmax scale and
// log2(e) folded into q's tables (rounded to bf16); without rope q is
// scaled by the same constant and rounded to bf16. m is the running row
// max (single) or the static bound (multi).
//
// What bounds it on this card: at the main-path shapes both kernels do
// ~4 N_q N_k D flops per head on ~(N_q + 2 N_k) D bf16 bytes, far above
// the H100's ~295 flop/byte ridge, so the tensor cores bound them.
// Design: the TPU kernel caches the prepared k once per (batch, head); here
// a small prep kernel writes LN+rope'd k once to a scratch buffer
// (prep_rows_kernel), and each attention CTA prepares its own q tile. One
// CTA of 4 warps per (64-row q tile, batch, head) walks 64-key K/V tiles
// staged in shared memory; QK^T and PV run on mma.sync m16n8k16 bf16 with
// f32 accumulators that stay in registers (the FlashAttention-2 layout:
// each warp owns 16 query rows, the softmax state lives in the
// accumulator fragments, P is repacked into A fragments without touching
// shared memory); key tiles past valid_len are never loaded. wgmma, TMA
// and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                // query rows per CTA
constexpr int BK = 64;                // keys per tile
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;   // prepared k (LN + rope applied) or raw k
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int H, Nq, Nk, valid_len;
  float q_scale;          // softmax scale * log2(e)
  const float* ln;        // (4, D): q gamma, q beta, k gamma, k beta; or null
  float ln_eps;
  const float* kv_bias;   // (Nk,) natural-log units; or null
  const float* cos_q;     // (Nq, D/2); or null (no rope)
  const float* sin_q;
  const float* smax;      // (B*H,) static bound, multi kernel only
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Prepare one head row held across a warp (lane l owns dims
// [l*PER, l*PER + PER)): optional LayerNorm, then rope at position n from
// (cos, sin) tables scaled by `scale`, or without rope a plain multiply by
// `scale` (skipped when it is 1). Every stage rounds to bf16 as the
// reference does. Returns whether x was changed.
template <int D>
__device__ __forceinline__ bool prep_row(float (&x)[D / 32], int lane, int n,
                                         const float* gamma, const float* beta,
                                         float eps, const float* cos_t,
                                         const float* sin_t, float scale) {
  constexpr int PER = D / 32;
  constexpr int HALF = D / 2;
  if (gamma != nullptr) {
    float s = 0.f, ss = 0.f;
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      s += x[j];
      ss += x[j] * x[j];
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mu = s / D;
    const float var = fmaxf(ss / D - mu * mu, 0.f);
    const float rs = rsqrtf(var + eps);
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      const int d = lane * PER + j;
      x[j] = __bfloat162float(
          __float2bfloat16((x[j] - mu) * rs * gamma[d] + beta[d]));
    }
  }
  if (cos_t != nullptr) {
    float y[PER];
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      // the rope partner d -+ D/2 sits in lane l ^ 16
      const float partner = __shfl_xor_sync(0xffffffffu, x[j], 16);
      const int d = lane * PER + j;
      const int f = d % HALF;
      const float c = cos_t[size_t(n) * HALF + f] * scale;
      float sn = sin_t[size_t(n) * HALF + f] * scale;
      if (d < HALF) sn = -sn;
      y[j] = __bfloat162float(__float2bfloat16(x[j] * c + partner * sn));
    }
#pragma unroll
    for (int j = 0; j < PER; ++j) x[j] = y[j];
    return true;
  }
  if (scale != 1.f) {
#pragma unroll
    for (int j = 0; j < PER; ++j)
      x[j] = __bfloat162float(__float2bfloat16(x[j] * scale));
    return true;
  }
  return gamma != nullptr;
}

// Prepared k rows, written once per call: one warp per (row, head).
template <int D>
__global__ void __launch_bounds__(NTHREAD)
    prep_rows_kernel(const __nv_bfloat16* src, __nv_bfloat16* dst, int rows,
                     int N, int H, const float* gamma, const float* beta,
                     float eps, const float* cos_t, const float* sin_t) {
  constexpr int PER = D / 32;
  const int lane = threadIdx.x % 32;
  const int item = blockIdx.x * NWARP + threadIdx.x / 32;
  if (item >= rows * H) return;   // whole warps exit together
  const int row = item / H;
  const size_t base = size_t(item) * D + lane * PER;
  float x[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) x[j] = __bfloat162float(src[base + j]);
  prep_row<D>(x, lane, row % N, gamma, beta, eps, cos_t, sin_t, 1.f);
#pragma unroll
  for (int j = 0; j < PER; ++j) dst[base + j] = __float2bfloat16(x[j]);
}

// Copy rows [row0, row0 + 64) of head h into a shared tile with 16-byte
// loads; rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int b,
                                          int h, int H, int N, int row0,
                                          int limit) {
  constexpr int VEC = D / 8;
  constexpr int LD = D + 8;
  for (int i = threadIdx.x; i < 64 * VEC; i += NTHREAD) {
    const int r = i / VEC, c = i % VEC;
    const int n = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (n < limit) {
      val = *reinterpret_cast<const uint4*>(
          src + ((size_t(b) * N + n) * H + h) * D + c * 8);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c * 8) = val;
  }
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

template <int D, bool STATIC>
__global__ void __launch_bounds__(NTHREAD) flash_fwd_kernel(Params p) {
  constexpr int LD = D + 8;          // bf16 tile row stride (conflict-free)
  constexpr int KS = D / 16;         // k-steps of QK^T
  constexpr int NT = BK / 8;         // 8-key n-tiles of S
  constexpr int DT = D / 8;          // 8-dim n-tiles of O
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;   // mma fragment coordinates

  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;

  // q tile: load, prepare in place (one warp per row), then keep this
  // warp's 16 rows as A fragments in registers for the whole key sweep.
  load_tile<D>(Qs, p.q, b, h, p.H, p.Nq, q0, p.Nq);
  __syncthreads();
  for (int r = warp; r < BQ; r += NWARP) {
    const int n = q0 + r;
    __nv_bfloat16* row = Qs + r * LD + lane * (D / 32);
    float x[D / 32];
#pragma unroll
    for (int j = 0; j < D / 32; ++j) x[j] = __bfloat162float(row[j]);
    const bool changed = prep_row<D>(
        x, lane, min(n, p.Nq - 1), p.ln, p.ln ? p.ln + D : nullptr, p.ln_eps,
        p.cos_q, p.sin_q, p.q_scale);
    if (changed) {
#pragma unroll
      for (int j = 0; j < D / 32; ++j) row[j] = __float2bfloat16(x[j]);
    }
  }
  __syncthreads();
  uint32_t qa[KS][4];
  {
    const int m = lane / 8, r = lane % 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      ldmatrix_x4(qa[ks], Qs + (warp * 16 + (m % 2) * 8 + r) * LD + ks * 16 +
                              (m / 2) * 8);
  }

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // rows g and g + 8 of this warp's 16; l is this lane's partial row sum
  float m_lo = STATIC ? p.smax[bh] : NEG_INF, m_hi = m_lo;
  float l_lo = 0.f, l_hi = 0.f;
  const int vl = min(p.valid_len, p.Nk);
  const int ntiles = (vl + BK - 1) / BK;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, p.k, b, h, p.H, p.Nk, k0, p.Nk);
    load_tile<D>(Vs, p.v, b, h, p.H, p.Nk, k0, vl);
    __syncthreads();

    // S = Q_w K^T: 16 x 64 per warp in NT accumulator fragments.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        // matrices: (keys 8j.., dims lo), (8j.., hi), (8j+8.., lo), (.., hi)
        uint32_t kb[4];
        const int m = lane / 8, r = lane % 8;
        ldmatrix_x4(kb, Ks + (j * 8 + (m / 2) * 8 + r) * LD + ks * 16 +
                            (m % 2) * 8);
        mma_bf16(s[j], qa[ks], kb[0], kb[1]);
        mma_bf16(s[j + 1], qa[ks], kb[2], kb[3]);
      }
    }

    // Bias, mask, softmax shift.
    float mx_lo = NEG_INF, mx_hi = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        float v = s[j][e];
        if (col < vl) {
          if (p.kv_bias != nullptr) v += p.kv_bias[col] * LOG2E;
        } else {
          v = NEG_INF;
        }
        s[j][e] = v;
      }
      mx_lo = fmaxf(mx_lo, fmaxf(s[j][0], s[j][1]));
      mx_hi = fmaxf(mx_hi, fmaxf(s[j][2], s[j][3]));
    }
    if (!STATIC) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, off));
        mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, off));
      }
      const float n_lo = fmaxf(m_lo, mx_lo), n_hi = fmaxf(m_hi, mx_hi);
      const float c_lo = exp2f(m_lo - n_lo), c_hi = exp2f(m_hi - n_hi);
      m_lo = n_lo;
      m_hi = n_hi;
      l_lo *= c_lo;
      l_hi *= c_hi;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        o[i][0] *= c_lo;
        o[i][1] *= c_lo;
        o[i][2] *= c_hi;
        o[i][3] *= c_hi;
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - m_lo);
      s[j][1] = exp2f(s[j][1] - m_lo);
      s[j][2] = exp2f(s[j][2] - m_hi);
      s[j][3] = exp2f(s[j][3] - m_hi);
      l_lo += s[j][0] + s[j][1];
      l_hi += s[j][2] + s[j][3];
    }

    // O += P V: P repacked from the S fragments into bf16 A fragments.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int i = 0; i < DT; i += 2) {
        // matrices: (keys lo, dims 8i..), (keys hi, 8i..), (lo, 8i+8..),
        // (hi, 8i+8..), transposed on load
        uint32_t vb[4];
        const int m = lane / 8, r = lane % 8;
        ldmatrix_x4_trans(vb, Vs + (kk * 16 + (m % 2) * 8 + r) * LD +
                                  (i + m / 2) * 8);
        mma_bf16(o[i], pa, vb[0], vb[1]);
        mma_bf16(o[i + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_lo += __shfl_xor_sync(0xffffffffu, l_lo, off);
    l_hi += __shfl_xor_sync(0xffffffffu, l_hi, off);
  }
  const float d_lo = fmaxf(l_lo, 1e-30f), d_hi = fmaxf(l_hi, 1e-30f);
  const int n_lo = q0 + warp * 16 + g, n_hi = n_lo + 8;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = i * 8 + 2 * t;
    if (n_lo < p.Nq) {
      __nv_bfloat162 v = __floats2bfloat162_rn(o[i][0] / d_lo, o[i][1] / d_lo);
      *reinterpret_cast<__nv_bfloat162*>(
          p.o + ((size_t(b) * p.Nq + n_lo) * p.H + h) * D + d) = v;
    }
    if (n_hi < p.Nq) {
      __nv_bfloat162 v = __floats2bfloat162_rn(o[i][2] / d_hi, o[i][3] / d_hi);
      *reinterpret_cast<__nv_bfloat162*>(
          p.o + ((size_t(b) * p.Nq + n_hi) * p.H + h) * D + d) = v;
    }
  }
}

template <int D, bool STATIC>
int launch(const Params& p, int B, cudaStream_t stream) {
  const size_t bytes = size_t(BQ + 2 * BK) * (D + 8) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D, STATIC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.Nq + BQ - 1) / BQ, B * p.H);
  flash_fwd_kernel<D, STATIC><<<grid, NTHREAD, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

template <int D>
int launch_prep(const __nv_bfloat16* src, __nv_bfloat16* dst, int B, int N,
                int H, const float* gamma, const float* beta, float eps,
                const float* cos_t, const float* sin_t, cudaStream_t stream) {
  const int items = B * N * H;
  prep_rows_kernel<D><<<(items + NWARP - 1) / NWARP, NTHREAD, 0, stream>>>(
      src, dst, B * N, N, H, gamma, beta, eps, cos_t, sin_t);
  return int(cudaGetLastError());
}

// k_work: scratch of k's shape for the prepared k, used when k needs LN or
// rope (null otherwise).
template <bool STATIC>
int dispatch(const void* q, const void* k, const void* v, void* o,
             void* k_work, int B, int H, int Nq, int Nk, int D,
             int valid_len, float q_scale, const void* ln, float ln_eps,
             const void* kv_bias, const void* cos_q, const void* sin_q,
             const void* cos_k, const void* sin_k, const void* smax,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lnf = static_cast<const float*>(ln);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  if (D != 64 && D != 128) return int(cudaErrorInvalidValue);
  if (ln != nullptr || cos_k != nullptr) {
    if (k_work == nullptr) return int(cudaErrorInvalidValue);
    __nv_bfloat16* kw = static_cast<__nv_bfloat16*>(k_work);
    const float* ck = static_cast<const float*>(cos_k);
    const float* sk = static_cast<const float*>(sin_k);
    const float* gk = lnf ? lnf + 2 * D : nullptr;
    const float* bk = lnf ? lnf + 3 * D : nullptr;
    const int err =
        D == 64 ? launch_prep<64>(kp, kw, B, Nk, H, gk, bk, ln_eps, ck, sk, st)
                : launch_prep<128>(kp, kw, B, Nk, H, gk, bk, ln_eps, ck, sk,
                                   st);
    if (err != 0) return err;
    kp = kw;
  }
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = kp;
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.valid_len = valid_len;
  p.q_scale = q_scale;
  p.ln = lnf;
  p.ln_eps = ln_eps;
  p.kv_bias = static_cast<const float*>(kv_bias);
  p.cos_q = static_cast<const float*>(cos_q);
  p.sin_q = static_cast<const float*>(sin_q);
  p.smax = static_cast<const float*>(smax);
  return D == 64 ? launch<64, STATIC>(p, B, st) : launch<128, STATIC>(p, B, st);
}

}  // namespace

extern "C" {

int flash_single_fwd(const void* q, const void* k, const void* v, void* o,
                     void* k_work, int B, int H, int Nq, int Nk, int D,
                     int valid_len, float q_scale, const void* ln,
                     float ln_eps, const void* kv_bias, const void* cos_q,
                     const void* sin_q, const void* cos_k, const void* sin_k,
                     void* stream) {
  return dispatch<false>(q, k, v, o, k_work, B, H, Nq, Nk, D, valid_len,
                         q_scale, ln, ln_eps, kv_bias, cos_q, sin_q, cos_k,
                         sin_k, nullptr, stream);
}

int flash_multi_fwd(const void* q, const void* k, const void* v, void* o,
                    void* k_work, int B, int H, int Nq, int Nk, int D,
                    int valid_len, float q_scale, const void* ln, float ln_eps,
                    const void* kv_bias, const void* cos_q, const void* sin_q,
                    const void* cos_k, const void* sin_k, const void* smax,
                    void* stream) {
  return dispatch<true>(q, k, v, o, k_work, B, H, Nq, Nk, D, valid_len,
                        q_scale, ln, ln_eps, kv_bias, cos_q, sin_q, cos_k,
                        sin_k, smax, stream);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
