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
//                     this kernel walks 128-key tiles with an online
//                     softmax, which computes the same function.
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
// max (single) or the static bound (multi). When the caller passes m_out
// and l_out (the training forward), each kernel also writes per (batch,
// head, row) the shift m the summands were taken against and the row sum
// l = sum_j exp2(s_j - m), the return_stats convention of the JAX kernels
// (attention.py:365-384); the inference path passes null pointers.
//
// What bounds it on this card: at the main-path shapes both kernels do
// ~4 N_q N_k D flops per head on ~(N_q + 2 N_k) D bf16 bytes, far above
// the H100's ~295 flop/byte ridge, so the tensor cores bound them, and at
// head dim 32 the exp units (one exp2 per logit outweighs both products);
// at head dim 128 (the camera trunk, 4-18 tokens) the bytes.
// Design: the TPU kernel caches the prepared k once per (batch, head); here
// a small prep kernel writes LN+rope'd k once to a scratch buffer
// (prep_rows_kernel), and q with LN or rope into the output buffer, which
// the attention kernel reads its q tiles from. Every head dim (32, 64,
// 128), bf16 or int8 QK^T, runs the Hopper design of flash_sm90.cuh:
// TMA-fed K/V ring, wgmma for both products, 128-row q tiles; key tiles
// past valid_len are never loaded.
//
// The int8 variants (flash_single_i8_fwd, flash_multi_i8_fwd) replace
// _flash_kernel with qk_int8=True (vggt_slam_tpu/ops/attention.py:103,
// :169-221, :274-276, :310-311, :606-629): q and k are roped with tables
// at scale 1, rounded to bf16 and quantized to int8 as
// clip(rint(x * 127 / amax), +-127) with per-(batch, head) scales from the
// int8 pre-pass (i8_scales_kernel, bit-equal to int8_scales in
// ops/attention.py), which also writes the quantized q and k once per
// call; QK^T runs on s8 wgmma with s32 accumulation, and the s32 logits
// times amax_q amax_k log2(e) / (sqrt(D) 127^2) enter the same softmax, P
// repack and bf16 PV as the bf16 kernels. The int8 products run at twice
// the bf16 rate, so QK^T's share of the bound halves; PV, the softmax and
// the bytes are unchanged.

#include <type_traits>

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int NWARP = 4;              // prep_rows_kernel: a warp per row
constexpr int NTHREAD = NWARP * 32;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;   // prepared k (LN + rope applied) or raw k
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int H, Nq, Nk, valid_len;
  float q_scale;          // softmax scale * log2(e)
  const float* ln_g;      // (D,) q's LayerNorm gamma, or null (no LN)
  const float* ln_b;      // (D,) q's LayerNorm beta
  float ln_eps;
  const float* kv_bias;   // (Nk,) natural-log units; or null
  const float* cos_q;     // (Nq, D/2); or null (no rope)
  const float* sin_q;
  const float* smax;      // (B*H,) static bound, multi kernel only
  float* m_out;           // (B*H, Nq) row shift, or null
  float* l_out;           // (B*H, Nq) row sum, or null
};

// The int8 kernels' parameters: no LN, no rope and no softmax scale (q and
// k arrive quantized by the pre-pass), the quantization scales instead.
struct ParamsI8 {
  const int8_t* q;        // q quantized by the pre-pass (rope, bf16 round)
  const int8_t* k;        // k quantized likewise
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  int H, Nq, Nk, valid_len;
  const float* scales;    // (3, B*H): 127/amax_q, 127/amax_k, dequant scale
  const float* kv_bias;
  const float* smax;
  float* m_out;
  float* l_out;
};

template <bool INT8>
using ParamsOf = std::conditional_t<INT8, ParamsI8, Params>;

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
      // products and sum rounded apart (no fma), as the plain version's
      // separate f32 ops: the bf16 round then agrees bit for bit, which
      // the int8 kernels need (a flipped bf16 ulp flips an int8 value)
      y[j] = __bfloat162float(__float2bfloat16(
          __fadd_rn(__fmul_rn(x[j], c), __fmul_rn(partner, sn))));
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

// Prepared rows, written once per call: one warp per (row, head). k at
// scale 1, q at the softmax scale (flash_sm90.cuh).
template <int D>
__global__ void __launch_bounds__(NTHREAD)
    prep_rows_kernel(const __nv_bfloat16* src, __nv_bfloat16* dst, int rows,
                     int N, int H, const float* gamma, const float* beta,
                     float eps, const float* cos_t, const float* sin_t,
                     float scale) {
  constexpr int PER = D / 32;
  const int lane = threadIdx.x % 32;
  const int item = blockIdx.x * NWARP + threadIdx.x / 32;
  if (item >= rows * H) return;   // whole warps exit together
  const int row = item / H;
  const size_t base = size_t(item) * D + lane * PER;
  float x[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) x[j] = __bfloat162float(src[base + j]);
  prep_row<D>(x, lane, row % N, gamma, beta, eps, cos_t, sin_t, scale);
#pragma unroll
  for (int j = 0; j < PER; ++j) dst[base + j] = __float2bfloat16(x[j]);
}

// The int8 pre-pass of flash_single_i8_fwd and flash_multi_i8_fwd, the
// counterpart of int8_scales (ops/attention.py; reference attention.py
// :606-629) and of the reference's _quant_i8 after its rope (:103,
// :169-221): the per-(batch, head) scales over every row of q and k, then
// q and k quantized once per call. What bounds it: bytes (q and k read
// twice, their int8 copies written once).
struct I8Prep {
  const __nv_bfloat16* x[2];   // q, k: packed (B, N, H*D)
  int8_t* x8[2];      // their int8 copies
  const float* cos_t[2];   // (N, D/2) rope tables at scale 1, or null
  const float* sin_t[2];
  int N[2], B, H, rope;
  unsigned* amax;   // (2, B*H) f32 bits of the largest x1^2 + x2^2 (rope)
                    // or |x|, then the count of finished scales blocks
  float* scales;    // (3, B*H): 127/amax_q, 127/amax_k, dequant scale
  float dq;         // log2(e) / sqrt(D) / 127^2, as the caller rounds it
};

constexpr int I8_THREADS = 256;
constexpr int I8_ROWS = 256;   // rows of one head a scales block reduces

__device__ __forceinline__ void unpack8(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(p[e]);
    x[2 * e] = f.x;
    x[2 * e + 1] = f.y;
  }
}

// quant_i8 of 8 values, packed in order.
__device__ __forceinline__ uint2 quant8(const float (&x)[8], float inv) {
  uint32_t w[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    w[e / 4] |= uint32_t(uint8_t(quant_i8(x[e], inv))) << (8 * (e % 4));
  return make_uint2(w[0], w[1]);
}

// Pass 1, grid (row blocks, 2 B H): the largest x1^2 + x2^2 over the rope
// pairs (products and sum rounded apart, as int8_scales' separate f32 ops)
// or the largest |x|, of I8_ROWS rows of one head of q (y < B H) or k. A
// thread takes dims [8c, 8c + 8) and their partners D/2 away. The values
// are not negative, so their f32 bits order as unsigned ints and blocks
// combine by atomicMax; IEEE sqrt is monotone, so the largest pair norm is
// the root of the largest square. The last block to finish turns the
// maxima into the scales with int8_scales' roundings: the clamp at 1e-6,
// 127/amax by one IEEE division, and (amax_q amax_k) dq.
template <int D>
__global__ void __launch_bounds__(I8_THREADS) i8_scales_kernel(I8Prep a) {
  constexpr int TPR = D / 16;                 // threads per row
  constexpr int STEP = I8_THREADS / TPR;      // rows per step
  static_assert(I8_ROWS % STEP == 0, "a block takes whole steps");
  const int BH = a.B * a.H;
  const int side = blockIdx.y >= BH, bh = blockIdx.y - side * BH;
  const int N = side ? a.N[1] : a.N[0];
  const size_t stride = size_t(a.H) * D;
  const __nv_bfloat16* x = (side ? a.x[1] : a.x[0]) +
                           (size_t(bh / a.H) * N * a.H + bh % a.H) * D +
                           (threadIdx.x % TPR) * 8;
  float mx = 0.f;
#pragma unroll
  for (int i = 0; i < I8_ROWS / STEP; ++i) {
    const int r = blockIdx.x * I8_ROWS + i * STEP + threadIdx.x / TPR;
    if (r < N) {
      float x1[8], x2[8];
      unpack8(*reinterpret_cast<const uint4*>(x + r * stride), x1);
      unpack8(*reinterpret_cast<const uint4*>(x + r * stride + D / 2), x2);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        mx = a.rope ? fmaxf(mx, __fadd_rn(__fmul_rn(x1[e], x1[e]),
                                          __fmul_rn(x2[e], x2[e])))
                    : fmaxf(mx, fmaxf(fabsf(x1[e]), fabsf(x2[e])));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  __shared__ float part[I8_THREADS / 32];
  __shared__ bool last;
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 0; w < I8_THREADS / 32; ++w) mx = fmaxf(mx, part[w]);
    if (mx > 0.f) atomicMax(a.amax + blockIdx.y, __float_as_uint(mx));
    __threadfence();
    last = atomicAdd(a.amax + 2 * BH, 1u) == gridDim.x * gridDim.y - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < BH; i += I8_THREADS) {
    float aq = __uint_as_float(__ldcg(a.amax + i));
    float ak = __uint_as_float(__ldcg(a.amax + BH + i));
    if (a.rope) {
      aq = __fsqrt_rn(aq);
      ak = __fsqrt_rn(ak);
    }
    aq = fmaxf(aq, 1e-6f);
    ak = fmaxf(ak, 1e-6f);
    a.scales[i] = __fdiv_rn(127.f, aq);
    a.scales[BH + i] = __fdiv_rn(127.f, ak);
    a.scales[2 * BH + i] = __fmul_rn(__fmul_rn(aq, ak), a.dq);
  }
}

// Pass 2: q rows, then k rows, rope'd at scale 1 (products and sum
// rounded apart, as prep_row), rounded to bf16 and quantized with their
// (batch, head) scale (quant_i8). A thread takes dims [8c, 8c + 8) of one
// (row, head) and their rope partners D/2 away.
template <int D>
__global__ void __launch_bounds__(I8_THREADS) prep_rows_i8_kernel(I8Prep a) {
  constexpr int TPR = D / 16, HALF = D / 2;
  const size_t n_q = size_t(a.B) * a.N[0] * a.H * TPR;
  size_t t = size_t(blockIdx.x) * I8_THREADS + threadIdx.x;
  const int side = t >= n_q;
  if (side) t -= n_q;
  // (the pointers picked by value: a runtime index into the parameter
  // arrays would copy them to local memory)
  const int N = side ? a.N[1] : a.N[0];
  if (t >= size_t(a.B) * N * a.H * TPR) return;
  const __nv_bfloat16* src = side ? a.x[1] : a.x[0];
  int8_t* dst = side ? a.x8[1] : a.x8[0];
  const float* cos_t = side ? a.cos_t[1] : a.cos_t[0];
  const float* sin_t = side ? a.sin_t[1] : a.sin_t[0];
  const int c = t % TPR;
  const size_t item = t / TPR, row = item / a.H;   // (row, head) item
  const int n = row % N, bh = (row / N) * a.H + item % a.H;
  const float inv = a.scales[side * a.B * a.H + bh];
  const size_t base = item * D + c * 8;
  float x1[8], x2[8];
  unpack8(*reinterpret_cast<const uint4*>(src + base), x1);
  unpack8(*reinterpret_cast<const uint4*>(src + base + HALF), x2);
  if (cos_t != nullptr) {
    const float* cs = cos_t + size_t(n) * HALF + c * 8;
    const float* sn = sin_t + size_t(n) * HALF + c * 8;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float y1 = __fadd_rn(__fmul_rn(x1[e], cs[e]),
                                 __fmul_rn(x2[e], -sn[e]));
      const float y2 = __fadd_rn(__fmul_rn(x2[e], cs[e]),
                                 __fmul_rn(x1[e], sn[e]));
      x1[e] = __bfloat162float(__float2bfloat16(y1));
      x2[e] = __bfloat162float(__float2bfloat16(y2));
    }
  }
  *reinterpret_cast<uint2*>(dst + base) = quant8(x1, inv);
  *reinterpret_cast<uint2*>(dst + base + HALF) = quant8(x2, inv);
}

// flash_fwd_sm90 launches since the library loaded, counted where the
// kernel is launched. Read by flash_fwd_design_launches.
std::atomic<long long> fwd_launches{0};

inline int counted_launch() {
  const int err = int(cudaGetLastError());
  if (err == 0) fwd_launches.fetch_add(1, std::memory_order_relaxed);
  return err;
}

template <int D>
int launch_prep(const __nv_bfloat16* src, __nv_bfloat16* dst, int B, int N,
                int H, const float* gamma, const float* beta, float eps,
                const float* cos_t, const float* sin_t, float scale,
                cudaStream_t stream) {
  const int blocks = (B * N * H + NWARP - 1) / NWARP;
  prep_rows_kernel<D><<<blocks, NTHREAD, 0, stream>>>(
      src, dst, B * N, N, H, gamma, beta, eps, cos_t, sin_t, scale);
  return int(cudaGetLastError());
}

// The int8 pre-pass: zero the counters, the scales, then (with
// `quantize`) q and k.
template <int D>
int launch_i8_prepass(const I8Prep& a, bool quantize, cudaStream_t stream) {
  const int BH = a.B * a.H;
  int err = int(cudaMemsetAsync(a.amax, 0, sizeof(unsigned) * (2 * BH + 1),
                                stream));
  if (err != 0) return err;
  const int rows = a.N[0] > a.N[1] ? a.N[0] : a.N[1];
  i8_scales_kernel<D><<<dim3((rows + I8_ROWS - 1) / I8_ROWS, 2 * BH),
                        I8_THREADS, 0, stream>>>(a);
  err = int(cudaGetLastError());
  if (err != 0 || !quantize) return err;
  const size_t threads = (size_t(a.N[0]) + a.N[1]) * BH * (D / 16);
  prep_rows_i8_kernel<D><<<(threads + I8_THREADS - 1) / I8_THREADS,
                           I8_THREADS, 0, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// flash_fwd_sm90: needs Params, ParamsI8, launch_prep and counted_launch
#include "flash_sm90.cuh"

namespace {

// Every head dim runs flash_sm90.cuh (int8: on q and k quantized by the
// pre-pass).
template <bool STATIC, bool INT8>
int launch_dim(const ParamsOf<INT8>& p, int B, int D, cudaStream_t stream) {
  if (D == 64) return launch_sm90<64, STATIC, INT8>(p, B, stream);
  if (D == 32) return launch_sm90<32, STATIC, INT8>(p, B, stream);
  return launch_sm90<128, STATIC, INT8>(p, B, stream);
}

bool bad_shape(int D, const void* m_out, const void* l_out) {
  return (D != 32 && D != 64 && D != 128) ||
         (m_out == nullptr) != (l_out == nullptr);
}

// k_work: scratch of k's shape for the prepared k, used when k needs LN or
// rope (null otherwise).
// ln_*: the (D,) f32 LayerNorm gammas and betas of q and k, all null
// without LN.
template <bool STATIC>
int dispatch(const void* q, const void* k, const void* v, void* o,
             void* k_work, int B, int H, int Nq, int Nk, int D,
             int valid_len, float q_scale, const void* ln_qg,
             const void* ln_qb, const void* ln_kg, const void* ln_kb,
             float ln_eps, const void* kv_bias, const void* cos_q,
             const void* sin_q, const void* cos_k, const void* sin_k,
             const void* smax, void* m_out, void* l_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(k);
  const bool ln = ln_qg != nullptr;
  if (bad_shape(D, m_out, l_out) || (ln_qb != nullptr) != ln ||
      (ln_kg != nullptr) != ln || (ln_kb != nullptr) != ln)
    return int(cudaErrorInvalidValue);
  if (ln || cos_k != nullptr) {
    if (k_work == nullptr) return int(cudaErrorInvalidValue);
    __nv_bfloat16* kw = static_cast<__nv_bfloat16*>(k_work);
    const auto prep = D == 32   ? launch_prep<32>
                      : D == 64 ? launch_prep<64>
                                : launch_prep<128>;
    const int err = prep(kp, kw, B, Nk, H, static_cast<const float*>(ln_kg),
                         static_cast<const float*>(ln_kb), ln_eps,
                         static_cast<const float*>(cos_k),
                         static_cast<const float*>(sin_k), 1.f, st);
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
  p.ln_g = static_cast<const float*>(ln_qg);
  p.ln_b = static_cast<const float*>(ln_qb);
  p.ln_eps = ln_eps;
  p.kv_bias = static_cast<const float*>(kv_bias);
  p.cos_q = static_cast<const float*>(cos_q);
  p.sin_q = static_cast<const float*>(sin_q);
  p.smax = static_cast<const float*>(smax);
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  return launch_dim<STATIC, false>(p, B, D, st);
}

// work: one int8 buffer of B H D (Nq + Nk) + 4 (2 B H + 1) bytes: q8 (q
// quantized), k8, then the pre-pass's counters. scales:
// the (3, B*H) f32 scales of ParamsI8, which the pre-pass writes; dq: the
// dequant constant log2(e) / sqrt(D) / 127^2.
I8Prep i8_prep_args(const void* q, const void* k, void* work, int B, int H,
                    int Nq, int Nk, int D, int rope, float dq, void* scales,
                    const void* cos_q, const void* sin_q, const void* cos_k,
                    const void* sin_k) {
  int8_t* w = static_cast<int8_t*>(work);
  const size_t row = size_t(B) * H * D;
  I8Prep a;
  a.x[0] = static_cast<const __nv_bfloat16*>(q);
  a.x[1] = static_cast<const __nv_bfloat16*>(k);
  a.x8[0] = w;
  a.x8[1] = w + row * Nq;
  a.cos_t[0] = static_cast<const float*>(cos_q);
  a.sin_t[0] = static_cast<const float*>(sin_q);
  a.cos_t[1] = static_cast<const float*>(cos_k);
  a.sin_t[1] = static_cast<const float*>(sin_k);
  a.N[0] = Nq;
  a.N[1] = Nk;
  a.B = B;
  a.H = H;
  a.rope = rope;
  a.amax = reinterpret_cast<unsigned*>(w + row * (size_t(Nq) + Nk));
  a.scales = static_cast<float*>(scales);
  a.dq = dq;
  return a;
}

int launch_i8_prepass_dim(const I8Prep& a, int D, bool quantize,
                          cudaStream_t stream) {
  return D == 32   ? launch_i8_prepass<32>(a, quantize, stream)
         : D == 64 ? launch_i8_prepass<64>(a, quantize, stream)
                   : launch_i8_prepass<128>(a, quantize, stream);
}

template <bool STATIC>
int dispatch_i8(const void* q, const void* k, const void* v, void* o,
                void* work, int B, int H, int Nq, int Nk, int D,
                int valid_len, void* scales, float dq, const void* kv_bias,
                const void* cos_q, const void* sin_q, const void* cos_k,
                const void* sin_k, const void* smax, void* m_out,
                void* l_out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_shape(D, m_out, l_out) || scales == nullptr || work == nullptr ||
      (cos_q == nullptr) != (cos_k == nullptr))
    return int(cudaErrorInvalidValue);
  const I8Prep a = i8_prep_args(q, k, work, B, H, Nq, Nk, D,
                                cos_q != nullptr, dq, scales, cos_q, sin_q,
                                cos_k, sin_k);
  const int err = launch_i8_prepass_dim(a, D, true, st);
  if (err != 0) return err;
  ParamsI8 p;
  p.q = a.x8[0];
  p.k = a.x8[1];
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.valid_len = valid_len;
  p.scales = a.scales;
  p.kv_bias = static_cast<const float*>(kv_bias);
  p.smax = static_cast<const float*>(smax);
  p.m_out = static_cast<float*>(m_out);
  p.l_out = static_cast<float*>(l_out);
  return launch_dim<STATIC, true>(p, B, D, st);
}

}  // namespace

extern "C" {

#define FLASH_ARGS                                                           \
  const void *q, const void *k, const void *v, void *o, void *k_work, int B, \
      int H, int Nq, int Nk, int D, int valid_len, float q_scale,            \
      const void *ln_qg, const void *ln_qb, const void *ln_kg,               \
      const void *ln_kb, float ln_eps, const void *kv_bias,                  \
      const void *cos_q, const void *sin_q, const void *cos_k,               \
      const void *sin_k
#define FLASH_PASS                                                          \
  q, k, v, o, k_work, B, H, Nq, Nk, D, valid_len, q_scale, ln_qg, ln_qb,    \
      ln_kg, ln_kb, ln_eps, kv_bias, cos_q, sin_q, cos_k, sin_k
#define FLASH_I8_ARGS                                                       \
  const void *q, const void *k, const void *v, void *o, void *work, int B,  \
      int H, int Nq, int Nk, int D, int valid_len, void *scales, float dq,  \
      const void *kv_bias, const void *cos_q, const void *sin_q,            \
      const void *cos_k, const void *sin_k
#define FLASH_I8_PASS                                                       \
  q, k, v, o, work, B, H, Nq, Nk, D, valid_len, scales, dq, kv_bias, cos_q, \
      sin_q, cos_k, sin_k

int flash_single_fwd(FLASH_ARGS, void* m_out, void* l_out, void* stream) {
  return dispatch<false>(FLASH_PASS, nullptr, m_out, l_out, stream);
}

int flash_multi_fwd(FLASH_ARGS, const void* smax, void* m_out, void* l_out,
                    void* stream) {
  return dispatch<true>(FLASH_PASS, smax, m_out, l_out, stream);
}

int flash_single_i8_fwd(FLASH_I8_ARGS, void* m_out, void* l_out,
                        void* stream) {
  return dispatch_i8<false>(FLASH_I8_PASS, nullptr, m_out, l_out, stream);
}

int flash_multi_i8_fwd(FLASH_I8_ARGS, const void* smax, void* m_out,
                       void* l_out, void* stream) {
  return dispatch_i8<true>(FLASH_I8_PASS, smax, m_out, l_out, stream);
}

// The int8 pre-pass's scales alone, as flash_*_i8_fwd computes them: the
// (3, B*H) f32 `scales` of q and k (rope: pair norms), `work` as theirs.
int flash_i8_scales(const void* q, const void* k, void* work, int B, int H,
                    int Nq, int Nk, int D, int rope, float dq, void* scales,
                    void* stream) {
  if (bad_shape(D, nullptr, nullptr) || scales == nullptr || work == nullptr)
    return int(cudaErrorInvalidValue);
  const I8Prep a = i8_prep_args(q, k, work, B, H, Nq, Nk, D, rope, dq, scales,
                                nullptr, nullptr, nullptr, nullptr);
  return launch_i8_prepass_dim(a, D, false, static_cast<cudaStream_t>(stream));
}

// out[0]: flash_fwd_sm90 launches.
void flash_fwd_design_launches(long long* out) {
  out[0] = fwd_launches.load(std::memory_order_relaxed);
}

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
