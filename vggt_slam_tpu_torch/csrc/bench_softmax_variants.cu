// The softmax-variant probe of scripts/bench_softmax_variants.py for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces `_kernel` (scripts/bench_softmax_variants.py:41, launched through
// run_kernel at :118) on contiguous (BH, N, 64) tensors with raw logits
// s = q k^T, in five modes: matmul (o = sum bf16(s) v, the floor); online
// (exp2, running max, o = acc / max(l, 1e-30)); static (p = exp2(s - smax),
// l the f32 sum of the unrounded p); staticfused (V widened to 128 columns
// of ones past D, so l is the sum of bf16(p) read from accumulator column D:
// 16 PV n-tiles of 8 instead of 8, in place of the row sum's adds);
// staticint8 (q, k quantized by the caller, p = exp2(f32(s32) * dequant -
// smax)). It attends to the first Nk keys of k and v (per-problem row count
// k_rows): the reference's run_kernel takes Nk from q's length.
//
// The reference's VMEM blocks (default 1024 x 2048) become CTA tilings,
// 16 q rows per warp: (BQ, BK) = (64, 64), (128, 64), (64, 128). Bound at
// the global shape: the bf16 products (5.0 ms) and one MUFU.EX2 per logit
// (about 4.6 ms; the floor in staticint8). The design is
// bench_attention.cu's; the modes differ only in their per-logit work.

#include "global_probe.cuh"

namespace {

using namespace probe;

enum Mode { MATMUL = 0, ONLINE = 1, STATIC = 2, STATICFUSED = 3,
            STATICINT8 = 4 };

struct Args {
  const void* q;            // (BH, Nq, D) bf16, or int8 (STATICINT8)
  const void* k;            // (BH, k_rows, D), q's type
  const __nv_bfloat16* v;   // (BH, k_rows, D)
  __nv_bfloat16* o;         // (BH, Nq, D)
  int Nq, Nk, k_rows;
  float smax, dequant;
};

template <int BQ, int BK, int MODE>
constexpr size_t smem_bytes() {
  constexpr size_t row = MODE == STATICINT8 ? LDB : LD * 2;
  return BQ * row + BK * row + BK * LD * 2;
}

template <int BQ, int BK, int MODE>
__global__ void __launch_bounds__(BQ * 2) softmax_variant_kernel(Args a) {
  constexpr int NTHREAD = BQ * 2;
  constexpr int NT = BK / 8;
  constexpr bool I8 = MODE == STATICINT8;
  constexpr bool FUSED = MODE == STATICFUSED;
  constexpr int NO = FUSED ? 2 * DT : DT;   // n-tiles of the accumulator
  constexpr size_t ROW = I8 ? LDB : LD * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* kt = smem + BQ * ROW;
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(kt + BK * ROW);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t qbase = size_t(bh) * a.Nq * D;
  const size_t kbase = size_t(bh) * a.k_rows * D;

  uint32_t qa[I8 ? KS8 : KS][4];
  if constexpr (I8) {
    stage_i8<BQ, NTHREAD>(reinterpret_cast<int8_t*>(smem),
                          static_cast<const int8_t*>(a.q) + qbase, q0);
    __syncthreads();
    load_q8(qa, reinterpret_cast<int8_t*>(smem), warp, lane);
  } else {
    stage<BQ, NTHREAD>(reinterpret_cast<__nv_bfloat16*>(smem),
                       static_cast<const __nv_bfloat16*>(a.q) + qbase, q0);
    __syncthreads();
    load_q(qa, reinterpret_cast<__nv_bfloat16*>(smem), warp, lane);
  }

  float o[NO][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < a.Nk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    if constexpr (I8)
      stage_i8<BK, NTHREAD>(reinterpret_cast<int8_t*>(kt),
                            static_cast<const int8_t*>(a.k) + kbase, k0);
    else
      stage<BK, NTHREAD>(reinterpret_cast<__nv_bfloat16*>(kt),
                         static_cast<const __nv_bfloat16*>(a.k) + kbase, k0);
    stage<BK, NTHREAD>(Vs, a.v + kbase, k0);
    __syncthreads();

    float s[NT][4];
    if constexpr (I8) {
      int acc[NT][4];
      qk_s8(acc, qa, reinterpret_cast<int8_t*>(kt), lane);
      dequant(s, acc, a.dequant);
    } else {
      qk_bf16(s, qa, reinterpret_cast<__nv_bfloat16*>(kt), lane);
    }
    if constexpr (MODE == ONLINE) {
      online_step<false>(s, o, m, l);
    } else if constexpr (MODE != MATMUL) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = exp2f(s[j][e] - a.smax);
        if constexpr (!FUSED) {
          l[0] += s[j][0] + s[j][1];
          l[1] += s[j][2] + s[j][3];
        }
      }
    }
    pv_bf16<NT, FUSED>(o, s, Vs, lane);
  }

  __nv_bfloat16* out = a.o + qbase;
  if constexpr (MODE == MATMUL) {
    store(o, 1.f, 1.f, out, q0, warp, lane);
  } else if constexpr (FUSED) {
    // Every accumulator column in [D, 128) holds the row sum of bf16(p)
    // (one A times ones), so their max is column D. Reading them all keeps
    // the eight ones n-tiles live: ptxas drops an mma.sync whose result is
    // never read, and would otherwise leave one n-tile of ones, not the
    // reference's 128-wide V.
    float l_lo = o[DT][0], l_hi = o[DT][2];
#pragma unroll
    for (int i = DT; i < 2 * DT; ++i) {
      l_lo = fmaxf(l_lo, fmaxf(o[i][0], o[i][1]));
      l_hi = fmaxf(l_hi, fmaxf(o[i][2], o[i][3]));
    }
    store(o, fmaxf(l_lo, 1e-30f), fmaxf(l_hi, 1e-30f), out, q0, warp, lane);
  } else {
    store(o, fmaxf(quad_sum(l[0]), 1e-30f), fmaxf(quad_sum(l[1]), 1e-30f),
          out, q0, warp, lane);
  }
}

template <int BQ, int BK, int MODE>
int launch_mode(const Args& a, int BH, cudaStream_t st) {
  return launch(softmax_variant_kernel<BQ, BK, MODE>, dim3(a.Nq / BQ, BH),
                BQ * 2, smem_bytes<BQ, BK, MODE>(), st, a);
}

template <int BQ, int BK>
int launch_tiling(const Args& a, int BH, int mode, cudaStream_t st) {
  if (a.Nq % BQ != 0 || a.Nk % BK != 0) return int(cudaErrorInvalidValue);
  switch (mode) {
    case MATMUL: return launch_mode<BQ, BK, MATMUL>(a, BH, st);
    case ONLINE: return launch_mode<BQ, BK, ONLINE>(a, BH, st);
    case STATIC: return launch_mode<BQ, BK, STATIC>(a, BH, st);
    case STATICFUSED: return launch_mode<BQ, BK, STATICFUSED>(a, BH, st);
    case STATICINT8: return launch_mode<BQ, BK, STATICINT8>(a, BH, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, o: (BH, Nq, D); k, v: (BH, k_rows, D); q and k int8 in mode 4, bf16
// otherwise. Attends to the first Nk <= k_rows keys.
int bench_softmax_variant(const void* q, const void* k, const void* v,
                          void* o, int BH, int Nq, int Nk, int k_rows,
                          int D_, int block_q, int block_k, int mode,
                          float smax, float dequant, void* stream) {
  if (D_ != D || BH <= 0 || BH > 65535 || Nq <= 0 || Nk <= 0 ||
      Nk > k_rows)
    return int(cudaErrorInvalidValue);
  const Args a{q, k, static_cast<const __nv_bfloat16*>(v),
               static_cast<__nv_bfloat16*>(o), Nq, Nk, k_rows, smax,
               dequant};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_q == 64 && block_k == 64) return launch_tiling<64, 64>(a, BH, mode, st);
  if (block_q == 128 && block_k == 64) return launch_tiling<128, 64>(a, BH, mode, st);
  if (block_q == 64 && block_k == 128) return launch_tiling<64, 128>(a, BH, mode, st);
  return int(cudaErrorInvalidValue);
}

const char* bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
