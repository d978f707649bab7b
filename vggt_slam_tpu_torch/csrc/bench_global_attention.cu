// The global-shape attention probe of scripts/bench_global_attention.py for
// Hopper (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces `_kernel` (scripts/bench_global_attention.py:48, launched through
// run_kernel at :106) on contiguous (BH, N, 64) tensors, in three modes:
// bf16 (s = f32(q k^T) * scale, online softmax with the natural exp in the
// reference's order, o = sum alpha-rescaled bf16(p) v / l); int8 (q, k
// quantized by the caller, s = f32(s32) * scale, PV in bf16); matmul (o =
// sum bf16(s * scale) v, the tensor-core floor). It attends to the first Nk
// keys of k and v (per-problem row count k_rows): the reference's
// run_kernel takes Nk from q's length.
//
// The reference's VMEM blocks (512..2048 x 2048..4096) cannot be CTAs: a
// 1024 x 64 f32 accumulator alone fills an SM's register file. The card
// takes five CTA tilings of its own, 16 q rows per warp: (BQ, BK) = (64,
// 64), (128, 64), (64, 128), (128, 128), (128, 32), beside the reference's
// (1024, 2048), (2048, 2048), (1024, 4096), (2048, 4096), (512, 2048).
//
// Bound on this card at the global shape (BH 16, N 34816): the bf16
// products 5.0 ms at 989 TFLOP/s, one MUFU.EX2 per logit about 4.6 ms (the
// floor once QK^T is int8); the 0.28 GB of tensors far below both. The
// design is bench_attention.cu's (mma.sync, synchronous single-buffered
// K/V tiles), so its times split the production kernel's.

#include "global_probe.cuh"

namespace {

using namespace probe;

enum Mode { BF16 = 0, INT8 = 1, MATMUL = 2 };

struct Args {
  const void* q;            // (BH, Nq, D) bf16, or int8 (INT8)
  const void* k;            // (BH, k_rows, D) bf16, or int8 (INT8)
  const __nv_bfloat16* v;   // (BH, k_rows, D)
  __nv_bfloat16* o;         // (BH, Nq, D)
  int Nq, Nk, k_rows;
  float scale;
};

template <int BQ, int BK, int MODE>
constexpr size_t smem_bytes() {
  constexpr size_t row = MODE == INT8 ? LDB : LD * 2;   // q and k rows
  return BQ * row + BK * row + BK * LD * 2;
}

template <int BQ, int BK, int MODE>
__global__ void __launch_bounds__(BQ * 2) global_attention_kernel(Args a) {
  constexpr int NTHREAD = BQ * 2;     // BQ / 16 warps
  constexpr int NT = BK / 8;          // 8-key n-tiles of S
  constexpr bool I8 = MODE == INT8;
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

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
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
      dequant(s, acc, a.scale);
    } else {
      qk_bf16(s, qa, reinterpret_cast<__nv_bfloat16*>(kt), lane);
      scale_by(s, a.scale);
    }
    if constexpr (MODE != MATMUL) online_step<true>(s, o, m, l);
    pv_bf16(o, s, Vs, lane);
  }

  __nv_bfloat16* out = a.o + qbase;
  if constexpr (MODE == MATMUL) {
    store(o, 1.f, 1.f, out, q0, warp, lane);
  } else {
    store(o, quad_sum(l[0]), quad_sum(l[1]), out, q0, warp, lane);
  }
}

template <int BQ, int BK, int MODE>
int launch_mode(const Args& a, int BH, cudaStream_t st) {
  return launch(global_attention_kernel<BQ, BK, MODE>,
                dim3(a.Nq / BQ, BH), BQ * 2, smem_bytes<BQ, BK, MODE>(), st,
                a);
}

template <int BQ, int BK>
int launch_tiling(const Args& a, int BH, int mode, cudaStream_t st) {
  if (a.Nq % BQ != 0 || a.Nk % BK != 0) return int(cudaErrorInvalidValue);
  switch (mode) {
    case BF16: return launch_mode<BQ, BK, BF16>(a, BH, st);
    case INT8: return launch_mode<BQ, BK, INT8>(a, BH, st);
    case MATMUL: return launch_mode<BQ, BK, MATMUL>(a, BH, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q, k: (BH, Nq, D) / (BH, k_rows, D), bf16 or int8 (mode 1); v (BH,
// k_rows, D) bf16; o (BH, Nq, D) bf16. Attends to the first Nk <= k_rows
// keys. block_q x block_k must be one of the five tilings.
int bench_global_attention(const void* q, const void* k, const void* v,
                           void* o, int BH, int Nq, int Nk, int k_rows,
                           int D_, int block_q, int block_k, int mode,
                           float scale, void* stream) {
  if (D_ != D || BH <= 0 || BH > 65535 || Nq <= 0 || Nk <= 0 ||
      Nk > k_rows)
    return int(cudaErrorInvalidValue);
  const Args a{q, k, static_cast<const __nv_bfloat16*>(v),
               static_cast<__nv_bfloat16*>(o), Nq, Nk, k_rows, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_q == 64 && block_k == 64) return launch_tiling<64, 64>(a, BH, mode, st);
  if (block_q == 128 && block_k == 64) return launch_tiling<128, 64>(a, BH, mode, st);
  if (block_q == 64 && block_k == 128) return launch_tiling<64, 128>(a, BH, mode, st);
  if (block_q == 128 && block_k == 128) return launch_tiling<128, 128>(a, BH, mode, st);
  if (block_q == 128 && block_k == 32) return launch_tiling<128, 32>(a, BH, mode, st);
  return int(cudaErrorInvalidValue);
}

const char* bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
