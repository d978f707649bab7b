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
// takes five CTA tilings of its own, (BQ, BK) = (64, 64), (128, 64), (64,
// 128), (128, 128), (128, 32), beside the reference's (1024, 2048), (2048,
// 2048), (1024, 4096), (2048, 4096), (512, 2048): BQ q rows (BQ / 64
// warpgroups) share one stream of BK-key tiles.
//
// Bound on this card at the global shape (BH 16, N 34816): the bf16
// products 5.0 ms at 989 TFLOP/s, one MUFU.EX2 per logit about 4.6 ms (the
// floor once QK^T is int8); the 0.28 GB of tensors far below both. Every
// mode and tiling runs global_sm90 (global_sm90.cuh: TMA ring refilled by
// release counts, wgmma products, QK^T of one tile issued before PV of the
// last).

#include "global_sm90.cuh"

namespace {

template <int BQ, int BK>
int launch_tiling(const void* q, const void* k, const void* v, void* o,
                  int BH, int Nq, int Nk, int k_rows, int mode, float scale,
                  cudaStream_t st) {
  switch (mode) {
    case G_BF16:
      return launch_global_sm90<BQ, BK, G_BF16>(q, k, v, o, nullptr, scale,
                                                BH, Nq, Nk, k_rows, st);
    case G_INT8:
      return launch_global_sm90<BQ, BK, G_INT8>(q, k, v, o, nullptr, scale,
                                                BH, Nq, Nk, k_rows, st);
    case G_MATMUL:
      return launch_global_sm90<BQ, BK, G_MATMUL>(q, k, v, o, nullptr, scale,
                                                  BH, Nq, Nk, k_rows, st);
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
  if (D_ != G_D || BH <= 0 || BH > 65535 || Nq <= 0 || Nk <= 0 ||
      Nk > k_rows)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TILING(bq, bk)                                                     \
  if (block_q == bq && block_k == bk)                                      \
    return launch_tiling<bq, bk>(q, k, v, o, BH, Nq, Nk, k_rows, mode,     \
                                 scale, st);
  TILING(64, 64) TILING(128, 64) TILING(64, 128) TILING(128, 128)
  TILING(128, 32)
#undef TILING
  return int(cudaErrorInvalidValue);
}

// out[0]: global_sm90 launches of bench_global_attention, every mode.
void bench_global_attention_design_launches(long long* out) {
  out[0] = design_launches.load(std::memory_order_relaxed);
}

const char* bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
