// The global-shape attention probe of scripts/bench_global_attention.py
// (sm_90a, ctypes): `_kernel` (:48, run_kernel at :106) on (BH, N, 64) in
// modes bf16 (online softmax, natural exp), int8 (q, k quantized by the
// caller) and matmul (the floor), over the first Nk keys (k_rows).
// Tilings (64, 64), (128, 64), (64, 128), (128, 128), (128, 32) stand
// beside the reference's VMEM blocks (a 1024 x 64 f32 accumulator fills an
// SM's registers). All run global_sm90.

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
