// The softmax-variant probe of scripts/bench_softmax_variants.py (sm_90a,
// ctypes): `_kernel` (:41, run_kernel at :118) on (BH, N, 64), raw logits,
// modes matmul, online, static (p = exp2(s - smax)), staticfused (l the
// tensor cores' sum of bf16(p) on 64 columns of ones) and staticint8 (l
// reset per q tile), over the first Nk keys (k_rows); tilings (64, 64),
// (128, 64), (64, 128). All run global_sm90, MODE SV_MATMUL + mode.

#include "global_sm90.cuh"

namespace {

template <int BQ, int BK>
int launch_tiling(const void* q, const void* k, const void* v, void* o,
                  int BH, int Nq, int Nk, int k_rows, int mode, float smax,
                  float dequant, cudaStream_t st) {
#define SV_CASE(m)                                                       \
  case m - SV_MATMUL:                                                    \
    return launch_global_sm90<BQ, BK, m>(q, k, v, o, nullptr, dequant,   \
                                         BH, Nq, Nk, k_rows, st, smax);
  switch (mode) {
    SV_CASE(SV_MATMUL) SV_CASE(SV_ONLINE) SV_CASE(SV_STATIC)
    SV_CASE(SV_STATICFUSED) SV_CASE(SV_STATICINT8)
    default: return int(cudaErrorInvalidValue);
  }
#undef SV_CASE
}

}  // namespace

extern "C" {

// q, o: (BH, Nq, D); k, v: (BH, k_rows, D); q and k int8 in mode 4, bf16
// otherwise. Attends to the first Nk <= k_rows keys. dequant scales the
// int8 logits (1 in the bf16 modes, which take the raw logits).
int bench_softmax_variant(const void* q, const void* k, const void* v,
                          void* o, int BH, int Nq, int Nk, int k_rows,
                          int D_, int block_q, int block_k, int mode,
                          float smax, float dequant, void* stream) {
  if (D_ != G_D || BH <= 0 || BH > 65535 || Nq <= 0 || Nk <= 0 ||
      Nk > k_rows)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TILING(bq, bk)                                                     \
  if (block_q == bq && block_k == bk)                                      \
    return launch_tiling<bq, bk>(q, k, v, o, BH, Nq, Nk, k_rows, mode,     \
                                 smax, dequant, st);
  TILING(64, 64) TILING(128, 64) TILING(64, 128)
#undef TILING
  return int(cudaErrorInvalidValue);
}

// out[0]: global_sm90 launches of bench_softmax_variant, every mode.
void bench_softmax_variants_design_launches(long long* out) {
  out[0] = design_launches.load(std::memory_order_relaxed);
}

const char* bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
