// The in-kernel int8 probe of scripts/bench_int8_inkernel.py (sm_90a,
// ctypes): `_kernel` (:43, run at :118), exp2 online softmax on bf16 (BH,
// N, 64) with per-(b, h) scales sc (5, BH) in modes bf16, qk8 (q, k
// quantized in the kernel, half to even) and qk8av8 (v and p too, PV in
// int8). The reference fills a per-head scratch relying on the TPU's
// in-order grid; here each CTA quantizes every tile it loads (the same
// values; 2.2 MB a head exceeds shared memory); V8 is stored transposed
// (8-bit wgmma operands are K-major). Tilings (64, 64), (128, 64). All run
// global_sm90.

#include "global_sm90.cuh"

namespace {

template <int BQ, int BK>
int launch_tiling(const void* sc, const void* q, const void* k,
                  const void* v, void* o, int BH, int Nq, int Nk, int mode,
                  cudaStream_t st) {
  const float* s = static_cast<const float*>(sc);
  switch (mode) {
    case 0:
      return launch_global_sm90<BQ, BK, IK_BF16>(q, k, v, o, s, 0.f, BH, Nq,
                                                 Nk, Nk, st);
    case 1:
      return launch_global_sm90<BQ, BK, IK_QK8>(q, k, v, o, s, 0.f, BH, Nq,
                                                Nk, Nk, st);
    case 2:
      return launch_global_sm90<BQ, BK, IK_QK8AV8>(q, k, v, o, s, 0.f, BH,
                                                   Nq, Nk, Nk, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// sc: (5, BH) f32; q, o: (BH, Nq, D) bf16; k, v: (BH, Nk, D) bf16; mode 0
// bf16, 1 qk8, 2 qk8av8.
int bench_int8_inkernel(const void* sc, const void* q, const void* k,
                        const void* v, void* o, int BH, int Nq, int Nk,
                        int D_, int block_q, int block_k, int mode,
                        void* stream) {
  if (D_ != G_D || BH <= 0 || BH > 65535 || Nq <= 0 || Nk <= 0)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_q == 64 && block_k == 64)
    return launch_tiling<64, 64>(sc, q, k, v, o, BH, Nq, Nk, mode, st);
  if (block_q == 128 && block_k == 64)
    return launch_tiling<128, 64>(sc, q, k, v, o, BH, Nq, Nk, mode, st);
  return int(cudaErrorInvalidValue);
}

// out[0]: global_sm90 launches of bench_int8_inkernel, every mode.
void bench_int8_inkernel_design_launches(long long* out) {
  out[0] = design_launches.load(std::memory_order_relaxed);
}

const char* bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
