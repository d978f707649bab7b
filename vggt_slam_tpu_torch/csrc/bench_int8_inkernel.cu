// The in-kernel int8 probe of scripts/bench_int8_inkernel.py for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes).
//
// Replaces `_kernel` (scripts/bench_int8_inkernel.py:43, launched through
// run at :118): exp2-domain online-softmax attention over contiguous bf16
// (BH, N, 64) tensors, with per-(b, h) scales sc (5, BH) from the caller
// (127/amax of q, k, v; the logit scale dq; amax(v)/127^2), in three
// modes: bf16; qk8 (q and k quantized in the kernel, clip(round(x *
// 127/amax)), round half to even, s = f32(s32) * dq, PV in bf16); qk8av8
// (v quantized too, p8 = clip(round(p * 127), 0, 127), PV in int8 with s32
// accumulation, times amax(v)/127^2).
//
// The reference quantizes k (and v) into a persistent Nk x D scratch while
// program_id(1) == 0, relying on the TPU's in-order grid; here CTAs run at
// once and 2.2 MB a head is ten times an SM's shared memory, so each CTA
// quantizes every K (and V) tile it loads, with the same scale: the same
// int8 values. The int8 PV stores V transposed (its keys permuted by
// key_pos, global_sm90.cuh), since 8-bit wgmma operands must be K-major.
//
// Tilings: the reference's (1024, 2048) and (2048, 2048) VMEM blocks become
// (64, 64) and (128, 64) CTA tilings. Bound at the global shape: one
// MUFU.EX2 per logit (about 4.6 ms) once QK^T is int8; bf16's products
// take 5.0 ms. Every mode and tiling runs global_sm90 (global_sm90.cuh).

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
