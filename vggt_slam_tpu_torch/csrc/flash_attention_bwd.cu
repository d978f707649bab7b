// Flash-attention backward for Hopper (sm_90a), packed (B, N, H*D) bf16
// layout, bound to PyTorch through a plain C interface (ctypes).
//
// One entry point, flash_bwd, computes what the two TPU kernels of the JAX
// package compute together: _flash_bwd_dq_kernel (dq) and
// _flash_bwd_dkv_kernel (dk, dv), vggt_slam_tpu/ops/attention.py:1106 and
// :1138. At every head dim (32, 64, 128) it runs bwd_prep_kernel (delta =
// rowsum(dO * O), the q tiles' row stats, and the zeroing of the dq
// accumulator), flash_bwd_sm90 (flash_bwd_sm90.cuh: TMA, wgmma, one CTA
// per 128-key tile computing dq, dk and dv) and bwd_dq_kernel.
//
// The kernel recomputes, per tile, the FlashAttention backward from the
// forward's row stats (m, l) and delta:
//     p_ij  = exp2(c * q_i.k_j - m_i) / max(l_i, 1e-30),  0 for j >= valid_len
//     dv_j  = sum_i bf16(p_ij) dO_i
//     dl_ij = bf16(p_ij (dO_i.v_j - delta_i))
//     dq_i  = sum_j dl_ij k_j / sqrt(D),   dk_j = sum_i dl_ij q_i / sqrt(D)
// with c = log2(e) / sqrt(D); the bf16 roundings are the JAX kernels'
// (dl cast to the input dtype before both products, p cast to dO's dtype
// before the dv product). Rows of dk and dv at or past valid_len are exactly
// zero, and query rows past Nq add nothing.

#include "flash_common.cuh"
#include "flash_bwd_sm90.cuh"

namespace {

// flash_bwd calls since the library loaded (each launches flash_bwd_sm90
// once). Read by flash_bwd_design_launches.
std::atomic<long long> bwd_launches{0};

// The three passes of one flash_bwd call at head dim D.
template <int D>
int run_bwd(const void* q, const void* k, const void* v, const void* dout,
            const void* out, const void* m, const void* l, void* dq, void* dk,
            void* dv, float* acc, float* work, int B, int H, int Nq, int Nk,
            int valid_len, float c_scale, float inv_sqrt_d,
            cudaStream_t stream) {
  const int n_qt = (Nq + BW_BQ - 1) / BW_BQ;
  const int err = launch_bwd_prep<D>(
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const __nv_bfloat16*>(out), static_cast<const float*>(m),
      static_cast<const float*>(l), work, acc, B, H, Nq, n_qt, stream);
  if (err != 0) return err;
  return launch_bwd_sm90<D>(q, k, v, dout, work, acc, dq, dk, dv, B, H, Nq,
                            Nk, valid_len, c_scale, inv_sqrt_d, stream);
}

}  // namespace

extern "C" {

// The floats of scratch flash_bwd takes, for the caller to allocate:
// out[0] for `work` (the q tiles' m, w and delta), out[1] for `dq_acc`.
void flash_bwd_scratch_floats(int B, int H, int Nq, int D, long long* out) {
  bwd_sm90_scratch(B, H, Nq, D, &out[0], &out[1]);
}

// dq, dk, dv of packed bf16 q, k, v, dout, out and the forward's f32 row
// stats m, l (B*H, Nq), with `work` and `dq_acc` of the sizes
// flash_bwd_scratch_floats gives.
int flash_bwd(const void* q, const void* k, const void* v, const void* dout,
              const void* out, const void* m, const void* l, void* dq,
              void* dk, void* dv, void* dq_acc, void* work, int B, int H,
              int Nq, int Nk, int D, int valid_len, float c_scale,
              float inv_sqrt_d, void* stream) {
  if (D != 32 && D != 64 && D != 128) return int(cudaErrorInvalidValue);
  const auto run = D == 32 ? run_bwd<32> : D == 64 ? run_bwd<64>
                                                   : run_bwd<128>;
  const int err = run(q, k, v, dout, out, m, l, dq, dk, dv,
                      static_cast<float*>(dq_acc), static_cast<float*>(work),
                      B, H, Nq, Nk, valid_len, c_scale, inv_sqrt_d,
                      static_cast<cudaStream_t>(stream));
  if (err == 0) bwd_launches.fetch_add(1, std::memory_order_relaxed);
  return err;
}

// out[0]: flash_bwd_sm90 launches.
void flash_bwd_design_launches(long long* out) {
  out[0] = bwd_launches.load(std::memory_order_relaxed);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
