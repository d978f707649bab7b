// Flash-attention backward for Hopper (sm_90a), packed (B, N, H*D) bf16
// layout, bound to PyTorch through a plain C interface (ctypes).
//
// One entry point, flash_bwd, computes what the two TPU kernels of the JAX
// package compute together: _flash_bwd_dq_kernel (dq) and
// _flash_bwd_dkv_kernel (dk, dv), vggt_slam_tpu/ops/attention.py:1106 and
// :1138. It first runs bwd_prep_kernel (delta = rowsum(dO * O), and the
// zeroing of the dq accumulator), then by head dim:
//
//   D = 32, 64   flash_bwd_sm90 (flash_bwd_sm90.cuh: TMA, wgmma, one CTA
//                per 128-key tile computing dq, dk and dv) and
//                bwd_dq_kernel;
//   D = 128      flash_bwd_dq_kernel and flash_bwd_dkv_kernel below (the
//                camera trunk: 4-18 tokens, where the call's fixed cost
//                and not the kernel sets the time).
//
// Every design recomputes, per tile, the FlashAttention backward from the
// forward's row stats (m, l) and delta:
//     p_ij  = exp2(c * q_i.k_j - m_i) / max(l_i, 1e-30),  0 for j >= valid_len
//     dv_j  = sum_i bf16(p_ij) dO_i
//     dl_ij = bf16(p_ij (dO_i.v_j - delta_i))
//     dq_i  = sum_j dl_ij k_j / sqrt(D),   dk_j = sum_i dl_ij q_i / sqrt(D)
// with c = log2(e) / sqrt(D); the bf16 roundings are the JAX kernels'
// (dl cast to the input dtype before both products, p cast to dO's dtype
// before the dv product). Rows of dk and dv at or past valid_len are exactly
// zero, and query rows past Nq add nothing.
//
// The D = 128 kernels: each output tile is owned by one CTA, so neither
// needs atomics (the TPU kernels split the work the same way). dq does ~6
// N_q N_k D flops per head and dkv ~8; the tensor cores bound both. They
// keep the forward kernels' FlashAttention-2 layout: 4 warps; each warp
// owns 16 rows of the CTA's own tile (q rows in dq, key rows in dkv), the
// other side is staged in 64-row shared tiles, and every product runs on
// mma.sync m16n8k16 bf16 with f32 accumulators in registers; P and dL are
// repacked from accumulator fragments into A fragments without touching
// shared memory. Key tiles past valid_len are never loaded.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;                // query rows per tile
constexpr int BK = 64;                // keys per tile
constexpr int NWARP = 4;
constexpr int NTHREAD = NWARP * 32;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  const float* m;         // (B*H, Nq) forward shift
  const float* l;         // (B*H, Nq) forward row sum
  const float* delta;     // (B*H, Nq) rowsum(dO * O)
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int H, Nq, Nk, valid_len;
  float c_scale;          // log2(e) / sqrt(D)
  float inv_sqrt_d;
};

template <int D>
constexpr size_t smem_bytes() {
  return size_t(2 * BQ + 2 * BK) * (D + 8) * 2 + 3 * BQ * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(NTHREAD) flash_bwd_dq_kernel(BwdParams p) {
  static_assert(D == 128, "head dims 32 and 64 run flash_bwd_sm90");
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;         // k-steps over the head dim
  constexpr int NT = BK / 8;         // 8-key n-tiles of S and dP
  constexpr int DT = D / 8;          // 8-dim n-tiles of dQ
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Os = Qs + BQ * LD;  // dO tile
  __nv_bfloat16* Ks = Os + BQ * LD;
  __nv_bfloat16* Vs = Ks + BK * LD;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * BQ;

  load_tile<D, NTHREAD>(Qs, p.q, b, h, p.H, p.Nq, q0, p.Nq);
  load_tile<D, NTHREAD>(Os, p.dout, b, h, p.H, p.Nq, q0, p.Nq);
  // Stats of rows g and g + 8 of this warp's 16; rows past Nq get w = 0.
  const int n_lo = q0 + warp * 16 + g, n_hi = n_lo + 8;
  const size_t srow = size_t(bh) * p.Nq;
  float m_lo = 0.f, w_lo = 0.f, dl_lo = 0.f, m_hi = 0.f, w_hi = 0.f,
        dl_hi = 0.f;
  if (n_lo < p.Nq) {
    m_lo = p.m[srow + n_lo];
    w_lo = 1.f / fmaxf(p.l[srow + n_lo], 1e-30f);
    dl_lo = p.delta[srow + n_lo];
  }
  if (n_hi < p.Nq) {
    m_hi = p.m[srow + n_hi];
    w_hi = 1.f / fmaxf(p.l[srow + n_hi], 1e-30f);
    dl_hi = p.delta[srow + n_hi];
  }

  float acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  const int vl = min(p.valid_len, p.Nk);
  const int ntiles = (vl + BK - 1) / BK;

  for (int tile = 0; tile < ntiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D, NTHREAD>(Ks, p.k, b, h, p.H, p.Nk, k0, vl);
    load_tile<D, NTHREAD>(Vs, p.v, b, h, p.H, p.Nk, k0, vl);
    __syncthreads();

    // S = Q K^T and dP = dO V^T, 16 x 64 per warp.
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t qa[4], oa[4];
      load_a<LD>(qa, Qs, warp * 16, ks * 16, lane);
      load_a<LD>(oa, Os, warp * 16, ks * 16, lane);
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        uint32_t kb[4], vb[4];
        load_bt<LD>(kb, Ks, j * 8, ks * 16, lane);
        mma_bf16(s[j], qa, kb[0], kb[1]);
        mma_bf16(s[j + 1], qa, kb[2], kb[3]);
        load_bt<LD>(vb, Vs, j * 8, ks * 16, lane);
        mma_bf16(dp[j], oa, vb[0], vb[1]);
        mma_bf16(dp[j + 1], oa, vb[2], vb[3]);
      }
    }

    // dL = P (dP - delta), P recomputed from the forward's stats.
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + j * 8 + 2 * t + (e & 1);
        const bool lo = e < 2;
        float pv = 0.f;
        if (col < vl)
          pv = exp2f(s[j][e] * p.c_scale - (lo ? m_lo : m_hi)) *
               (lo ? w_lo : w_hi);
        s[j][e] = pv * (dp[j][e] - (lo ? dl_lo : dl_hi));
      }
    }

    // dQ += dL K: dL repacked into bf16 A fragments.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t la[4];
      la[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      la[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      la[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      la[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int i = 0; i < DT; i += 2) {
        uint32_t kb[4];
        load_b<LD>(kb, Ks, kk * 16, i * 8, lane);
        mma_bf16(acc[i], la, kb[0], kb[1]);
        mma_bf16(acc[i + 1], la, kb[2], kb[3]);
      }
    }
  }

  const float sc = p.inv_sqrt_d;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = i * 8 + 2 * t;
    if (n_lo < p.Nq)
      *reinterpret_cast<__nv_bfloat162*>(
          p.dq + ((size_t(b) * p.Nq + n_lo) * p.H + h) * D + d) =
          __floats2bfloat162_rn(acc[i][0] * sc, acc[i][1] * sc);
    if (n_hi < p.Nq)
      *reinterpret_cast<__nv_bfloat162*>(
          p.dq + ((size_t(b) * p.Nq + n_hi) * p.H + h) * D + d) =
          __floats2bfloat162_rn(acc[i][2] * sc, acc[i][3] * sc);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREAD) flash_bwd_dkv_kernel(BwdParams p) {
  static_assert(D == 128, "head dims 32 and 64 run flash_bwd_sm90");
  constexpr int LD = D + 8;
  constexpr int KS = D / 16;
  constexpr int NT = BQ / 8;         // 8-query n-tiles of S^T and dP^T
  constexpr int DT = D / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Vs = Ks + BK * LD;
  __nv_bfloat16* Qs = Vs + BK * LD;
  __nv_bfloat16* Os = Qs + BQ * LD;  // dO tile
  float* sm = reinterpret_cast<float*>(Os + BQ * LD);
  float* sw = sm + BQ;
  float* sd = sw + BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = blockIdx.x * BK;
  const int vl = min(p.valid_len, p.Nk);
  const int key_lo = k0 + warp * 16 + g, key_hi = key_lo + 8;

  float acck[DT][4], accv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[i][e] = accv[i][e] = 0.f;

  if (k0 < vl) {   // key tiles past valid_len keep zero gradients
    load_tile<D, NTHREAD>(Ks, p.k, b, h, p.H, p.Nk, k0, vl);
    load_tile<D, NTHREAD>(Vs, p.v, b, h, p.H, p.Nk, k0, vl);
    const size_t srow = size_t(bh) * p.Nq;
    const int nq_tiles = (p.Nq + BQ - 1) / BQ;
    for (int qt = 0; qt < nq_tiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D, NTHREAD>(Qs, p.q, b, h, p.H, p.Nq, q0, p.Nq);
      load_tile<D, NTHREAD>(Os, p.dout, b, h, p.H, p.Nq, q0, p.Nq);
      if (threadIdx.x < BQ) {
        const int n = q0 + threadIdx.x;
        const bool ok = n < p.Nq;
        sm[threadIdx.x] = ok ? p.m[srow + n] : 0.f;
        sw[threadIdx.x] = ok ? 1.f / fmaxf(p.l[srow + n], 1e-30f) : 0.f;
        sd[threadIdx.x] = ok ? p.delta[srow + n] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T, 16 keys x 64 queries per warp.
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, Ks, warp * 16, ks * 16, lane);
        load_a<LD>(va, Vs, warp * 16, ks * 16, lane);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t qb[4], ob[4];
          load_bt<LD>(qb, Qs, j * 8, ks * 16, lane);
          mma_bf16(s[j], ka, qb[0], qb[1]);
          mma_bf16(s[j + 1], ka, qb[2], qb[3]);
          load_bt<LD>(ob, Os, j * 8, ks * 16, lane);
          mma_bf16(dp[j], va, ob[0], ob[1]);
          mma_bf16(dp[j + 1], va, ob[2], ob[3]);
        }
      }

      // P^T into s, dL^T = P^T (dP^T - delta) into dp.
#pragma unroll
      for (int j = 0; j < NT; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * t + (e & 1);
          const int key = e < 2 ? key_lo : key_hi;
          float pv = 0.f;
          if (key < vl) pv = exp2f(s[j][e] * p.c_scale - sm[c]) * sw[c];
          s[j][e] = pv;
          dp[j][e] = pv * (dp[j][e] - sd[c]);
        }
      }

      // dV += bf16(P^T) dO and dK += bf16(dL^T) Q.
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], la[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        la[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
        la[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
        la[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        la[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
        for (int i = 0; i < DT; i += 2) {
          uint32_t ob[4], qb[4];
          load_b<LD>(ob, Os, kk * 16, i * 8, lane);
          mma_bf16(accv[i], pa, ob[0], ob[1]);
          mma_bf16(accv[i + 1], pa, ob[2], ob[3]);
          load_b<LD>(qb, Qs, kk * 16, i * 8, lane);
          mma_bf16(acck[i], la, qb[0], qb[1]);
          mma_bf16(acck[i + 1], la, qb[2], qb[3]);
        }
      }
    }
  }

  const float sc = p.inv_sqrt_d;
#pragma unroll
  for (int i = 0; i < DT; ++i) {
    const int d = i * 8 + 2 * t;
    if (key_lo < p.Nk) {
      const size_t off = ((size_t(b) * p.Nk + key_lo) * p.H + h) * D + d;
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off) =
          __floats2bfloat162_rn(acck[i][0] * sc, acck[i][1] * sc);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off) =
          __floats2bfloat162_rn(accv[i][0], accv[i][1]);
    }
    if (key_hi < p.Nk) {
      const size_t off = ((size_t(b) * p.Nk + key_hi) * p.H + h) * D + d;
      *reinterpret_cast<__nv_bfloat162*>(p.dk + off) =
          __floats2bfloat162_rn(acck[i][2] * sc, acck[i][3] * sc);
      *reinterpret_cast<__nv_bfloat162*>(p.dv + off) =
          __floats2bfloat162_rn(accv[i][2], accv[i][3]);
    }
  }
}

template <int D, bool DKV>
int launch(const BwdParams& p, int B, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  auto kernel = DKV ? flash_bwd_dkv_kernel<D> : flash_bwd_dq_kernel<D>;
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  const int err = smem_limit_once(kernel, int(bytes), attr_set, &dev);
  if (err != 0) return err;
  const int n = DKV ? p.Nk : p.Nq;
  const dim3 grid((n + 63) / 64, B * p.H);
  kernel<<<grid, NTHREAD, bytes, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace

// flash_bwd_sm90 and the passes around it: need flash_common.cuh
#include "flash_bwd_sm90.cuh"

namespace {

// Backward launches by design since the library loaded: [0] the mma.sync
// kernels (D = 128), [1] flash_bwd_sm90 (TMA + wgmma). Read by
// flash_bwd_design_launches.
std::atomic<long long> bwd_launches[2];

}  // namespace

extern "C" {

// The floats of scratch flash_bwd takes, for the caller to allocate:
// out[0] for `work` (the q tiles' m, w and delta at D = 32 and 64, delta at
// D = 128), out[1] for `dq_acc` (0 at D = 128).
void flash_bwd_scratch_floats(int B, int H, int Nq, int D, long long* out) {
  if (D == 128) {
    out[0] = (long long)B * H * Nq;
    out[1] = 0;
  } else {
    bwd_sm90_scratch(B, H, Nq, D, &out[0], &out[1]);
  }
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* dout_ = static_cast<const __nv_bfloat16*>(dout);
  const auto* out_ = static_cast<const __nv_bfloat16*>(out);
  const auto* m_ = static_cast<const float*>(m);
  const auto* l_ = static_cast<const float*>(l);
  float* work_ = static_cast<float*>(work);
  float* acc = static_cast<float*>(dq_acc);
  const int n_qt = (Nq + BW_BQ - 1) / BW_BQ;
  int err;
  if (D != 128) {
    err = D == 64 ? launch_bwd_prep<64, true>(dout_, out_, m_, l_, work_,
                                              acc, B, H, Nq, n_qt, st)
                  : launch_bwd_prep<32, true>(dout_, out_, m_, l_, work_,
                                              acc, B, H, Nq, n_qt, st);
    if (err == 0)
      err = D == 64 ? launch_bwd_sm90<64>(q, k, v, dout, work_, acc, dq, dk,
                                          dv, B, H, Nq, Nk, valid_len,
                                          c_scale, inv_sqrt_d, st)
                    : launch_bwd_sm90<32>(q, k, v, dout, work_, acc, dq, dk,
                                          dv, B, H, Nq, Nk, valid_len,
                                          c_scale, inv_sqrt_d, st);
    if (err == 0) bwd_launches[1].fetch_add(1, std::memory_order_relaxed);
    return err;
  }
  err = launch_bwd_prep<128, false>(dout_, out_, m_, l_, work_, nullptr, B,
                                    H, Nq, n_qt, st);
  if (err != 0) return err;
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = dout_;
  p.m = m_;
  p.l = l_;
  p.delta = work_;
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.H = H;
  p.Nq = Nq;
  p.Nk = Nk;
  p.valid_len = valid_len;
  p.c_scale = c_scale;
  p.inv_sqrt_d = inv_sqrt_d;
  err = launch<128, false>(p, B, st);
  if (err == 0) err = launch<128, true>(p, B, st);
  if (err == 0) bwd_launches[0].fetch_add(1, std::memory_order_relaxed);
  return err;
}

// out[0]: mma.sync launches (D = 128), out[1]: flash_bwd_sm90 launches.
void flash_bwd_design_launches(long long* out) {
  out[0] = bwd_launches[0].load(std::memory_order_relaxed);
  out[1] = bwd_launches[1].load(std::memory_order_relaxed);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
