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
// quantizes every K (and V) tile as it stages it, with the same scale: the
// same int8 values. Two layout traps of the int8 PV (mma.sync m16n8k32 .s8):
// (a) B must be k-contiguous and the contraction runs over keys, while
// ldmatrix .trans moves 16-bit elements only: int8 V is stored transposed
// (D rows of BK key bytes); (b) the QK^T accumulator gives a thread keys 2t,
// 2t + 1 of each 8-key n-tile, where the s8 A fragment wants 4t..4t+3 and
// 16+4t..16+4t+3 of 32: instead of shuffling p8 between lanes, V's keys are
// permuted within each 32 (key_pos) to match. The contraction order is
// free, so the product is the same.
//
// Tilings: the reference's (1024, 2048) and (2048, 2048) VMEM blocks become
// (64, 64) and (128, 64) CTA tilings. Bound at the global shape: one
// MUFU.EX2 per logit (about 4.6 ms) once QK^T is int8; bf16's products
// take 5.0 ms.

#include "global_probe.cuh"

namespace {

using namespace probe;

enum Mode { BF16 = 0, QK8 = 1, QK8AV8 = 2 };

struct Args {
  const float* sc;          // (5, BH)
  const __nv_bfloat16* q;   // (BH, Nq, D)
  const __nv_bfloat16* k;   // (BH, Nk, D)
  const __nv_bfloat16* v;   // (BH, Nk, D)
  __nv_bfloat16* o;         // (BH, Nq, D)
  int BH, Nq, Nk;
};

// Position of key `key` of a tile in the transposed int8 V tile: within its
// group of 32, key 8 j + 2 t + i (j the n-tile, i = 0, 1) goes to byte
// 16 (j / 2) + 4 t + 2 (j % 2) + i, where pv_s8's A fragment holds its p8.
__device__ __forceinline__ int key_pos(int key) {
  const int w = key & 7;
  return (key & ~31) + ((key >> 4) & 1) * 16 + (w >> 1) * 4 +
         ((key >> 3) & 1) * 2 + (w & 1);
}

// The BK x D bf16 V tile quantized into a D x (BK + 16) byte tile, keys
// permuted by key_pos. Neighbouring threads take neighbouring keys, so a
// warp's byte stores to one row land in 8 consecutive words.
template <int BK, int NTHREAD>
__device__ __forceinline__ void stage_vt8(int8_t* dst,
                                          const __nv_bfloat16* src, int row0,
                                          float inv) {
  constexpr int LDV = BK + 16;
  for (int i = threadIdx.x; i < BK * (D / 8); i += NTHREAD) {
    const int r = i % BK, c = i / BK;   // key r, dims 8c .. 8c + 7
    const uint4 raw =
        *reinterpret_cast<const uint4*>(src + size_t(row0 + r) * D + c * 8);
    const int pos = key_pos(r);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      dst[(c * 8 + e) * LDV + pos] = quant_i8(bf16_at(raw, e), inv);
  }
}

__device__ __forceinline__ uint32_t p8(float p) {
  return uint32_t(min(127, max(0, __float2int_rn(__fmul_rn(p, 127.f)))));
}

__device__ __forceinline__ uint32_t pack_p8(float a, float b, float c,
                                            float d) {
  return p8(a) | p8(b) << 8 | p8(c) << 16 | p8(d) << 24;
}

// O += f32(s32(P8 V8)) * dv over a BK = NT * 8 key tile, P8 quantized from
// the S fragments (already exp2'd), V8 the transposed, permuted tile.
template <int NT>
__device__ __forceinline__ void pv_s8(float (&o)[DT][4],
                                      const float (&p)[NT][4],
                                      const int8_t* Vt8, float dv, int lane) {
  constexpr int LDV = NT * 8 + 16;
  int acc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0;
#pragma unroll
  for (int kk = 0; kk < NT / 4; ++kk) {   // 32 keys: n-tiles 4kk .. 4kk + 3
    const float(&p0)[4] = p[4 * kk];
    const float(&p1)[4] = p[4 * kk + 1];
    const float(&p2)[4] = p[4 * kk + 2];
    const float(&p3)[4] = p[4 * kk + 3];
    uint32_t pa[4];
    pa[0] = pack_p8(p0[0], p0[1], p1[0], p1[1]);   // row g, bytes 4t..
    pa[1] = pack_p8(p0[2], p0[3], p1[2], p1[3]);   // row g + 8
    pa[2] = pack_p8(p2[0], p2[1], p3[0], p3[1]);   // row g, bytes 16 + 4t..
    pa[3] = pack_p8(p2[2], p2[3], p3[2], p3[3]);   // row g + 8
#pragma unroll
    for (int i = 0; i < DT; i += 2) {
      uint32_t vb[4];
      load_bt8<LDV>(vb, Vt8, i * 8, kk * 32, lane);
      mma_s8(acc[i], pa, vb[0], vb[1]);
      mma_s8(acc[i + 1], pa, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < DT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      o[i][e] += __fmul_rn(static_cast<float>(acc[i][e]), dv);
  }
}

template <int BQ, int BK, int MODE>
constexpr size_t smem_bytes() {
  constexpr size_t row = MODE == BF16 ? LD * 2 : LDB;
  constexpr size_t vt = MODE == QK8AV8 ? D * (BK + 16) : BK * LD * 2;
  return BQ * row + BK * row + vt;
}

template <int BQ, int BK, int MODE>
__global__ void __launch_bounds__(BQ * 2) int8_inkernel_kernel(Args a) {
  constexpr int NTHREAD = BQ * 2;
  constexpr int NT = BK / 8;
  constexpr bool Q8 = MODE != BF16;
  constexpr bool AV8 = MODE == QK8AV8;
  constexpr size_t ROW = Q8 ? LDB : LD * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* kt = smem + BQ * ROW;
  unsigned char* vt = kt + BK * ROW;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const size_t qbase = size_t(bh) * a.Nq * D;
  const size_t kbase = size_t(bh) * a.Nk * D;
  const float inv_q = a.sc[bh], inv_k = a.sc[a.BH + bh];
  const float inv_v = a.sc[2 * a.BH + bh], dq = a.sc[3 * a.BH + bh];
  const float dv = a.sc[4 * a.BH + bh];

  uint32_t qa[Q8 ? KS8 : KS][4];
  if constexpr (Q8) {
    stage_quant<BQ, NTHREAD>(reinterpret_cast<int8_t*>(smem), a.q + qbase,
                             q0, inv_q);
    __syncthreads();
    load_q8(qa, reinterpret_cast<int8_t*>(smem), warp, lane);
  } else {
    stage<BQ, NTHREAD>(reinterpret_cast<__nv_bfloat16*>(smem), a.q + qbase,
                       q0);
    __syncthreads();
    load_q(qa, reinterpret_cast<__nv_bfloat16*>(smem), warp, lane);
  }

  float o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < a.Nk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    if constexpr (Q8)
      stage_quant<BK, NTHREAD>(reinterpret_cast<int8_t*>(kt), a.k + kbase,
                               k0, inv_k);
    else
      stage<BK, NTHREAD>(reinterpret_cast<__nv_bfloat16*>(kt), a.k + kbase,
                         k0);
    if constexpr (AV8)
      stage_vt8<BK, NTHREAD>(reinterpret_cast<int8_t*>(vt), a.v + kbase, k0,
                             inv_v);
    else
      stage<BK, NTHREAD>(reinterpret_cast<__nv_bfloat16*>(vt), a.v + kbase,
                         k0);
    __syncthreads();

    float s[NT][4];
    if constexpr (Q8) {
      int acc[NT][4];
      qk_s8(acc, qa, reinterpret_cast<int8_t*>(kt), lane);
      dequant(s, acc, dq);
    } else {
      qk_bf16(s, qa, reinterpret_cast<__nv_bfloat16*>(kt), lane);
      scale_by(s, dq);
    }
    online_step<false>(s, o, m, l);
    if constexpr (AV8)
      pv_s8(o, s, reinterpret_cast<int8_t*>(vt), dv, lane);
    else
      pv_bf16(o, s, reinterpret_cast<__nv_bfloat16*>(vt), lane);
  }
  store(o, quad_sum(l[0]), quad_sum(l[1]), a.o + qbase, q0, warp, lane);
}

template <int BQ, int BK, int MODE>
int launch_mode(const Args& a, cudaStream_t st) {
  return launch(int8_inkernel_kernel<BQ, BK, MODE>, dim3(a.Nq / BQ, a.BH),
                BQ * 2, smem_bytes<BQ, BK, MODE>(), st, a);
}

template <int BQ, int BK>
int launch_tiling(const Args& a, int mode, cudaStream_t st) {
  if (a.Nq % BQ != 0 || a.Nk % BK != 0) return int(cudaErrorInvalidValue);
  switch (mode) {
    case BF16: return launch_mode<BQ, BK, BF16>(a, st);
    case QK8: return launch_mode<BQ, BK, QK8>(a, st);
    case QK8AV8: return launch_mode<BQ, BK, QK8AV8>(a, st);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// sc: (5, BH) f32; q, o: (BH, Nq, D) bf16; k, v: (BH, Nk, D) bf16.
int bench_int8_inkernel(const void* sc, const void* q, const void* k,
                        const void* v, void* o, int BH, int Nq, int Nk,
                        int D_, int block_q, int block_k, int mode,
                        void* stream) {
  if (D_ != D || BH <= 0 || BH > 65535 || Nq <= 0 || Nk <= 0)
    return int(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(sc),
               static_cast<const __nv_bfloat16*>(q),
               static_cast<const __nv_bfloat16*>(k),
               static_cast<const __nv_bfloat16*>(v),
               static_cast<__nv_bfloat16*>(o), BH, Nq, Nk};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_q == 64 && block_k == 64) return launch_tiling<64, 64>(a, mode, st);
  if (block_q == 128 && block_k == 64) return launch_tiling<128, 64>(a, mode, st);
  return int(cudaErrorInvalidValue);
}

const char* bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
