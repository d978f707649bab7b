// Fused DPT output tail for Hopper (sm_90a), bound to PyTorch through a
// plain C interface (ctypes).
//
// dpt_tail_fwd replaces vggt_slam_tpu/ops/dpt_tail.py _kernel (fused_tail):
// for each frame s and output pixel (r, c) of the (rows_out, W) map
//   u(r, c)  = bf16(x[s, lo, c] + (x[s, lo + 1, c] - x[s, lo, c]) frac
//                   + pos[r, c])                  align-corners row taps,
//              zero outside the image (the 3x3 conv's zero padding)
//   h(r, c)  = bf16(relu(sum_{dr, dc, ci} u(r + dr - 1, c + dc - 1, ci)
//                        w0[dr, dc, ci, :] + b0))            f32 accumulate
//   out[:, s, r, c] = w1t h(r, c) + b1                       f32
// with lo = clip(floor(r ratio), 0, rows_in - 2), frac = clip(r ratio - lo,
// 0, 1), ratio = (rows_in - 1) / (rows_out - 1), all in f32 as the reference
// and fused_tail_ref. x arrives after the column upsample, (S, rows_in, W,
// cin) bf16; the output is channel-first (cout, S, rows_out, W) f32.
//
// What bounds it on this card: at the depth head's shape (S 18, 224 -> 392
// rows, W 518, cin 128, cmid 32) the 3x3 conv is 270 GFLOP on ~0.62 GB of
// bytes (x once, pos, the f32 output): 0.27 ms of bf16 tensor-core time
// against 0.19 ms of HBM time, so the tensor cores bound it.
// Design: an implicit GEMM on mma.sync m16n8k16 bf16 (M = the 8 x 32 output
// pixels of a CTA, K = 9 cin, N = cmid = 32). Each CTA stages the (8 + 2) x
// (32 + 2) halo of interpolated rows, with pos added and rounded, in shared
// memory 32 channels at a time together with the matching 9 x 32 rows of
// w0, so a CTA needs 50 KB and several fit on an SM; the A fragments are
// ldmatrix reads of 16 neighbouring halo pixels at the tap's offset, the
// B fragments ldmatrix.trans reads of the weight chunk. Each warp owns one
// output row (two 16-pixel m-tiles) and keeps its 16 x 32 f32 accumulators
// in registers; the epilogue adds b0, applies ReLU, rounds to bf16 and
// reduces the 1x1 conv across the four lanes that hold a pixel's channels.
// Edge column tiles (W = 518 is not a multiple of 32) are masked on store.
// Pipelining the staging and wgmma are later work.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int TR = 8;               // output rows per CTA (one per warp)
constexpr int TC = 32;              // output columns per CTA
constexpr int CC = 32;              // input channels per staged chunk
constexpr int CMID = 32;            // 3x3 conv output channels
constexpr int MAX_COUT = 4;
constexpr int NWARP = TR;
constexpr int NTHREAD = NWARP * 32;
constexpr int UR = TR + 2, UC = TC + 2;   // staged halo
constexpr int LDU = CC + 8;         // bf16 per staged pixel (80 bytes)
constexpr int LDW = CMID + 8;       // bf16 per staged weight row (80 bytes)
constexpr size_t SMEM = size_t(UR * UC * LDU + 9 * CC * LDW) * 2;

struct Params {
  const __nv_bfloat16* x;     // (S, rows_in, W, cin)
  const __nv_bfloat16* pos;   // (rows_out, W, cin)
  const __nv_bfloat16* w0;    // (9 cin, CMID), rows (dr, dc, ci)
  const float* b0;            // (CMID,)
  const float* w1t;           // (cout, CMID), bf16-rounded values
  const float* b1;            // (cout,)
  float* out;                 // (cout, S, rows_out, W)
  int S, rows_in, rows_out, W, cin, cout;
  float ratio;
};

__device__ __forceinline__ float lerp_pos(float a, float b, float frac,
                                          float pe) {
  // (a + (b - a) frac) + pe, rounded as written (no contraction)
  return __fadd_rn(__fadd_rn(a, __fmul_rn(__fsub_rn(b, a), frac)), pe);
}

__global__ void __launch_bounds__(NTHREAD) dpt_tail_kernel(Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* U = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Wc = U + UR * UC * LDU;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int c0 = blockIdx.x * TC, r0 = blockIdx.y * TR, s = blockIdx.z;

  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
      acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

  for (int ch = 0; ch < p.cin; ch += CC) {
    __syncthreads();   // every warp is done with the previous chunk
    // Halo of interpolated rows + pos, 8 channels (16 bytes) per item.
    for (int i = threadIdx.x; i < UR * UC * (CC / 8); i += NTHREAD) {
      const int v8 = i % (CC / 8), pix = i / (CC / 8);
      const int gor = r0 - 1 + pix / UC, col = c0 - 1 + pix % UC;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (gor >= 0 && gor < p.rows_out && col >= 0 && col < p.W) {
        const float pf = __fmul_rn(static_cast<float>(gor), p.ratio);
        const int lo = min(max(static_cast<int>(floorf(pf)), 0),
                           p.rows_in - 2);
        const float frac =
            fminf(fmaxf(__fsub_rn(pf, static_cast<float>(lo)), 0.f), 1.f);
        const size_t xa = ((size_t(s) * p.rows_in + lo) * p.W + col) *
                              p.cin + ch + v8 * 8;
        const uint4 ra = *reinterpret_cast<const uint4*>(p.x + xa);
        const uint4 rb = *reinterpret_cast<const uint4*>(
            p.x + xa + size_t(p.W) * p.cin);
        const uint4 rp = *reinterpret_cast<const uint4*>(
            p.pos + (size_t(gor) * p.W + col) * p.cin + ch + v8 * 8);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&ra);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&rb);
        const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&rp);
        __nv_bfloat162 o2[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fa = __bfloat1622float2(a2[e]);
          const float2 fb = __bfloat1622float2(b2[e]);
          const float2 fp = __bfloat1622float2(p2[e]);
          o2[e] = __floats2bfloat162_rn(lerp_pos(fa.x, fb.x, frac, fp.x),
                                        lerp_pos(fa.y, fb.y, frac, fp.y));
        }
        val = *reinterpret_cast<const uint4*>(o2);
      }
      *reinterpret_cast<uint4*>(U + pix * LDU + v8 * 8) = val;
    }
    // The chunk's weight rows (tap, ci) for ci in [ch, ch + CC).
    for (int i = threadIdx.x; i < 9 * CC * (CMID / 8); i += NTHREAD) {
      const int v8 = i % (CMID / 8), row = i / (CMID / 8);
      const int tap = row / CC, ci = row % CC;
      *reinterpret_cast<uint4*>(Wc + row * LDW + v8 * 8) =
          *reinterpret_cast<const uint4*>(
              p.w0 + (size_t(tap) * p.cin + ch + ci) * CMID + v8 * 8);
    }
    __syncthreads();

#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dr = tap / 3, dc = tap % 3;
#pragma unroll
      for (int kk = 0; kk < CC / 16; ++kk) {
        uint32_t b[2][4];
        load_b<LDW>(b[0], Wc, tap * CC + kk * 16, 0, lane);
        load_b<LDW>(b[1], Wc, tap * CC + kk * 16, 16, lane);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          uint32_t a[4];
          load_a<LDU>(a, U + ((warp + dr) * UC + mt * 16 + dc) * LDU, 0,
                      kk * 16, lane);
          mma_bf16(acc[mt][0], a, b[0][0], b[0][1]);
          mma_bf16(acc[mt][1], a, b[0][2], b[0][3]);
          mma_bf16(acc[mt][2], a, b[1][0], b[1][1]);
          mma_bf16(acc[mt][3], a, b[1][2], b[1][3]);
        }
      }
    }
  }

  // Epilogue: lane (g, t) holds, for pixels g and g + 8 of each m-tile,
  // the mid channels nt * 8 + 2t + {0, 1}.
  const int row = r0 + warp;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    float lo_part[MAX_COUT], hi_part[MAX_COUT];
#pragma unroll
    for (int o = 0; o < MAX_COUT; ++o) lo_part[o] = hi_part[o] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = nt * 8 + 2 * t + e;
        const float bias = p.b0[m];
        const float h_lo = __bfloat162float(
            __float2bfloat16(fmaxf(acc[mt][nt][e] + bias, 0.f)));
        const float h_hi = __bfloat162float(
            __float2bfloat16(fmaxf(acc[mt][nt][2 + e] + bias, 0.f)));
#pragma unroll
        for (int o = 0; o < MAX_COUT; ++o) {
          if (o < p.cout) {
            const float w = p.w1t[o * CMID + m];
            lo_part[o] = fmaf(h_lo, w, lo_part[o]);
            hi_part[o] = fmaf(h_hi, w, hi_part[o]);
          }
        }
      }
    }
#pragma unroll
    for (int o = 0; o < MAX_COUT; ++o) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        lo_part[o] += __shfl_xor_sync(0xffffffffu, lo_part[o], off);
        hi_part[o] += __shfl_xor_sync(0xffffffffu, hi_part[o], off);
      }
    }
    const int col_lo = c0 + mt * 16 + g, col_hi = col_lo + 8;
    if (t == 0 && row < p.rows_out) {
      for (int o = 0; o < p.cout; ++o) {
        float* dst = p.out + ((size_t(o) * p.S + s) * p.rows_out + row) * p.W;
        if (col_lo < p.W) dst[col_lo] = lo_part[o] + p.b1[o];
        if (col_hi < p.W) dst[col_hi] = hi_part[o] + p.b1[o];
      }
    }
  }
}

}  // namespace

extern "C" {

int dpt_tail_fwd(const void* x, const void* pos, const void* w0,
                 const void* b0, const void* w1t, const void* b1, void* out,
                 int S, int rows_in, int rows_out, int W, int cin, int cmid,
                 int cout, float ratio, void* stream) {
  if (cmid != CMID || cin % CC != 0 || cout < 1 || cout > MAX_COUT ||
      rows_in < 2 || rows_out < 2 || W < 1 || S < 1)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      dpt_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(SMEM));
  if (err != cudaSuccess) return int(err);
  Params p;
  p.x = static_cast<const __nv_bfloat16*>(x);
  p.pos = static_cast<const __nv_bfloat16*>(pos);
  p.w0 = static_cast<const __nv_bfloat16*>(w0);
  p.b0 = static_cast<const float*>(b0);
  p.w1t = static_cast<const float*>(w1t);
  p.b1 = static_cast<const float*>(b1);
  p.out = static_cast<float*>(out);
  p.S = S;
  p.rows_in = rows_in;
  p.rows_out = rows_out;
  p.W = W;
  p.cin = cin;
  p.cout = cout;
  p.ratio = ratio;
  const dim3 grid((W + TC - 1) / TC, (rows_out + TR - 1) / TR, S);
  dpt_tail_kernel<<<grid, NTHREAD, SMEM, static_cast<cudaStream_t>(stream)>>>(
      p);
  return int(cudaGetLastError());
}

const char* dpt_tail_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
