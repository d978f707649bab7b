// The matmul-shape probes of scripts/bench_matmul_shapes.py for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes): on
// contiguous bf16 a (B, M, K), b (B, K, N) and o (B, M, N), o[p] =
// bf16(a[p] @ b[p]), f32 sums rounded once at the store (the reference's
// preferred_element_type=f32, then .astype).
//   bench_batched_mm  replaces pallas_batched_mm (:41, launched at :49),
//                     one whole problem per grid step;
//   bench_grouped_mm  replaces pallas_grouped_mm (:64, launched at :75), G
//                     problems per grid step in a loop over g (:67-70).
// A whole 1056 x 1056 problem cannot be a CTA: each CTA computes one BM x
// BN output tile of one problem, or the same tile of G consecutive
// problems one after the other (amortising what a CTA pays once, as the
// reference's loop amortises a grid step). Tilings 64 x 64 (4 warps of
// 32 x 32) and 128 x 128 (8 warps of 64 x 32).
//
// Per 64-deep K step each thread issues all its 16-byte loads of the A and
// B tiles into registers, then, after a barrier, stores them to shared
// memory (synchronous and single-buffered, as the attention probes; a
// strided loop of unknown trip count would issue them one after another).
// A fragments come from ldmatrix, B's (N-contiguous, as V in PV) from
// ldmatrix.trans; mma.sync m16n8k16 accumulates in f32 registers. The tile
// is rounded once, staged in shared memory and stored in 16-byte rows.
// Edges (1056 = 16 * 64 + 32 = 8 * 128 + 32; the PV shape's K = 1056 ends
// in a 32-deep step): loads past an edge fill zeros, stores are masked. K
// and N are multiples of 8, so every 16-byte chunk is whole and aligned.
// No cp.async, TMA or wgmma: beside torch.bmm, the times say what this
// simple design leaves.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BK = 64;          // K step
constexpr int LDA = BK + 8;     // A tile row stride (elements)

struct Args {
  const __nv_bfloat16* a;   // (B, M, K)
  const __nv_bfloat16* b;   // (B, K, N)
  __nv_bfloat16* o;         // (B, M, N)
  int M, K, N, G;           // G problems per CTA (1 in the batched kernel)
};

template <int BM, int BN>
struct Tiling {
  static constexpr int WM = BM == 128 ? 64 : 32;   // warp tile rows
  static constexpr int WN = 32;                    // warp tile columns
  static constexpr int WARPS_N = BN / WN;
  static constexpr int NTHREAD = 32 * (BM / WM) * WARPS_N;
  static constexpr int MT = WM / 16;               // 16-row m-tiles a warp
  static constexpr int NT = WN / 8;                // 8-column n-tiles a warp
  static constexpr int LDB = BN + 8;               // B and output tile stride
  // CTAs an SM must hold (80 and 128 registers): left free, ptxas takes
  // 116 and 154-174, which halves the CTAs in flight (up to 40% slower).
  static constexpr int MIN_BLOCKS = BM == 128 ? 2 : 6;
  static constexpr int STAGE = BM * LDA + BK * LDB;
  static constexpr size_t SMEM =
      2 * size_t(STAGE > BM * LDB ? STAGE : BM * LDB);
};

// This thread's 16-byte chunks of a ROWS x COLS tile of the row-major bf16
// matrix at src (row stride ld): `load` issues all of them at once, zero
// at or past (rows_left, cols_left); `store` writes them to shared memory.
template <int ROWS, int COLS, int NTHREAD>
struct Chunks {
  static constexpr int CH = COLS / 8, N = ROWS * CH / NTHREAD;
  static_assert(ROWS * CH % NTHREAD == 0, "whole chunks per thread");
  uint4 v[N];

  __device__ __forceinline__ void load(const __nv_bfloat16* src, size_t ld,
                                       int rows_left, int cols_left) {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = threadIdx.x + it * NTHREAD, r = i / CH, c = (i % CH) * 8;
      v[it] = make_uint4(0u, 0u, 0u, 0u);
      if (r < rows_left && c < cols_left)
        v[it] = *reinterpret_cast<const uint4*>(src + r * ld + c);
    }
  }

  template <int LDS>
  __device__ __forceinline__ void store(__nv_bfloat16* dst) const {
#pragma unroll
    for (int it = 0; it < N; ++it) {
      const int i = threadIdx.x + it * NTHREAD;
      *reinterpret_cast<uint4*>(dst + (i / CH) * LDS + (i % CH) * 8) = v[it];
    }
  }
};

// One BM x BN output tile of problem p.
template <int BM, int BN>
__device__ __forceinline__ void tile_product(const Args& a, size_t p,
                                             unsigned char* smem) {
  using T = Tiling<BM, BN>;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDA;
  __nv_bfloat16* Cs = As;   // the output tile, once the K sweep is done
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = (warp / T::WARPS_N) * T::WM, wn = (warp % T::WARPS_N) * T::WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const __nv_bfloat16* A = a.a + p * a.M * a.K + size_t(m0) * a.K;
  const __nv_bfloat16* B = a.b + p * a.K * a.N + n0;

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int k0 = 0; k0 < a.K; k0 += BK) {
    Chunks<BM, BK, T::NTHREAD> ca;
    Chunks<BK, BN, T::NTHREAD> cb;
    ca.load(A + k0, a.K, a.M - m0, a.K - k0);
    cb.load(B + size_t(k0) * a.N, a.N, a.K - k0, a.N - n0);
    __syncthreads();  // every warp is done with the previous tiles
    ca.template store<LDA>(As);
    cb.template store<T::LDB>(Bs);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      uint32_t af[T::MT][4];
#pragma unroll
      for (int i = 0; i < T::MT; ++i)
        load_a<LDA>(af[i], As, wm + i * 16, ks * 16, lane);
#pragma unroll
      for (int j = 0; j < T::NT; j += 2) {
        uint32_t bf[4];
        load_b<T::LDB>(bf, Bs, ks * 16, wn + j * 8, lane);
#pragma unroll
        for (int i = 0; i < T::MT; ++i) {
          mma_bf16(acc[i][j], af[i], bf[0], bf[1]);
          mma_bf16(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
  }

  __syncthreads();  // the output tile overwrites the staged A and B
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < T::MT; ++i)
#pragma unroll
    for (int j = 0; j < T::NT; ++j) {
      __nv_bfloat16* c = Cs + (wm + i * 16 + g) * T::LDB + wn + j * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(c) =
          __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<__nv_bfloat162*>(c + 8 * T::LDB) =
          __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
    }
  __syncthreads();
  __nv_bfloat16* O = a.o + p * a.M * a.N + size_t(m0) * a.N + n0;
  constexpr int CH = BN / 8;
  for (int i = threadIdx.x; i < BM * CH; i += T::NTHREAD) {
    const int r = i / CH, c = (i % CH) * 8;
    if (m0 + r < a.M && n0 + c < a.N)
      *reinterpret_cast<uint4*>(O + size_t(r) * a.N + c) =
          *reinterpret_cast<const uint4*>(Cs + r * T::LDB + c);
  }
}

// Batched: problem blockIdx.z. Grouped: problems [blockIdx.z * G, + G), one
// after the other (the next sweep's first barrier protects the staged tile).
template <int BM, int BN, bool GROUPED>
__global__ void __launch_bounds__(Tiling<BM, BN>::NTHREAD,
                                  Tiling<BM, BN>::MIN_BLOCKS)
    mm_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  if constexpr (GROUPED) {
    for (int g = 0; g < a.G; ++g)
      tile_product<BM, BN>(a, size_t(blockIdx.z) * a.G + g, smem);
  } else {
    tile_product<BM, BN>(a, blockIdx.z, smem);
  }
}

template <int BM, int BN, bool GROUPED>
int launch_tiling(const Args& a, int B, cudaStream_t st) {
  using T = Tiling<BM, BN>;
  // Under 48 KB, no opt-in attribute: a launch is one stream operation.
  static_assert(T::SMEM <= 48 * 1024, "tile needs opt-in shared memory");
  const dim3 grid((a.N + BN - 1) / BN, (a.M + BM - 1) / BM, B / a.G);
  mm_kernel<BM, BN, GROUPED><<<grid, T::NTHREAD, T::SMEM, st>>>(a);
  return int(cudaGetLastError());
}

template <bool GROUPED>
int dispatch(const void* a, const void* b, void* o, int B, int M, int K,
             int N, int G, int bm, int bn, void* stream) {
  if (B <= 0 || M <= 0 || K <= 0 || N <= 0 || G <= 0 || B % G ||
      B / G > 65535 || K % 8 || N % 8 || (M + 63) / 64 > 65535)
    return int(cudaErrorInvalidValue);
  const Args args{static_cast<const __nv_bfloat16*>(a),
                  static_cast<const __nv_bfloat16*>(b),
                  static_cast<__nv_bfloat16*>(o), M, K, N, G};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 64 && bn == 64) return launch_tiling<64, 64, GROUPED>(args, B, st);
  if (bm == 128 && bn == 128)
    return launch_tiling<128, 128, GROUPED>(args, B, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a (B, M, K), b (B, K, N), o (B, M, N): contiguous bf16, 16-byte aligned;
// K and N multiples of 8; block_m x block_n 64 x 64 or 128 x 128.
int bench_batched_mm(const void* a, const void* b, void* o, int B, int M,
                     int K, int N, int block_m, int block_n, void* stream) {
  return dispatch<false>(a, b, o, B, M, K, N, 1, block_m, block_n, stream);
}

// The same, G consecutive problems per CTA; G divides B.
int bench_grouped_mm(const void* a, const void* b, void* o, int B, int M,
                     int K, int N, int G, int block_m, int block_n,
                     void* stream) {
  return dispatch<true>(a, b, o, B, M, K, N, G, block_m, block_n, stream);
}

const char* bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
