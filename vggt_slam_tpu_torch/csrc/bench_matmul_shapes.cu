// The matmul-shape probes of scripts/bench_matmul_shapes.py for Hopper
// (sm_90a), bound to PyTorch through a plain C interface (ctypes): on
// contiguous bf16 a (B, M, K), b (B, K, N) and o (B, M, N), o[p] =
// bf16(a[p] @ b[p]), f32 sums rounded once at the store (the reference's
// preferred_element_type=f32, then .astype).
//   bench_batched_mm  replaces pallas_batched_mm (:41, launched at :49),
//                     one whole problem per grid step;
//   bench_grouped_mm  replaces pallas_grouped_mm (:64, launched at :75), G
//                     problems per grid step in a loop over g (:67-70).
// Both run mm_sm90<BN>, a persistent grid of at most one CTA per SM that
// walks over work items: one 128 x BN output tile of one problem
// (batched), or that tile of G consecutive problems in order g = 0 ... G-1
// (grouped: the reference's grid step; batched is G = 1). Items run
// problem by problem, the tiles of one problem row by row, so the CTAs in
// flight share a problem's a row panels and b column panels in L2.
//
// Loads: TMA into a ring of slots, each an A tile (128 x 64, K-major) and a
// B tile (64 x BN as BN / 64 panels of 64 K rows, N-contiguous), 128-byte
// swizzled, through 3-D maps (K, M, B), (N, K, B) and (N, M, B): the batch
// is a dimension of its own, so rows past M, columns past N and K past its
// end (1056 = 16 * 64 + 32) read as zeros and a store clips them, never
// touching the next problem. The ring runs across K steps, items and the G
// problems of an item. 256 threads, two consumer warpgroups and no
// producer: a warp done with a slot adds one to its release count in
// shared memory and the eighth issues the slot's next load (a ninth warp
// would cap ptxas at 168 registers; 64 x 256 f32 sums take 128 a thread).
// A load's coordinates come from four divisions by run-time values, done
// by multiply-high (`FastDiv`): as plain divisions, on the path of the
// warp that issues the load, they made QK^T 1.19x and (2048)^3 1.56x as
// long.
// Products: wgmma m64nBNk16, warpgroup w rows [64w, 64w + 64) of the tile,
// A K-major and B MN-major from shared memory, one instruction per 16 of K
// for all BN columns (the descriptor's leading byte offset steps over the
// panels); one m64n64k16 a panel, which reads A from shared memory BN / 64
// times, took 1.2x as long at (2048)^3 at 128 x 256.
// Epilogue: each warpgroup rounds its 64 x BN sums to bf16 into a staging
// buffer of its own (the swizzled layout of a 64 x 64 box), then
// fence.proxy.async and one thread stores it by TMA (one box a panel, one
// bulk group a tile), and goes on to the next tile while the store drains;
// wait_group.read frees a buffer before it is written again. Ring and
// staging share the shared memory, split per launch (MmCfg): a sweep of
// one or two K steps takes a ring of 2 and up to five staging buffers a
// warpgroup, since at K = 64 the stores are the whole cost and drain only
// as fast as the buffers in flight allow (two buffers: 1.48x the time at
// the QK^T shape); a longer sweep the deepest ring that leaves one.
// Bounds: bytes at the B = 528 shapes (the 1.18 GB output of QK^T, the
// 1.18 GB a of PV) and at K = 64, operations at (2048)^3.

#include <climits>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace flash;

constexpr int BM = 128;            // output rows of a tile: 64 a warpgroup
constexpr int BK = 64;             // K step: one 128-byte row of A
constexpr int MM_THREADS = 256;    // two consumer warpgroups
constexpr int PANEL = 64 * 128;    // 64 rows of one 128-byte panel
constexpr int A_BYTES = BM * 128;  // the A tile of a ring slot
constexpr int MAX_STAGES = 8, MAX_STG = 5;
// Shared memory for the ring and the staging buffers: all a block may take
// but the 1 KB alignment slack and a barrier and a count a slot.
constexpr int POOL = int(SM90_SMEM_MAX) - 1024 - 12 * MAX_STAGES;

template <int BN>
struct MmCfg {
  static_assert(BN == 128 || BN == 256, "BN of 128 or 256");
  static constexpr int NP = BN / 64;                  // 128-byte panels
  static constexpr int SLOT = A_BYTES + NP * PANEL;   // A and B of a K step
  static constexpr int STG = NP * PANEL;    // a warpgroup's 64 x BN bf16
  // The split of the pool (file header): a ring of 2 for one or two K
  // steps, else the deepest that leaves one staging buffer a warpgroup;
  // then as many staging buffers as fit, at most MAX_STG.
  static constexpr int LONG_STAGES =
      (POOL - 2 * STG) / SLOT < MAX_STAGES ? (POOL - 2 * STG) / SLOT
                                           : MAX_STAGES;
  static int stages(int nk) { return nk <= 2 ? 2 : LONG_STAGES; }
  static int nstg(int stages) {
    const int n = (POOL - stages * SLOT) / (2 * STG);
    return n < MAX_STG ? n : MAX_STG;
  }
  static size_t smem(int stages, int nstg) {
    return 1024 + size_t(stages) * SLOT + size_t(2 * nstg) * STG +
           12 * stages;
  }
  static_assert(LONG_STAGES >= 3, "a ring of three for long sweeps");
};

// n / d for 0 <= n < 2^31 by a multiply-high, an add and a shift, with the
// divisor's magic number found once on the host (CUTLASS's FastDivmod): a
// load's coordinates take four divisions, on the path of the warp that
// issues it.
struct FastDiv {
  int d;
  uint32_t m, s;
  void set(int d_) {
    d = d_;
    s = 0;
    while ((1u << s) < uint32_t(d)) ++s;
    m = uint32_t((uint64_t(1) << 32) * ((uint64_t(1) << s) - d) / d + 1);
  }
  __device__ __forceinline__ int div(int n) const {
    return int((__umulhi(uint32_t(n), m) + uint32_t(n)) >> s);
  }
};

struct MmParams {
  CUtensorMap ta, tb, to;   // a (K, M, B), b (N, K, B), o (N, M, B)
  int M, N, K, items;
  FastDiv nk, G, tiles, n_nt;   // K steps, problems an item, tiles a
                                // problem, n tiles
  int stages, nstg;             // ring slots; staging buffers a warpgroup
};

// cp.async.bulk.wait_group.read n, n < MAX_STG.
__device__ __forceinline__ void bulk_wait_read_n(int n) {
  switch (n) {
    case 0: bulk_wait_read<0>(); break;
    case 1: bulk_wait_read<1>(); break;
    case 2: bulk_wait_read<2>(); break;
    case 3: bulk_wait_read<3>(); break;
    default: bulk_wait_read<4>(); break;
  }
}

template <int BN>
__global__ void __launch_bounds__(MM_THREADS, 1)
    mm_sm90(const __grid_constant__ MmParams P) {
  using C = MmCfg<BN>;
  constexpr int NT = BN / 8;
  const int S = P.stages, NSTG = P.nstg;
  extern __shared__ unsigned char mm_raw[];
  // 1 KB aligned, as the 128B swizzle's 8-row atom
  const uint32_t base = (smem_addr(mm_raw) + 1023) & ~1023u;
  const uint32_t ring = base, stage = ring + S * C::SLOT;
  const uint32_t full = stage + 2 * NSTG * C::STG;
  unsigned char* gen = mm_raw + (base - smem_addr(mm_raw));
  unsigned* released =
      reinterpret_cast<unsigned*>(gen + (full - base) + 8 * S);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;

  // The loads of this CTA in order: unit u (item blockIdx.x + (u / G)
  // gridDim.x, problem u % G of it) has nk K steps; load n is K step n % nk
  // of unit n / nk, into ring slot n % S (`slot`).
  auto load = [&](int n, int slot) {
    const int u = P.nk.div(n), v = P.G.div(u);
    const int item = blockIdx.x + v * gridDim.x;
    if (item >= P.items) return;
    const int grp = P.tiles.div(item), t = item - grp * P.tiles.d;
    const int mt = P.n_nt.div(t), prob = grp * P.G.d + u - v * P.G.d;
    const int m0 = mt * BM, n0 = (t - mt * P.n_nt.d) * BN;
    const int k0 = (n - u * P.nk.d) * BK;
    const uint32_t bar = full + 8 * slot, dst = ring + slot * C::SLOT;
    // B panels wholly past N are not loaded: their stale columns reach
    // only output columns past N, which the store clips
    const int np = min(C::NP, (P.N - n0 + 63) / 64);
    mbar_expect_tx(bar, A_BYTES + np * PANEL);
    tma_load_3d(dst, &P.ta, bar, k0, m0, prob);
#pragma unroll
    for (int p = 0; p < C::NP; ++p)
      if (p < np)
        tma_load_3d(dst + A_BYTES + p * PANEL, &P.tb, bar, n0 + 64 * p, k0,
                    prob);
  };

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      mbar_init(full + 8 * i, 1);
      released[i] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int n = 0; n < S; ++n) load(n, n);
  }
  __syncthreads();

  // This warp is done with load n (in `slot`): the eighth warp to say so
  // loads n + S into the slot at once.
  auto release = [&](int n, int slot) {
    __syncwarp();
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(released + slot, 1u) % 8 == 7) {
        __threadfence_block();
        fence_proxy_async();
        load(n + S, slot);
      }
    }
    __syncwarp();
  };

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // The products of the K step in ring slot `slot` (phase `phase` of its
  // barrier), issued and committed once it landed: 64 x BN += A (this
  // warpgroup's 64 rows) B, 16 of K an instruction (K past its end is zero
  // in both tiles), the first overwriting acc. Then the next slot.
  int slot = 0, phase = 0;
  auto issue = [&](bool first) {
    const uint32_t at = ring + slot * C::SLOT;
    mbar_wait(full + 8 * slot, phase);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const uint64_t da = row_desc<128>(at + wg * 64 * 128 + ks * 32);
      const uint64_t db = mn_desc(at + A_BYTES + ks * 16 * 128, PANEL);
      wgmma_ss_mn(acc, da, db, !first || ks > 0);
    }
    wgmma_commit();
    if (++slot == S) {
      slot = 0;
      phase ^= 1;
    }
  };

  // this thread's fragment rows r and r + 8 of the warpgroup's 64
  const int r = 16 * (warp % 4) + lane / 4, t4 = lane % 4;
  int n = 0, buf = 0;   // loads consumed; this tile's staging buffer
  for (int item = blockIdx.x; item < P.items; item += gridDim.x) {
    const int grp = P.tiles.div(item), t = item - grp * P.tiles.d;
    const int mt = P.n_nt.div(t);
    const int m0 = mt * BM, n0 = (t - mt * P.n_nt.d) * BN;
#pragma unroll 1
    for (int g = 0; g < P.G.d; ++g) {
      reg_fence(acc);
      int done = slot;   // the slot of the step whose products run
      issue(true);
      ++n;
#pragma unroll 1
      for (int step = 1; step < P.nk.d; ++step, ++n) {
        const int next = slot;
        issue(false);
        // the previous K step's products are done: its slot is free
        wgmma_wait<1>();
        release(n - 1, done);
        done = next;
      }
      wgmma_wait<0>();
      reg_fence(acc);
      release(n - 1, done);   // the next loads go out before the epilogue

      // Epilogue: this warpgroup's 64 x BN in bf16 into its staging buffer
      // (panel j / 8, 16-byte chunk j % 8 of row r swizzled by r % 8), then
      // one TMA store a panel; the buffer's last store done reading first.
      const uint32_t stg = stage + (wg * NSTG + buf) * C::STG;
      if (++buf == NSTG) buf = 0;
      if (threadIdx.x % 128 == 0) bulk_wait_read_n(NSTG - 1);
      warpgroup_sync(wg);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        unsigned char* c = gen + (stg - base) + (j / 8) * PANEL + r * 128 +
                           (((j % 8) ^ (r % 8)) << 4) + 4 * t4;
        *reinterpret_cast<uint32_t*>(c) = pack_bf16(acc[j][0], acc[j][1]);
        *reinterpret_cast<uint32_t*>(c + 8 * 128) =
            pack_bf16(acc[j][2], acc[j][3]);
      }
      fence_proxy_async();
      warpgroup_sync(wg);
      if (threadIdx.x % 128 == 0) {
        const int row = m0 + 64 * wg, prob = grp * P.G.d + g;
#pragma unroll
        for (int p = 0; p < C::NP; ++p)
          if (row < P.M && n0 + 64 * p < P.N)
            tma_store_3d(&P.to, stg + p * PANEL, n0 + 64 * p, row, prob);
        bulk_commit();
      }
    }
  }
  if (threadIdx.x % 128 == 0) bulk_wait_all();
}

// mm_sm90 launches since the library loaded, counted where the kernel is
// launched. Read by bench_matmul_design_launches.
std::atomic<long long> design_launches{0};

template <int BN>
int launch(const void* a, const void* b, void* o, int B, int M, int K, int N,
           int G, cudaStream_t st) {
  using C = MmCfg<BN>;
  MmParams P{};
  int err = encode_rows(&P.ta, a, B, M, K, BM);
  if (err == 0) err = encode_rows(&P.tb, b, B, K, N, BK);
  if (err == 0) err = encode_rows(&P.to, o, B, M, N, 64);
  if (err != 0) return err;
  const auto kernel = mm_sm90<BN>;
  static std::atomic<uint64_t> attr_set{0};
  int dev = 0;
  err = smem_limit_once(kernel, int(SM90_SMEM_MAX), attr_set, &dev);
  if (err != 0) return err;
  P.M = M;
  P.N = N;
  P.K = K;
  const long long m_t = (M + BM - 1LL) / BM, n_t = (N + BN - 1LL) / BN;
  const long long k_t = (K + BK - 1LL) / BK;
  // every load index of a CTA fits an int
  if (double(m_t) * n_t * B * k_t > INT_MAX)
    return int(cudaErrorInvalidValue);
  const int n_nt = int(n_t), tiles = int(m_t * n_t), nk = int(k_t);
  P.nk.set(nk);
  P.G.set(G);
  P.tiles.set(tiles);
  P.n_nt.set(n_nt);
  P.items = tiles * (B / G);
  P.stages = C::stages(nk);
  P.nstg = C::nstg(P.stages);
  const int sms = sm_count(dev);
  if (sms <= 0) return int(cudaErrorInvalidValue);
  kernel<<<P.items < sms ? P.items : sms, MM_THREADS,
           C::smem(P.stages, P.nstg), st>>>(P);
  err = int(cudaGetLastError());
  if (err == 0) design_launches.fetch_add(1, std::memory_order_relaxed);
  return err;
}

int dispatch(const void* a, const void* b, void* o, int B, int M, int K,
             int N, int G, int bm, int bn, void* stream) {
  if (B <= 0 || M <= 0 || K <= 0 || N <= 0 || G <= 0 || B % G || K % 8 ||
      N % 8)
    return int(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bm == 128 && bn == 128) return launch<128>(a, b, o, B, M, K, N, G, st);
  if (bm == 128 && bn == 256) return launch<256>(a, b, o, B, M, K, N, G, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// a (B, M, K), b (B, K, N), o (B, M, N): contiguous bf16, 16-byte aligned;
// K and N multiples of 8; block_m x block_n 128 x 128 or 128 x 256.
int bench_batched_mm(const void* a, const void* b, void* o, int B, int M,
                     int K, int N, int block_m, int block_n, void* stream) {
  return dispatch(a, b, o, B, M, K, N, 1, block_m, block_n, stream);
}

// The same, the same tile of G consecutive problems a work item; G
// divides B.
int bench_grouped_mm(const void* a, const void* b, void* o, int B, int M,
                     int K, int N, int G, int block_m, int block_n,
                     void* stream) {
  return dispatch(a, b, o, B, M, K, N, G, block_m, block_n, stream);
}

// out[0]: mm_sm90 launches (bench_batched_mm, bench_grouped_mm).
void bench_matmul_design_launches(long long* out) {
  out[0] = design_launches.load(std::memory_order_relaxed);
}

const char* bench_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
