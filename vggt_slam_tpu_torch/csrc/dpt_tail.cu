// Fused DPT output tail (sm_90a, ctypes): dpt_tail_fwd replaces
// vggt_slam_tpu/ops/dpt_tail.py _kernel (fused_tail). Per frame s and pixel
// (r, c) of the (rows_out, W) map, in f32 as the reference:
//   u(r, c)  = bf16(x[s, lo, c] + (x[s, lo + 1, c] - x[s, lo, c]) frac
//                   + pos[r, c])       align-corners row taps, 0 outside
//   h(r, c)  = bf16(relu(sum_{dr, dc, ci} u(r + dr - 1, c + dc - 1, ci)
//                        w0[dr, dc, ci, :] + b0))
//   out[:, s, r, c] = w1t h(r, c) + b1
// lo = clip(floor(r ratio), 0, rows_in - 2), frac = clip(r ratio - lo, 0,
// 1), ratio = (rows_in - 1) / (rows_out - 1). Bound at the depth head's
// shape: 270 GFLOP, 0.27 ms of tensor cores against 0.19 ms of HBM.
//
// dpt_tail_sm90<cin>: a persistent grid over 64-column strips of TR rows of
// a frame pair; warpgroup f runs frame f's products, 2 + f builds its u
// rows. u of halo row h is the A operand of m64n96k16 whose B stacks the
// three row taps, so h adds to rows h + 1, h, h - 1; no-swizzle K-major
// operands, so a column tap is a 16-byte descriptor shift (odd pitch 67
// keeps u's stores conflict-free). The leaving row gets b0, ReLU, bf16 and
// the 1x1 conv; w0 by bulk copy once a CTA, x rows by TMA two ahead.

#include <climits>

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace flash;

constexpr int TC = 64;               // output columns of a strip (wgmma M)
constexpr int HPX = TC + 2;          // halo pixels of a u row
constexpr int NPIX = 67;             // u row pitch in pixels (odd)
constexpr int LBO_U = NPIX * 16;     // bytes between u's 8-channel chunks
constexpr int CMID = 32;
constexpr int NB = 3 * CMID;         // B's N: the three row taps
constexpr int LBO_W = NB * 16;       // bytes between B's 8-channel chunks
constexpr int MAX_COUT = 4;
constexpr int MAX_CIN = 128;
// warpgroups 0, 1: the products of frames 0, 1; 2, 3: their u producers
constexpr int NTHREAD = 512;
constexpr int XROWS = 3;             // x ring: rows a frame
constexpr int WTS = 4 * CMID * 4 + CMID * 4;   // w1t (padded to 4) and b0
// mbarriers: w; the x ring's 3 slots a frame; u full and empty a frame
constexpr int NBAR = 11;

__host__ __device__ constexpr int round128(int n) { return (n + 127) & ~127; }

// Shared memory at cin channels: w0 as B, then per frame its x ring (XROWS
// rows) and its u row; the epilogue's weights, the mbarriers.
struct TailSmem {
  int wsz, xsz, usz, wg;
  __host__ __device__ explicit TailSmem(int cin)
      : wsz(3 * cin / 8 * LBO_W), xsz(round128(HPX * cin * 2)),
        usz(round128(NPIX * 2 * cin)), wg(XROWS * xsz + usz) {}
  __host__ __device__ int total() const {
    return wsz + 2 * wg + WTS + 8 * NBAR + 128;   // 128-byte alignment slack
  }
};

struct TailParams {
  CUtensorMap tx;              // x as (cin, W, S rows_in), box (cin, 66, 1)
  const __nv_bfloat16* pos;    // (rows_out, W, cin)
  const __nv_bfloat16* w0p;    // (3 cin / 8, 96, 8): `kernel_weights`
  const float* b0;             // (CMID,)
  const float* w1t;            // (cout, CMID), bf16-rounded values
  const float* b1;             // (cout,)
  float* out;                  // (cout, S, rows_out, W)
  int S, rows_in, rows_out, W, cin, cout;
  float ratio;
  int tr, nstrips, npairs, items;
};

__device__ __forceinline__ float lerp_pos(float a, float b, float frac,
                                          float pe) {
  // (a + (b - a) frac) + pe, rounded as written (no contraction)
  return __fadd_rn(__fadd_rn(a, __fmul_rn(__fsub_rn(b, a), frac)), pe);
}

// Two bf16 of each of a, b, pe (low half first) -> the two bf16 of u.
__device__ __forceinline__ uint32_t lerp2(uint32_t a, uint32_t b, float frac,
                                          uint32_t pe) {
  const float lo = lerp_pos(__uint_as_float(a << 16), __uint_as_float(b << 16),
                            frac, __uint_as_float(pe << 16));
  const float hi = lerp_pos(__uint_as_float(a & 0xFFFF0000u),
                            __uint_as_float(b & 0xFFFF0000u), frac,
                            __uint_as_float(pe & 0xFFFF0000u));
  return pack_bf16(lo, hi);
}

extern __shared__ __align__(128) unsigned char tail_raw[];

// Shared memory by its 32-bit address, as plain accesses, which the compiler
// may overlap (the barriers' asm orders them where it must).
template <typename T>
__device__ __forceinline__ T& sm(uint32_t addr) {
  return *reinterpret_cast<T*>(tail_raw + (addr - smem_addr(tail_raw)));
}

// `bytes` contiguous bytes from global src into shared dst, completing on
// mbarrier bar (a bulk copy, no tensor map).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar) : "memory");
}

// wgmma descriptor of a K-major no-swizzle operand: 8-row core matrices of
// 16-byte rows (stride byte offset 128 between 8-row groups), 8-element K
// chunks `lbo` bytes apart; layout 0; any 16-byte start.
__device__ __forceinline__ uint64_t kdesc(uint32_t addr, uint32_t lbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(lbo >> 4) << 16) |
         (uint64_t(128 >> 4) << 32);
}

// d (64 x 96 per warpgroup: n8 tiles 0-3, 4-7, 8-11 the row taps dr = 0,
// 1, 2) += A (64 x 16, smem) B (16 x 96, smem), both K-major: wgmma
// m64n96k16.
__device__ __forceinline__ void wgmma_n96(float (&d)[12][4], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : SM90_F4(d, 0), SM90_F4(d, 1), SM90_F4(d, 2), SM90_F4(d, 3),
        SM90_F4(d, 4), SM90_F4(d, 5), SM90_F4(d, 6), SM90_F4(d, 7),
        SM90_F4(d, 8), SM90_F4(d, 9), SM90_F4(d, 10), SM90_F4(d, 11)
      : "l"(da), "l"(db), "r"(1));
}

// One thread's state of dpt_tail_sm90<CIN>, its steps as inlined members
// (the accumulators and prefetched pos must stay in registers).
template <int CIN>
struct Tail {
  static constexpr int CPX = CIN / 8;                 // u chunks a pixel
  static constexpr int NITEMS = HPX * CPX;            // (pixel, chunk) items
  static constexpr int NI = (NITEMS + 127) / 128;     // items a thread
  const TailParams& P;
  TailSmem L;
  int w, f, wt, warp, g, t;   // warpgroup, its frame (w % 2)
  uint32_t wsm, wts, wbar, xbar, ufull, uempty;
  // the producer's items i = wt + 128 k: pixel i / CPX, chunk i % CPX
  uint32_t u_off;   // item 0's u offset (chunk j: j LBO_U + 16 pixel)
  uint4 pe[NI];     // the items' pos values at the next halo row
  uint32_t xpar = 0, upar = 0;   // mbarrier parities: x ring; u full/empty
  int next_row = 0;    // the next x row to load (the producer's thread 0)
  bool w_ready = false;
  // the work item: a strip of a band of the frame pair s0, s0 + 1 (nf of
  // them below S); this warpgroup's frame s0 + f
  int c0, r0, nrows, s0, nf, first, last, have;

  __device__ __forceinline__ Tail(const TailParams& p, uint32_t base)
      : P(p), L(CIN) {
    const int tid = threadIdx.x;
    // warpgroup-uniform as ptxas sees it (a broadcast within the warp)
    w = __shfl_sync(0xffffffffu, tid / 128, 0);
    f = w % 2;
    wt = tid % 128;
    warp = wt / 32;
    g = tid % 32 / 4;
    t = tid % 4;
    wsm = base;
    wts = base + L.wsz + 2 * L.wg;
    wbar = wts + WTS;
    xbar = wbar + 8 + 8 * XROWS * f;
    ufull = wbar + 8 + 16 * XROWS;
    uempty = ufull + 16;
    u_off = u_item(0);
  }
  // this warpgroup's frame's x ring and u row
  __device__ __forceinline__ uint32_t xs() const {
    return wsm + L.wsz + f * L.wg;
  }
  __device__ __forceinline__ uint32_t us() const {
    return xs() + XROWS * L.xsz;
  }

  __device__ __forceinline__ uint32_t u_item(int k) const {
    const uint32_t i = uint32_t(wt) + 128u * k;
    return i % CPX * LBO_U + i / CPX * 16;
  }
  // item k's u offset: a constant step from u_off where CPX divides 128
  __device__ __forceinline__ uint32_t u_at(int k) const {
    return 128 % CPX == 0 ? u_off + k * (128 / CPX) * 16 : u_item(k);
  }
  // item k exists (NITEMS is no multiple of 128)
  __device__ __forceinline__ bool has(int k) const {
    return (k + 1) * 128 <= NITEMS || wt + 128 * k < NITEMS;
  }

  __device__ __forceinline__ int row_lo(int r, float& frac) const {
    const float pf = __fmul_rn(static_cast<float>(r), P.ratio);
    const int lo = min(max(static_cast<int>(floorf(pf)), 0), P.rows_in - 2);
    frac = fminf(fmaxf(__fsub_rn(pf, static_cast<float>(lo)), 0.f), 1.f);
    return lo;
  }

  __device__ __forceinline__ void start(int item) {
    const int pair = item % P.npairs, rest = item / P.npairs;
    const int strip = rest % P.nstrips, band = rest / P.nstrips;
    c0 = strip * TC;
    r0 = band * P.tr;
    nrows = min(P.tr, P.rows_out - r0);
    s0 = 2 * pair;
    nf = min(2, P.S - s0);
    float frac;
    first = row_lo(max(r0 - 1, 0), frac);
    last = row_lo(min(r0 + nrows, P.rows_out - 1), frac) + 1;
    have = first - 1;
    next_row = first;
  }

  // ---- the u producers (warpgroups 2, 3) ----

  // x rows up to `upto` of frame f into its ring (one thread; the
  // producer's barrier after the last build that read a slot frees it)
  __device__ __forceinline__ void load_rows(int upto) {
    for (upto = min(upto, last); next_row <= upto; ++next_row) {
      const int slot = next_row % XROWS;
      const uint32_t b = xbar + 8 * slot;
      mbar_expect_tx(b, HPX * CIN * 2);
      tma_load_3d(xs() + slot * L.xsz, &P.tx, b, 0, c0 - 1,
                  (s0 + f) * P.rows_in + next_row);
    }
  }

  // pos of halo row h for this thread's items (zero past the image)
  __device__ __forceinline__ void load_pos(int h) {
    const bool inside = h >= 0 && h < P.rows_out;
    const __nv_bfloat16* row =
        P.pos + (size_t(inside ? h : 0) * P.W + c0 - 1) * CIN;
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      pe[k] = make_uint4(0u, 0u, 0u, 0u);
      const uint32_t i = uint32_t(wt) + 128u * k;
      const int col = c0 - 1 + int(i / CPX);
      if (inside && has(k) && col >= 0 && col < P.W)
        pe[k] = __ldg(reinterpret_cast<const uint4*>(row) + i);
    }
  }

  // u of frame f at halo row h (rows outside the image are the 3x3 conv's
  // zeros), once frame f's products have read the last one
  __device__ __forceinline__ void build(int h) {
    mbar_wait(uempty + 8 * f, (upar & 1) ^ 1);
    upar ^= 1u;
    const uint32_t u = us();
    if (h >= 0 && h < P.rows_out) {
      float fr;
      const int lo = row_lo(h, fr);
      while (have < lo + 1) {
        const int slot = ++have % XROWS;
        mbar_wait(xbar + 8 * slot, (xpar >> slot) & 1);
        xpar ^= 1u << slot;
      }
      // item i of a row of x (pixel i / CPX, chunk i % CPX) is at 16 i
      const uint32_t xa = xs() + lo % XROWS * L.xsz + 16 * wt;
      const uint32_t xb = xs() + (lo + 1) % XROWS * L.xsz + 16 * wt;
      // loads before stores, in groups (the compiler does not move a
      // load above a store to shared memory that might alias it; a group
      // of GRP items holds 8 GRP registers under the 128 of 512 threads)
      constexpr int GRP = 3;
#pragma unroll
      for (int k0 = 0; k0 < NI; k0 += GRP) {
        uint4 a[GRP], b[GRP];
#pragma unroll
        for (int k = k0; k < k0 + GRP && k < NI; ++k) {
          if (has(k)) {
            a[k - k0] = sm<const uint4>(xa + 2048 * k);
            b[k - k0] = sm<const uint4>(xb + 2048 * k);
          }
        }
#pragma unroll
        for (int k = k0; k < k0 + GRP && k < NI; ++k) {
          if (has(k))
            sm<uint4>(u + u_at(k)) = make_uint4(
                lerp2(a[k - k0].x, b[k - k0].x, fr, pe[k].x),
                lerp2(a[k - k0].y, b[k - k0].y, fr, pe[k].y),
                lerp2(a[k - k0].z, b[k - k0].z, fr, pe[k].z),
                lerp2(a[k - k0].w, b[k - k0].w, fr, pe[k].w));
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < NI; ++k)
        if (has(k)) sm<uint4>(u + u_at(k)) = make_uint4(0u, 0u, 0u, 0u);
    }
    fence_proxy_async();
    mbar_arrive(ufull + 8 * f);
  }

  // ---- the products (warpgroups 0, 1) ----

  // The products at halo row h: rows h + 1, h, h - 1 (n8 tiles 0-3, 4-7, 8-11)
  // += u(h)'s taps, 3 CIN / 16 instructions, once u(h) is written. Issue
  // blocks until the tensor cores take each instruction, so the other
  // warpgroups' work is what overlaps them.
  __device__ __forceinline__ void issue(float (&d)[12][4]) {
    if (!w_ready) {
      mbar_wait(wbar, 0);
      w_ready = true;
    }
    mbar_wait(ufull + 8 * f, upar & 1);
    upar ^= 1u;
    wgmma_fence();
    const uint64_t da = kdesc(us(), LBO_U), db = kdesc(wsm, LBO_W);
#pragma unroll
    for (int dc = 0; dc < 3; ++dc) {
#pragma unroll
      for (int kk = 0; kk < CIN / 16; ++kk)   // start addresses in 16 bytes
        wgmma_n96(d, da + (2 * kk * LBO_U + dc * 16) / 16,
                  db + (dc * CPX + 2 * kk) * LBO_W / 16);
    }
    wgmma_commit();
  }

  // The rows move up a halo row after the products (h - 2 <- h - 1, finished;
  // h - 1 <- h; h <- h + 1; h + 1 <- 0): wgmma wants its 48 sums in one
  // register range, so values move, by volatile instructions after the wait.
  // As SSA renamings the loop's phi copies read the sums while the next
  // products were in flight, and ptxas serialized every wgmma.
  __device__ __forceinline__ static void shift(float (&d)[16][4]) {
#pragma unroll
    for (int j = 0; j < 12; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("mov.b32 %0, %1;"
                     : "=f"(d[15 - j][e]) : "f"(d[11 - j][e]));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        asm volatile("mov.b32 %0, 0;" : "=f"(d[j][e]));
    }
  }

  // Output row `row` is complete: add b0, ReLU, round to bf16, reduce the 1x1
  // conv across the four lanes of a pixel, lane t keeping output channel t of
  // its two pixels (lane (g, t): pixels 16 warp + g (e < 2), + 8 (e >= 2), mid
  // channels 8j + 2t + (e & 1)).
  __device__ __forceinline__ void finish(const float (&d)[4][4], int row) {
    if (row < r0 || row >= r0 + nrows) return;
    float plo[MAX_COUT] = {0.f, 0.f, 0.f, 0.f};
    float phi[MAX_COUT] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = 8 * j + 2 * t;
      const float2 bias = sm<const float2>(wts + 4 * CMID * 4 + m * 4);
      float hv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        hv[e] = __bfloat162float(__float2bfloat16(
            fmaxf(d[j][e] + (e % 2 ? bias.y : bias.x), 0.f)));
#pragma unroll
      for (int o = 0; o < MAX_COUT; ++o) {   // rows past cout are zero
        const float2 wv = sm<const float2>(wts + (o * CMID + m) * 4);
        plo[o] = fmaf(hv[0], wv.x, fmaf(hv[1], wv.y, plo[o]));
        phi[o] = fmaf(hv[2], wv.x, fmaf(hv[3], wv.y, phi[o]));
      }
    }
    const float b1 = t < P.cout ? __ldg(P.b1 + t) : 0.f;
    const int col = c0 + 16 * warp + g;
    float* dst =
        P.out + ((size_t(t) * P.S + s0 + f) * P.rows_out + row) * P.W;
    const float vlo = quad_scatter(plo), vhi = quad_scatter(phi);
    if (t < P.cout) {
      if (col < P.W) dst[col] = vlo + b1;
      if (col + 8 < P.W) dst[col + 8] = vhi + b1;
    }
  }

  // Reduce-scatter over the quad: lane t ends with the quad's sum of p[t].
  __device__ __forceinline__ float quad_scatter(const float (&p)[4]) const {
    const bool b2 = t & 2, b1 = t & 1;
    float k0 = b2 ? p[2] : p[0], k1 = b2 ? p[3] : p[1];
    k0 += __shfl_xor_sync(0xffffffffu, b2 ? p[0] : p[2], 2);
    k1 += __shfl_xor_sync(0xffffffffu, b2 ? p[1] : p[3], 2);
    return (b1 ? k1 : k0) + __shfl_xor_sync(0xffffffffu, b1 ? k0 : k1, 1);
  }
};

template <int CIN>
__global__ void __launch_bounds__(NTHREAD, 1)
    dpt_tail_sm90(const __grid_constant__ TailParams P) {
  Tail<CIN> T(P, (smem_addr(tail_raw) + 127) & ~127u);
  if (threadIdx.x == 0) {
    for (int i = 0; i < NBAR; ++i)   // u full, empty: the 128 threads of
      mbar_init(T.wbar + 8 * i, i < 1 + 2 * XROWS ? 1 : 128);   // one side
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(T.wbar, T.L.wsz);
    bulk_load(T.wsm, P.w0p, T.L.wsz, T.wbar);
  }
  // the epilogue's weights: w1t as 4 x CMID (zero past cout), then b0
  for (int i = threadIdx.x; i < 5 * CMID; i += NTHREAD) {
    const int o = i / CMID;
    sm<float>(T.wts + 4 * i) = o == 4 ? P.b0[i % CMID]
                               : o < P.cout ? P.w1t[i] : 0.f;
  }
  __syncthreads();
  if (T.w >= 2) {
    // u of frame f, halo row by halo row, x two rows ahead
    for (int item = blockIdx.x; item < P.items; item += gridDim.x) {
      T.start(item);
      if (T.f >= T.nf) continue;
      const int hb = T.r0 - 1, hl = T.r0 + T.nrows;
      if (T.wt == 0) T.load_rows(T.first + XROWS - 1);
      T.load_pos(hb);
      for (int h = hb; h <= hl; ++h) {
        T.build(h);
        if (h < hl) T.load_pos(h + 1);
        warpgroup_sync(T.w);   // the ring's rows below lo(h + 1) read
        if (T.wt == 0) {
          float fr;
          T.load_rows(T.row_lo(min(h + 1, P.rows_out - 1), fr) + 2);
        }
      }
    }
    return;
  }
  // the products of frame f: [n8 tile: rows h + 1, h, h - 1 (the 48 sums
  // of the products), h - 2][fragment]
  float acc[16][4];
  float(&mma)[12][4] = *reinterpret_cast<float(*)[12][4]>(acc[0]);
  float(&done)[4][4] = *reinterpret_cast<float(*)[4][4]>(acc[12]);
  for (int item = blockIdx.x; item < P.items; item += gridDim.x) {
    T.start(item);
    if (T.f >= T.nf) continue;
    const int hb = T.r0 - 1, hl = T.r0 + T.nrows;   // halo rows hb ... hl
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    for (int h = hb; h <= hl; ++h) {
      T.issue(mma);
      wgmma_wait<0>();
      mbar_arrive(T.uempty + 8 * T.f);   // u(h) read
      Tail<CIN>::shift(acc);
      T.finish(done, h - 1);   // while the other frame's products run
    }
  }
}

// dpt_tail_sm90 launches since the library loaded, counted where the
// kernel is launched. Read by dpt_tail_design_launches.
std::atomic<long long> design_launches{0};

// The band height: the TR that gives the least rounds of items over the
// grid times the halo rows (TR + 2) and a fill of two a band.
int band_rows(int rows_out, int nstrips, int npairs, int sms) {
  long long best = LLONG_MAX;
  int tr_best = rows_out;
  for (int tr = 4; tr <= rows_out; ++tr) {
    const long long items =
        (long long)((rows_out + tr - 1) / tr) * nstrips * npairs;
    const long long cost = (items + sms - 1) / sms * (tr + 4);
    if (cost < best) {
      best = cost;
      tr_best = tr;
    }
  }
  return tr_best;
}

}  // namespace

extern "C" {

// x (S, rows_in, W, cin), pos (rows_out, W, cin): contiguous 16-byte aligned
// bf16; w0p: kernel_weights(w0), (3 cin / 8, 96, 8) bf16; b0 (cmid,), w1t
// (cout, cmid), b1 (cout,), out (cout, S, rows_out, W) f32. cin 32-128 by 32,
// cmid 32, cout 1-4.
int dpt_tail_fwd(const void* x, const void* pos, const void* w0p,
                 const void* b0, const void* w1t, const void* b1, void* out,
                 int S, int rows_in, int rows_out, int W, int cin, int cmid,
                 int cout, float ratio, void* stream) {
  if (cmid != CMID || cin % 32 != 0 || cin < 32 || cin > MAX_CIN ||
      cout < 1 || cout > MAX_COUT || rows_in < 2 || rows_out < 2 || W < 1 ||
      S < 1)
    return int(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(pos) |
       reinterpret_cast<uintptr_t>(w0p)) % 16 != 0)
    return int(cudaErrorMisalignedAddress);
  TailParams P{};
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cuuint64_t(cin), cuuint64_t(W),
                              cuuint64_t(S) * rows_in};
  const cuuint64_t strides[2] = {cuuint64_t(cin) * 2,
                                 cuuint64_t(cin) * 2 * W};
  const cuuint32_t box[3] = {cuuint32_t(cin), cuuint32_t(HPX), 1};
  const cuuint32_t step[3] = {1, 1, 1};
  if (encode(&P.tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(x),
             dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return int(cudaErrorInvalidValue);
  void (*const kernel)(TailParams) = cin == 32   ? dpt_tail_sm90<32>
                                     : cin == 64 ? dpt_tail_sm90<64>
                                     : cin == 96 ? dpt_tail_sm90<96>
                                                 : dpt_tail_sm90<128>;
  static std::atomic<uint64_t> attr_set[4];
  int dev = 0;
  int err = smem_limit_once(kernel, int(SM90_SMEM_MAX),
                            attr_set[cin / 32 - 1], &dev);
  if (err != 0) return err;
  const int sms = sm_count(dev);
  if (sms <= 0) return int(cudaErrorInvalidValue);
  P.pos = static_cast<const __nv_bfloat16*>(pos);
  P.w0p = static_cast<const __nv_bfloat16*>(w0p);
  P.b0 = static_cast<const float*>(b0);
  P.w1t = static_cast<const float*>(w1t);
  P.b1 = static_cast<const float*>(b1);
  P.out = static_cast<float*>(out);
  P.S = S;
  P.rows_in = rows_in;
  P.rows_out = rows_out;
  P.W = W;
  P.cin = cin;
  P.cout = cout;
  P.ratio = ratio;
  P.nstrips = (W + TC - 1) / TC;
  P.npairs = (S + 1) / 2;
  P.tr = band_rows(rows_out, P.nstrips, P.npairs, sms);
  const long long items = (long long)((rows_out + P.tr - 1) / P.tr) *
                          P.nstrips * P.npairs;
  if (items > INT_MAX) return int(cudaErrorInvalidValue);
  P.items = int(items);
  kernel<<<P.items < sms ? P.items : sms, NTHREAD, TailSmem(cin).total(),
           static_cast<cudaStream_t>(stream)>>>(P);
  err = int(cudaGetLastError());
  if (err == 0) design_launches.fetch_add(1, std::memory_order_relaxed);
  return err;
}

// out[0]: dpt_tail_sm90 launches.
void dpt_tail_design_launches(long long* out) {
  out[0] = design_launches.load(std::memory_order_relaxed);
}

const char* dpt_tail_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
