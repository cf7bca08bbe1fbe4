// Paged MLA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_paged_mla_kernel` / `paged_mla_attention`
// in src/repro/kernels/paged_attention.py.
//
// What it computes, for each sequence b and head n of a DeepSeek-V3 MLA
// decode step (W_kb is absorbed into the query outside the kernel, W_vb
// applies after it):
//   s_t = scale * (q_lat[n] . c_kv[t] + q_rope[n] . k_rope[t]),
//         masked to NEG_INF where t > pos[b];
//   online softmax over the sequence's pages (running m, l, acc in fp32);
//   out[n] = acc / max(l, 1e-30): the latent context [R] in fp32.
//
// What bounds it on an H100: bytes.  At B 16, N 128, R 512, Hr 64 and
// positions up to 2047 it reads about 19 MB of latent pages and writes 4 MB
// of context; the 9 GFLOP of products are about 240 operations a byte of
// pool, under the bf16 tensor cores' ridge (about 295), so on tensor cores
// the bytes set the pace (the fp32 CUDA cores, at 67 TFLOP/s, would need
// 0.14 ms for the products alone).
//
// What the design does about it:
//  * MLA is multi-query in latent space: every head scores against the
//    same page.  One block owns (64 heads, sequence b, split z), so both
//    products are wgmma tiles with M = 64 heads, and at N 128 two blocks
//    read each page (the second from L2).
//  * Three warpgroups: the producer (one thread) feeds a ring of 4 stages
//    of 2 pages (32 tokens, 36 KB at full width) through TMA and
//    mbarriers, so up to 8 pages are in flight; the two consumers split R
//    (256 latent columns each: a 64 x 256 fp32 accumulator, 128 registers
//    a thread; setmaxnreg moves registers from the producer to them).
//  * Scores S = [q_lat | q_rope] [c_kv | k_rope]^T (K = R + 64: the rope
//    half is zero-padded by the tensor map) with m64n32k16, Q and the page
//    tile from shared memory, K-major.  Each consumer computes the whole S
//    tile and its softmax itself (both get the same bits), which costs
//    tensor time the bytes leave free and saves a barrier a stage.
//  * Context O += P c_kv with P from registers and c_kv as the B operand,
//    MN-major through the transpose bit.  P is split into a bf16 high part
//    and a bf16 low part (lo = bf16(p - hi)), two wgmmas into the same fp32
//    accumulator: a single bf16 P misses the fp32 output's 1e-3 tolerance
//    at full width (about 3.6e-3), hi + lo lands near 1e-5.  The row sums l
//    come from the unrounded fp32 p.
//  * Overlap: stage i's S is in flight with stage i - 1's P c_kv while the
//    softmax of stage i runs; a stage is released to the producer as soon
//    as its P c_kv has landed.
//  * Split over pages (flash-decoding): split z scores pages
//    [z * split_pages, (z + 1) * split_pages) of the sequence; the host
//    picks split_pages from shapes only (B, N, pps and the SM count; never
//    from pos, which would cost a device sync).  With one split the block
//    writes the normalised context itself (one launch); with more, each
//    split writes its unnormalised context and (m, l) to scratch the
//    wrapper allocates, and paged_mla_combine merges them in a second
//    launch.  Blocks past the sequence's last page exit at once.
//  * Both pools are read in place through their own tensor maps: no
//    concatenation and no padding copy of R, Hr or N (rows at or past N
//    and columns past R or Hr fall outside the maps and arrive as zeros,
//    so 0 x garbage is never NaN; rows at or past N are not stored).
//  * The page loop stops at page pos[b] / P.  Sentinel table entries are
//    clipped as the reference's wrapper does, and masked by pos; the
//    second page of a split's last stage, past the split, is masked too.
//  * The masked sentinel stays the finite NEG_INF = -1e30.  The softmax
//    runs in base 2: the scale folds log2(e) in, and (m, l) in the split
//    scratch are in that base.
//  * The merge launch is a programmatic dependent of the partial grid: it
//    is scheduled while the partial blocks run and waits in
//    griddepcontrol.wait for their writes, so its launch latency hides.
// Instances: full width (N 128, R 512, Hr 64: two consumers) and smoke
// width (N 4, R 32, Hr 16: one consumer, m64n64 context over the
// zero-padded half).  ptxas (CUDA 12.8, -O3, sm_90a): 168 registers a
// thread at launch for the full-width instance (setmaxnreg then gives the
// consumers 240 and the producer 24), 96 for the smoke instance, 32 for
// the merge; no spills and no stack frame.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int P = 16;              // tokens per page
constexpr int PAGES = 2;           // pages per ring stage
constexpr int TOK = P * PAGES;     // tokens per stage: N of the score tile
constexpr int BH = 64;             // heads per block: M of both products
constexpr int ROWB = 128;          // one swizzled box row: 64 bf16

template <int R, int HR>
struct Cfg {
  static_assert(R == 32 || R % 128 == 0, "R is 32 or a multiple of 128");
  static_assert(HR % 8 == 0 && HR <= 64, "the rope part fits one half");
  static constexpr int CW = (R + 63) / 64;         // 64-column halves of c_kv
  static constexpr int KH = CW + 1;                // ... plus the rope half
  static constexpr int NC = R >= 512 ? 2 : 1;      // consumer warpgroups
  static constexpr int RW = R / NC;                // latent columns each
  static constexpr int NCH = RW >= 128 ? RW / 128 : 1;   // context wgmmas
  static constexpr int OW = RW >= 128 ? 64 : 32;   // accumulator regs each
  static constexpr int NT = 128 * (NC + 1);
  static constexpr int ST = 4;                     // ring stages
  static constexpr int HALF = TOK * ROWB;          // one half of a stage
  static constexpr int STAGE = KH * HALF;
  static constexpr int Q_BYTES = KH * BH * ROWB;
  static constexpr int S_OFF = Q_BYTES;
  static constexpr int BAR_OFF = S_OFF + ST * STAGE;
  // q, then full and empty per stage; 1024 of slack to align
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * ST) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.  A
// wait of more than ~10 s traps (a launch error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > 20000000000ll) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets in 16-byte units
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma boundary
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(float (&d)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i) fence_regs(d[i]);
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// 2^x on the MUFU unit (results below 2^-126 flush to zero: such a p adds
// nothing to l or to the context at fp32 precision)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64 x 32] (+)= A[64 x 16] * B[16 x 32], A and B from shared memory
// (K-major descriptors); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the
// mma.m16n8k16 A layout, warp w rows 16w..16w+15), B from shared memory
// MN-major (transpose bit set)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 128] += A[64 x 16] * B[16 x 128], as above
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Accumulator layout of wgmma m64nNk16 (fp32), per warpgroup: warp w of
// the group owns rows 16w..16w+15; with lane = 4g + t, d[4j + i] is row
// 16w + g + 8 * (i >> 1), column 8j + 2t + (i & 1).  So two neighbouring
// 8-column groups of S are the register A fragment of P over those 16
// tokens (a0 row g, a1 row g + 8, a2 / a3 the next 8 tokens).
template <int R, int HR>
__global__ void __launch_bounds__(Cfg<R, HR>::NT, 1)
paged_mla_partial(const __grid_constant__ CUtensorMap tm_ql,   // [B, N, R]
                  const __grid_constant__ CUtensorMap tm_qr,   // [B, N, HR]
                  const __grid_constant__ CUtensorMap tm_ckv,  // [n_pages*P, R]
                  const __grid_constant__ CUtensorMap tm_kr,   // [n_pages*P, HR]
                  const int32_t* __restrict__ tbl,             // [B, pps]
                  const int32_t* __restrict__ pos,             // [B]
                  float* __restrict__ out,                     // [B, N, R]
                  float* __restrict__ part_acc,                // [B, S, N, R]
                  float* __restrict__ part_ml,                 // [B, S, N, 2]
                  int N, int n_pages, int pps, int split_pages,
                  float scale_log2) {
  using C = Cfg<R, HR>;
  const int tile = blockIdx.x, b = blockIdx.y, split = blockIdx.z;
  const int p_b = pos[b];
  int n_iter = p_b / P + 1;
  if (n_iter > pps) n_iter = pps;
  const int j0 = split * split_pages;
  const int j1 = min(j0 + split_pages, n_iter);
  // the merge launch may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (j0 >= j1) return;                 // past this sequence's last page
  const int n_st = (j1 - j0 + PAGES - 1) / PAGES;
  const int last = min(p_b, j1 * P - 1);   // last position this split sees

  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sS = base + C::S_OFF;
  const uint32_t bar_q = base + C::BAR_OFF;
  auto bar_f = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_e = [&](int s) { return bar_q + 8 * (1 + C::ST + s); };

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::ST; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), 4 * C::NC);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == C::NC) {
    // ---- producer: one thread keeps the ring full ----
    if constexpr (C::NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == C::NC * 128) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int h = 0; h < C::CW; ++h)
        tma_load_3d(sQ + h * BH * ROWB, &tm_ql, h * 64, tile * BH, b, bar_q);
      tma_load_3d(sQ + C::CW * BH * ROWB, &tm_qr, 0, tile * BH, b, bar_q);
      const int32_t* trow = tbl + (size_t)b * pps;
      for (int i = 0; i < n_st; ++i) {
        const int s = i % C::ST;
        // the (i / ST)-th release of stage s
        if (i >= C::ST) mbar_wait(bar_e(s), ((i / C::ST) & 1) ^ 1);
        mbar_expect_tx(bar_f(s), C::STAGE);
        const uint32_t st = sS + s * C::STAGE;
        for (int pg = 0; pg < PAGES; ++pg) {
          // a slot past the split still loads a real page (masked below)
          int page = trow[min(j0 + i * PAGES + pg, pps - 1)];
          page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
          for (int h = 0; h < C::CW; ++h)
            tma_load_2d(st + h * C::HALF + pg * P * ROWB, &tm_ckv, h * 64,
                        page * P, bar_f(s));
          tma_load_2d(st + C::CW * C::HALF + pg * P * ROWB, &tm_kr, 0,
                      page * P, bar_f(s));
        }
      }
    }
    return;
  }

  // ---- consumers: all 64 heads, latent columns [wg * RW, (wg + 1) * RW) --
  if constexpr (C::NC > 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float o[C::NCH][C::OW];
#pragma unroll
  for (int c = 0; c < C::NCH; ++c)
#pragma unroll
    for (int i = 0; i < C::OW; ++i) o[c][i] = 0.f;
  float s[TOK / 2];                    // one stage's scores, then its fp32 P
#pragma unroll
  for (int i = 0; i < TOK / 2; ++i) s[i] = 0.f;
  uint32_t ph[TOK / 16][4], pl[TOK / 16][4];   // P = hi + lo in bf16

  // S = [q_lat | q_rope] [c_kv | k_rope]^T for stage i: 64 heads x 32
  // tokens, 16 columns a step (issued, not waited for)
  auto issue_s = [&](int i) {
    const uint32_t st = sS + (i % C::ST) * C::STAGE;
#pragma unroll
    for (int kk = 0; kk < C::KH * 4; ++kk)
      wgmma_ss_n32(
          s, sw128_desc(sQ + (kk / 4) * BH * ROWB + (kk % 4) * 32, 16, 1024),
          sw128_desc(st + (kk / 4) * C::HALF + (kk % 4) * 32, 16, 1024),
          kk > 0);
  };
  // O += (P_hi + P_lo) c_kv for stage i: 16 tokens a step, c_kv MN-major
  auto issue_pv = [&](int i) {
    const uint32_t st = sS + (i % C::ST) * C::STAGE;
    const uint32_t col0 = st + wg * (C::RW / 64) * C::HALF;
#pragma unroll
    for (int kk = 0; kk < TOK / 16; ++kk)
#pragma unroll
      for (int c = 0; c < C::NCH; ++c) {
        const uint64_t d = sw128_desc(col0 + 2 * c * C::HALF + kk * 16 * ROWB,
                                      C::HALF, 1024);
        wgmma_rs(o[c], ph[kk], d);
        wgmma_rs(o[c], pl[kk], d);
      }
  };
  // scale (base 2) and mask the scores of stage i, then the online
  // softmax: new row maxima m, their correction corr, P in s (fp32), sums
  // in l (each lane's share of its two rows)
  auto softmax = [&](int i) {
    const int tok0 = (j0 + i * PAGES) * P;
#pragma unroll
    for (int e = 0; e < TOK / 2; ++e) s[e] *= scale_log2;
    if (tok0 + TOK - 1 > last) {
#pragma unroll
      for (int j = 0; j < TOK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (tok0 + 8 * j + 2 * t4 + (e & 1) > last) s[4 * j + e] = kNegInf;
    }
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < TOK / 8; ++j) {
      mt[0] = fmaxf(mt[0], fmaxf(s[4 * j], s[4 * j + 1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(kFull, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(kFull, mt[h], 2));
      corr[h] = ex2(m[h] - mt[h]);
      m[h] = mt[h];
    }
#pragma unroll
    for (int j = 0; j < TOK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(s[4 * j + e] - m[e >> 1]);
        s[4 * j + e] = p;
        ps[e >> 1] += p;
      }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < TOK / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float a = s[8 * kk + 2 * q], c = s[8 * kk + 2 * q + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(a, c);
        const float2 hf = __bfloat1622float2(hi);
        ph[kk][q] = bits(hi);
        pl[kk][q] = bits(__floats2bfloat162_rn(a - hf.x, c - hf.y));
      }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int j = 0; j < C::OW / 4; ++j) {
        o[c][4 * j] *= corr[0];
        o[c][4 * j + 1] *= corr[0];
        o[c][4 * j + 2] *= corr[1];
        o[c][4 * j + 3] *= corr[1];
      }
  };
  auto phase = [](int i) { return (i / C::ST) & 1; };

  mbar_wait(bar_q, 0);
  mbar_wait(bar_f(0), 0);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0);
  pack_p();
  for (int i = 1; i < n_st; ++i) {
    mbar_wait(bar_f(i % C::ST), phase(i));
    // the products read o, ph and pl: their last writes stay above the fence
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    wgmma_fence();
    issue_s(i);
    wgmma_commit();
    issue_pv(i - 1);
    wgmma_commit();
    wgmma_wait<1>();            // S of stage i has landed
    fence_regs(s);
    softmax(i);
    wgmma_wait<0>();            // P c_kv of stage i - 1 too
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    if (lane == 0) mbar_arrive(bar_e((i - 1) % C::ST));
    rescale_o();
    pack_p();
  }
  fence_regs(o);
  fence_regs(ph);
  fence_regs(pl);
  wgmma_fence();
  issue_pv(n_st - 1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(o);

  // one split: normalise and write the context; several: write this
  // split's unnormalised context and its (m, l) for paged_mla_combine
  const bool whole = gridDim.z == 1;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const int head = tile * BH + warp * 16 + g + 8 * h;
    if (head >= N) continue;
    const float d = whole ? fmaxf(l[h], 1e-30f) : 1.f;
    float* orow = whole ? out + ((size_t)b * N + head) * R
                        : part_acc + (((size_t)b * gridDim.z + split) * N +
                                      head) * R;
#pragma unroll
    for (int c = 0; c < C::NCH; ++c)
#pragma unroll
      for (int j = 0; j < C::OW / 4; ++j) {
        const int col = wg * C::RW + c * 128 + 8 * j + 2 * t4;
        if (R % 64 == 0 || col < R)
          *reinterpret_cast<float2*>(orow + col) =
              make_float2(o[c][4 * j + 2 * h] / d, o[c][4 * j + 2 * h + 1] / d);
      }
    if (!whole && wg == 0 && t4 == 0)
      *reinterpret_cast<float2*>(
          part_ml + (((size_t)b * gridDim.z + split) * N + head) * 2) =
          make_float2(m[h], l[h]);
  }
}

// Merge the splits of one (sequence, head), in base 2: M = max m_s,
// out = sum_s acc_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M), 1e-30), over
// the splits that held pages of the sequence.  One thread per column pair.
template <int R>
__global__ void paged_mla_combine(const float* __restrict__ part_acc,
                                  const float* __restrict__ part_ml,
                                  const int32_t* __restrict__ pos,
                                  float* __restrict__ out, int N, int pps,
                                  int split_pages, int S) {
  const int h = blockIdx.x, b = blockIdx.y;
  int n_iter = pos[b] / P + 1;
  if (n_iter > pps) n_iter = pps;
  const int used = (n_iter + split_pages - 1) / split_pages;
  // launched early (programmatic dependent launch): the partials are
  // complete and visible only after this
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* ml = part_ml + ((size_t)b * S * N + h) * 2;
  float mx = kNegInf;
#pragma unroll 4
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, ml[(size_t)s * N * 2]);
  float den = 0.f;
  float2 num = make_float2(0.f, 0.f);
  const int c = 2 * threadIdx.x;
#pragma unroll 4
  for (int s = 0; s < used; ++s) {
    const float w = exp2f(ml[(size_t)s * N * 2] - mx);
    den += ml[(size_t)s * N * 2 + 1] * w;
    const float2 a = *reinterpret_cast<const float2*>(
        part_acc + (((size_t)b * S + s) * N + h) * R + c);
    num.x = fmaf(a.x, w, num.x);
    num.y = fmaf(a.y, w, num.y);
  }
  den = fmaxf(den, 1e-30f);
  *reinterpret_cast<float2*>(out + ((size_t)b * N + h) * R + c) =
      make_float2(num.x / den, num.y / den);
}

// Launch `kernel` behind the grid just launched on `stream`, allowed to be
// scheduled before that grid ends (programmatic dependent launch): the
// kernel's griddepcontrol.wait holds it until the grid's writes are visible,
// and the launch's own latency overlaps the grid's tail.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), dim3 grid, int block,
                             cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(block);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// cuTensorMapEncodeTiled, reached through the runtime's entry-point query
// so the library needs no link against libcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor of `rank` dims (innermost first, row strides in bytes) as
// a tensor map with 128-byte swizzle; a box is 64 inner elements (one
// swizzled row, zero-filled past dims[0]) by box[1..] of the rest.
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides,
              const cuuint32_t* box) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int R, int HR>
cudaError_t launch(const void* q_lat, const void* q_rope, const void* ckv,
                   const void* krope, const void* tbl, const void* pos,
                   void* out, void* part_acc, void* part_ml, int B, int N,
                   int n_pages, int pps, int split_pages, float scale,
                   cudaStream_t stream) {
  using C = Cfg<R, HR>;
  // set on every call: an attribute set once from one host thread is not
  // in effect in another
  {
    cudaError_t err = cudaFuncSetAttribute(
        paged_mla_partial<R, HR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::SMEM);
    if (err != cudaSuccess) return err;
  }
  const int S = (pps + split_pages - 1) / split_pages;
  const cuuint64_t ql_dims[3] = {(cuuint64_t)R, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t ql_str[2] = {(cuuint64_t)R * 2, (cuuint64_t)N * R * 2};
  const cuuint64_t qr_dims[3] = {(cuuint64_t)HR, (cuuint64_t)N, (cuuint64_t)B};
  const cuuint64_t qr_str[2] = {(cuuint64_t)HR * 2, (cuuint64_t)N * HR * 2};
  const cuuint32_t q_box[3] = {64, BH, 1};
  const cuuint64_t ck_dims[2] = {(cuuint64_t)R, (cuuint64_t)n_pages * P};
  const cuuint64_t ck_str[1] = {(cuuint64_t)R * 2};
  const cuuint64_t kr_dims[2] = {(cuuint64_t)HR, (cuuint64_t)n_pages * P};
  const cuuint64_t kr_str[1] = {(cuuint64_t)HR * 2};
  const cuuint32_t page_box[2] = {64, P};
  CUtensorMap mql, mqr, mck, mkr;
  if (!make_map(&mql, q_lat, 3, ql_dims, ql_str, q_box) ||
      !make_map(&mqr, q_rope, 3, qr_dims, qr_str, q_box) ||
      !make_map(&mck, ckv, 2, ck_dims, ck_str, page_box) ||
      !make_map(&mkr, krope, 2, kr_dims, kr_str, page_box))
    return cudaErrorInvalidValue;
  dim3 grid((N + BH - 1) / BH, B, S);
  paged_mla_partial<R, HR><<<grid, C::NT, C::SMEM, stream>>>(
      mql, mqr, mck, mkr, static_cast<const int32_t*>(tbl),
      static_cast<const int32_t*>(pos), static_cast<float*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), N, n_pages,
      pps, split_pages, scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return launch_dependent(paged_mla_combine<R>, dim3(N, B), R / 2, stream,
                          static_cast<const float*>(part_acc),
                          static_cast<const float*>(part_ml),
                          static_cast<const int32_t*>(pos),
                          static_cast<float*>(out), N, pps, split_pages, S);
}

}  // namespace

extern "C" {

// Shapes the kernel is instantiated for: deepseek-v3 at full width (128
// heads, R 512, Hr 64) and at its smoke width (4 heads, R 32, Hr 16), pages
// of 16.  The Python wrapper raises on anything else before launching.
int repro_paged_mla_supported(int N, int R, int HR, int page) {
  return page == P && ((N == 128 && R == 512 && HR == 64) ||
                       (N == 4 && R == 32 && HR == 16));
}

// q_lat [B, N, R], q_rope [B, N, HR], pool_ckv [n_pages, P, R], pool_krope
// [n_pages, P, HR] bf16 (contiguous, 16-byte aligned), tbl [B, pps] int32,
// pos [B] int32, out [B, N, R] fp32.  The table runs in S = ceil(pps /
// split_pages) splits (split_pages even, from the host's plan); with S > 1,
// part_acc [B, S, N, R] and part_ml [B, S, N, 2] fp32 scratch (unused, and
// may be null, with one).  Launches on `stream` (a second launch merges
// the splits when S > 1) and returns cudaGetLastError() (0 = launched;
// cudaErrorInvalidValue when a tensor map cannot be made).
int repro_paged_mla_attention(const void* q_lat, const void* q_rope,
                              const void* pool_ckv, const void* pool_krope,
                              const void* tbl, const void* pos, void* out,
                              void* part_acc, void* part_ml, int B, int N,
                              int R, int HR, int page, int n_pages, int pps,
                              int split_pages, float scale, void* stream) {
  if (B <= 0 || B >= 65536 || pps <= 0 || n_pages <= 0 ||
      split_pages <= 0 || split_pages % PAGES != 0 ||
      (pps + split_pages - 1) / split_pages >= 65536 ||
      !repro_paged_mla_supported(N, R, HR, page))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 512)
    return (int)launch<512, 64>(q_lat, q_rope, pool_ckv, pool_krope, tbl,
                                pos, out, part_acc, part_ml, B, N, n_pages,
                                pps, split_pages, scale, s);
  return (int)launch<32, 16>(q_lat, q_rope, pool_ckv, pool_krope, tbl, pos,
                             out, part_acc, part_ml, B, N, n_pages, pps,
                             split_pages, scale, s);
}

}  // extern "C"
