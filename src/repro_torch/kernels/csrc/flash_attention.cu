// Flash attention (full-sequence forward) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/attention.py (reached through `flash_attention_bshd`,
// src/repro/kernels/ops.py).
//
// What it computes: the self-attention of `gqa_forward`, in the reference's
// BSHD layout.  q [B, Sq, Nq, H], k/v [B, Skv, Nkv, H] bf16; query head
// n*G + g reads kv head n (G = Nq / Nkv).  For query row i and key j:
//   s_ij = (q_i . k_j) / sqrt(H), NEG_INF where j >= Skv, where j > i
//   (causal) or where j <= i - window (window > 0);
//   online softmax over key tiles (running m, l, acc in fp32);
//   out_i = acc / max(l, 1e-30), written as bf16.
//
// What bounds it on an H100: operations.  A causal (sequence, query head)
// at S = 2048, H = 64 does 4 * S^2 * H / 2 = 537 MFLOP and moves its q and
// o rows plus a quarter of its kv head's k and v rows (G = 4), 655 KB:
// about 820 FLOPs a byte, past the card's ~295 (bf16 tensor cores over
// HBM).  At H = 64 the exponentials weigh as much: one exp2 per (row,
// key) at 16 a clock on an SM's MUFU units take as long as the products
// at the tensor cores' peak.
//
// What the design does about it (the shape of a Hopper kernel):
//  * one block per (128-row query tile, query head, sequence), three
//    warpgroups: consumers 0 and 1 own 64 query rows each, warpgroup 2 is
//    the producer, of which one thread issues every load.  setmaxnreg moves
//    registers from the producer (24) to the consumers (240);
//  * TMA loads: q once, then k and v tiles of 128 keys into a ring of 4
//    (H 64) or 2 (H 128) stages, each signalled by its own mbarrier (k and
//    v apart, so S = Q K^T starts before v lands) and released through an
//    `empty` mbarrier when both consumers are done with it.  The tensor
//    maps are 4-D [B, S, N, H] views of the BSHD tensors with 128-byte
//    swizzle, 64 head elements a box row (H 128 loads two halves); rows
//    past Sq and keys past Skv fall outside the map and arrive as zeros,
//    so 0 x garbage is never NaN;
//  * both products on wgmma: S = Q K^T (m64n128k16, Q and K from shared
//    memory, K-major) and O += P V (A = P from registers in bf16, V from
//    shared memory MN-major through the transpose bit).  The row sums l
//    use the unrounded fp32 P;
//  * overlap: within a consumer, tile i's Q K^T and tile i - 1's P V are
//    issued together and tile i's softmax runs while P V is in flight;
//    between the consumers, named barriers hand the turn to issue products
//    back and forth (ping-pong), so one's products run while the other's
//    softmax does.  The softmax is issue-bound, so it spends as few
//    instructions as its fixed arithmetic allows (x = s * scale rounded
//    once, p = exp2(x - m); folding the scale into the exponent's FFMA
//    moved the forward's greedy tokens against the decode replay): edge
//    masks as one compare pair an element, exp2 as one MUFU op (ftz), and
//    no rescale of O when no row maximum moved;
//  * GQA by index (kv head = query head / G): no repeated K/V copy, and no
//    transpose: the tensor maps read the BSHD layout through its strides;
//  * no padding: the kernel masks keys >= Skv itself and does not store
//    rows >= Sq; masks are evaluated on edge tiles only;
//  * key tiles wholly above the causal diagonal or wholly before the
//    window are skipped (they contribute exact zeros in the reference), and
//    the query tiles with the most keys are scheduled first (grid.z);
//  * the masked sentinel stays the finite NEG_INF = -1e30, as in the Pallas
//    kernel: a row whose first visited tile is fully masked carries m =
//    NEG_INF and p = 1 until a tile with a valid key rescales that away by
//    exp(NEG_INF - m) = 0 (with -inf the same row would give NaN).
//  The softmax runs in base 2: the scale folds log2(e) in, so exp2 serves.
//
// On request (a non-null `lse`, as training asks), the epilogue also writes
// each stored row's log-sum-exp for the backward
// (csrc/flash_attention_bwd.cu) in natural-log units:
//   L_i = log sum_j exp(s_ij) = (m + log2 l) * ln 2,
// with m and l the row's base-2 running maximum and sum; fp32 [B, Nq, Sq].
// That is an instance of its own (the LSE template flag), so the instance
// every call without it runs is the code it was: with the store in one
// instance for both, the H 128 rows ran 4-8 % slower.  O is computed the
// same way in both.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int BM = 128;        // query rows per block (64 per consumer)
constexpr int BN = 128;        // keys per tile
constexpr int NCONS = 2;       // consumer warpgroups
constexpr int NT = 128 * (NCONS + 1);
constexpr int ROWB = 128;      // bytes of one swizzled box row (64 bf16)

template <int H>
struct Cfg {
  static constexpr int NH = H / 64;             // 64-element halves
  static constexpr int ST = H == 64 ? 4 : 2;    // k/v ring stages
  static constexpr int Q_BYTES = NH * BM * ROWB;
  static constexpr int KV_BYTES = NH * BN * ROWB;   // one k or v tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + ST * KV_BYTES;
  // q, then k_full, v_full, empty per stage; 1024 of slack to align
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 3 * ST) + 1024;
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

// 4-D TMA load of one box into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
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

// named barriers 1 and 2 hand the turn to issue products between the two
// consumer warpgroups (256 threads: one group syncs, the other arrives)
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
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

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// 2^x on the MUFU unit, flushing results below 2^-126 to zero (exp2f
// spends extra instructions on them; such a p adds nothing to l or to
// P V at fp32 and bf16 precision)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], A and B from shared memory
// (K-major descriptors); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
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

// d[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (the
// mma.m16n8k16 A layout, warp w rows 16w..16w+15), B from shared memory
// MN-major (transpose bit set)
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
// 8-column groups of S, rounded to bf16, are the register A fragment of P
// over those 16 keys (a0 row g, a1 row g + 8, a2 / a3 the next 8 keys).
// LSE: the instance that also writes the rows' log-sum-exp (training's);
// the other is the code it was before that output existed.
template <int H, bool LSE>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 __nv_bfloat16* __restrict__ out,     // [B, Sq, Nq, H]
                 float* __restrict__ lse,             // [B, Nq, Sq] or null
                 int sq, int skv, int nq, int nkv, int causal, int window,
                 float scale_log2) {
  using C = Cfg<H>;
  extern __shared__ uint8_t smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sQ = base, sK = base + C::K_OFF, sV = base + C::V_OFF;
  const uint32_t bar_q = base + C::BAR_OFF;
  auto bar_k = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8 * (1 + C::ST + s); };
  auto bar_e = [&](int s) { return bar_q + 8 * (1 + 2 * C::ST + s); };

  const int qt = gridDim.z - 1 - blockIdx.z;   // longest causal rows first
  const int qh = blockIdx.x, b = blockIdx.y;
  const int kvh = qh / (nq / nkv);
  const int q0 = qt * BM;
  // key tiles holding a key that some row of this block may see
  int hi = skv;
  if (causal) hi = min(hi, min(q0 + BM, sq));
  const int lo = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = lo / BN;
  const int t_hi = (hi + BN - 1) / BN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::ST; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_e(s), 4 * NCONS);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONS) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NCONS * 128) {
      mbar_expect_tx(bar_q, C::Q_BYTES);
      for (int hh = 0; hh < C::NH; ++hh)
        tma_load_4d(sQ + hh * BM * ROWB, &tm_q, hh * 64, qh, q0, b, bar_q);
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, s = i % C::ST;
        // the (i / ST)-th release of stage s
        if (i >= C::ST) mbar_wait(bar_e(s), ((i / C::ST) & 1) ^ 1);
        mbar_expect_tx(bar_k(s), C::KV_BYTES);
        for (int hh = 0; hh < C::NH; ++hh)
          tma_load_4d(sK + s * C::KV_BYTES + hh * BN * ROWB, &tm_k, hh * 64,
                      kvh, t * BN, b, bar_k(s));
        mbar_expect_tx(bar_v(s), C::KV_BYTES);
        for (int hh = 0; hh < C::NH; ++hh)
          tma_load_4d(sV + s * C::KV_BYTES + hh * BN * ROWB, &tm_v, hh * 64,
                      kvh, t * BN, b, bar_v(s));
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row_base = q0 + wg * 64;          // this warpgroup's rows
    const int r0 = row_base + warp * 16 + g;    // this thread's: r0, r0 + 8

    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
    float o[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) o[i] = 0.f;
    float s[BN / 2];           // scores of one tile, then its fp32 P
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) s[i] = 0.f;
    uint32_t pa[BN / 16][4];   // P in bf16: the A operand of O += P V

    const uint32_t qa = sQ + wg * 64 * ROWB;
    // S = Q K^T for tile index i: 64 rows x 128 keys, 16 head elements a
    // step (issued, not waited for)
    auto issue_qk = [&](int i) {
      const uint32_t ka = sK + (i % C::ST) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk)
        wgmma_ss_n128(
            s, sw128_desc(qa + (kk / 4) * BM * ROWB + (kk % 4) * 32, 16, 1024),
            sw128_desc(ka + (kk / 4) * BN * ROWB + (kk % 4) * 32, 16, 1024),
            kk > 0);
    };
    // O += P V for tile index i: 16 keys a step, V MN-major
    auto issue_pv = [&](int i) {
      const uint32_t va = sV + (i % C::ST) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs(o, pa[kk], sw128_desc(va + kk * 16 * ROWB, BN * ROWB, 1024));
    };
    // scale (base 2) and mask the scores of key tile t, then the online
    // softmax: new row maxima m, their correction corr, P in s (fp32),
    // sums in l.  The arithmetic stays x = s * scale rounded once, p =
    // exp2(x - m) (see the notes above)
    auto softmax = [&](int t) {
      const int key0 = t * BN;
      const bool edge = key0 + BN > skv ||
                        (causal && key0 + BN - 1 > row_base) ||
                        (window && key0 <= row_base + 63 - window);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[4 * j + e] *= scale_log2;
      if (edge) {
        // key key0 + c (c = 2 t + 8 j + (e & 1)) is valid for row r when
        // c - 2t lies in [lo, hi]: key < Skv, key <= r (causal), key >
        // r - window (window), so one compare pair an element
        int lo[2], hi[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          hi[h] = (causal ? min(row, skv - 1) : skv - 1) - key0 - 2 * t4;
          lo[h] = window ? row - window + 1 - key0 - 2 * t4 : -BN;
        }
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + (e & 1), h = e >> 1;
            if (c > hi[h] || c < lo[h]) s[4 * j + e] = kNegInf;
          }
        }
      }
      // each row's 128 scores lie in one quad of lanes
      float mt[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
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
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[4 * j + e] - m[e >> 1]);
          s[4 * j + e] = p;
          ps[e >> 1] += p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto rescale_o = [&]() {   // (corr is exactly 1 where m held still)
      if (!__any_sync(kFull, corr[0] != 1.f || corr[1] != 1.f)) return;
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        o[4 * j] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
    };
    auto phase = [](int i) { return (i / C::ST) & 1; };

    // Software pipeline over key tiles: tile i's Q K^T is in flight on the
    // tensor cores with tile i - 1's P V while this warpgroup runs tile
    // i's softmax on the CUDA cores and MUFU.
    const int n_t = t_hi - t_lo;
    mbar_wait(bar_q, 0);
    if (n_t > 0) {
      mbar_wait(bar_k(0), 0);
      wgmma_fence();
      issue_qk(0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      softmax(t_lo);
      pack_p();
    }
    // (each group syncs n_t - 1 times and is arrived at as often)
    if (wg == 1 && n_t > 1) bar_arrive(1, 256);   // consumer 0 first
    for (int i = 1; i < n_t; ++i) {
      mbar_wait(bar_k(i % C::ST), phase(i));
      mbar_wait(bar_v((i - 1) % C::ST), phase(i - 1));
      // the products read o and pa: their last writes stay above the fence
      fence_regs(o);
      fence_regs(pa);
      // ping-pong: the consumers take turns to issue their products, so
      // one's products run while the other's softmax does
      bar_sync(1 + wg, 256);
      wgmma_fence();
      issue_qk(i);
      wgmma_commit();
      issue_pv(i - 1);
      wgmma_commit();
      if (!(wg == 1 && i == n_t - 1)) bar_arrive(2 - wg, 256);
      wgmma_wait<1>();          // Q K^T of tile i has landed
      fence_regs(s);
      softmax(t_lo + i);
      wgmma_wait<0>();          // P V of tile i - 1 too
      fence_regs(o);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(bar_e((i - 1) % C::ST));
      rescale_o();
      pack_p();
    }
    if (n_t > 0) {
      mbar_wait(bar_v((n_t - 1) % C::ST), phase(n_t - 1));
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
      issue_pv(n_t - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    __nv_bfloat16* ob = out + (size_t)blockIdx.y * sq * nq * H +
                        (size_t)qh * H;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(kFull, l[h], 1);
      l[h] += __shfl_xor_sync(kFull, l[h], 2);
      const float denom = fmaxf(l[h], 1e-30f);
      const int row = r0 + h * 8;
      if (row < sq) {
        if (LSE && t4 == 0)
          lse[((size_t)blockIdx.y * nq + qh) * sq + row] =
              (m[h] + log2f(l[h])) * kLn2;
        __nv_bfloat16* orow = ob + (size_t)row * nq * H;
#pragma unroll
        for (int j = 0; j < H / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] / denom,
                                    o[4 * j + 2 * h + 1] / denom);
      }
    }
  }
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

// A BSHD tensor [B, S, N, H] bf16 as a 4-D tensor map whose box is 64 head
// elements (one 128-byte swizzled row) x `rows` positions of one head.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int N, int H,
              int rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)H, (cuuint64_t)N, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)H * 2, (cuuint64_t)N * H * 2,
                                 (cuuint64_t)S * N * H * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int H>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int sq, int skv, int nq, int nkv,
                   int causal, int window, float scale, cudaStream_t stream) {
  using C = Cfg<H>;
  const auto kernel = lse != nullptr ? flash_fwd_kernel<H, true>
                                     : flash_fwd_kernel<H, false>;
  // set on every call: an attribute set once from one host thread is not
  // in effect in another (autograd's worker thread, for one)
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B, sq, nq, H, BM) ||
      !make_map(&mk, k, B, skv, nkv, H, BN) ||
      !make_map(&mv, v, B, skv, nkv, H, BN))
    return cudaErrorInvalidValue;
  dim3 grid(nq, B, (sq + BM - 1) / BM);
  kernel<<<grid, NT, C::SMEM, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), lse, sq, skv, nq, nkv,
      causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/out [B, Sq, Nq, H], k/v [B, Skv, Nkv, H], bf16, contiguous, 16-byte
// aligned; Nq a multiple of Nkv; H 64 or 128; B and ceil(Sq / 128) below
// 65536.  lse: null, or fp32 [B, Nq, Sq] for each row's log-sum-exp.
// Launches on `stream` and returns cudaGetLastError() (0 = launched;
// cudaErrorInvalidValue when a tensor map cannot be made).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, void* lse, int B, int sq, int skv,
                          int nq, int nkv, int H, int causal, int window,
                          float scale, void* stream) {
  if (B <= 0 || B >= 65536 || sq <= 0 || (sq + BM - 1) / BM >= 65536 ||
      skv <= 0 || nkv <= 0 || nq % nkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 64)
    return (int)launch<64>(q, k, v, out, static_cast<float*>(lse), B, sq,
                           skv, nq, nkv, causal, window, scale, s);
  if (H == 128)
    return (int)launch<128>(q, k, v, out, static_cast<float*>(lse), B, sq,
                            skv, nq, nkv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
