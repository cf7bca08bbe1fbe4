// Flash attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel: the reference package has no attention
// backward kernel.  It trains by differentiating the jnp `_sdpa`
// (src/repro/models/attention.py:79, reached from `gqa_forward`), which
// keeps a [B, Nq, Sq, Skv] fp32 score tensor per layer for its backward.
// This kernel is the gradient of the port's forward kernel
// (csrc/flash_attention.cu) without that tensor.
//
// What it computes, in the forward's BSHD layout: q, o, dO [B, Sq, Nq, H],
// k/v [B, Skv, Nkv, H] bf16; query head n*G + g reads kv head n.  With
// s_ij = (q_i . k_j) / sqrt(H), NEG_INF where j > i (causal) or
// j <= i - window (window > 0), and each row's log-sum-exp L_i as the
// forward wrote it (natural log, fp32 [B, Nq, Sq]):
//   P_ij = exp(s_ij - L_i), D_i = sum_h dO_ih O_ih, dP = dO V^T,
//   dS = P o (dP - D), dQ = dS K / sqrt(H), dK = dS^T Q / sqrt(H),
//   dV = P^T dO,
// dK and dV summed over each kv head's G query heads; bf16 outputs.
//
// What bounds it on an H100: operations.  The five products take 10 H
// FLOPs a visible (query, key) pair; at granite-3-2b's training shape (S
// 1024, H 64, causal) that is 640 FLOPs a pair against 2 H bytes a row of
// each of q, k, v, o, dO, dq, dk, dv: past the card's ~295 FLOPs a byte.
// At H 64 the exponentials weigh as much as in the forward (one exp2 a
// pair, recomputed in each of the two product kernels).
//
// What the design does about it (the forward's Hopper shape, twice):
//  * the forward writes each row's log-sum-exp, so nothing recomputes the
//    row statistics: seven products where the work needs five (S and dP
//    are computed once for dQ and once, transposed, for dK and dV);
//  * a pre-pass takes D = rowsum(dO o O) from the o it is given and the
//    log-sum-exp in base 2 (times log2 e, so P = exp2(s * scale * log2 e
//    - L2), one FFMA and one MUFU op a pair) into fp32 rows padded to a
//    multiple of 128, the pad rows P = 0 and D = 0;
//  * kernel dq: one block per (128-row query tile, query head, sequence),
//    the forward's three warpgroups (a producer thread issuing TMA loads of
//    q, dO and the rows' statistics, then a ring of k and v tiles under
//    full and empty mbarriers; two consumer warpgroups of 64 rows, with
//    setmaxnreg moving registers to them).  Per key tile: S = Q K^T and
//    dP = dO V^T on wgmma from shared memory (K-major), P and dS in
//    registers, dQ += dS K with dS from registers in bf16 and K through
//    the transpose bit (the forward's P V issue with V replaced by K).  At
//    H 128 tile i's S and dP are issued beside tile i - 1's dQ;
//  * kernel dkv: one block per (128-key tile, kv head, share of its G
//    query heads, sequence): k and v once, then a ring of 64-query tiles
//    of q, dO and their statistics for every query head of the share.  Per
//    query tile: S^T = K Q^T and dP^T = V dO^T (K-major from shared
//    memory), P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q
//    with A from registers and B through the transpose bit.  At H 128, dK
//    and dV hold 128 fp32 registers a thread, so query tiles are 64 rows
//    and the products of one tile are not overlapped with the next tile's
//    P^T (at H 64 they are);
//  * where the kv heads and key tiles give fewer blocks than SMs, G is
//    split over blocks: each share writes fp32 partial dK and dV, and a
//    small kernel sums the shares in a fixed order;
//  * no atomics anywhere, so every call gives the same bits; P and dS
//    enter the tensor cores in bf16, every sum is fp32;
//  * tiles wholly above the causal diagonal or before the window are not
//    visited (their P is exactly 0); masks are evaluated on edge tiles
//    only; rows past Sq and keys past Skv arrive from TMA as zeros, take
//    P = 0 and are not stored.  The tiles with the most work go first.
//  * Rows with no visible key (no causal mask but a window) are refused by
//    the entry point: the reference gives them a uniform P over all keys,
//    which the skipped tiles would miss.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kPadLse = 1e30f;   // a base-2 log-sum-exp that makes P = 0
constexpr unsigned kFull = 0xffffffffu;
constexpr int NCONS = 2;           // consumer warpgroups
constexpr int NT = 128 * (NCONS + 1);
constexpr int ROWB = 128;          // bytes of one swizzled box row (64 bf16)
constexpr int BM = 128;            // dq: query rows a block (64 a consumer)
constexpr int BK = 128;            // dkv: keys a block (64 a consumer)
constexpr int SPAD = 128;          // statistics rows padded to a multiple

// dq kernel: q and dO of the block, a ring of KN-key k and v tiles
template <int H>
struct DqCfg {
  static constexpr int KN = H == 64 ? 128 : 64;   // keys a tile
  // tile i's S and dP issued beside tile i-1's dQ: faster at H 128; at
  // H 64 (S and dP 64 registers each) the unpipelined loop is 3-4 % faster
  static constexpr bool PIPE = H == 128;
  static constexpr int NH = H / 64;               // 64-element halves
  static constexpr int ST = 3;                    // ring stages
  static constexpr int Q_BYTES = NH * BM * ROWB;  // q or dO
  static constexpr int KV_BYTES = NH * KN * ROWB; // one k or v tile
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + ST * KV_BYTES;
  static constexpr int STAT_OFF = V_OFF + ST * KV_BYTES;  // L2[BM], D[BM]
  static constexpr int BAR_OFF = STAT_OFF + 2 * BM * 4;
  // q, then kv_full and empty per stage; 1024 of slack to align
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * ST) + 1024;
};

// dkv kernel: k and v of the block, a ring of BQ-query q and dO tiles with
// their statistics
template <int H>
struct DkvCfg {
  static constexpr int BQ = 64;                   // queries a tile
  // at H 128 the pipelined loop (dK, dV, two tiles' P^T and dS^T) spills
  static constexpr bool PIPE = H == 64;
  static constexpr int NH = H / 64;
  static constexpr int ST = H == 64 ? 4 : 3;
  static constexpr int KV_BYTES = NH * BK * ROWB; // the k or the v tile
  static constexpr int Q_BYTES = NH * BQ * ROWB;  // one q or dO tile
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + ST * Q_BYTES;
  static constexpr int STAT_OFF = DO_OFF + ST * Q_BYTES;  // L2[BQ], D[BQ]
  static constexpr int BAR_OFF = STAT_OFF + ST * 2 * BQ * 4;
  // k/v, then full and empty per stage
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

// bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned) from
// global to shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
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

// K-major operand of 64 (or 128) rows of a tile whose 64-element halves
// lie `half_bytes` apart: the descriptor of 16 head elements kk
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk,
                                           int half_bytes) {
  return sw128_desc(tile + (kk / 4) * half_bytes + (kk % 4) * 32, 16, 1024);
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

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(d[i][j])::"memory");
}

// 2^x on the MUFU unit, flushing results below 2^-126 to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d[64 x 64] (+)= A[64 x 16] * B[16 x 64], A and B from shared memory
// (K-major descriptors); scale_d = 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x 128] (+)= A[64 x 16] * B[16 x 128], as above
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
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

// Two neighbouring 8-column groups of an fp32 accumulator, rounded to
// bf16, are the register A fragment of the next product over those 16
// columns (see the layout note above flash_bwd_dq_kernel)
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4],
                                       const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    a[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// ---- pre-pass: D and the base-2 log-sum-exp, padded rows ----------------
// stats [2, B, Nq, Sp]: plane 0 L2 = L * log2 e, plane 1 D = rowsum(dO o O);
// rows i >= Sq (and rows whose log-sum-exp saw no visible key) take L2 =
// kPadLse and D = 0, so their P and dS are 0.  H / 8 threads a row, one
// 16-byte chunk of dO and of O each; rows in (b, i, n) order, so the loads
// are contiguous.
template <int H>
__global__ void __launch_bounds__(256)
flash_bwd_prep_kernel(const bf16* __restrict__ o,
                      const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      float* __restrict__ stats, int B, int sq, int sp,
                      int nq) {
  constexpr int TPR = H / 8;
  const long long rows = (long long)B * sp * nq;
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = gid / TPR;
  const int c = (int)(gid % TPR);
  const bool valid = row < rows;
  const int n = (int)(row % nq);
  const int i = (int)((row / nq) % sp);
  const int b = (int)(row / ((long long)nq * sp));
  float acc = 0.f;
  if (valid && i < sq) {
    const size_t off = (((size_t)b * sq + i) * nq + n) * H + c * 8;
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(dout + off));
    const uint4 y = __ldg(reinterpret_cast<const uint4*>(o + off));
    const __nv_bfloat162* xa = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ya = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 xf = __bfloat1622float2(xa[e]);
      const float2 yf = __bfloat1622float2(ya[e]);
      acc += xf.x * yf.x + xf.y * yf.y;
    }
  }
#pragma unroll
  for (int w = TPR / 2; w > 0; w /= 2) acc += __shfl_xor_sync(kFull, acc, w);
  if (valid && c == 0) {
    const size_t si = ((size_t)b * nq + n) * sp + i;
    float l2 = kPadLse;
    if (i < sq) {
      l2 = lse[((size_t)b * nq + n) * sq + i] * kLog2e;
      if (!(l2 > -1e29f)) l2 = kPadLse;   // no visible key was seen
    }
    stats[si] = l2;
    stats[(size_t)rows + si] = i < sq ? acc : 0.f;
  }
}

// Accumulator layout of wgmma m64nNk16 (fp32), per warpgroup: warp w of
// the group owns rows 16w..16w+15; with lane = 4g + t, d[4j + i] is row
// 16w + g + 8 * (i >> 1), column 8j + 2t + (i & 1).
//
// kernel dq: grid (Nq, B, query tiles), longest causal rows first.
template <int H>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ stats,
                    bf16* __restrict__ dq,        // [B, Sq, Nq, H]
                    int B, int sq, int sp, int skv, int nq, int nkv,
                    int causal, int window, float scale) {
  using C = DqCfg<H>;
  constexpr int KN = C::KN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sQ = base, sdO = base + C::DO_OFF;
  const uint32_t sK = base + C::K_OFF, sV = base + C::V_OFF;
  const uint32_t sStat = base + C::STAT_OFF;
  const float* lstat = reinterpret_cast<const float*>(gbase + C::STAT_OFF);
  const uint32_t bar_q = base + C::BAR_OFF;
  auto bar_kv = [&](int s) { return bar_q + 8 * (1 + s); };
  auto bar_e = [&](int s) { return bar_q + 8 * (1 + C::ST + s); };

  const int qt = gridDim.z - 1 - blockIdx.z;
  const int qh = blockIdx.x, b = blockIdx.y;
  const int kvh = qh / (nq / nkv);
  const int q0 = qt * BM;
  int hi = skv;
  if (causal) hi = min(hi, min(q0 + BM, sq));
  const int lo = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = lo / KN;
  const int t_hi = (hi + KN - 1) / KN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < C::ST; ++s) {
      mbar_init(bar_kv(s), 1);
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
      mbar_expect_tx(bar_q, 2 * C::Q_BYTES + 2 * BM * 4);
      for (int hh = 0; hh < C::NH; ++hh) {
        tma_load_4d(sQ + hh * BM * ROWB, &tm_q, hh * 64, qh, q0, b, bar_q);
        tma_load_4d(sdO + hh * BM * ROWB, &tm_do, hh * 64, qh, q0, b, bar_q);
      }
      const float* st = stats + ((size_t)b * nq + qh) * sp + q0;
      bulk_load(sStat, st, BM * 4, bar_q);
      bulk_load(sStat + BM * 4, st + (size_t)B * nq * sp, BM * 4, bar_q);
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, s = i % C::ST;
        if (i >= C::ST) mbar_wait(bar_e(s), ((i / C::ST) & 1) ^ 1);
        mbar_expect_tx(bar_kv(s), 2 * C::KV_BYTES);
        for (int hh = 0; hh < C::NH; ++hh) {
          tma_load_4d(sK + s * C::KV_BYTES + hh * KN * ROWB, &tm_k, hh * 64,
                      kvh, t * KN, b, bar_kv(s));
          tma_load_4d(sV + s * C::KV_BYTES + hh * KN * ROWB, &tm_v, hh * 64,
                      kvh, t * KN, b, bar_kv(s));
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int row_base = q0 + wg * 64;
    const int lr = wg * 64 + warp * 16 + g;     // rows lr, lr + 8 of the tile
    const int r0 = q0 + lr;
    const float scale_log2 = scale * kLog2e;

    float dqa[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) dqa[i] = 0.f;
    float s[KN / 2], dp[KN / 2];
#pragma unroll
    for (int i = 0; i < KN / 2; ++i) s[i] = dp[i] = 0.f;
    uint32_t pa[KN / 16][4];   // dS in bf16: the A operand of dQ += dS K

    const uint32_t qa = sQ + wg * 64 * ROWB, da = sdO + wg * 64 * ROWB;
    auto issue_sdp = [&](int i) {
      const uint32_t ka = sK + (i % C::ST) * C::KV_BYTES;
      const uint32_t va = sV + (i % C::ST) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk)
        wgmma_ss(s, kmajor(qa, kk, BM * ROWB), kmajor(ka, kk, KN * ROWB),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk)
        wgmma_ss(dp, kmajor(da, kk, BM * ROWB), kmajor(va, kk, KN * ROWB),
                 kk > 0);
    };
    auto issue_dq = [&](int i) {
      const uint32_t ka = sK + (i % C::ST) * C::KV_BYTES;
#pragma unroll
      for (int kk = 0; kk < KN / 16; ++kk)
        wgmma_rs(dqa, pa[kk], sw128_desc(ka + kk * 16 * ROWB, KN * ROWB,
                                         1024));
    };

    mbar_wait(bar_q, 0);
    float l2[2], dd[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l2[h] = lstat[lr + 8 * h];
      dd[h] = lstat[BM + lr + 8 * h];
    }
    // P = exp2(s * scale log2 e - L2) with the forward's masks (edge tiles
    // only), then dS = P o (dP - D), left in s
    auto compute_ds = [&](int t) {
      const int key0 = t * KN;
      const bool edge = key0 + KN > skv ||
                        (causal && key0 + KN - 1 > row_base) ||
                        (window && key0 <= row_base + 63 - window);
      if (edge) {
        int lo_c[2], hi_c[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + 8 * h;
          hi_c[h] = (causal ? min(row, skv - 1) : skv - 1) - key0 - 2 * t4;
          lo_c[h] = window ? row - window + 1 - key0 - 2 * t4 : -KN;
        }
#pragma unroll
        for (int j = 0; j < KN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + (e & 1), h = e >> 1;
            if (c > hi_c[h] || c < lo_c[h]) s[4 * j + e] = kNegInf;
          }
      }
#pragma unroll
      for (int j = 0; j < KN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const float p = ex2(fmaf(s[4 * j + e], scale_log2, -l2[h]));
          s[4 * j + e] = p * (dp[4 * j + e] - dd[h]);
        }
    };
    auto phase = [](int i) { return (i / C::ST) & 1; };

    const int n_t = t_hi - t_lo;
    for (int i = 0; i < n_t; ++i) {
      mbar_wait(bar_kv(i % C::ST), phase(i));
      const bool overlap = C::PIPE && i > 0;
      // the products read dqa and pa: their last writes stay above the fence
      fence_regs(dqa);
      fence_regs(pa);
      wgmma_fence();
      issue_sdp(i);
      wgmma_commit();
      if (overlap) {
        issue_dq(i - 1);
        wgmma_commit();
        wgmma_wait<1>();       // S and dP of tile i have landed
      } else {
        wgmma_wait<0>();
      }
      fence_regs(s);
      fence_regs(dp);
      compute_ds(t_lo + i);
      if (overlap) {
        wgmma_wait<0>();       // dQ of tile i - 1 too
        fence_regs(dqa);
        fence_regs(pa);
        if (lane == 0) mbar_arrive(bar_e((i - 1) % C::ST));
      }
      pack_a<KN>(pa, s);
      if (!C::PIPE) {
        fence_regs(pa);
        wgmma_fence();
        issue_dq(i);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dqa);
        if (lane == 0) mbar_arrive(bar_e(i % C::ST));
      }
    }
    if (C::PIPE && n_t > 0) {
      fence_regs(dqa);
      fence_regs(pa);
      wgmma_fence();
      issue_dq(n_t - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dqa);
    }

    bf16* ob = dq + (size_t)b * sq * nq * H + (size_t)qh * H;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + h * 8;
      if (row < sq) {
        bf16* orow = ob + (size_t)row * nq * H;
#pragma unroll
        for (int j = 0; j < H / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + 2 * t4) =
              __floats2bfloat162_rn(dqa[4 * j + 2 * h] * scale,
                                    dqa[4 * j + 2 * h + 1] * scale);
      }
    }
  }
}

// kernel dkv: grid (Nkv * splits, B, key tiles), the key tiles that most
// queries see first.  Share `sp_i` of kv head n takes query heads
// n * G + sp_i * (G / splits) ... + G / splits - 1.  With splits 1 the block
// writes bf16 dK and dV; otherwise fp32 partials part[sp_i][0 = dK, 1 = dV]
// [B, Skv, Nkv, H], summed by flash_bwd_sum_kernel.
template <int H>
__global__ void __launch_bounds__(NT, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ stats,
                     bf16* __restrict__ dk, bf16* __restrict__ dv,
                     float* __restrict__ part, int B, int sq, int sp,
                     int skv, int nq, int nkv, int causal, int window,
                     int splits, float scale) {
  using C = DkvCfg<H>;
  constexpr int BQ = C::BQ;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sK = base, sV = base + C::V_OFF;
  const uint32_t sQ = base + C::Q_OFF, sdO = base + C::DO_OFF;
  const uint32_t sStat = base + C::STAT_OFF;
  const float* lstat = reinterpret_cast<const float*>(gbase + C::STAT_OFF);
  const uint32_t bar_kv = base + C::BAR_OFF;
  auto bar_f = [&](int s) { return bar_kv + 8 * (1 + s); };
  auto bar_e = [&](int s) { return bar_kv + 8 * (1 + C::ST + s); };

  const int kvh = blockIdx.x / splits, share = blockIdx.x % splits;
  const int b = blockIdx.y, j0 = blockIdx.z * BK;
  const int group = nq / nkv, gps = group / splits;
  const int head0 = kvh * group + share * gps;
  // the query tiles holding a row that sees some key of this block
  const int lo_q = causal ? j0 : 0;
  const int hi_q = window ? min(sq, min(j0 + BK, skv) - 1 + window) : sq;
  const int qt_lo = lo_q / BQ;
  const int n_qt = max(0, (hi_q + BQ - 1) / BQ - qt_lo);
  const int total = gps * n_qt;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < C::ST; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), 4 * NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NCONS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == NCONS * 128) {
      mbar_expect_tx(bar_kv, 2 * C::KV_BYTES);
      for (int hh = 0; hh < C::NH; ++hh) {
        tma_load_4d(sK + hh * BK * ROWB, &tm_k, hh * 64, kvh, j0, b, bar_kv);
        tma_load_4d(sV + hh * BK * ROWB, &tm_v, hh * 64, kvh, j0, b, bar_kv);
      }
      const size_t plane = (size_t)B * nq * sp;
      for (int it = 0; it < total; ++it) {
        const int s = it % C::ST;
        const int n = head0 + it / n_qt, i0 = (qt_lo + it % n_qt) * BQ;
        if (it >= C::ST) mbar_wait(bar_e(s), ((it / C::ST) & 1) ^ 1);
        mbar_expect_tx(bar_f(s), 2 * C::Q_BYTES + 2 * BQ * 4);
        for (int hh = 0; hh < C::NH; ++hh) {
          tma_load_4d(sQ + s * C::Q_BYTES + hh * BQ * ROWB, &tm_q, hh * 64,
                      n, i0, b, bar_f(s));
          tma_load_4d(sdO + s * C::Q_BYTES + hh * BQ * ROWB, &tm_do, hh * 64,
                      n, i0, b, bar_f(s));
        }
        const float* st = stats + ((size_t)b * nq + n) * sp + i0;
        bulk_load(sStat + s * 2 * BQ * 4, st, BQ * 4, bar_f(s));
        bulk_load(sStat + s * 2 * BQ * 4 + BQ * 4, st + plane, BQ * 4,
                  bar_f(s));
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int kb = j0 + wg * 64;                 // this warpgroup's keys
    const int kr0 = kb + warp * 16 + g;          // this thread's: kr0, kr0 + 8
    const float scale_log2 = scale * kLog2e;

    float dka[H / 2], dva[H / 2];
#pragma unroll
    for (int i = 0; i < H / 2; ++i) dka[i] = dva[i] = 0.f;
    float s[BQ / 2], dp[BQ / 2];
#pragma unroll
    for (int i = 0; i < BQ / 2; ++i) s[i] = dp[i] = 0.f;
    uint32_t pa[BQ / 16][4], pb[BQ / 16][4];   // P^T and dS^T in bf16

    const uint32_t ka = sK + wg * 64 * ROWB, va = sV + wg * 64 * ROWB;
    auto issue_sdp = [&](int it) {
      const uint32_t qs = sQ + (it % C::ST) * C::Q_BYTES;
      const uint32_t ds = sdO + (it % C::ST) * C::Q_BYTES;
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk)
        wgmma_ss(s, kmajor(ka, kk, BK * ROWB), kmajor(qs, kk, BQ * ROWB),
                 kk > 0);
#pragma unroll
      for (int kk = 0; kk < H / 16; ++kk)
        wgmma_ss(dp, kmajor(va, kk, BK * ROWB), kmajor(ds, kk, BQ * ROWB),
                 kk > 0);
    };
    auto issue_kv = [&](int it) {
      const uint32_t qs = sQ + (it % C::ST) * C::Q_BYTES;
      const uint32_t ds = sdO + (it % C::ST) * C::Q_BYTES;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs(dva, pa[kk], sw128_desc(ds + kk * 16 * ROWB, BQ * ROWB,
                                         1024));
        wgmma_rs(dka, pb[kk], sw128_desc(qs + kk * 16 * ROWB, BQ * ROWB,
                                         1024));
      }
    };
    // P^T = exp2(s * scale log2 e - L2[query]) under the masks (edge tiles
    // only) into s, dS^T = P^T o (dP^T - D[query]) into dp; each column's
    // statistics from the stage
    auto compute = [&](int it) {
      const int i0 = (qt_lo + it % n_qt) * BQ;
      const float* ls = lstat + (it % C::ST) * 2 * BQ;
      const bool edge = (causal && kb + 63 > i0) ||
                        (window && i0 + BQ - 1 - kb >= window);
      if (edge) {
        // query i0 + c (c = 2 t + 8 j + (e & 1)) sees key k when c - 2t
        // lies in [lo, hi]: i >= k (causal), i < k + window (window)
        int lo_c[2], hi_c[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int key = kr0 + 8 * h;
          lo_c[h] = causal ? key - i0 - 2 * t4 : -BQ;
          hi_c[h] = window ? key + window - 1 - i0 - 2 * t4 : BQ;
        }
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = 8 * j + (e & 1), h = e >> 1;
            if (c > hi_c[h] || c < lo_c[h]) s[4 * j + e] = kNegInf;
          }
      }
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t4);
        const float2 d2 =
            *reinterpret_cast<const float2*>(ls + BQ + 8 * j + 2 * t4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lv = (e & 1) ? l2.y : l2.x;
          const float dv_ = (e & 1) ? d2.y : d2.x;
          const float p = ex2(fmaf(s[4 * j + e], scale_log2, -lv));
          s[4 * j + e] = p;
          dp[4 * j + e] = p * (dp[4 * j + e] - dv_);
        }
      }
    };
    auto phase = [](int i) { return (i / C::ST) & 1; };

    mbar_wait(bar_kv, 0);
    for (int it = 0; it < total; ++it) {
      mbar_wait(bar_f(it % C::ST), phase(it));
      const bool overlap = C::PIPE && it > 0;
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pa);
      fence_regs(pb);
      wgmma_fence();
      issue_sdp(it);
      wgmma_commit();
      if (overlap) {
        issue_kv(it - 1);
        wgmma_commit();
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      fence_regs(s);
      fence_regs(dp);
      compute(it);
      if (overlap) {
        wgmma_wait<0>();
        fence_regs(dka);
        fence_regs(dva);
        fence_regs(pa);
        fence_regs(pb);
        if (lane == 0) mbar_arrive(bar_e((it - 1) % C::ST));
      }
      pack_a<BQ>(pa, s);
      pack_a<BQ>(pb, dp);
      if (!C::PIPE) {
        fence_regs(pa);
        fence_regs(pb);
        wgmma_fence();
        issue_kv(it);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dka);
        fence_regs(dva);
        if (lane == 0) mbar_arrive(bar_e(it % C::ST));
      }
    }
    if (C::PIPE && total > 0) {
      fence_regs(dka);
      fence_regs(dva);
      fence_regs(pa);
      fence_regs(pb);
      wgmma_fence();
      issue_kv(total - 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
    }

    const size_t kv_elems = (size_t)B * skv * nkv * H;
    const size_t kbase = (size_t)b * skv * nkv * H + (size_t)kvh * H;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = kr0 + 8 * h;
      if (key >= skv) continue;
      const size_t off = kbase + (size_t)key * nkv * H + 2 * t4;
      if (splits == 1) {
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          *reinterpret_cast<__nv_bfloat162*>(dk + off + 8 * j) =
              __floats2bfloat162_rn(dka[4 * j + 2 * h] * scale,
                                    dka[4 * j + 2 * h + 1] * scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + off + 8 * j) =
              __floats2bfloat162_rn(dva[4 * j + 2 * h],
                                    dva[4 * j + 2 * h + 1]);
        }
      } else {
        float* pk = part + (size_t)share * 2 * kv_elems + off;
        float* pv = pk + kv_elems;
#pragma unroll
        for (int j = 0; j < H / 8; ++j) {
          *reinterpret_cast<float2*>(pk + 8 * j) =
              make_float2(dka[4 * j + 2 * h] * scale,
                          dka[4 * j + 2 * h + 1] * scale);
          *reinterpret_cast<float2*>(pv + 8 * j) =
              make_float2(dva[4 * j + 2 * h], dva[4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// dK and dV from the shares' fp32 partials, summed in share order: four
// elements a thread
__global__ void __launch_bounds__(256)
flash_bwd_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, long long n4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= 2 * n4) return;
  const bool is_v = i >= n4;
  const long long e = is_v ? i - n4 : i;
  const float4* src = reinterpret_cast<const float4*>(part) + i;
  float4 acc = src[0];
  for (int s = 1; s < splits; ++s) {
    const float4 x = src[(size_t)s * 2 * n4];
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(is_v ? dv : dk) +
                        2 * e;
  dst[0] = __floats2bfloat162_rn(acc.x, acc.y);
  dst[1] = __floats2bfloat162_rn(acc.z, acc.w);
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
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, const void* lse,
                   void* dq, void* dk, void* dv, void* stats, void* part,
                   int B, int sq, int skv, int nq, int nkv, int causal,
                   int window, float scale, int splits, cudaStream_t s) {
  using A = DqCfg<H>;
  using K = DkvCfg<H>;
  // set on every call: the backward runs on autograd's worker thread, and
  // an attribute set once from another host thread is not in effect there
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      A::SMEM);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<H>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           K::SMEM);
  if (e != cudaSuccess) return e;
  CUtensorMap mq_a, mdo_a, mk_a, mv_a, mq_b, mdo_b, mk_b, mv_b;
  if (!make_map(&mq_a, q, B, sq, nq, H, BM) ||
      !make_map(&mdo_a, dout, B, sq, nq, H, BM) ||
      !make_map(&mk_a, k, B, skv, nkv, H, A::KN) ||
      !make_map(&mv_a, v, B, skv, nkv, H, A::KN) ||
      !make_map(&mq_b, q, B, sq, nq, H, K::BQ) ||
      !make_map(&mdo_b, dout, B, sq, nq, H, K::BQ) ||
      !make_map(&mk_b, k, B, skv, nkv, H, BK) ||
      !make_map(&mv_b, v, B, skv, nkv, H, BK))
    return cudaErrorInvalidValue;
  const int sp = (sq + SPAD - 1) / SPAD * SPAD;
  float* st = static_cast<float*>(stats);
  const long long prep_threads = (long long)B * sp * nq * (H / 8);
  flash_bwd_prep_kernel<H><<<(unsigned)((prep_threads + 255) / 256), 256, 0,
                             s>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), st, B, sq, sp, nq);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 ga(nq, B, (sq + BM - 1) / BM);
  flash_bwd_dq_kernel<H><<<ga, NT, A::SMEM, s>>>(
      mq_a, mk_a, mv_a, mdo_a, st, static_cast<bf16*>(dq), B, sq, sp, skv,
      nq, nkv, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 gb(nkv * splits, B, (skv + BK - 1) / BK);
  flash_bwd_dkv_kernel<H><<<gb, NT, K::SMEM, s>>>(
      mq_b, mk_b, mv_b, mdo_b, st, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float*>(part), B, sq, sp, skv, nq,
      nkv, causal, window, splits, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const long long n4 = (long long)B * skv * nkv * H / 4;
  flash_bwd_sum_kernel<<<(unsigned)((2 * n4 + 255) / 256), 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n4, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/o/dout/dq [B, Sq, Nq, H], k/v/dk/dv [B, Skv, Nkv, H] bf16, contiguous,
// 16-byte aligned; lse fp32 [B, Nq, Sq], the forward's natural-log row
// log-sum-exp; stats fp32 scratch [2, B, Nq, Sp] with Sp = Sq rounded up to
// a multiple of 128; part fp32 scratch [splits, 2, B, Skv, Nkv, H] when
// splits > 1 (else unused); splits divides G = Nq / Nkv; H 64 or 128; B,
// Nkv * splits and ceil(Sq / 128) below 65536; window > 0 only with causal.
// Launches the pre-pass, kernel dq, kernel dkv and (splits > 1) the sum on
// `stream` and returns cudaGetLastError() (0 = launched;
// cudaErrorInvalidValue when a tensor map cannot be made).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout,
                              const void* lse, void* dq, void* dk, void* dv,
                              void* stats, void* part, int B, int sq, int skv,
                              int nq, int nkv, int H, int causal, int window,
                              float scale, int splits, void* stream) {
  if (B <= 0 || B >= 65536 || sq <= 0 || (sq + BM - 1) / BM >= 65536 ||
      skv <= 0 || (skv + BK - 1) / BK >= 65536 || nkv <= 0 ||
      nq >= 65536 || nq % nkv != 0 || window < 0 || (window > 0 && !causal) ||
      splits <= 0 || (nq / nkv) % splits != 0 ||
      (long long)nkv * splits >= 65536 || (splits > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 64)
    return (int)launch<64>(q, k, v, o, dout, lse, dq, dk, dv, stats, part, B,
                           sq, skv, nq, nkv, causal, window, scale, splits, s);
  if (H == 128)
    return (int)launch<128>(q, k, v, o, dout, lse, dq, dk, dv, stats, part,
                            B, sq, skv, nq, nkv, causal, window, scale,
                            splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
