// Paged GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_paged_gqa_kernel` /
// `paged_gqa_attention` in src/repro/kernels/paged_attention.py.
//
// What it computes: one decode token per sequence attends over that
// sequence's KV pages, looked up through the block table tbl[b, j]:
//   s_t = (q . k_t) * scale, masked to NEG_INF where t > pos[b];
//   online softmax over pages (running m, l, acc in fp32);
//   out = acc / max(l, 1e-30), written in q's dtype (bf16).
//
// What bounds it on an H100: bytes.  Each (sequence, kv head) reads its
// ceil((pos + 1) / P) pages of K and V once; the arithmetic is 4 G
// operations a 2-byte K/V element pair, far below the card's ~295
// operations a byte.  So the card must keep enough bytes in flight: at
// 3.35 TB/s and about 1 us of latency an SM needs some 20-25 KB in flight.
//
// What the design does about it:
//  * one block per (up to 8 kv heads, sequence b, split z): with Nkv <= 8
//    (granite 8, llama4 8, qwen2-vl 2) a block reads whole pages, 16 KB of
//    K and 16 KB of V a page at granite's 8 x 64, so the card streams
//    contiguous pages.  (A block per kv head would read 128-byte rows at a
//    1 KB stride and need 8x the blocks to keep the same bytes in flight.)
//    One warp per kv head owns its G query rows;
//  * a producer warp (one thread) feeds a ring of 3 pages through TMA and
//    mbarriers: up to 96 KB in flight a block at H 64 (two blocks an SM),
//    192 KB at H 128; no staging through registers and no block-wide
//    barrier per page.  The tensor maps read the pool in its native
//    [n_pages, P, Nkv, H] layout through its strides (no transpose and no
//    padding copy), one box of 16 tokens x 64 elements per kv head and
//    64-element half, with 128-byte swizzle so the ldmatrix reads below
//    are free of bank conflicts;
//  * the products on tensor cores, mma.sync m16n8k16: S = Q K^T with the
//    G query rows padded to 16 as the A operand (held in registers for the
//    whole loop; any G from 1 to 8), K through ldmatrix; O += P V with V
//    through ldmatrix.trans and P as a bf16 high part plus a bf16 low part
//    (two products into the same fp32 accumulator).  A single bf16 P
//    (2^-9 relative) moved live granite outputs near |out| 1-2 by two
//    bf16 ulps, 1.6e-2 against the 1e-2 tolerance; hi + lo leaves only
//    the fp32 order of the sums.  The row sums l come from the unrounded
//    fp32 p;
//  * split over pages (flash-decoding): split z scores pages
//    [z * split_pages, (z + 1) * split_pages) of the sequence; the host
//    picks split_pages from shapes only (B, Nkv, pps and the SM count;
//    never from pos, which would cost a device sync).  With one split the
//    block writes the bf16 output itself; with more, each split writes
//    fp32 partials (unnormalised O and (m, l)) to scratch the wrapper
//    allocates, and paged_gqa_combine merges them and rounds once, in a
//    second launch, a programmatic dependent of the first: it is
//    scheduled while the partial blocks run and waits in
//    griddepcontrol.wait for their writes, so its launch latency hides.
//    (Merging in the last block of each sequence to arrive, behind an
//    atomic counter, saves the launch but measured slower on the H100: its
//    merge runs on one SM per sequence, after the others.)  Blocks past
//    the sequence's last page exit at once;
//  * the page loop stops at page pos[b] / P (the TPU grid walks all
//    pages_per_slot pages, sentinels included); sentinel table entries are
//    clipped and masked by pos; the masked sentinel stays the finite
//    NEG_INF = -1e30.  The softmax runs in base 2 (the scale folds log2(e)
//    in; (m, l) in the split scratch are in that base).
//  * H 224 (Zamba2-7B's shared blocks: 448-byte rows, 3.5 swizzled
//    128-byte rows): a head is four boxes of 64 elements, the last one
//    half outside the pool's row, which TMA fills with zeros (the box's
//    full bytes still count toward the barrier); the products stop at
//    element 224, so the zeros are never read.  A ring stage of 8 such
//    heads would be 128 KB, so a block spans KVB_WIDE = 4 kv heads (64 KB
//    a stage, 192 KB for the ring, one 160-thread block an SM).
// Instances: P 16, H 64, 128 and 224; Nkv, G (1..8) and the split are
// runtime values.  ptxas (CUDA 12.8, -O3, sm_90a): 86 registers a thread
// at H 64 (two 288-thread blocks an SM), 141 at H 128, 255 at H 224 (the
// cap; one 160-thread block an SM in any case), 32 for the merge; no
// spills and no stack frame.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int P = 16;            // tokens per page
constexpr int KVB = 8;           // kv heads per block (one warp each)
constexpr int KVB_WIDE = 4;      // ... at H above 128
constexpr int ST = 3;            // ring stages, one page each
constexpr int MAXG = 8;          // query rows per kv head, padded to 16
constexpr int BOX = P * 128;     // one box: 16 tokens x 64 bf16, swizzled

__host__ __device__ constexpr int kvb_of(int H) {
  return H <= 128 ? KVB : KVB_WIDE;
}

__host__ __device__ constexpr int boxes_of(int H) {  // 64-element boxes
  return (H + 63) / 64;
}

__host__ __device__ constexpr int stage_bytes(int kvb, int H) {
  return 2 * kvb * boxes_of(H) * BOX;   // K and V of kvb heads
}

template <int H>
constexpr int max_smem() {
  return ST * stage_bytes(kvb_of(H), H) + 8 * 2 * ST + 1024;
}

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

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16 x 8] += a[16 x 16] * b[16 x 8], bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Address of 16-byte chunk `chunk` of row `row` in a 128-byte-swizzled box
// (rows of 128 bytes, the pattern repeating every 8 rows)
__device__ __forceinline__ uint32_t swz(uint32_t box, int row, int chunk) {
  return box + row * 128 + ((chunk ^ (row & 7)) << 4);
}

// Fragment layouts of mma.m16n8k16 (lane = 4g + t): A a0 = (row g, cols
// 2t, 2t+1), a1 = row g + 8, a2 / a3 = cols + 8; B b0 = (k 2t, 2t+1, col
// g), b1 = k + 8; C c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = row g + 8.
// Rows g + 8 are padding (G <= 8): their A entries are zero.
template <int H>
__global__ void __launch_bounds__(32 * (kvb_of(H) + 1))
paged_gqa_partial(const __grid_constant__ CUtensorMap tm_k,   // [n_pages, P, Nkv, H]
                  const __grid_constant__ CUtensorMap tm_v,
                  const __nv_bfloat16* __restrict__ q,        // [B, Nkv*G, H]
                  const int32_t* __restrict__ tbl,            // [B, pps]
                  const int32_t* __restrict__ pos,            // [B]
                  __nv_bfloat16* __restrict__ out,            // [B, Nkv*G, H]
                  float* __restrict__ part_o,                 // [B, S, Nkv*G, H]
                  float* __restrict__ part_ml,                // [B, S, Nkv*G, 2]
                  int nkv, int G, int n_pages, int pps, int split_pages,
                  float scale_log2) {
  constexpr int NH = boxes_of(H);      // 64-element boxes of a head
  constexpr int KB = kvb_of(H);
  const int kvb = min(nkv, KB);        // kv heads a block spans
  const int kvh0 = blockIdx.x * KB;
  const int live = min(kvb, nkv - kvh0);   // ... of them inside Nkv
  const int b = blockIdx.y, split = blockIdx.z;
  const int p_b = pos[b];
  int n_iter = p_b / P + 1;
  if (n_iter > pps) n_iter = pps;
  const int j0 = split * split_pages;
  const int j1 = min(j0 + split_pages, n_iter);
  // the merge launch may be scheduled now; it waits for this grid's end
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if (j0 >= j1) return;                // past this sequence's last page
  const int n_pg = j1 - j0;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const int sb = stage_bytes(kvb, H);
  // stage s: K of kv head w at s * sb + w * NH * BOX, V after all K
  const uint32_t bar0 = base + ST * sb;
  auto bar_f = [&](int s) { return bar0 + 8 * s; };
  auto bar_e = [&](int s) { return bar0 + 8 * (ST + s); };

  if (threadIdx.x == 0) {
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_f(s), 1);
      mbar_init(bar_e(s), live);       // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kvb) {
    // ---- producer: one thread keeps the ring full ----
    if (lane == 0) {
      const int32_t* trow = tbl + (size_t)b * pps;
      const int bytes = 2 * live * NH * BOX;
      for (int i = 0; i < n_pg; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(bar_e(s), ((i / ST) & 1) ^ 1);
        int page = trow[j0 + i];
        page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
        mbar_expect_tx(bar_f(s), bytes);
        const uint32_t kst = base + s * sb, vst = kst + kvb * NH * BOX;
        for (int w = 0; w < live; ++w)
          for (int hh = 0; hh < NH; ++hh) {
            tma_load_4d(kst + (w * NH + hh) * BOX, &tm_k, hh * 64, kvh0 + w,
                        0, page, bar_f(s));
            tma_load_4d(vst + (w * NH + hh) * BOX, &tm_v, hh * 64, kvh0 + w,
                        0, page, bar_f(s));
          }
      }
    }
    return;
  }
  if (warp >= live) return;            // kv heads past Nkv

  // ---- consumer warp: kv head kvh, query rows kvh * G + g, g < G ----
  const int kvh = kvh0 + warp;
  const int g = lane >> 2, t4 = lane & 3;
  const int nq = nkv * G;
  const bool row_ok = g < G;
  const size_t qrow = (size_t)b * nq + (size_t)kvh * G + g;

  uint32_t qa[H / 16][4];              // Q as the A operand, rows >= G zero
#pragma unroll
  for (int ks = 0; ks < H / 16; ++ks) {
    const __nv_bfloat16* qp = q + qrow * H + 16 * ks + 2 * t4;
    qa[ks][0] = row_ok ? *reinterpret_cast<const uint32_t*>(qp) : 0u;
    qa[ks][2] = row_ok ? *reinterpret_cast<const uint32_t*>(qp + 8) : 0u;
    qa[ks][1] = qa[ks][3] = 0u;
  }

  float m = kNegInf, l = 0.f;          // row g: max and this lane's sum
  float o[H / 8][4];
#pragma unroll
  for (int n = 0; n < H / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  // ldmatrix lane roles: matrix mi = lane / 8, its row ri = lane % 8
  const int mi = lane >> 3, ri = lane & 7;
  for (int i = 0; i < n_pg; ++i) {
    const int s = i % ST;
    mbar_wait(bar_f(s), (i / ST) & 1);
    const uint32_t kb = base + s * sb + warp * NH * BOX;
    const uint32_t vb = kb + kvb * NH * BOX;

    // S = Q K^T over the page's 16 tokens (two 8-token tiles)
    float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < H / 16; ++ks) {
      // matrices: tokens 0-7 / 8-15 (mi >> 1) x dims 16 ks + 8 (mi & 1)
      uint32_t r[4];
      const int tok = (mi >> 1) * 8 + ri;
      ldsm_x4(r, swz(kb + (ks / 4) * BOX, tok, 2 * (ks % 4) + (mi & 1)));
      mma16816(sc[0], qa[ks], r[0], r[1]);
      mma16816(sc[1], qa[ks], r[2], r[3]);
    }

    // online softmax of row g over tokens 8 n + 2 t + e (base 2)
    const int tok0 = (j0 + i) * P;
    float x[2][2];
    float mt = m;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float v = sc[n][e] * scale_log2;
        if (tok0 + 8 * n + 2 * t4 + e > p_b) v = kNegInf;
        x[n][e] = v;
        mt = fmaxf(mt, v);
      }
    mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
    const float corr = ex2(m - mt);
    m = mt;
    float ps = 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        x[n][e] = ex2(x[n][e] - m);
        ps += x[n][e];
      }
    l = l * corr + ps;
    // P = hi + lo, both bf16: the A operands of two products into O
    uint32_t ph[4], pl[4];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const __nv_bfloat162 hi = __floats2bfloat162_rn(x[n][0], x[n][1]);
      const float2 hf = __bfloat1622float2(hi);
      ph[2 * n] = *reinterpret_cast<const uint32_t*>(&hi);
      pl[2 * n] = pack_bf16(x[n][0] - hf.x, x[n][1] - hf.y);
      ph[2 * n + 1] = pl[2 * n + 1] = 0u;   // rows g + 8: padding
    }
#pragma unroll
    for (int n = 0; n < H / 8; ++n) {
      o[n][0] *= corr;
      o[n][1] *= corr;
    }

    // O += P V: 16 output dims a step, V through ldmatrix.trans
#pragma unroll
    for (int np = 0; np < H / 16; ++np) {
      // matrices: tokens 0-7 / 8-15 (mi & 1) x dims 16 np + 8 (mi >> 1)
      uint32_t r[4];
      const int tok = (mi & 1) * 8 + ri;
      ldsm_x4_t(r, swz(vb + (np / 4) * BOX, tok, 2 * (np % 4) + (mi >> 1)));
      mma16816(o[2 * np], ph, r[0], r[1]);
      mma16816(o[2 * np], pl, r[0], r[1]);
      mma16816(o[2 * np + 1], ph, r[2], r[3]);
      mma16816(o[2 * np + 1], pl, r[2], r[3]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_e(s));   // this warp is done with s
  }

  l += __shfl_xor_sync(kFull, l, 1);
  l += __shfl_xor_sync(kFull, l, 2);
  if (!row_ok) return;
  const int S = gridDim.z;
  if (S == 1) {
    const float d = fmaxf(l, 1e-30f);
    __nv_bfloat16* op = out + qrow * H + 2 * t4;
#pragma unroll
    for (int n = 0; n < H / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(op + 8 * n) =
          __floats2bfloat162_rn(o[n][0] / d, o[n][1] / d);
    return;
  }
  const size_t prow = ((size_t)b * S + split) * nq + (size_t)kvh * G + g;
  float* op = part_o + prow * H + 2 * t4;
#pragma unroll
  for (int n = 0; n < H / 8; ++n)
    *reinterpret_cast<float2*>(op + 8 * n) = make_float2(o[n][0], o[n][1]);
  if (t4 == 0)
    *reinterpret_cast<float2*>(part_ml + prow * 2) = make_float2(m, l);
}

// Merge the splits of one (sequence, query head), in base 2, and round
// once to bf16: M = max m_s, out = sum_s o_s 2^(m_s - M) /
// max(sum_s l_s 2^(m_s - M), 1e-30), over the splits that held pages of
// the sequence.  One thread per column pair.
template <int H>
__global__ void paged_gqa_combine(const float* __restrict__ part_o,
                                  const float* __restrict__ part_ml,
                                  const int32_t* __restrict__ pos,
                                  __nv_bfloat16* __restrict__ out, int nq,
                                  int pps, int split_pages, int S) {
  const int h = blockIdx.x, b = blockIdx.y;
  int n_iter = pos[b] / P + 1;
  if (n_iter > pps) n_iter = pps;
  const int used = (n_iter + split_pages - 1) / split_pages;
  // launched early (programmatic dependent launch): the partials are
  // complete and visible only after this
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const float* ml = part_ml + ((size_t)b * S * nq + h) * 2;
  float mx = kNegInf;
#pragma unroll 4
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, ml[(size_t)s * nq * 2]);
  float den = 0.f;
  float2 num = make_float2(0.f, 0.f);
  const int c = 2 * threadIdx.x;
#pragma unroll 4
  for (int s = 0; s < used; ++s) {
    const float w = exp2f(ml[(size_t)s * nq * 2] - mx);
    den += ml[(size_t)s * nq * 2 + 1] * w;
    const float2 a = *reinterpret_cast<const float2*>(
        part_o + (((size_t)b * S + s) * nq + h) * H + c);
    num.x = fmaf(a.x, w, num.x);
    num.y = fmaf(a.y, w, num.y);
  }
  den = fmaxf(den, 1e-30f);
  *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)b * nq + h) * H + c) =
      __floats2bfloat162_rn(num.x / den, num.y / den);
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

// A pool [n_pages, P, Nkv, H] bf16 as a 4-D tensor map whose box is 64
// head elements (one 128-byte swizzled row) x 1 kv head x P tokens; at H
// 224 the last box of a head reaches past the row and is zero-filled.
bool make_map(CUtensorMap* map, const void* ptr, int n_pages, int nkv,
              int H) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)H, (cuuint64_t)nkv, (cuuint64_t)P,
                              (cuuint64_t)n_pages};
  const cuuint64_t strides[3] = {(cuuint64_t)H * 2, (cuuint64_t)nkv * H * 2,
                                 (cuuint64_t)P * nkv * H * 2};
  const cuuint32_t box[4] = {64, 1, P, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int H>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* tbl, const void* pos, void* out, void* part_o,
                   void* part_ml, int B, int nkv, int G, int n_pages,
                   int pps, int split_pages, float scale,
                   cudaStream_t stream) {
  // set on every call: an attribute set once from one host thread is not
  // in effect in another
  {
    cudaError_t err = cudaFuncSetAttribute(
        paged_gqa_partial<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        max_smem<H>());
    if (err != cudaSuccess) return err;
  }
  CUtensorMap mk, mv;
  if (!make_map(&mk, k, n_pages, nkv, H) || !make_map(&mv, v, n_pages, nkv, H))
    return cudaErrorInvalidValue;
  constexpr int KB = kvb_of(H);
  const int kvb = nkv < KB ? nkv : KB;
  const int S = (pps + split_pages - 1) / split_pages;
  const int smem = ST * stage_bytes(kvb, H) + 8 * 2 * ST + 1024;
  dim3 grid((nkv + KB - 1) / KB, B, S);
  paged_gqa_partial<H><<<grid, 32 * (kvb + 1), smem, stream>>>(
      mk, mv, static_cast<const __nv_bfloat16*>(q),
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(pos),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_o),
      static_cast<float*>(part_ml), nkv, G, n_pages, pps, split_pages,
      scale * kLog2e);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  return launch_dependent(paged_gqa_combine<H>, dim3(nkv * G, B), H / 2,
                          stream, static_cast<const float*>(part_o),
                          static_cast<const float*>(part_ml),
                          static_cast<const int32_t*>(pos),
                          static_cast<__nv_bfloat16*>(out), nkv * G, pps,
                          split_pages, S);
}

}  // namespace

extern "C" {

// Shapes the kernel is instantiated for; the Python wrapper raises on
// anything else before launching.
int repro_paged_gqa_supported(int P_, int H, int G) {
  return P_ == P && (H == 64 || H == 128 || H == 224) && G >= 1 &&
         G <= MAXG;
}

// q/out [B, Nkv*G, H] bf16, pools [n_pages, P, Nkv, H] bf16 (contiguous,
// 16-byte aligned), tbl [B, pps] int32, pos [B] int32.  The table runs in
// S = ceil(pps / split_pages) splits (from the host's plan); with S > 1,
// part_o [B, S, Nkv*G, H] and part_ml [B, S, Nkv*G, 2] fp32 scratch
// (unused, and may be null, with one).  Launches on `stream` (a second
// launch merges the splits when S > 1) and returns cudaGetLastError() (0 =
// launched; cudaErrorInvalidValue when a tensor map cannot be made).
int repro_paged_gqa_attention(const void* q, const void* pool_k,
                              const void* pool_v, const void* tbl,
                              const void* pos, void* out, void* part_o,
                              void* part_ml, int B, int nkv, int G, int H,
                              int P_, int n_pages, int pps, int split_pages,
                              float scale, void* stream) {
  if (!repro_paged_gqa_supported(P_, H, G) || B <= 0 || B >= 65536 ||
      nkv <= 0 || n_pages <= 0 || pps <= 0 || split_pages <= 0 ||
      (pps + split_pages - 1) / split_pages >= 65536)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 64)
    return (int)launch<64>(q, pool_k, pool_v, tbl, pos, out, part_o, part_ml,
                           B, nkv, G, n_pages, pps, split_pages, scale, s);
  if (H == 224)
    return (int)launch<224>(q, pool_k, pool_v, tbl, pos, out, part_o,
                            part_ml, B, nkv, G, n_pages, pps, split_pages,
                            scale, s);
  return (int)launch<128>(q, pool_k, pool_v, tbl, pos, out, part_o, part_ml,
                          B, nkv, G, n_pages, pps, split_pages, scale, s);
}

}  // extern "C"
