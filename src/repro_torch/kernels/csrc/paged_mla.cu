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
// What bounds it on an H100.  At B 16, N 128, R 512, Hr 64 and positions up
// to 2047 it reads at most 37.7 MB of latent pages and does
// 2 * B * N * S * (R + Hr + R) = 9.1 GFLOP: about 240 operations per byte,
// near the bf16 tensor-core ridge (about 295).  This version runs the
// products on the fp32 CUDA cores (67 TFLOP/s), so it is bound by
// operations there, at no less than about 0.14 ms for that shape; moving
// the products to tensor cores (mma.sync / wgmma, 64 heads a warpgroup) is
// later work.
//
// What the design does:
//  * MLA is multi-query in latent space: every head scores against the
//    same page.  One block owns (a tile of 2 * WARPS heads, sequence b,
//    split z), 16 heads at full width, and stages each page [P, R + Hr]
//    (18 KB) once in shared memory for all its heads; the other head tiles
//    of the sequence read the same page again from L2.
//  * Split over pages (flash-decoding): split z scores pages
//    [16 z, 16 z + 16) of the sequence, so a long sequence spreads over
//    many SMs instead of serialising in one block; blocks past the
//    sequence's last page exit at once.  With one split (tables of at most
//    16 pages, 256 positions) the block writes the normalised context
//    itself; with more, each split writes its unnormalised context and
//    (m, l) to scratch the wrapper allocates, and paged_mla_combine merges
//    them with the usual rescaling.
//  * Both pools are read in place through their own pointers: no
//    concatenation and no padding of R, Hr or N (the TPU wrapper pads to
//    128 lanes and 8 sublanes and concatenates both pools on every call,
//    copying every pool at every layer and step).
//  * cp.async double buffering: page j + 1 is in flight while page j is
//    scored.  The page loop stops at page pos[b] / P (the TPU grid walks
//    every page of the table).  Sentinel table entries are clipped as the
//    reference's wrapper does, and masked by pos.
//
// Thread layout.  Warp w owns heads (2w, 2w + 1) of the block's tile.  For
// the scores, lane l holds (in registers) the query pairs at columns
// 64k + 2l of the concatenated [q_lat | q_rope] row (C = R + Hr columns) and
// forms 2 heads x P tokens = 32 partial dot products; a transpose-reduce
// (31 shuffles) leaves lane l with the full score of head l / 16, token
// l % 16, and the softmax statistics of a head live in its 16-lane half.
// For the context, lane l owns the latent pairs at columns 64k + 2l of both
// heads, and each token's probability is broadcast by shuffle.
// Shared-memory reads of a page row by a warp are 32 consecutive words: no
// bank conflict.  At full width the block needs 255 registers a thread and
// spills about 400 bytes; capping it at 128 to fit two blocks an SM spilled
// 1,152 bytes and ran 4x slower, so one block an SM it is.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int P = 16;                  // tokens per page (2 heads x P = 32)
constexpr int kSplitPages = 16;        // pages per split (256 positions)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// One step of the warp's transpose-reduce of 32 partial sums: each lane
// keeps the half of part[0, 2W) whose index bit W matches its own lane bit,
// adds its partner's (lane ^ W) copy of that half, and moves it to
// part[0, W).  W is a template constant so every index is static and part
// stays in registers.
template <int W>
__device__ __forceinline__ void fold_half(float (&part)[32], int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float lo = part[i], hi = part[i + W];
    const float send = upper ? lo : hi;
    part[i] = (upper ? hi : lo) + __shfl_xor_sync(kFull, send, W);
  }
}

template <int R, int HR, int WARPS>
__global__ void __launch_bounds__(32 * WARPS)
paged_mla_partial(const __nv_bfloat16* __restrict__ q_lat,       // [B, N, R]
                  const __nv_bfloat16* __restrict__ q_rope,      // [B, N, HR]
                  const __nv_bfloat16* __restrict__ pool_ckv,    // [n_pages, P, R]
                  const __nv_bfloat16* __restrict__ pool_krope,  // [n_pages, P, HR]
                  const int32_t* __restrict__ tbl,               // [B, pps]
                  const int32_t* __restrict__ pos,               // [B]
                  float* __restrict__ out,                       // [B, N, R]
                  float* __restrict__ part_acc,                  // [B, S, N, R]
                  float* __restrict__ part_ml,                   // [B, S, N, 2]
                  int N, int n_pages, int pps, float scale) {
  constexpr int C = R + HR;            // concatenated row width
  constexpr int NT = 32 * WARPS;
  constexpr int KC = (C + 63) / 64;    // score pairs per lane
  constexpr int KR = (R + 63) / 64;    // latent pairs per lane
  constexpr int CK = P * R / 8;        // 16-byte chunks of a c_kv page
  constexpr int CH = P * C / 8;        // 16-byte chunks of the staged page
  static_assert(R % 8 == 0 && HR % 8 == 0,
                "latent rows must be whole 16-byte chunks");

  __shared__ __align__(16) __nv_bfloat16 page_s[2][P * C];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.y;
  const int split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int h0 = blockIdx.x * 2 * WARPS + 2 * warp;
  const int p_b = pos[b];
  int n_iter = p_b / P + 1;
  if (n_iter > pps) n_iter = pps;
  const int j0 = split * kSplitPages;
  const int j1 = min(j0 + kSplitPages, n_iter);
  if (j0 >= j1) return;                // past this sequence's last page
  const int32_t* trow = tbl + (size_t)b * pps;
  const size_t row0 = (size_t)b * N + h0;

  float2 q[2][KC];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const size_t row = row0 + hh;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const int c = 64 * k + 2 * lane;
      float2 v = make_float2(0.f, 0.f);
      if (c < R)
        v = load2(q_lat + row * R + c);
      else if (C % 64 == 0 || c < C)
        v = load2(q_rope + row * HR + (c - R));
      q[hh][k] = v;
    }
  }

  auto stage = [&](int j, int buf) {
    int page = trow[j];
    page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
    const __nv_bfloat16* ck = pool_ckv + (size_t)page * P * R;
    const __nv_bfloat16* kr = pool_krope + (size_t)page * P * HR;
    for (int ch = threadIdx.x; ch < CH; ch += NT) {
      int row, col;
      const __nv_bfloat16* src;
      if (ch < CK) {
        row = ch / (R / 8);
        col = (ch % (R / 8)) * 8;
        src = ck + row * R + col;
      } else {
        const int c2 = ch - CK;
        row = c2 / (HR / 8);
        col = (c2 % (HR / 8)) * 8;
        src = kr + row * HR + col;
        col += R;
      }
      cp_async16(&page_s[buf][row * C + col], src);
    }
    cp_async_commit();
  };

  float m = kNegInf, l = 0.f;          // statistics of head lane / 16
  float2 acc[2][KR];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int k = 0; k < KR; ++k) acc[hh][k] = make_float2(0.f, 0.f);

  stage(j0, 0);
  for (int j = j0; j < j1; ++j) {
    const int buf = (j - j0) & 1;
    if (j + 1 < j1)
      stage(j + 1, buf ^ 1);
    else
      cp_async_commit();               // an empty group keeps the count
    cp_async_wait_1();                 // this thread's part of page j landed
    __syncthreads();                   // ... and every thread's
    const __nv_bfloat16* pg = page_s[buf];

    // partial scores part[hh * P + t] over this lane's columns
    float part[32];                    // 2 heads x P tokens
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const __nv_bfloat16* row = pg + t * C;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        const int c = 64 * k + 2 * lane;
        if (C % 64 == 0 || c < C) {
          const float2 kv = load2(row + c);
          s0 = fmaf(q[0][k].x, kv.x, s0);
          s0 = fmaf(q[0][k].y, kv.y, s0);
          s1 = fmaf(q[1][k].x, kv.x, s1);
          s1 = fmaf(q[1][k].y, kv.y, s1);
        }
      }
      part[t] = s0;
      part[P + t] = s1;
    }
    // lane l ends with the full sum of part[l] (see fold_half)
    fold_half<16>(part, lane);
    fold_half<8>(part, lane);
    fold_half<4>(part, lane);
    fold_half<2>(part, lane);
    fold_half<1>(part, lane);
    float s = part[0] * scale;
    if (j * P + (lane & (P - 1)) > p_b) s = kNegInf;

    float mt = s;
#pragma unroll
    for (int o = 1; o < P; o <<= 1)
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
    const float m_new = fmaxf(m, mt);
    const float p = expf(s - m_new);
    const float corr = expf(m - m_new);
    float ps = p;
#pragma unroll
    for (int o = 1; o < P; o <<= 1) ps += __shfl_xor_sync(kFull, ps, o);
    l = l * corr + ps;
    m = m_new;

    const float c0 = __shfl_sync(kFull, corr, 0);
    const float c1 = __shfl_sync(kFull, corr, P);
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      acc[0][k].x *= c0;
      acc[0][k].y *= c0;
      acc[1][k].x *= c1;
      acc[1][k].y *= c1;
    }
#pragma unroll
    for (int t = 0; t < P; ++t) {
      const float p0 = __shfl_sync(kFull, p, t);
      const float p1 = __shfl_sync(kFull, p, P + t);
      const __nv_bfloat16* row = pg + t * C;
#pragma unroll
      for (int k = 0; k < KR; ++k) {
        const int c = 64 * k + 2 * lane;
        if (R % 64 == 0 || c < R) {
          const float2 v = load2(row + c);
          acc[0][k].x = fmaf(p0, v.x, acc[0][k].x);
          acc[0][k].y = fmaf(p0, v.y, acc[0][k].y);
          acc[1][k].x = fmaf(p1, v.x, acc[1][k].x);
          acc[1][k].y = fmaf(p1, v.y, acc[1][k].y);
        }
      }
    }
    __syncthreads();                   // buffer `buf` is free for page j + 2
  }

  // one split: normalise and write the context; several: write this
  // split's unnormalised context and its (m, l) for paged_mla_combine
  const float l0 = __shfl_sync(kFull, l, 0), l1 = __shfl_sync(kFull, l, P);
  const float m0 = __shfl_sync(kFull, m, 0), m1 = __shfl_sync(kFull, m, P);
  const bool whole = n_splits == 1;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float d = whole ? fmaxf(hh ? l1 : l0, 1e-30f) : 1.f;
    const size_t row = row0 + hh;
    float* orow = whole ? out + row * R
                        : part_acc + (((size_t)b * n_splits + split) * N +
                                      h0 + hh) * R;
#pragma unroll
    for (int k = 0; k < KR; ++k) {
      const int c = 64 * k + 2 * lane;
      if (R % 64 == 0 || c < R)
        *reinterpret_cast<float2*>(orow + c) =
            make_float2(acc[hh][k].x / d, acc[hh][k].y / d);
    }
    if (!whole && lane == 0)
      *reinterpret_cast<float2*>(
          part_ml + (((size_t)b * n_splits + split) * N + h0 + hh) * 2) =
          make_float2(hh ? m1 : m0, hh ? l1 : l0);
  }
}

// Merge the splits of one (sequence, head): M = max m_s,
// out = sum_s acc_s e^(m_s - M) / max(sum_s l_s e^(m_s - M), 1e-30), over
// the splits that held pages of the sequence.  One thread per column pair.
template <int R>
__global__ void paged_mla_combine(const float* __restrict__ part_acc,
                                  const float* __restrict__ part_ml,
                                  const int32_t* __restrict__ pos,
                                  float* __restrict__ out, int N, int pps) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int S = (pps + kSplitPages - 1) / kSplitPages;
  int n_iter = pos[b] / P + 1;
  if (n_iter > pps) n_iter = pps;
  const int used = (n_iter + kSplitPages - 1) / kSplitPages;
  const float* ml = part_ml + ((size_t)b * S * N + h) * 2;
  float mx = kNegInf;
  for (int s = 0; s < used; ++s) mx = fmaxf(mx, ml[(size_t)s * N * 2]);
  float den = 0.f;
  float2 num = make_float2(0.f, 0.f);
  const int c = 2 * threadIdx.x;
  for (int s = 0; s < used; ++s) {
    const float w = expf(ml[(size_t)s * N * 2] - mx);
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

template <int R, int HR, int WARPS>
cudaError_t launch(const void* q_lat, const void* q_rope, const void* ckv,
                   const void* krope, const void* tbl, const void* pos,
                   void* out, void* part_acc, void* part_ml, int B, int N,
                   int n_pages, int pps, float scale, cudaStream_t stream) {
  const int S = (pps + kSplitPages - 1) / kSplitPages;
  dim3 grid(N / (2 * WARPS), B, S);
  paged_mla_partial<R, HR, WARPS><<<grid, 32 * WARPS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q_lat),
      static_cast<const __nv_bfloat16*>(q_rope),
      static_cast<const __nv_bfloat16*>(ckv),
      static_cast<const __nv_bfloat16*>(krope),
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(pos),
      static_cast<float*>(out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), N, n_pages, pps, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || S == 1) return err;
  paged_mla_combine<R><<<dim3(N, B), R / 2, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int32_t*>(pos), static_cast<float*>(out), N, pps);
  return cudaGetLastError();
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

// Pages one block scores: a table of pps pages runs in
// ceil(pps / repro_paged_mla_split_pages()) splits, and the wrapper sizes the
// split scratch from it.
int repro_paged_mla_split_pages() { return kSplitPages; }

// q_lat [B, N, R], q_rope [B, N, HR], pool_ckv [n_pages, P, R], pool_krope
// [n_pages, P, HR] bf16 (contiguous, 16-byte aligned), tbl [B, pps] int32,
// pos [B] int32, out [B, N, R] fp32; with more than one split, part_acc
// [B, S, N, R] and part_ml [B, S, N, 2] fp32 scratch (unused, and may be
// null, with one).  Launches on `stream` and returns cudaGetLastError()
// (0 = launched).
int repro_paged_mla_attention(const void* q_lat, const void* q_rope,
                              const void* pool_ckv, const void* pool_krope,
                              const void* tbl, const void* pos, void* out,
                              void* part_acc, void* part_ml, int B, int N,
                              int R, int HR, int page, int n_pages, int pps,
                              float scale, void* stream) {
  if (B <= 0 || pps <= 0 || !repro_paged_mla_supported(N, R, HR, page))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (R == 512)
    return (int)launch<512, 64, 8>(q_lat, q_rope, pool_ckv, pool_krope, tbl,
                                   pos, out, part_acc, part_ml, B, N, n_pages,
                                   pps, scale, s);
  return (int)launch<32, 16, 2>(q_lat, q_rope, pool_ckv, pool_krope, tbl, pos,
                                out, part_acc, part_ml, B, N, n_pages, pps,
                                scale, s);
}

}  // extern "C"
