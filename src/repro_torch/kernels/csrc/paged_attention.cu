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
// What bounds it on an H100: bytes.  Each (sequence, kv-head) reads its
// ceil((pos+1)/P) pages of K and V once; the arithmetic is 4 FMAs per
// byte of KV for G = 4, far below the card's ~295 operations per byte.
//
// What the design does about it:
//  * one block per (kv-head, sequence) holding its G query rows, so the
//    K/V page is read from device memory once for the whole query group;
//  * the pool is read in its native [n_pages, P, Nkv, H] layout through
//    its strides: no head-major transpose and no padding copy of the pool;
//  * the page loop stops at page pos[b] / P (the TPU grid walks all
//    pages_per_slot pages, sentinels included);
//  * 16-byte loads, and the next page is loaded into registers while the
//    current one is scored from shared memory (one page in flight).
// Splitting the page loop across blocks (split-K) is not done yet: at 16
// slots x 8 kv-heads the grid is 128 blocks for 132 SMs.
//
// Thread layout for a block of G warps: warp g owns query row g.  Lane
// (split, t) = (lane / P, lane % P) scores token t of the page over the
// split-th slice of the head dimension; the slices are summed with warp
// shuffles.  For the value product, lane l owns output dims
// [l * H/32, (l+1) * H/32).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <int P, int H, int G>
__global__ void __launch_bounds__(32 * G)
paged_gqa_kernel(const __nv_bfloat16* __restrict__ q,       // [B, Nkv*G, H]
                 const __nv_bfloat16* __restrict__ pool_k,  // [n_pages, P, Nkv, H]
                 const __nv_bfloat16* __restrict__ pool_v,
                 const int32_t* __restrict__ tbl,           // [B, pps]
                 const int32_t* __restrict__ pos,           // [B]
                 __nv_bfloat16* __restrict__ out,           // [B, Nkv*G, H]
                 int nkv, int n_pages, int pps, float scale) {
  constexpr int SPLIT = 32 / P;        // lanes sharing one token's dot product
  constexpr int HS = H / SPLIT;        // head dims per split
  constexpr int DL = H / 32;           // output dims per lane
  constexpr int ROW = H + 2;           // padded smem row: odd word count
  constexpr int NT = 32 * G;
  constexpr int CPR = H / 8;           // 16-byte chunks per token row
  constexpr int CH = P * CPR;          // 16-byte chunks per page (one head)
  constexpr int CPT = (CH + NT - 1) / NT;
  static_assert(32 % P == 0, "page size must divide the warp");
  static_assert(HS % 2 == 0 && DL % 2 == 0, "head dim must be a multiple of 64");

  __shared__ __align__(16) __nv_bfloat16 ks[P * ROW];
  __shared__ __align__(16) __nv_bfloat16 vs[P * ROW];

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int g = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int t_lane = lane % P;
  const int split = lane / P;
  const int qh = kvh * G + g;
  const int p_b = pos[b];
  int n_iter = p_b / P + 1;
  if (n_iter > pps) n_iter = pps;
  const int32_t* trow = tbl + (size_t)b * pps;

  float qr[HS];
  const __nv_bfloat16* qp = q + ((size_t)b * nkv * G + qh) * H + split * HS;
#pragma unroll
  for (int i = 0; i < HS; i += 2) {
    float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qp + i));
    qr[i] = f.x;
    qr[i + 1] = f.y;
  }

  uint4 kreg[CPT], vreg[CPT];
  auto load = [&](int j) {
    int page = trow[j];
    page = page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      int ch = threadIdx.x + c * NT;
      if (ch < CH) {
        int r = ch / CPR, col = (ch % CPR) * 8;
        size_t off = (((size_t)page * P + r) * nkv + kvh) * H + col;
        kreg[c] = *reinterpret_cast<const uint4*>(pool_k + off);
        vreg[c] = *reinterpret_cast<const uint4*>(pool_v + off);
      }
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      int ch = threadIdx.x + c * NT;
      if (ch < CH) {
        int r = ch / CPR, col = (ch % CPR) * 8;
        uint32_t* kd = reinterpret_cast<uint32_t*>(ks + r * ROW + col);
        uint32_t* vd = reinterpret_cast<uint32_t*>(vs + r * ROW + col);
        const uint32_t* kw = reinterpret_cast<const uint32_t*>(&kreg[c]);
        const uint32_t* vw = reinterpret_cast<const uint32_t*>(&vreg[c]);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          kd[w] = kw[w];
          vd[w] = vw[w];
        }
      }
    }
  };

  float m = kNegInf, l = 0.f;
  float acc[DL];
#pragma unroll
  for (int d = 0; d < DL; ++d) acc[d] = 0.f;

  if (n_iter > 0) load(0);
  for (int j = 0; j < n_iter; ++j) {
    __syncthreads();                   // the previous page is fully consumed
    store();
    __syncthreads();
    if (j + 1 < n_iter) load(j + 1);   // in flight while this page is scored

    const __nv_bfloat16* kr = ks + t_lane * ROW + split * HS;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < HS; i += 2) {
      float2 kf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(kr + i));
      s = fmaf(qr[i], kf.x, s);
      s = fmaf(qr[i + 1], kf.y, s);
    }
#pragma unroll
    for (int o = P; o < 32; o <<= 1) s += __shfl_xor_sync(kFull, s, o);
    s *= scale;
    if (j * P + t_lane > p_b) s = kNegInf;

    float mt = s;
#pragma unroll
    for (int o = 1; o < P; o <<= 1) mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, o));
    const float m_new = fmaxf(m, mt);
    const float p = expf(s - m_new);
    const float corr = expf(m - m_new);
    float ps = p;
#pragma unroll
    for (int o = 1; o < P; o <<= 1) ps += __shfl_xor_sync(kFull, ps, o);
    l = l * corr + ps;
#pragma unroll
    for (int d = 0; d < DL; ++d) acc[d] *= corr;
#pragma unroll
    for (int tt = 0; tt < P; ++tt) {
      const float pt = __shfl_sync(kFull, p, tt);
      const __nv_bfloat16* vr = vs + tt * ROW + lane * DL;
#pragma unroll
      for (int d = 0; d < DL; d += 2) {
        float2 vf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vr + d));
        acc[d] = fmaf(pt, vf.x, acc[d]);
        acc[d + 1] = fmaf(pt, vf.y, acc[d + 1]);
      }
    }
    m = m_new;
  }

  const float denom = fmaxf(l, 1e-30f);
  __nv_bfloat16* op = out + ((size_t)b * nkv * G + qh) * H + lane * DL;
#pragma unroll
  for (int d = 0; d < DL; d += 2) {
    *reinterpret_cast<__nv_bfloat162*>(op + d) =
        __floats2bfloat162_rn(acc[d] / denom, acc[d + 1] / denom);
  }
}

template <int P, int H>
cudaError_t launch_h(const void* q, const void* k, const void* v,
                     const void* tbl, const void* pos, void* out, int B,
                     int nkv, int G, int n_pages, int pps, float scale,
                     cudaStream_t stream) {
  dim3 grid(nkv, B);
#define REPRO_LAUNCH(GG)                                                     \
  paged_gqa_kernel<P, H, GG><<<grid, 32 * GG, 0, stream>>>(                 \
      static_cast<const __nv_bfloat16*>(q),                                 \
      static_cast<const __nv_bfloat16*>(k),                                 \
      static_cast<const __nv_bfloat16*>(v),                                 \
      static_cast<const int32_t*>(tbl), static_cast<const int32_t*>(pos),   \
      static_cast<__nv_bfloat16*>(out), nkv, n_pages, pps, scale)
  switch (G) {
    case 1: REPRO_LAUNCH(1); break;
    case 2: REPRO_LAUNCH(2); break;
    case 4: REPRO_LAUNCH(4); break;
    case 8: REPRO_LAUNCH(8); break;
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_LAUNCH
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shapes the kernel is instantiated for; the Python wrapper raises on
// anything else before launching.
int repro_paged_gqa_supported(int P, int H, int G) {
  return P == 16 && (H == 64 || H == 128) &&
         (G == 1 || G == 2 || G == 4 || G == 8);
}

// q/out [B, Nkv*G, H] bf16, pools [n_pages, P, Nkv, H] bf16 (contiguous,
// 16-byte aligned), tbl [B, pps] int32, pos [B] int32.  Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int repro_paged_gqa_attention(const void* q, const void* pool_k,
                              const void* pool_v, const void* tbl,
                              const void* pos, void* out, int B, int nkv,
                              int G, int H, int P, int n_pages, int pps,
                              float scale, void* stream) {
  if (!repro_paged_gqa_supported(P, H, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 64)
    return (int)launch_h<16, 64>(q, pool_k, pool_v, tbl, pos, out, B, nkv, G,
                                 n_pages, pps, scale, s);
  return (int)launch_h<16, 128>(q, pool_k, pool_v, tbl, pos, out, B, nkv, G,
                                n_pages, pps, scale, s);
}

}  // extern "C"
