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
// j <= i - window (window > 0), P = softmax(s) by rows:
//   D_i = sum_h dO_ih O_ih, dP = dO V^T, dS = P o (dP - D),
//   dQ = dS K / sqrt(H), dK = dS^T Q / sqrt(H), dV = P^T dO,
// dK and dV summed over each kv head's G query heads; bf16 outputs.
//
// What bounds it on an H100: operations.  The five products take 10 H
// FLOPs a visible (query, key) pair; at granite-3-2b's training shape (S
// 1024, H 64, causal) that is 640 FLOPs a pair against 2 H bytes a row of
// each of q, k, v, o, dO, dq, dk, dv: past the card's ~295 FLOPs a byte.
//
// What the design does about it (simple first: warp-level tensor-core
// products through the WMMA API, no TMA, no pipelining):
//  * kernel A, one block per (64-row query tile, query head, sequence),
//    four warps of 16 rows: loads q, dO and o, takes D; pass 1 recomputes
//    the row max and sum over the visible key tiles (online) and writes
//    the log-sum-exp and D to fp32 scratch; pass 2 recomputes P from the
//    log-sum-exp, dP = dO V^T, dS, and accumulates dQ += dS K in fp32
//    fragments.  The forward kernel writes no log-sum-exp, so it stays as
//    it is;
//  * kernel B, launched after A on the same stream, one block per (64-key
//    tile, kv head, sequence): loops over the G query heads and the query
//    tiles that can see its keys, recomputes P^T = exp(K Q^T / sqrt(H) -
//    lse) and dP^T = V dO^T, and accumulates dV += P^T dO and
//    dK += dS^T Q in fp32 fragments (each warp owns 16 keys);
//  * P and dS enter the tensor cores as bf16, every sum is fp32; no
//    atomics, so the gradients are the same on every run;
//  * tiles wholly above the causal diagonal or before the window are not
//    visited (their P is exactly 0); edge tiles mask per element; rows past
//    Sq and keys past Skv load as zeros, take P = 0 and are not stored.
//    Causal query tiles with the most keys are scheduled first.
//  * Rows with no visible key (no causal mask but a window) are refused by
//    the entry point: the reference gives them a uniform P over all keys,
//    which the skipped tiles would miss.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int BM = 64;         // query rows a tile
constexpr int BN = 64;         // keys a tile
constexpr int NW = 4;          // warps a block, 16 rows (A) or keys (B) each
constexpr int NT = 32 * NW;
constexpr int SP = BN + 4;     // pitch (floats) of a [64, 64] fp32 tile
constexpr int PP = BN + 8;     // pitch (elements) of a [64, 64] bf16 tile

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>
    FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
    FragBRow;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    FragBCol;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

constexpr int align128(int x) { return (x + 127) & ~127; }

template <int H>
struct Cfg {
  static constexpr int HP = H + 8;                      // bf16 row pitch
  static constexpr int HF = H / 16;                     // fragments across H
  static constexpr int OP = H + 4;                      // fp32 staging pitch
  static constexpr int TILE = align128(64 * HP * 2);    // a [64, H] bf16 tile
  static constexpr int FT = align128(64 * SP * 4);      // a [64, 64] fp32 tile
  static constexpr int PT = align128(64 * PP * 2);      // a [64, 64] bf16 tile
  static constexpr int STAGE = align128(64 * OP * 4);   // [64, H] fp32 staging
  static constexpr int F2 = 2 * FT > STAGE ? 2 * FT : STAGE;
  // A: q, dO, k (o first), v tiles; S and dP, then the dQ staging; dS
  static constexpr int SMEM_A = 4 * TILE + F2 + PT;
  // B: k, v, q, dO tiles; lse and D of the query tile; S^T and dP^T, then
  // the staging; P^T and dS^T
  static constexpr int STATS = align128(2 * 64 * 4);
  static constexpr int SMEM_B = 4 * TILE + STATS + F2 + 2 * PT;
};

__device__ __forceinline__ bool visible(int i, int j, int causal,
                                        int window) {
  return (!causal || j <= i) && (window == 0 || j > i - window);
}

// 64 rows of H bf16 each, row r at src + r * stride, into a tile of pitch
// HP; rows from `valid` on are zeros.
template <int H>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          long long stride, int valid) {
  constexpr int CPR = H / 8;
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += NT) {
    const int r = idx / CPR, c = idx - r * CPR;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      val = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c * 8));
    *reinterpret_cast<uint4*>(dst + r * Cfg<H>::HP + c * 8) = val;
  }
}

// out[16, 64] (fp32, pitch SP) = a[16, H] . b[64, H]^T (bf16, pitch HP)
template <int H>
__device__ __forceinline__ void rows_by_rows_t(float* out, const bf16* a,
                                               const bf16* b) {
  constexpr int HP = Cfg<H>::HP, HF = Cfg<H>::HF;
  FragA fa[HF];
#pragma unroll
  for (int kk = 0; kk < HF; ++kk)
    wmma::load_matrix_sync(fa[kk], a + 16 * kk, HP);
#pragma unroll
  for (int c = 0; c < BN / 16; ++c) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < HF; ++kk) {
      FragBCol fb;
      wmma::load_matrix_sync(fb, b + 16 * c * HP + 16 * kk, HP);
      wmma::mma_sync(acc, fa[kk], fb, acc);
    }
    wmma::store_matrix_sync(out + 16 * c, acc, SP, wmma::mem_row_major);
  }
}

// acc[16, H] += p[16, 64] (bf16, pitch PP) . b[64, H] (bf16, pitch HP)
template <int H>
__device__ __forceinline__ void acc_rows(FragC* acc, const bf16* p,
                                         const bf16* b) {
  constexpr int HP = Cfg<H>::HP, HF = Cfg<H>::HF;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, p + 16 * kk, PP);
#pragma unroll
    for (int f = 0; f < HF; ++f) {
      FragBRow fb;
      wmma::load_matrix_sync(fb, b + 16 * kk * HP + 16 * f, HP);
      wmma::mma_sync(acc[f], fa, fb, acc[f]);
    }
  }
}

// A warp's 16 x H fp32 fragments, times `mul`, to bf16 rows at dst +
// r * stride for r < valid, through the warp's staging rows (pitch OP).
template <int H>
__device__ __forceinline__ void store_rows(bf16* dst, long long stride,
                                           int valid, FragC* acc, float mul,
                                           float* stage, int lane) {
  constexpr int OP = Cfg<H>::OP, HF = Cfg<H>::HF;
#pragma unroll
  for (int f = 0; f < HF; ++f) {
#pragma unroll
    for (int e = 0; e < acc[f].num_elements; ++e) acc[f].x[e] *= mul;
    wmma::store_matrix_sync(stage + 16 * f, acc[f], OP, wmma::mem_row_major);
  }
  __syncwarp();
  const int r = lane >> 1, h0 = (lane & 1) * (H / 2);
  if (r < valid) {
#pragma unroll
    for (int c = 0; c < H / 2; c += 8) {
      const float* s = stage + r * OP + h0 + c;
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int t = 0; t < 8; ++t) tmp[t] = __float2bfloat16(s[t]);
      *reinterpret_cast<uint4*>(dst + r * stride + h0 + c) =
          *reinterpret_cast<const uint4*>(tmp);
    }
  }
  __syncwarp();
}

template <int H>
__global__ void __launch_bounds__(NT)
    dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ o,
              const bf16* __restrict__ dout, bf16* __restrict__ dq,
              float* __restrict__ lse_out, float* __restrict__ d_out, int sq,
              int skv, int nq, int nkv, int causal, int window,
              float scale) {
  using C = Cfg<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + C::TILE);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * C::TILE);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * C::TILE);
  float* sS = reinterpret_cast<float*>(smem + 4 * C::TILE);
  float* sdP = reinterpret_cast<float*>(smem + 4 * C::TILE + C::FT);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * C::TILE + C::F2);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int i0 = qt * BM, n = blockIdx.y, b = blockIdx.z;
  const int kvh = n / (nq / nkv);
  const long long qstride = (long long)nq * H, kstride = (long long)nkv * H;
  const long long qbase = ((long long)b * sq + i0) * qstride + (long long)n * H;
  const int qvalid = min(BM, sq - i0);
  load_rows<H>(sQ, q + qbase, qstride, qvalid);
  load_rows<H>(sdO, dout + qbase, qstride, qvalid);
  load_rows<H>(sK, o + qbase, qstride, qvalid);    // o: for D only
  __syncthreads();

  // each lane owns half a row: row r of the warp's 16, columns half * 32..
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r, i = i0 + row;
  float dsum = 0.0f;
  {
    const bf16* a = sdO + row * C::HP + half * (H / 2);
    const bf16* c = sK + row * C::HP + half * (H / 2);
#pragma unroll 8
    for (int h = 0; h < H / 2; ++h)
      dsum += __bfloat162float(a[h]) * __bfloat162float(c[h]);
    dsum += __shfl_xor_sync(kFull, dsum, 1);
  }
  __syncthreads();    // the o tile is overwritten by k below

  const int hi = causal ? min(skv, i0 + BM) : skv;
  const int lo = window ? max(0, i0 - window + 1) : 0;
  const int t_lo = lo / BN, t_hi = (hi + BN - 1) / BN;
  float* sSw = sS + warp * 16 * SP;
  float* sdPw = sdP + warp * 16 * SP;
  bf16* sPw = sP + warp * 16 * PP;
  const bf16* sQw = sQ + warp * 16 * C::HP;
  const bf16* sdOw = sdO + warp * 16 * C::HP;

  // pass 1: row max and sum over the visible keys (each lane its half row)
  float m = kNegInf, l = 0.0f;
  for (int t = t_lo; t < t_hi; ++t) {
    const int j0 = t * BN;
    load_rows<H>(sK, k + ((long long)b * skv + j0) * kstride +
                         (long long)kvh * H, kstride, min(BN, skv - j0));
    __syncthreads();
    rows_by_rows_t<H>(sSw, sQw, sK);
    __syncwarp();
    const float* srow = sSw + r * SP + half * 32;
    const int jb = j0 + half * 32;
    float tmax = kNegInf;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int j = jb + c;
      const float x = (j < skv && visible(i, j, causal, window))
                          ? srow[c] * scale : kNegInf;
      tmax = fmaxf(tmax, x);
    }
    const float mn = fmaxf(m, tmax);
    float acc = 0.0f;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int j = jb + c;
      const float x = (j < skv && visible(i, j, causal, window))
                          ? srow[c] * scale : kNegInf;
      acc += expf(x - mn);
    }
    l = l * expf(m - mn) + acc;
    m = mn;
    __syncthreads();  // sK is reloaded next
  }
  const float m2 = __shfl_xor_sync(kFull, m, 1);
  const float l2 = __shfl_xor_sync(kFull, l, 1);
  const float mt = fmaxf(m, m2);
  const float lse = mt + logf(l * expf(m - mt) + l2 * expf(m2 - mt));
  if (half == 0 && i < sq) {
    const long long si = ((long long)b * nq + n) * sq + i;
    lse_out[si] = lse;
    d_out[si] = dsum;
  }

  // pass 2: dS and dQ += dS K
  FragC acc[C::HF];
#pragma unroll
  for (int f = 0; f < C::HF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  for (int t = t_lo; t < t_hi; ++t) {
    const int j0 = t * BN;
    const long long kbase = ((long long)b * skv + j0) * kstride +
                            (long long)kvh * H;
    const int kvalid = min(BN, skv - j0);
    load_rows<H>(sK, k + kbase, kstride, kvalid);
    load_rows<H>(sV, v + kbase, kstride, kvalid);
    __syncthreads();
    rows_by_rows_t<H>(sSw, sQw, sK);
    rows_by_rows_t<H>(sdPw, sdOw, sV);
    __syncwarp();
    const int jb = j0 + half * 32;
#pragma unroll 8
    for (int c = 0; c < 32; ++c) {
      const int j = jb + c, col = half * 32 + c;
      const bool vis = i < sq && j < skv && visible(i, j, causal, window);
      const float p = vis ? expf(sSw[r * SP + col] * scale - lse) : 0.0f;
      sPw[r * PP + col] = __float2bfloat16(p * (sdPw[r * SP + col] - dsum));
    }
    __syncwarp();
    acc_rows<H>(acc, sPw, sK);
    __syncthreads();  // sK, sV are reloaded next
  }
  store_rows<H>(dq + qbase + warp * 16 * qstride, qstride, qvalid - warp * 16,
                acc, scale, sS + warp * 16 * C::OP, lane);
}

template <int H>
__global__ void __launch_bounds__(NT)
    dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dd,
               bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int skv,
               int nq, int nkv, int causal, int window, float scale) {
  using C = Cfg<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + C::TILE);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * C::TILE);
  bf16* sdO = reinterpret_cast<bf16*>(smem + 3 * C::TILE);
  float* sL = reinterpret_cast<float*>(smem + 4 * C::TILE);
  float* sD = sL + 64;
  float* sS = reinterpret_cast<float*>(smem + 4 * C::TILE + C::STATS);
  float* sdP = reinterpret_cast<float*>(smem + 4 * C::TILE + C::STATS + C::FT);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * C::TILE + C::STATS + C::F2);
  bf16* sdS = reinterpret_cast<bf16*>(smem + 4 * C::TILE + C::STATS + C::F2 +
                                      C::PT);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int j0 = blockIdx.x * BN, kvh = blockIdx.y, b = blockIdx.z;
  const int g = nq / nkv;
  const long long qstride = (long long)nq * H, kstride = (long long)nkv * H;
  const long long kbase = ((long long)b * skv + j0) * kstride +
                          (long long)kvh * H;
  const int kvalid = min(BN, skv - j0);
  load_rows<H>(sK, k + kbase, kstride, kvalid);
  load_rows<H>(sV, v + kbase, kstride, kvalid);

  // the query tiles that can see a key of this tile
  const int lo_q = causal ? j0 : 0;
  const int hi_q = window ? min(sq, j0 + BN - 1 + window) : sq;
  const int qt_lo = lo_q / BM, qt_hi = (hi_q + BM - 1) / BM;

  const int r = lane >> 1, half = lane & 1;
  const int j = j0 + warp * 16 + r;     // this lane's key
  float* sSw = sS + warp * 16 * SP;
  float* sdPw = sdP + warp * 16 * SP;
  bf16* sPw = sP + warp * 16 * PP;
  bf16* sdSw = sdS + warp * 16 * PP;
  const bf16* sKw = sK + warp * 16 * C::HP;
  const bf16* sVw = sV + warp * 16 * C::HP;
  FragC acc_k[C::HF], acc_v[C::HF];
#pragma unroll
  for (int f = 0; f < C::HF; ++f) {
    wmma::fill_fragment(acc_k[f], 0.0f);
    wmma::fill_fragment(acc_v[f], 0.0f);
  }
  for (int gi = 0; gi < g; ++gi) {
    const int n = kvh * g + gi;
    for (int qt = qt_lo; qt < qt_hi; ++qt) {
      const int i0 = qt * BM;
      const long long qbase = ((long long)b * sq + i0) * qstride +
                              (long long)n * H;
      const int qvalid = min(BM, sq - i0);
      __syncthreads();  // the previous tile's readers are done
      load_rows<H>(sQ, q + qbase, qstride, qvalid);
      load_rows<H>(sdO, dout + qbase, qstride, qvalid);
      for (int idx = threadIdx.x; idx < 64; idx += NT) {
        const long long si = ((long long)b * nq + n) * sq + i0 + idx;
        sL[idx] = idx < qvalid ? lse[si] : 0.0f;
        sD[idx] = idx < qvalid ? dd[si] : 0.0f;
      }
      __syncthreads();
      rows_by_rows_t<H>(sSw, sKw, sQ);     // S^T: this warp's keys x queries
      rows_by_rows_t<H>(sdPw, sVw, sdO);   // dP^T
      __syncwarp();
#pragma unroll 8
      for (int c = 0; c < 32; ++c) {
        const int col = half * 32 + c, i = i0 + col;
        const bool vis = i < sq && j < skv && visible(i, j, causal, window);
        const float p = vis ? expf(sSw[r * SP + col] * scale - sL[col])
                            : 0.0f;
        sPw[r * PP + col] = __float2bfloat16(p);
        sdSw[r * PP + col] =
            __float2bfloat16(p * (sdPw[r * SP + col] - sD[col]));
      }
      __syncwarp();
      acc_rows<H>(acc_v, sPw, sdO);
      acc_rows<H>(acc_k, sdSw, sQ);
    }
  }
  __syncthreads();  // the staging below overlaps other warps' S^T rows
  float* stage = sS + warp * 16 * C::OP;
  bf16* dkw = dk + kbase + warp * 16 * kstride;
  bf16* dvw = dv + kbase + warp * 16 * kstride;
  store_rows<H>(dkw, kstride, kvalid - warp * 16, acc_k, scale, stage, lane);
  store_rows<H>(dvw, kstride, kvalid - warp * 16, acc_v, 1.0f, stage, lane);
}

template <int H>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dout, void* dq, void* dk,
                   void* dv, void* lse, void* dd, int B, int sq, int skv,
                   int nq, int nkv, int causal, int window, float scale,
                   cudaStream_t s) {
  using C = Cfg<H>;
  cudaError_t e = cudaFuncSetAttribute(
      dq_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_A);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(dkv_kernel<H>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           C::SMEM_B);
  if (e != cudaSuccess) return e;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* dob = static_cast<const bf16*>(dout);
  dim3 ga((sq + BM - 1) / BM, nq, B);
  dq_kernel<H><<<ga, NT, C::SMEM_A, s>>>(
      qb, kb, vb, static_cast<const bf16*>(o), dob, static_cast<bf16*>(dq),
      static_cast<float*>(lse), static_cast<float*>(dd), sq, skv, nq, nkv,
      causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 gb((skv + BN - 1) / BN, nkv, B);
  dkv_kernel<H><<<gb, NT, C::SMEM_B, s>>>(
      qb, kb, vb, dob, static_cast<const float*>(lse),
      static_cast<const float*>(dd), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), sq, skv, nq, nkv, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/o/dout/dq [B, Sq, Nq, H], k/v/dk/dv [B, Skv, Nkv, H] bf16, contiguous,
// 16-byte aligned; lse and dd fp32 scratch of B * Nq * Sq; Nq a multiple of
// Nkv; H 64 or 128; B and Nq below 65536; window > 0 only with causal.
// Launches kernel A then kernel B on `stream` and returns
// cudaGetLastError() (0 = launched).
int repro_flash_attention_bwd(const void* q, const void* k, const void* v,
                              const void* o, const void* dout, void* dq,
                              void* dk, void* dv, void* lse, void* dd, int B,
                              int sq, int skv, int nq, int nkv, int H,
                              int causal, int window, float scale,
                              void* stream) {
  if (B <= 0 || B >= 65536 || sq <= 0 || skv <= 0 || nkv <= 0 ||
      nq >= 65536 || nq % nkv != 0 || window < 0 || (window > 0 && !causal))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 64)
    return (int)launch<64>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, sq, skv,
                           nq, nkv, causal, window, scale, s);
  if (H == 128)
    return (int)launch<128>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, sq,
                            skv, nq, nkv, causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
