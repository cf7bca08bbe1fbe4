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
// HBM).
//
// What the design does about it:
//  * one block of 4 warps per (64-row query tile, query head, sequence);
//    each warp owns 16 query rows, held in registers as mma.sync A
//    fragments for the whole key loop;
//  * key/value tiles of 64 keys are staged in shared memory as bf16 by
//    cp.async, two stages deep, so the next tile loads while this one is
//    multiplied; rows are padded by 8 elements so ldmatrix reads are free
//    of bank conflicts; keys >= Skv are zero-filled (a 0 probability times
//    uninitialised memory could be NaN);
//  * both products on the tensor cores: S = Q K^T and O += P V with
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate).  P is rounded to bf16
//    for the second product (the reference keeps it fp32); the row sums l
//    use the unrounded fp32 P;
//  * GQA by index (kv head = query head / G): no repeated K/V copy, and no
//    transpose: rows are read through their strides in the BSHD layout;
//  * no padding: the kernel masks keys >= Skv itself and does not store
//    rows >= Sq;
//  * key tiles wholly above the causal diagonal or wholly before the
//    window are skipped (they contribute exact zeros in the reference), and
//    the causal tiles with the most keys are scheduled first;
//  * the masked sentinel stays the finite NEG_INF = -1e30, as in the Pallas
//    kernel: a row whose first visited tile is fully masked carries m =
//    NEG_INF and p = 1 until a tile with a valid key rescales that away by
//    exp(NEG_INF - m) = 0 (with -inf the same row would give NaN).
//  The softmax runs in base 2: the scale folds log2(e) in, so exp2f serves.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int BM = 64;        // query rows per block (16 per warp)
constexpr int BN = 64;        // keys per staged tile
constexpr int NW = 4;         // warps per block
constexpr int NT = 32 * NW;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d[16x8] += a[16x16] * b[16x8], bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A 16x16: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//            a2 (row g, cols 8+2t..), a3 (row g+8, cols 8+2t..)
//   B 16x8:  b0 (rows 2t..2t+1, col g), b1 (rows 8+2t.., col g)
//   C 16x8:  c0 c1 (row g, cols 2t, 2t+1), c2 c3 (row g+8, same cols)
// So the C fragments of two neighbouring 8-key score tiles are, once
// rounded to bf16, the A fragment of P over those 16 keys.
template <int H>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,  // [B, Sq, Nq, H]
                 const __nv_bfloat16* __restrict__ k,  // [B, Skv, Nkv, H]
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ out,      // [B, Sq, Nq, H]
                 int sq, int skv, int nq, int nkv, int causal, int window,
                 float scale_log2) {
  constexpr int ROW = H + 8;       // padded shared row, in elements
  constexpr int KC = H / 16;       // 16-wide chunks of the head dim
  constexpr int NTH = H / 8;       // 8-wide output column tiles
  constexpr int NJ = BN / 8;       // 8-key score tiles per staged tile
  constexpr int TILE = BN * ROW;   // one staged K or V tile, in elements
  constexpr int CPR = H / 8;       // 16-byte chunks per row
  static_assert(KC % 2 == 0, "head dim must be a multiple of 32");
  extern __shared__ __align__(16) __nv_bfloat16 smem[];  // [2][K, V]

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int qh = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = qh / (nq / nkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = qt * BM;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const size_t q_stride = (size_t)nq * H;    // between query positions
  const size_t kv_stride = (size_t)nkv * H;  // between key positions

  // key tiles holding a key that some row of this block may see
  int hi = skv;
  if (causal) hi = min(hi, min(q0 + BM, sq));
  const int lo = window ? max(0, q0 - window + 1) : 0;
  const int t_lo = lo / BN;
  const int t_hi = (hi + BN - 1) / BN;

  const __nv_bfloat16* kb = k + (size_t)b * skv * kv_stride + (size_t)kvh * H;
  const __nv_bfloat16* vb = v + (size_t)b * skv * kv_stride + (size_t)kvh * H;
  auto load_tile = [&](int t, int stage) {
    __nv_bfloat16* ks = smem + stage * 2 * TILE;
    __nv_bfloat16* vs = ks + TILE;
    for (int c = threadIdx.x; c < BN * CPR; c += NT) {
      const int r = c / CPR, col = (c % CPR) * 8;
      const int key = t * BN + r;
      const int bytes = key < skv ? 16 : 0;
      const size_t off = (size_t)(key < skv ? key : 0) * kv_stride + col;
      cp_async16(ks + r * ROW + col, kb + off, bytes);
      cp_async16(vs + r * ROW + col, vb + off, bytes);
    }
    cp_async_commit();
  };
  if (t_lo < t_hi) load_tile(t_lo, 0);

  // this warp's 16 query rows as A fragments, zero past Sq
  const __nv_bfloat16* qb = q + (size_t)b * sq * q_stride + (size_t)qh * H;
  uint32_t qf[KC][4];
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i & 1) * 8;
      const int col = kc * 16 + (i >> 1) * 8 + 2 * t4;
      qf[kc][i] = row < sq ? *reinterpret_cast<const uint32_t*>(
                                 qb + (size_t)row * q_stride + col)
                           : 0u;
    }
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NTH][4];
#pragma unroll
  for (int n = 0; n < NTH; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int stage = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      load_tile(t + 1, stage ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = smem + stage * 2 * TILE;
    const __nv_bfloat16* vs = ks + TILE;

    // S = Q K^T over this warp's 16 rows and the tile's 64 keys
    float s[NJ][4];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; kc += 2) {
        uint32_t kf[4];
        ldmatrix_x4(kf, ks + (j * 8 + (lane & 7)) * ROW + kc * 16 +
                            (lane >> 3) * 8);
        mma_bf16(s[j], qf[kc], kf[0], kf[1]);
        mma_bf16(s[j], qf[kc + 1], kf[2], kf[3]);
      }
    }

    // scale (base 2) and mask; only tiles that cross an edge test keys
    const int key0 = t * BN;
    const bool edge = key0 + BN > skv || (causal && key0 + BN - 1 > q0) ||
                      (window && key0 <= q0 + BM - 1 - window);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float x = s[j][i] * scale_log2;
        if (edge) {
          const int key = key0 + j * 8 + 2 * t4 + (i & 1);
          const int row = r0 + (i >> 1) * 8;
          bool ok = key < skv;
          if (causal) ok = ok && key <= row;
          if (window) ok = ok && key > row - window;
          if (!ok) x = kNegInf;
        }
        s[j][i] = x;
      }
    }

    // online softmax: each row's 64 scores lie in one quad of lanes
    float mt[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mt[0] = fmaxf(mt[0], fmaxf(s[j][0], s[j][1]));
      mt[1] = fmaxf(mt[1], fmaxf(s[j][2], s[j][3]));
    }
    float corr[2], ps[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(kFull, mt[h], 1));
      mt[h] = fmaxf(mt[h], __shfl_xor_sync(kFull, mt[h], 2));
      corr[h] = exp2f(m[h] - mt[h]);
      m[h] = mt[h];
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[j][i] - m[i >> 1]);
        s[j][i] = p;
        ps[i >> 1] += p;
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l[h] = l[h] * corr[h] + ps[h];
#pragma unroll
    for (int n = 0; n < NTH; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int hp = 0; hp < NTH / 2; ++hp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vs + (kk * 16 + (lane & 7) +
                                    ((lane >> 3) & 1) * 8) * ROW +
                                  hp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * hp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * hp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // this stage is consumed before it is loaded again
  }

  __nv_bfloat16* ob = out + (size_t)b * sq * q_stride + (size_t)qh * H;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(kFull, l[h], 1);
    l[h] += __shfl_xor_sync(kFull, l[h], 2);
    const float denom = fmaxf(l[h], 1e-30f);
    const int row = r0 + h * 8;
    if (row < sq) {
      __nv_bfloat16* orow = ob + (size_t)row * q_stride;
#pragma unroll
      for (int n = 0; n < NTH; ++n) {
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[n][2 * h] / denom,
                                  acc[n][2 * h + 1] / denom);
      }
    }
  }
}

template <int H>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int sq, int skv, int nq, int nkv, int causal,
                   int window, float scale, cudaStream_t stream) {
  constexpr int smem = 2 * 2 * BN * (H + 8) * (int)sizeof(__nv_bfloat16);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
  }
  dim3 grid((sq + BM - 1) / BM, nq, B);
  flash_fwd_kernel<H><<<grid, NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      sq, skv, nq, nkv, causal, window, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q/out [B, Sq, Nq, H], k/v [B, Skv, Nkv, H], bf16, contiguous, 16-byte
// aligned; Nq a multiple of Nkv; H 64 or 128.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int B, int sq, int skv, int nq, int nkv,
                          int H, int causal, int window, float scale,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 64)
    return (int)launch<64>(q, k, v, out, B, sq, skv, nq, nkv, causal, window,
                           scale, s);
  if (H == 128)
    return (int)launch<128>(q, k, v, out, B, sq, skv, nq, nkv, causal,
                            window, scale, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
