// Fused exit-head entropy for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel `_exit_head_kernel` / `exit_head_entropy`
// in src/repro/kernels/exit_head.py.
//
// What it computes: for each row of x [T, D] the entropy of
// softmax(x @ W) with W [D, V], without storing the [T, V] logits:
//   per vocab tile: m = max l, s = sum exp(l - m), t = sum l * exp(l - m);
//   merged over tiles with the usual rescaling; H = m + log s - t / s.
//
// What bounds it on an H100: bytes.  W is read once per probe (granite-3-2b
// 2048 x 49155 bf16 = 201 MB, 0.060 ms at 3.35 TB/s; deepseek-v3 7168 x
// 129280 = 1.85 GB, 0.553 ms); the logits are 2 * T * D * V operations,
// 16 per byte of W at T = 16, far below the tensor cores' ~295.
//
// What the design does about it:
//  * pass 1: one block of 4 warps per (128-column vocab tile, group of 16
//    rows): 385 tiles at granite's V and 1,010 at deepseek-v3's, and with
//    four blocks resident on each of the 132 SMs no wave runs on part of
//    the card (granite's 385 tiles fit in one wave).  At T <= 16 every
//    byte of W is read exactly once; T > 16 runs one 16-row group after
//    another (grid.y);
//  * W travels through shared memory in 16-byte cp.async copies, a ring of
//    6 stages of 32 rows x 128 columns (8.7 KB each), so five stages
//    (43 KB a block, ~174 KB an SM) are in flight while one is multiplied.
//    What limits the rate is less the bytes in flight than each block's
//    serial step (wait, barrier, issue, multiply): four blocks of short
//    steps beat three of long ones and two of deep rings (PERF.md §6);
//  * the products run on the tensor cores: mma.sync m16n8k16, bf16 in,
//    fp32 accumulate.  The 16 rows of x are the A operand (one m16 tile):
//    the next step's [16, 32] slice of x is loaded into registers while
//    this step multiplies, stored to a double-buffered shared slice, and
//    read back with ldmatrix (x read as scattered 2-byte fragments cost as
//    many L1 cycles as W's bytes); each warp owns 32 vocab columns (4 n8
//    tiles);
//  * two instances, chosen by the caller:
//    - aligned (V % 8 == 0 and W 16-byte aligned, deepseek-v3): a tile row
//      is 16 whole chunks; B fragments come from ldmatrix.trans;
//    - odd pitch (granite's V = 49155: rows are only 2-byte aligned): each
//      row segment is copied as the 17 aligned chunks that cover it, and
//      the B fragments are read at that row's own shift, one bf16 at a
//      time.  W is never copied or padded;
//  * the ragged edges are masked in the kernel: rows k >= D are zero-filled
//    (0 x uninitialised shared memory could be NaN), columns >= V are
//    dropped from the (m, s, t) reductions;
//  * each block reduces its tile to per-row partial (m, s, t) in a scratch
//    buffer the wrapper allocates; pass 2 (one block per row) merges the
//    partials and finishes the entropy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int BV = 128;             // vocab columns per tile (32 per warp)
constexpr int TB = 16;              // rows per tile: one m16 MMA tile
constexpr int DK = 32;              // rows of W per stage
constexpr int NSTAGE = 6;           // stages in the ring
constexpr int NW = BV / 32;         // warps per block, 32 columns each
constexpr int NT = 32 * NW;
constexpr int MIN_BLOCKS = 4;       // resident blocks an SM must hold
constexpr int ROWP = BV + 8;        // shared row: 136 bf16 = 17 chunks
constexpr int STAGE = DK * ROWP;    // one stage, in elements
constexpr int XROWP = DK + 8;       // shared row of the x slice
constexpr int XSLICE = TB * XROWP;  // one x slice, in elements
constexpr int XPT = (TB * DK / 8 + NT - 1) / NT;  // x chunks per thread
constexpr int SMEM = (NSTAGE * STAGE + 2 * XSLICE) * 2;
constexpr int FIN = 256;            // threads of the finish pass
constexpr int FW = FIN / 32;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; the first src_bytes come from global
// memory, the rest of the 16 are zero-filled
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Copy rows [k0, k0 + DK) x columns [n0, n0 + BV) of W into one stage.
template <bool ALIGNED>
__device__ __forceinline__ void load_stage(__nv_bfloat16* ws,
                                           const __nv_bfloat16* w, int k0,
                                           int n0, int D, int V) {
  constexpr int CH = ALIGNED ? BV / 8 : BV / 8 + 1;   // chunks per row
  const uintptr_t end = reinterpret_cast<uintptr_t>(w + (size_t)D * V);
  for (int c = threadIdx.x; c < DK * CH; c += NT) {
    const int r = c / CH, cc = c % CH;
    const int k = k0 + r;
    const __nv_bfloat16* src = w;
    int bytes = 0;
    if (k < D) {
      if (ALIGNED) {
        const int col = n0 + cc * 8;
        if (col < V) {
          src = w + (size_t)k * V + col;
          bytes = 16;
        }
      } else {
        // the aligned chunks covering elements k*V + n0 ... + BV; the
        // first may start before W's first byte, but inside its 16-byte
        // granule (so inside the same allocation page); the last is cut
        // at W's end
        const uintptr_t a =
            reinterpret_cast<uintptr_t>(w + (size_t)k * V + n0);
        const uintptr_t c0 = (a & ~uintptr_t(15)) + 16 * (uintptr_t)cc;
        if (c0 < end) {
          src = reinterpret_cast<const __nv_bfloat16*>(c0);
          bytes = end - c0 < 16 ? (int)(end - c0) : 16;
        }
      }
    }
    cp_async16(ws + r * ROWP + cc * 8, src, bytes);
  }
}

// Fragment layouts of mma.m16n8k16 (lane = 4 * g + t):
//   A 16x16: a0 (row g, cols 2t..2t+1), a1 (row g+8, same cols),
//            a2 (row g, cols 8+2t..), a3 (row g+8, cols 8+2t..)
//   B 16x8:  b0 (rows 2t..2t+1, col g), b1 (rows 8+2t.., col g)
//   C 16x8:  c0 c1 (row g, cols 2t, 2t+1), c2 c3 (row g+8, same cols)
template <bool ALIGNED>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
exit_head_partial(const __nv_bfloat16* __restrict__ x,   // [T, D]
                  const __nv_bfloat16* __restrict__ w,   // [D, V]
                  float* __restrict__ part_m,            // [T, n_tiles]
                  float* __restrict__ part_s,
                  float* __restrict__ part_t,
                  int T, int D, int V, int n_tiles) {
  // [NSTAGE][DK][ROWP] W ring, then [2][TB][XROWP] x slices
  extern __shared__ __align__(16) __nv_bfloat16 ring[];
  __nv_bfloat16* xs = ring + NSTAGE * STAGE;

  const int tile = blockIdx.x;
  const int n0 = tile * BV;
  const int r0 = blockIdx.y * TB;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int nk = (D + DK - 1) / DK;
  // odd pitch: a row's element offset inside its first 16-byte chunk is
  // (base + k * V + n0) mod 8, in elements
  const int v7 = V & 7;
  const int b7 = (int)((reinterpret_cast<uintptr_t>(w) & 15) >> 1);
  // x rows in 16-byte loads where they are 16-byte aligned
  const bool xvec = D % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;

  // this thread's 8-element chunks of the [TB, DK] x slice of step ks,
  // zero past T and D
  uint4 xr[XPT];
  auto load_x = [&](int ks) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = threadIdx.x + i * NT;
      const int row = r0 + c / (DK / 8), k = ks * DK + (c % (DK / 8)) * 8;
      const __nv_bfloat16* src = x + (size_t)row * D + k;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (c < TB * DK / 8 && row < T) {
        if (xvec && k < D) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          unsigned short e[8];
#pragma unroll
          for (int j = 0; j < 8; ++j)
            e[j] = k + j < D
                       ? __ldg(reinterpret_cast<const unsigned short*>(src) + j)
                       : (unsigned short)0;
          v = make_uint4(e[0] | (uint32_t)e[1] << 16,
                         e[2] | (uint32_t)e[3] << 16,
                         e[4] | (uint32_t)e[5] << 16,
                         e[6] | (uint32_t)e[7] << 16);
        }
      }
      xr[i] = v;
    }
  };
  auto store_x = [&](int ks) {
#pragma unroll
    for (int i = 0; i < XPT; ++i) {
      const int c = threadIdx.x + i * NT;
      if (c < TB * DK / 8)
        *reinterpret_cast<uint4*>(xs + (ks & 1) * XSLICE +
                                  (c / (DK / 8)) * XROWP +
                                  (c % (DK / 8)) * 8) = xr[i];
    }
  };

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < nk) load_stage<ALIGNED>(ring + s * STAGE, w, s * DK, n0, D, V);
    cp_async_commit();
  }
  load_x(0);
  store_x(0);

  for (int ks = 0; ks < nk; ++ks) {
    const int k0 = ks * DK;
    // the next step's x slice: loads in flight during this step's products
    if (ks + 1 < nk) load_x(ks + 1);
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();   // stage ks and x slice ks landed; step ks - 1 done
    if (ks + NSTAGE - 1 < nk)
      load_stage<ALIGNED>(ring + ((ks + NSTAGE - 1) % NSTAGE) * STAGE, w,
                          k0 + (NSTAGE - 1) * DK, n0, D, V);
    cp_async_commit();

    const __nv_bfloat16* ws = ring + (ks % NSTAGE) * STAGE;
    const __nv_bfloat16* xk = xs + (ks & 1) * XSLICE;
#pragma unroll
    for (int kc = 0; kc < DK / 16; ++kc) {
      uint32_t a[4];
      ldmatrix_x4(a, xk + ((lane & 7) + ((lane >> 3) & 1) * 8) * XROWP +
                         kc * 16 + (lane >> 4) * 8);
      uint32_t b[4][2];
      if (ALIGNED) {
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t f[4];
          ldmatrix_x4_trans(
              f, ws + (kc * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ROWP +
                     warp * 32 + jp * 16 + (lane >> 4) * 8);
          b[2 * jp][0] = f[0];
          b[2 * jp][1] = f[1];
          b[2 * jp + 1][0] = f[2];
          b[2 * jp + 1][1] = f[3];
        }
      } else {
        const int kr = kc * 16 + 2 * t4;   // rows kr, kr+1, kr+8, kr+9
        const unsigned short* p[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = kr + (i & 1) + (i >> 1) * 8;
          const int sh = ((k0 + r) * v7 + n0 + b7) & 7;
          p[i] = reinterpret_cast<const unsigned short*>(ws + r * ROWP + sh +
                                                         warp * 32 + g);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j][0] = (uint32_t)p[0][j * 8] | ((uint32_t)p[1][j * 8] << 16);
          b[j][1] = (uint32_t)p[2][j * 8] | ((uint32_t)p[3][j * 8] << 16);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[j], a, b[j][0], b[j][1]);
    }
    if (ks + 1 < nk) store_x(ks + 1);   // the slice read in step ks - 1
  }
  cp_async_wait<0>();
  __syncthreads();   // the ring is free: the reductions reuse it
  float (*red_a)[NW] = reinterpret_cast<float (*)[NW]>(ring);
  float (*red_b)[NW] = red_a + TB;
  float* rowm = reinterpret_cast<float*>(red_b + TB);

  // columns past V drop out; rows g (i < 2) and g + 8 (i >= 2)
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = n0 + warp * 32 + j * 8 + 2 * t4 + (i & 1);
      const float l = col < V ? acc[j][i] : kNegInf;
      acc[j][i] = l;
      mx[i >> 1] = fmaxf(mx[i >> 1], l);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(kFull, mx[h], 2));
    if (t4 == 0) red_a[g + 8 * h][warp] = mx[h];
  }
  __syncthreads();
  if (threadIdx.x < TB) {
    float mm = red_a[threadIdx.x][0];
#pragma unroll
    for (int i = 1; i < NW; ++i) mm = fmaxf(mm, red_a[threadIdx.x][i]);
    rowm[threadIdx.x] = mm;
  }
  __syncthreads();
  float se[2] = {0.f, 0.f}, te[2] = {0.f, 0.f};
  const float m0 = rowm[g], m1 = rowm[g + 8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float l = acc[j][i];
      const float e = expf(l - ((i >> 1) ? m1 : m0));  // 0 where masked
      se[i >> 1] += e;
      te[i >> 1] += l * e;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    se[h] += __shfl_xor_sync(kFull, se[h], 1);
    se[h] += __shfl_xor_sync(kFull, se[h], 2);
    te[h] += __shfl_xor_sync(kFull, te[h], 1);
    te[h] += __shfl_xor_sync(kFull, te[h], 2);
  }
  __syncthreads();   // every thread has read rowm and red_a
  if (t4 == 0) {
    red_a[g][warp] = se[0];
    red_b[g][warp] = te[0];
    red_a[g + 8][warp] = se[1];
    red_b[g + 8][warp] = te[1];
  }
  __syncthreads();
  if (threadIdx.x < TB && r0 + threadIdx.x < T) {
    float ss = 0.f, tt = 0.f;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      ss += red_a[threadIdx.x][i];
      tt += red_b[threadIdx.x][i];
    }
    const size_t o = (size_t)(r0 + threadIdx.x) * n_tiles + tile;
    part_m[o] = rowm[threadIdx.x];
    part_s[o] = ss;
    part_t[o] = tt;
  }
}

__global__ void __launch_bounds__(FIN)
exit_head_finish(const float* __restrict__ part_m,
                 const float* __restrict__ part_s,
                 const float* __restrict__ part_t,
                 float* __restrict__ out, int n_tiles) {
  __shared__ float red_a[FW];
  __shared__ float red_b[FW];
  __shared__ float row_max;
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* pm = part_m + (size_t)row * n_tiles;
  const float* ps = part_s + (size_t)row * n_tiles;
  const float* pt = part_t + (size_t)row * n_tiles;

  float mm = kNegInf;
  for (int j = threadIdx.x; j < n_tiles; j += FIN) mm = fmaxf(mm, pm[j]);
  mm = warp_max(mm);
  if (lane == 0) red_a[warp] = mm;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red_a[0];
    for (int i = 1; i < FW; ++i) m = fmaxf(m, red_a[i]);
    row_max = m;
  }
  __syncthreads();
  const float m = row_max;
  float ss = 0.f, tt = 0.f;
  for (int j = threadIdx.x; j < n_tiles; j += FIN) {
    const float c = expf(pm[j] - m);
    ss = fmaf(ps[j], c, ss);
    tt = fmaf(pt[j], c, tt);
  }
  ss = warp_sum(ss);
  tt = warp_sum(tt);
  __syncthreads();
  if (lane == 0) {
    red_a[warp] = ss;
    red_b[warp] = tt;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f, t = 0.f;
    for (int i = 0; i < FW; ++i) {
      s += red_a[i];
      t += red_b[i];
    }
    out[row] = m + logf(s) - t / s;
  }
}

// Dynamic shared memory above 48 KB, and all of L1 as shared memory so
// MIN_BLOCKS blocks fit on an SM; on every launch: an attribute set once
// from one host thread is not in effect in another.
template <bool ALIGNED>
cudaError_t set_attributes() {
  cudaError_t err = cudaFuncSetAttribute(
      exit_head_partial<ALIGNED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(exit_head_partial<ALIGNED>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <bool ALIGNED>
cudaError_t launch_partial(const void* x, const void* w, float* pm,
                           float* ps, float* pt, int T, int D, int V,
                           int n_tiles, cudaStream_t s) {
  cudaError_t err = set_attributes<ALIGNED>();
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles, (T + TB - 1) / TB);
  exit_head_partial<ALIGNED><<<grid, NT, SMEM, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), pm, ps, pt, T, D, V, n_tiles);
  return cudaGetLastError();
}

template <bool ALIGNED>
int blocks_per_sm() {
  int n = 0;
  if (set_attributes<ALIGNED>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, exit_head_partial<ALIGNED>, NT, SMEM) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

extern "C" {

// Vocab tile width: the wrapper sizes the partials scratch as
// 3 * T * ceil(V / repro_exit_head_block_v()) floats.
int repro_exit_head_block_v() { return BV; }

// Blocks of pass 1 resident on one SM (-1 on a CUDA error), for the
// aligned (1) or odd-pitch (0) instance: the measure of what is in flight.
int repro_exit_head_blocks_per_sm(int aligned) {
  return aligned ? blocks_per_sm<true>() : blocks_per_sm<false>();
}

// x [T, D] bf16, w [D, V] bf16 (both contiguous), part fp32 scratch of
// 3 * T * n_tiles, out [T] fp32.  aligned = 1 takes the aligned instance
// (V % 8 == 0 and w 16-byte aligned, else cudaErrorInvalidValue), 0 the
// odd-pitch one.  Launches both passes on `stream` and returns
// cudaGetLastError() (0 = launched).
int repro_exit_head_entropy(const void* x, const void* w, void* part,
                            void* out, int T, int D, int V, int aligned,
                            void* stream) {
  if (T <= 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  if (aligned && (V % 8 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + BV - 1) / BV;
  float* pm = static_cast<float*>(part);
  float* ps = pm + (size_t)T * n_tiles;
  float* pt = ps + (size_t)T * n_tiles;
  cudaError_t err =
      aligned ? launch_partial<true>(x, w, pm, ps, pt, T, D, V, n_tiles, s)
              : launch_partial<false>(x, w, pm, ps, pt, T, D, V, n_tiles, s);
  if (err != cudaSuccess) return (int)err;
  exit_head_finish<<<T, FIN, 0, s>>>(pm, ps, pt, static_cast<float*>(out),
                                     n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
