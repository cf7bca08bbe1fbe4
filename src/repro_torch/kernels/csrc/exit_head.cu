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
// What bounds it on an H100: bytes.  W (2048 x 49155 bf16 = 201 MB at full
// width) is read once per probe; the logits are 2 * T * D * V operations,
// about 16 per byte of W at T = 16.
//
// What the design does about it.  The TPU kernel carries (m, s, t) across a
// sequential vocab grid axis; Hopper blocks run in no order, so:
//  * pass 1: each block owns one BV-wide vocab tile for a group of up to
//    TB = 16 rows, so at T <= 16 every byte of W is read exactly once.  Each
//    thread owns one vocab column and keeps TB fp32 dot products in
//    registers; x is staged through shared memory (fp32, row-interleaved so
//    that one float4 load serves four rows).  The block reduces its tile to
//    per-row partial (m, s, t) in a scratch buffer the wrapper allocates.
//  * pass 2: one block per row merges the partials and finishes the
//    entropy.
//  * the ragged vocab edge (49155 is no multiple of BV) is masked in the
//    kernel: columns past V contribute nothing, so W is never padded.
// The dot products run on the CUDA cores in fp32 (bf16 in, fp32
// accumulate); tensor cores and asynchronous copies are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int BV = 256;            // vocab columns per block (one per thread)
constexpr int TB = 16;             // rows per block
constexpr int DK = 256;            // depth staged through shared memory
constexpr int NW = BV / 32;

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

__global__ void __launch_bounds__(BV)
exit_head_partial(const __nv_bfloat16* __restrict__ x,   // [T, D]
                  const __nv_bfloat16* __restrict__ w,   // [D, V]
                  float* __restrict__ part_m,            // [T, n_tiles]
                  float* __restrict__ part_s,
                  float* __restrict__ part_t,
                  int T, int D, int V, int n_tiles) {
  __shared__ __align__(16) float xs[DK * TB];
  __shared__ float red_a[TB][NW];
  __shared__ float red_b[TB][NW];
  __shared__ float rowm[TB];

  const int tile = blockIdx.x;
  const int r0 = blockIdx.y * TB;
  const int v = tile * BV + threadIdx.x;
  const bool valid = v < V;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float acc[TB];
#pragma unroll
  for (int r = 0; r < TB; ++r) acc[r] = 0.f;

  for (int k0 = 0; k0 < D; k0 += DK) {
    const int kn = min(DK, D - k0);
    __syncthreads();                   // previous chunk fully consumed
    for (int i = threadIdx.x; i < DK * TB; i += BV) {
      const int kk = i / TB, r = i % TB;
      float val = 0.f;
      if (kk < kn && r0 + r < T)
        val = __bfloat162float(x[(size_t)(r0 + r) * D + k0 + kk]);
      xs[i] = val;
    }
    __syncthreads();
    if (valid) {
      const __nv_bfloat16* wp = w + (size_t)k0 * V + v;
#pragma unroll 8
      for (int kk = 0; kk < kn; ++kk) {
        const float wv = __bfloat162float(wp[(size_t)kk * V]);
        const float4* xr = reinterpret_cast<const float4*>(xs + kk * TB);
#pragma unroll
        for (int q4 = 0; q4 < TB / 4; ++q4) {
          const float4 xv = xr[q4];
          acc[4 * q4 + 0] = fmaf(xv.x, wv, acc[4 * q4 + 0]);
          acc[4 * q4 + 1] = fmaf(xv.y, wv, acc[4 * q4 + 1]);
          acc[4 * q4 + 2] = fmaf(xv.z, wv, acc[4 * q4 + 2]);
          acc[4 * q4 + 3] = fmaf(xv.w, wv, acc[4 * q4 + 3]);
        }
      }
    }
  }

  // per-row tile max
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    const float mv = warp_max(valid ? acc[r] : kNegInf);
    if (lane == 0) red_a[r][warp] = mv;
  }
  __syncthreads();
  if (threadIdx.x < TB) {
    float mm = red_a[threadIdx.x][0];
    for (int i = 1; i < NW; ++i) mm = fmaxf(mm, red_a[threadIdx.x][i]);
    rowm[threadIdx.x] = mm;
  }
  __syncthreads();
  // per-row tile sums of exp(l - m) and l * exp(l - m)
#pragma unroll
  for (int r = 0; r < TB; ++r) {
    const float e = valid ? expf(acc[r] - rowm[r]) : 0.f;
    const float se = warp_sum(e);
    const float te = warp_sum(valid ? acc[r] * e : 0.f);
    if (lane == 0) {
      red_a[r][warp] = se;
      red_b[r][warp] = te;
    }
  }
  __syncthreads();
  if (threadIdx.x < TB && r0 + threadIdx.x < T) {
    float ss = 0.f, tt = 0.f;
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

__global__ void __launch_bounds__(BV)
exit_head_finish(const float* __restrict__ part_m,
                 const float* __restrict__ part_s,
                 const float* __restrict__ part_t,
                 float* __restrict__ out, int n_tiles) {
  __shared__ float red_a[NW];
  __shared__ float red_b[NW];
  __shared__ float row_max;
  const int row = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* pm = part_m + (size_t)row * n_tiles;
  const float* ps = part_s + (size_t)row * n_tiles;
  const float* pt = part_t + (size_t)row * n_tiles;

  float mm = kNegInf;
  for (int j = threadIdx.x; j < n_tiles; j += BV) mm = fmaxf(mm, pm[j]);
  mm = warp_max(mm);
  if (lane == 0) red_a[warp] = mm;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = red_a[0];
    for (int i = 1; i < NW; ++i) m = fmaxf(m, red_a[i]);
    row_max = m;
  }
  __syncthreads();
  const float m = row_max;
  float ss = 0.f, tt = 0.f;
  for (int j = threadIdx.x; j < n_tiles; j += BV) {
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
    for (int i = 0; i < NW; ++i) {
      s += red_a[i];
      t += red_b[i];
    }
    out[row] = m + logf(s) - t / s;
  }
}

}  // namespace

extern "C" {

// Vocab tile width: the wrapper sizes the partials scratch as
// 3 * T * ceil(V / repro_exit_head_block_v()) floats.
int repro_exit_head_block_v() { return BV; }

// x [T, D] bf16, w [D, V] bf16 (both contiguous), part fp32 scratch of
// 3 * T * n_tiles, out [T] fp32.  Launches both passes on `stream` and
// returns cudaGetLastError() (0 = launched).
int repro_exit_head_entropy(const void* x, const void* w, void* part,
                            void* out, int T, int D, int V, void* stream) {
  if (T <= 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + BV - 1) / BV;
  float* pm = static_cast<float*>(part);
  float* ps = pm + (size_t)T * n_tiles;
  float* pt = ps + (size_t)T * n_tiles;
  dim3 grid1(n_tiles, (T + TB - 1) / TB);
  exit_head_partial<<<grid1, BV, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), pm, ps, pt, T, D, V, n_tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  exit_head_finish<<<T, BV, 0, s>>>(pm, ps, pt, static_cast<float*>(out),
                                    n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
