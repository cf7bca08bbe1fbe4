// W8A8 grouped expert GEMM for Hopper (sm_90a), plain C interface.
//
// Replaces no Pallas kernel.  The reference runs this product outside
// Pallas, as XLA's int8 dot_general with an int32 result in
// `_q_expert_matmul` (src/repro/models/ffn.py:164).  PyTorch has no call
// for it on the card: torch.bmm has no integer kernel on CUDA (and returns
// int8 for int8 inputs), and torch._int_mm is 2-D and needs more than 16
// rows, where a decode step gives each expert 4.
//
// What it computes, for every expert e, capacity row c and column n:
//   out[e, c, n] = float(sum_k aq[e, c, k] * wq[e, k, n]) * a_scale[e, c]
//                                                          * w_scale[e, n]
// with the int32 sum exact (|sum| <= K * 127^2 < 2^31 for K < 133,144), its
// conversion rounded to nearest, then the two fp32 products left to right,
// each rounded once: the reference's `acc.astype(f32) * as_ * ws`.  Every
// capacity row is computed, empty or not, as the reference does.
//
// What bounds it on an H100: bytes, at serving's shapes.  A decode step
// gives each of llama4-maverick's 128 experts C = 4 rows, so one product
// reads the whole [128, 5120, 8192] int8 weight, 5.37 GB (1.60 ms at 3.35
// TB/s), for 2 * 4 = 8 operations a byte, far below the ~590 a byte where
// the int8 tensor cores would become the limit.  At a forward's C = 40 it
// is 80 operations a byte, still below it.
//
// What the design does about it (a first, simple design: integer dot
// products on the CUDA cores, not the tensor cores):
//  * one block of 8 warps per (expert, 128-column tile of N, group of 8
//    rows of C): grid (ceil(N / 128), ceil(C / 8), E).  At C <= 8 every
//    byte of wq is read once; a larger C re-reads it once per 8-row group,
//    from L2 where those blocks run together;
//  * lane l owns 4 adjacent columns; warp w walks rows k = 16 (w + 8 j) of
//    K, 16 rows a step, loading one 4-byte word of wq a row: a warp reads
//    128 contiguous bytes of each row, 16 rows in flight;
//  * wq is stored [E, K, N] (the reference's layout, kept by the bridge and
//    the snapshots), so the K values of one column sit N bytes apart.  Each
//    4 x 4 byte block (4 rows, 4 columns) is transposed in registers with
//    __byte_perm into one K-packed word a column, the operand __dp4a takes;
//  * each row's 16 activation bytes of the step are one 16-byte load, the
//    same address in every lane (a broadcast from L1), and meet the 4
//    columns' words in 16 __dp4a (s8 x s8 -> s32 accumulate);
//  * the 8 warps' partial sums meet in shared memory (32 KB); the epilogue
//    scales each sum and stores fp32, 32 consecutive columns a warp.
// The ragged edges: columns >= N load nothing and store nothing (N is a
// multiple of 4, so a lane's 4 columns are all in or all out); rows >= C
// are skipped.  K must be a multiple of 16 (the caller checks).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NWARP = 8;            // warps a block, splitting K
constexpr int NT = 32 * NWARP;
constexpr int BN = 128;             // columns a block: 4 a lane
constexpr int BC = 8;               // capacity rows a block
constexpr int KS = 16;              // rows of K a warp takes a step

// w0..w3: 4 consecutive rows' words of 4 columns (byte j = column j) ->
// col[j]: column j's 4 rows as one word (byte i = row i)
__device__ __forceinline__ void transpose4(uint32_t w0, uint32_t w1,
                                           uint32_t w2, uint32_t w3,
                                           uint32_t col[4]) {
  const uint32_t t0 = __byte_perm(w0, w1, 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const uint32_t t1 = __byte_perm(w2, w3, 0x5140);  // w2.b0 w3.b0 w2.b1 w3.b1
  const uint32_t t2 = __byte_perm(w0, w1, 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const uint32_t t3 = __byte_perm(w2, w3, 0x7362);  // w2.b2 w3.b2 w2.b3 w3.b3
  col[0] = __byte_perm(t0, t1, 0x5410);
  col[1] = __byte_perm(t0, t1, 0x7632);
  col[2] = __byte_perm(t2, t3, 0x5410);
  col[3] = __byte_perm(t2, t3, 0x7632);
}

__global__ void __launch_bounds__(NT, 2)
w8a8_expert_kernel(const int8_t* __restrict__ aq,
                   const float* __restrict__ a_scale,
                   const int8_t* __restrict__ wq,
                   const float* __restrict__ w_scale,
                   float* __restrict__ out, int C, int K, int N) {
  __shared__ __align__(16) int red[NWARP][BC][BN];
  const int e = blockIdx.z;
  const int c0 = blockIdx.y * BC;
  const int rows = min(BC, C - c0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n = blockIdx.x * BN + 4 * lane;
  const bool col_ok = n < N;
  const int8_t* a = aq + ((size_t)e * C + c0) * K;
  const int8_t* w = wq + (size_t)e * K * N + (col_ok ? n : 0);

  int acc[BC][4];
#pragma unroll
  for (int c = 0; c < BC; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0;

  for (int k = warp * KS; k < K; k += NWARP * KS) {
    uint32_t wv[KS];
#pragma unroll
    for (int i = 0; i < KS; ++i)
      wv[i] = col_ok ? __ldg(reinterpret_cast<const unsigned int*>(
                           w + (size_t)(k + i) * N))
                     : 0u;
    uint32_t col[KS / 4][4];
#pragma unroll
    for (int g = 0; g < KS / 4; ++g)
      transpose4(wv[4 * g], wv[4 * g + 1], wv[4 * g + 2], wv[4 * g + 3],
                 col[g]);
#pragma unroll
    for (int c = 0; c < BC; ++c) {
      if (c < rows) {
        const int4 av =
            __ldg(reinterpret_cast<const int4*>(a + (size_t)c * K + k));
        const int aw[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int g = 0; g < KS / 4; ++g)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[c][j] = __dp4a(aw[g], (int)col[g][j], acc[c][j]);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < BC; ++c)
    *reinterpret_cast<int4*>(&red[warp][c][4 * lane]) =
        make_int4(acc[c][0], acc[c][1], acc[c][2], acc[c][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < BC * BN; i += NT) {
    const int c = i / BN;
    const int col = blockIdx.x * BN + i % BN;
    if (c < rows && col < N) {
      int s = 0;
#pragma unroll
      for (int ww = 0; ww < NWARP; ++ww) s += red[ww][c][i % BN];
      const size_t row = (size_t)e * C + c0 + c;
      out[row * N + col] = __fmul_rn(
          __fmul_rn(__int2float_rn(s), a_scale[row]),
          w_scale[(size_t)e * N + col]);
    }
  }
}

}  // namespace

extern "C" {

// Rows of K a warp step: K must be a multiple of it.
int repro_w8a8_k_step() { return KS; }

// aq [E, C, K] int8, a_scale [E, C, 1] fp32, wq [E, K, N] int8, w_scale
// [E, 1, N] fp32 -> out [E, C, N] fp32; all contiguous, aq 16-byte and wq
// 4-byte aligned; K a multiple of 16 below 133,144, N a multiple of 4, E
// and ceil(C / 8) below 65536.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int repro_w8a8_expert_matmul(const void* aq, const void* a_scale,
                             const void* wq, const void* w_scale, void* out,
                             int E, int C, int K, int N, void* stream) {
  if (E <= 0 || E >= 65536 || C <= 0 || (C + BC - 1) / BC >= 65536 ||
      K <= 0 || K % KS != 0 || K >= 133144 || N <= 0 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (C + BC - 1) / BC, E);
  w8a8_expert_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(aq), static_cast<const float*>(a_scale),
      static_cast<const int8_t*>(wq), static_cast<const float*>(w_scale),
      static_cast<float*>(out), C, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
