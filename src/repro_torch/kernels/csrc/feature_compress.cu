// Per-row int8 feature compression for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels `_quant_kernel` / `quantize_rows` and
// `_dequant_kernel` / `dequantize_rows` in
// src/repro/kernels/feature_compress.py: the survey's intermediate-data
// compression operator, which the serving scheduler runs on every float
// leaf of a slot it migrates with an int8 handoff.
//
// quantize_rows_kernel: x [T, D] (fp32 or bf16) -> q [T, D] int8 and
// scale [T] fp32, per row
//   amax  = max |x|
//   scale = max(amax * fl(1/127), 1e-8)
//   q     = clip(round_half_even(x / scale), -127, 127)
// The reference kernel writes `amax / 127.0`; XLA rewrites a division by a
// constant into a multiplication by its rounded reciprocal, so the scale
// the reference actually ships is amax * fl(1/127), which is what this
// kernel computes (tests/test_torch_feature_compress.py shows it).  x /
// scale is an IEEE division (__fdiv_rn, as XLA keeps it) and rintf rounds
// half to even like jnp.round, so q and scale are bit-exact against the
// reference and against the plain version in kernels/ref.py.  Inputs are
// finite cache rows: fmaxf would drop a NaN that the plain version keeps.
//
// dequantize_rows_kernel: x = (float(q) * scale[row]) rounded once to the
// output type (__float2bfloat16_rn, as torch's .to(bfloat16)) or fp32.
//
// What bounds them on an H100: bytes.  Quantize moves T*D*in_bytes + T*D
// + 4T bytes, dequantize T*D + 4T + T*D*out_bytes, and each does a handful
// of operations per element.
//
// What the design does about it.  The TPU kernel takes 256-row tiles
// through VMEM, with the rows padded to 256 and D to 128 lanes by its
// wrapper; that padding is a tiling artefact and is not ported.  Here one
// warp owns one row: a strided loop over D (neighbouring lanes on
// neighbouring elements, so loads coalesce), a __shfl_xor_sync max
// reduction, then a second pass over the row (from L1/L2) that writes q.
// Any D works.  At D = 64 each lane holds two elements, so half of each
// warp's load width is idle; packing several rows per warp with 16-byte
// loads is later work.  Dequantize is elementwise, one thread per element
// in a grid-stride loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = 1.0f / 127.0f;   // rounded once, like XLA's
constexpr float kMinScale = 1e-8f;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ float load_f(const float* p, size_t i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, size_t i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store_f(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, long long rows, int D) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;           // uniform across the warp
  const size_t base = (size_t)row * D;
  float amax = 0.f;
  for (int i = lane; i < D; i += 32) amax = fmaxf(amax, fabsf(load_f(x, base + i)));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, o));
  const float s = fmaxf(amax * kInv127, kMinScale);
  for (int i = lane; i < D; i += 32) {
    float v = rintf(__fdiv_rn(load_f(x, base + i), s));
    v = fminf(fmaxf(v, -127.f), 127.f);
    q[base + i] = static_cast<int8_t>(static_cast<int>(v));
  }
  if (lane == 0) scale[row] = s;
}

template <typename T>
__global__ void dequantize_rows_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scale,
                                       T* __restrict__ out, size_t n, int D) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride)
    store_f(out, i, static_cast<float>(q[i]) * scale[i / D]);
}

}  // namespace

extern "C" {

// x [rows, D] contiguous, fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1); q [rows,
// D] int8, scale [rows] fp32.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int repro_quantize_rows(const void* x, int x_bf16, void* q, void* scale,
                        long long rows, int D, void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    quantize_rows_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), rows, D);
  else
    quantize_rows_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, s>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(q),
        static_cast<float*>(scale), rows, D);
  return (int)cudaGetLastError();
}

// q [rows, D] int8 and scale [rows] fp32, contiguous; out [rows, D] fp32
// (out_bf16 = 0) or bf16 (out_bf16 = 1).  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
int repro_dequantize_rows(const void* q, const void* scale, void* out,
                          int out_bf16, long long rows, int D, void* stream) {
  if (rows <= 0 || D <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)rows * D;
  const int threads = 256;
  const size_t want = (n + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < (1u << 20) ? want : (1u << 20));
  if (out_bf16)
    dequantize_rows_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), n, D);
  else
    dequantize_rows_kernel<<<blocks, threads, 0, s>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<float*>(out), n, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
