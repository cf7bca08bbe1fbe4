// Per-row int8 feature compression for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels `_quant_kernel` / `quantize_rows` and
// `_dequant_kernel` / `dequantize_rows` in
// src/repro/kernels/feature_compress.py: the survey's intermediate-data
// compression operator, which the serving scheduler runs on every float
// leaf of a slot it migrates with an int8 handoff.
//
// quantize: x [T, D] (fp32 or bf16) -> q [T, D] int8 and scale [T] fp32,
// per row
//   amax  = max |x|
//   scale = max(amax * fl(1/127), 1e-8)
//   q     = clip(round_half_even(x / scale), -127, 127)
// The reference kernel writes `amax / 127.0`; XLA rewrites a division by a
// constant into a multiplication by its rounded reciprocal, so the scale
// the reference actually ships is amax * fl(1/127), which is what these
// kernels compute (tests/test_torch_feature_compress.py shows it).  x /
// scale is an IEEE division (__fdiv_rn, as XLA keeps it) rounded half to
// even like jnp.round, so q and scale are bit-exact against the reference
// and against the plain version in kernels/ref.py.  Inputs are finite
// cache rows: fmaxf would drop a NaN that the plain version keeps.
//
// dequantize: x = (float(q) * scale[row]) rounded once to the output type
// (round to nearest even, as torch's .to(bfloat16)) or fp32.
//
// What bounds them on an H100: bytes.  Quantize moves T*D*in_bytes + T*D
// + 4T bytes, dequantize T*D + 4T + T*D*out_bytes, and each does a handful
// of operations per element.  The TPU kernel takes 256-row tiles through
// VMEM, with rows padded to 256 and D to 128 lanes by its wrapper; that
// padding is a tiling artefact and is not ported.
//
// Two instances of each kernel; the host plan (kernels/feature_compress.py
// `plan`) picks one by shape and pointer alignment, and a launch of either
// is a hand-written kernel (there is no fallback):
//
// `vec`, whenever a row of the float side (x of quantize, the output of
// dequantize) is a whole number of 16-byte vectors and every pointer is
// 16-byte aligned.  What it does about the bytes:
//  - 16-byte accesses.  Quantize gives a row to a group of g lanes (g a
//    power of two, at most 32): lane k of the group holds the row's
//    vectors j * g + k for j < V, so each load instruction of a warp reads
//    512 contiguous bytes.  At D = 64 bf16 a row is 8 vectors, g = 8 and a
//    warp holds 4 rows; at D = 512 bf16 g = 32 and V = 2; at D = 2048 fp32
//    V = 16, the widest row the instance takes (8 KB; a longer row takes
//    the scalar instance).  Dequantize gives a lane one 16-byte vector of
//    the output (8 bf16 or 4 fp32, from 8 or 4 bytes of q), so that each
//    store instruction of a warp writes 512 contiguous bytes; one 16-byte
//    vector of q a lane would need two 16-byte stores 32 bytes apart,
//    which is slower (launch/int8_sweep.py, PERF.md).
//  - One pass.  The row stays in registers, so device memory is read once;
//    amax is reduced with __shfl_xor_sync inside the group (max is exact
//    in any order), and each lane writes its q as one 8-byte (bf16 in) or
//    4-byte (fp32 in) store, the group's first lane the row's scale: a
//    warp's stores of q and of scales land on adjacent addresses.
//  - Bytes in flight.  A persistent grid (the plan: a few blocks per SM,
//    `blocks_per_sm`) strides over rows; each thread keeps at least kLoads
//    independent 16-byte loads in flight (U row groups of V vectors at
//    once in quantize; kDeqLoads pieces in dequantize), about 64 KB per SM.
//  - Cache hints.  Inputs are read once (ld.global.nc.L1::no_allocate) and
//    outputs go straight to the host after the call, so they are stored
//    with the streaming hint (st.global.cs).
//  - Few instructions per element.  clip-then-round is round-then-clip
//    (the bounds are integers), and adding 1.5 * 2^23 rounds |y| <= 127 to
//    the nearest integer, ties to even, exactly as rintf does, leaving q's
//    two's-complement byte in the low byte of the sum's bits: no FRND, no
//    F2I, and three PRMTs pack four bytes.  Dequantize finds a piece's row
//    with a shift when the pieces a row are a power of two, else with a
//    32-bit multiply-high divide whose magic numbers the plan computes
//    (never a 64-bit division), and rounds pairs with
//    __floats2bfloat162_rn.
//
// `scalar`, for a row that is not a whole number of 16-byte vectors (a
// ragged D), a misaligned view or a quantized row over 8 KB: one warp per
// row with a strided loop over D (neighbouring lanes on neighbouring
// elements, so loads coalesce), then a second pass over the row that
// writes q (quantize); one thread per element in a grid-stride loop
// (dequantize).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kInv127 = 1.0f / 127.0f;   // rounded once, like XLA's
constexpr float kMinScale = 1e-8f;
constexpr float kRoundMagic = 12582912.0f;  // 1.5 * 2^23
constexpr int kWarpsPerBlock = 8;  // blocks of 256 threads, both instances
constexpr int kLoads = 4;          // vec quantize: 16-byte loads in flight
constexpr int kDeqLoads = 8;       // vec dequantize: q loads in flight
constexpr int kMaxVectors = 16;    // vec quantize: 16-byte vectors a lane
constexpr int kScalarThreads = 256;  // scalar dequantize: threads a block

// vec: resident blocks per SM (the launch bound); the plan's persistent
// grid is the card's SM count times this
constexpr int blocks_per_sm(int v) { return v >= 16 ? 1 : v >= 8 ? 2 : 4; }

// ---- scalar instance ---------------------------------------------------

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

// ---- vec instance ------------------------------------------------------

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ void st_stream(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}
__device__ __forceinline__ void st_stream(void* p, uint2 v) {
  asm volatile("st.global.cs.v2.u32 [%0], {%1, %2};"
               :: "l"(p), "r"(v.x), "r"(v.y));
}
__device__ __forceinline__ void st_stream(void* p, uint32_t v) {
  asm volatile("st.global.cs.u32 [%0], %1;" :: "l"(p), "r"(v));
}
__device__ __forceinline__ void st_stream(float* p, float v) {
  asm volatile("st.global.cs.f32 [%0], %1;" :: "l"(p), "f"(v));
}

// One 16-byte vector of T as E fp32 values (exact).
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};
template <> struct Vec<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

// clip(round_half_even(x / s), +-127) in the low byte of the result: the
// sum 1.5 * 2^23 + y lies in [2^23, 2^24), where the fp32 ulp is 1, so the
// addition rounds y to an integer, ties to even (1.5 * 2^23 is even), and
// the sum's bits are 0x4B400000 + q.
__device__ __forceinline__ uint32_t q_bits(float x, float s) {
  const float y = fminf(fmaxf(__fdiv_rn(x, s), -127.f), 127.f);
  return __float_as_uint(__fadd_rn(y, kRoundMagic));
}
// The low bytes of four words, in order, as one word.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

template <typename T>
__device__ __forceinline__ float vec_amax(const uint4& v, float a) {
  float f[Vec<T>::E];
  Vec<T>::unpack(v, f);
#pragma unroll
  for (int e = 0; e < Vec<T>::E; ++e) a = fmaxf(a, fabsf(f[e]));
  return a;
}

template <typename T>
__device__ __forceinline__ void vec_store_q(int8_t* dst, const uint4& v,
                                            float s) {
  float f[Vec<T>::E];
  Vec<T>::unpack(v, f);
  uint32_t w[Vec<T>::E / 4];
#pragma unroll
  for (int i = 0; i < Vec<T>::E / 4; ++i)
    w[i] = pack4(q_bits(f[4 * i], s), q_bits(f[4 * i + 1], s),
                 q_bits(f[4 * i + 2], s), q_bits(f[4 * i + 3], s));
  if constexpr (Vec<T>::E == 8)
    st_stream(dst, make_uint2(w[0], w[1]));
  else
    st_stream(dst, w[0]);
}

__device__ __forceinline__ float row_scale(float amax) {
  return fmaxf(__fmul_rn(amax, kInv127), kMinScale);
}

// A row of g lanes per group, V vectors a lane (g * V covers the row), U
// row groups a warp at a time (U * V >= kLoads).
template <typename T, int V>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, blocks_per_sm(V))
quantize_vec_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                    float* __restrict__ scale, long long rows, int D,
                    int log2g) {
  constexpr int E = Vec<T>::E;
  constexpr int U = V >= kLoads ? 1 : kLoads / V;
  const int lane = threadIdx.x & 31;
  const int g = 1 << log2g;
  const int k = lane & (g - 1);            // lane within the row's group
  const int sub = lane >> log2g;           // row within the warp's rows
  const int rpw = 32 >> log2g;             // rows a warp holds
  const int chunks = D / E;                // 16-byte vectors a row
  const long long warp =
      (long long)blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  const long long warps = (long long)gridDim.x * kWarpsPerBlock;
  const long long step = (long long)rpw * U;   // rows a warp iteration
  for (long long r0 = warp * step; r0 < rows; r0 += warps * step) {
    uint4 v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long row = r0 + u * rpw + sub;
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = j * g + k;
        v[u][j] = (row < rows && c < chunks)
                      ? ld_stream(x + row * D + (size_t)c * E)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    float s[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) a = vec_amax<T>(v[u][j], a);
      s[u] = a;
    }
    for (int o = g >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
        s[u] = fmaxf(s[u], __shfl_xor_sync(kFull, s[u], o));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      s[u] = row_scale(s[u]);
      const long long row = r0 + u * rpw + sub;
      if (row < rows) {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = j * g + k;
          if (c < chunks)
            vec_store_q<T>(q + row * D + (size_t)c * E, v[u][j], s[u]);
        }
        if (k == 0) st_stream(scale + row, s[u]);
      }
    }
  }
}

// 8 int8 of q (bf16 out) or 4 (fp32 out) times the row's scale, rounded
// once to the output type: one 16-byte vector of the output.
__device__ __forceinline__ uint32_t bf16x2(uint32_t w, int h, float s) {
  const float a = __fmul_rn(
      static_cast<float>(static_cast<int8_t>(w >> (16 * h))), s);
  const float b = __fmul_rn(
      static_cast<float>(static_cast<int8_t>(w >> (16 * h + 8))), s);
  const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&p);
}
__device__ __forceinline__ uint4 dequant(uint2 w, float s, __nv_bfloat16*) {
  return make_uint4(bf16x2(w.x, 0, s), bf16x2(w.x, 1, s), bf16x2(w.y, 0, s),
                    bf16x2(w.y, 1, s));
}
__device__ __forceinline__ uint4 dequant(uint32_t w, float s, float*) {
  uint32_t o[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    o[b] = __float_as_uint(__fmul_rn(
        static_cast<float>(static_cast<int8_t>(w >> (8 * b))), s));
  return make_uint4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void ld_stream(const void* p, uint2& v) {
  asm("ld.global.nc.L1::no_allocate.v2.u32 {%0, %1}, [%2];"
      : "=r"(v.x), "=r"(v.y)
      : "l"(p));
}
__device__ __forceinline__ void ld_stream(const void* p, uint32_t& v) {
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
}

// A lane makes one 16-byte vector of the output, piece i: E = 16 /
// sizeof(T) elements from E bytes of q.  Piece i lies in row i / (D / E):
// i >> shift when D / E is a power of two (shift >= 0), else
// (umulhi(i, mul) + i) >> shr, exact for i < 2^31 (the plan's magic
// numbers).  kDeqLoads pieces a thread at a time.
template <typename T>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, blocks_per_sm(1))
dequantize_vec_kernel(const int8_t* __restrict__ q,
                      const float* __restrict__ scale, T* __restrict__ out,
                      unsigned pieces, int shift, unsigned mul, int shr) {
  constexpr int E = 16 / sizeof(T);
  using In = typename std::conditional<E == 8, uint2, uint32_t>::type;
  const unsigned threads = gridDim.x * blockDim.x;
  for (unsigned i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < pieces;
       i0 += threads * kDeqLoads) {
    In v[kDeqLoads];
    float s[kDeqLoads];
#pragma unroll
    for (int u = 0; u < kDeqLoads; ++u) {
      const unsigned i = i0 + u * threads;
      if (i < pieces) {
        const unsigned row =
            shift >= 0 ? i >> shift : (__umulhi(i, mul) + i) >> shr;
        ld_stream(q + (size_t)i * E, v[u]);
        s[u] = __ldg(scale + row);
      }
    }
#pragma unroll
    for (int u = 0; u < kDeqLoads; ++u) {
      const unsigned i = i0 + u * threads;
      if (i < pieces)
        st_stream(out + (size_t)i * E, dequant(v[u], s[u], out));
    }
  }
}

template <typename T>
cudaError_t launch_quantize_vec(const void* x, void* q, void* scale,
                                long long rows, int D, int log2g, int v,
                                int grid, cudaStream_t st) {
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  const dim3 block(32 * kWarpsPerBlock);
  switch (v) {
    case 1: quantize_vec_kernel<T, 1><<<grid, block, 0, st>>>(
        xp, qp, sp, rows, D, log2g); break;
    case 2: quantize_vec_kernel<T, 2><<<grid, block, 0, st>>>(
        xp, qp, sp, rows, D, log2g); break;
    case 4: quantize_vec_kernel<T, 4><<<grid, block, 0, st>>>(
        xp, qp, sp, rows, D, log2g); break;
    case 8: quantize_vec_kernel<T, 8><<<grid, block, 0, st>>>(
        xp, qp, sp, rows, D, log2g); break;
    case kMaxVectors: quantize_vec_kernel<T, kMaxVectors><<<grid, block, 0,
                                                          st>>>(
        xp, qp, sp, rows, D, log2g); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// x [rows, D] contiguous, fp32 (x_bf16 = 0) or bf16 (x_bf16 = 1); q [rows,
// D] int8, scale [rows] fp32.  vec = 1 takes the vec instance with groups
// of 2^log2g lanes a row and v vectors a lane, vec = 0 the scalar one;
// `grid` blocks of 256 threads (the plan's).  Launches on `stream` and
// returns cudaGetLastError() (0 = launched), or an error for arguments
// the instance does not take.
int repro_quantize_rows(const void* x, int x_bf16, void* q, void* scale,
                        long long rows, int D, int vec, int log2g, int v,
                        int grid, void* stream) {
  if (rows <= 0 || D <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!vec) {
    if ((long long)grid * kWarpsPerBlock < rows)
      return (int)cudaErrorInvalidValue;
    if (x_bf16)
      quantize_rows_kernel<<<grid, 32 * kWarpsPerBlock, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scale), rows, D);
    else
      quantize_rows_kernel<<<grid, 32 * kWarpsPerBlock, 0, st>>>(
          static_cast<const float*>(x), static_cast<int8_t*>(q),
          static_cast<float*>(scale), rows, D);
    return (int)cudaGetLastError();
  }
  const int elem = x_bf16 ? 2 : 4;
  if (((long long)D * elem) % 16 != 0 || log2g < 0 || log2g > 5)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(q)) return (int)cudaErrorMisalignedAddress;
  if (((long long)v << log2g) * 16 < (long long)D * elem)
    return (int)cudaErrorInvalidValue;      // the lanes must cover the row
  const cudaError_t err =
      x_bf16 ? launch_quantize_vec<__nv_bfloat16>(x, q, scale, rows, D,
                                                  log2g, v, grid, st)
             : launch_quantize_vec<float>(x, q, scale, rows, D, log2g, v,
                                          grid, st);
  return (int)err;
}

// q [rows, D] int8 and scale [rows] fp32, contiguous; out [rows, D] fp32
// (out_bf16 = 0) or bf16 (out_bf16 = 1).  vec = 1 takes the vec instance,
// which finds a piece's row by `shift` (>= 0) or by the magic numbers
// `mul`, `shr`; vec = 0 the scalar one.  `grid` blocks of 256 threads.
// Launches on `stream` and returns cudaGetLastError() (0 = launched), or
// an error for arguments the instance does not take.
int repro_dequantize_rows(const void* q, const void* scale, void* out,
                          int out_bf16, long long rows, int D, int vec,
                          int shift, unsigned mul, int shr, int grid,
                          void* stream) {
  if (rows <= 0 || D <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!vec) {
    const size_t n = (size_t)rows * D;
    if (out_bf16)
      dequantize_rows_kernel<<<grid, kScalarThreads, 0, st>>>(
          static_cast<const int8_t*>(q), static_cast<const float*>(scale),
          static_cast<__nv_bfloat16*>(out), n, D);
    else
      dequantize_rows_kernel<<<grid, kScalarThreads, 0, st>>>(
          static_cast<const int8_t*>(q), static_cast<const float*>(scale),
          static_cast<float*>(out), n, D);
    return (int)cudaGetLastError();
  }
  const int e = out_bf16 ? 8 : 4;          // elements a 16-byte piece
  if (D % e != 0 ||
      (long long)grid * 32 * kWarpsPerBlock * kDeqLoads >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  const long long c = D / e;
  const long long pieces = rows * c;
  if (pieces >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  auto row_of = [&](long long i) -> long long {
    if (shift >= 0) return i >> shift;
    const unsigned long long hi =
        ((unsigned long long)(unsigned)i * mul) >> 32;
    return (long long)((hi + (unsigned long long)i) >> shr);
  };
  // the row of the last piece of row 0, the first of row 1, the last
  if (shift > 30 || (shift >= 0 && (1LL << shift) != c) ||
      (shift < 0 && (shr < 0 || shr > 31 || row_of(c - 1) != 0 ||
                     (rows > 1 && row_of(c) != 1) ||
                     row_of(pieces - 1) != rows - 1)))
    return (int)cudaErrorInvalidValue;
  if (out_bf16)
    dequantize_vec_kernel<<<grid, 32 * kWarpsPerBlock, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), (unsigned)pieces, shift, mul, shr);
  else
    dequantize_vec_kernel<<<grid, 32 * kWarpsPerBlock, 0, st>>>(
        static_cast<const int8_t*>(q), static_cast<const float*>(scale),
        static_cast<float*>(out), (unsigned)pieces, shift, mul, shr);
  return (int)cudaGetLastError();
}

}  // extern "C"
