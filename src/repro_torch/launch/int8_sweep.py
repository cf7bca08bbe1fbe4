"""The int8 handoff kernels against design variants and streaming
yardsticks, on one card.

    python -m repro_torch.launch.int8_sweep [--json PATH]

At the granite-3-2b slot leaf [655360, 64] bf16 (two copies, so every
call reads from HBM past the 50 MB L2), each checked bit for bit against
the plain version, then timed in turns (``kernel_ab.interleaved``, three
rounds):

  quantize    the plan's kernel, and the same source with 2 or 8 row
              groups a warp (``kLoads``) at 6 or 2 blocks an SM
              (``blocks_per_sm``);
  dequantize  the plan's kernel (to bf16), the same source with 4 pieces
              a thread in flight (``kDeqLoads``), and the design it
              replaced: one 16-byte vector of q a lane, its 32 output
              bytes written as two 16-byte stores 32 bytes apart;
  yardsticks  a pass that only reads 84 MB and one that only writes 84 MB,
              with the same 16-byte streaming accesses: what the card
              gives such passes in each direction.

Variants are built from the checked-in source with its constants changed,
into ``build/repro_torch/int8_sweep/``.  Prints one line per setting
(median, spread).  The card is required.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from repro_torch.kernels import build, feature_compress as fc, ops, ref
from repro_torch.launch import kernel_ab as ab

OUT = build.BUILD_DIR / "int8_sweep"
ROWS, D = 655360, 64

# the replaced dequantize design and the yardsticks, with the source's
# cache hints
EXTRA = r"""
#include <cuda_bf16.h>
#include <stdint.h>
__device__ __forceinline__ uint4 ld16(const void* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}
__device__ __forceinline__ void st16(void* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};"
               :: "l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w));
}
__device__ __forceinline__ uint32_t bf2(uint32_t w, int h, float s) {
  const float a = __fmul_rn((float)(int8_t)(w >> (16 * h)), s);
  const float b = __fmul_rn((float)(int8_t)(w >> (16 * h + 8)), s);
  __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&p);
}
__global__ void __launch_bounds__(256, 4)
deq_two_stores(const int8_t* q, const float* scale, __nv_bfloat16* out,
               unsigned nvec, int shift) {
  const unsigned threads = gridDim.x * blockDim.x;
  for (unsigned i0 = blockIdx.x * blockDim.x + threadIdx.x; i0 < nvec;
       i0 += threads * 4) {
    uint4 v[4]; float s[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned i = i0 + u * threads;
      if (i < nvec) { v[u] = ld16(q + (size_t)i * 16);
                      s[u] = __ldg(scale + (i >> shift)); }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const unsigned i = i0 + u * threads;
      if (i >= nvec) continue;
      const uint32_t w[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
      st16(out + (size_t)i * 16,
           make_uint4(bf2(w[0], 0, s[u]), bf2(w[0], 1, s[u]),
                      bf2(w[1], 0, s[u]), bf2(w[1], 1, s[u])));
      st16(out + (size_t)i * 16 + 8,
           make_uint4(bf2(w[2], 0, s[u]), bf2(w[2], 1, s[u]),
                      bf2(w[3], 0, s[u]), bf2(w[3], 1, s[u])));
    }
  }
}
__global__ void read_only(const uint4* in, size_t n, unsigned* sink) {
  const size_t t = gridDim.x * (size_t)blockDim.x;
  unsigned a = 0;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += t) { const uint4 v = ld16(in + i); a ^= v.x ^ v.y ^ v.z ^ v.w; }
  if (a == 0x9e3779b9u) *sink = a;
}
__global__ void write_only(uint4* out, size_t n) {
  const size_t t = gridDim.x * (size_t)blockDim.x;
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += t) st16(out + i, make_uint4((unsigned)i, 0u, 0u, 0u));
}
extern "C" {
int sweep_deq_two_stores(const void* q, const void* s, void* o,
                         unsigned nvec, int shift, int grid, void* st) {
  deq_two_stores<<<grid, 256, 0, (cudaStream_t)st>>>(
      (const int8_t*)q, (const float*)s, (__nv_bfloat16*)o, nvec, shift);
  return (int)cudaGetLastError();
}
int sweep_read(const void* in, size_t n16, void* sink, int grid, void* st) {
  read_only<<<grid, 256, 0, (cudaStream_t)st>>>((const uint4*)in, n16,
                                                (unsigned*)sink);
  return (int)cudaGetLastError();
}
int sweep_write(void* out, size_t n16, int grid, void* st) {
  write_only<<<grid, 256, 0, (cudaStream_t)st>>>((uint4*)out, n16);
  return (int)cudaGetLastError();
}
}
"""
_P, _I, _U, _S = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                  ctypes.c_size_t)


def _compile(name: str, source: str) -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src, so = OUT / f"{name}.cu", OUT / f"{name}.so"
    src.write_text(source)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"int8_sweep: {name} did not build\n"
                           + proc.stdout + proc.stderr)
    return ctypes.CDLL(str(so))


def variant(name: str, subs) -> ctypes.CDLL:
    """The checked-in source with the (old, new) substitutions made."""
    text = build.SOURCES["feature_compress"].read_text()
    for old, new in subs:
        if old not in text:
            raise RuntimeError(f"int8_sweep: '{old}' is not in the source")
        text = text.replace(old, new)
    lib = _compile(name, text)
    for fn, (argtypes, restype) in build.SIGNATURES[
            "feature_compress"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def quantize_with(lib, loads: int, blocks: int):
    """The vec quantize of a D-64 bf16 row (g 8, v 1) with ``loads`` row
    groups a warp on a grid of ``blocks`` an SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def call(x):
        t, d = x.shape
        q = torch.empty((t, d), dtype=torch.int8, device=x.device)
        s = torch.empty((t, 1), dtype=torch.float32, device=x.device)
        grid = min(-(-t // (4 * loads * fc.WARPS)), sms * blocks)
        build.check(lib.repro_quantize_rows(
            x.data_ptr(), 1, q.data_ptr(), s.data_ptr(), t, d, 1, 3, 1, grid,
            torch.cuda.current_stream().cuda_stream), "variant quantize")
        return q, s
    return call


def dequantize_with(lib, loads: int):
    """The vec dequantize to bf16 with ``loads`` pieces a thread."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def call(q, s):
        t, d = q.shape
        out = torch.empty((t, d), dtype=torch.bfloat16, device=q.device)
        p = fc.plan(t, d, 2, (0,), sms=sms, kernel="dequantize")
        grid = min(-(-p["pieces"] // (32 * fc.WARPS * loads)),
                   sms * fc.blocks_per_sm(1))
        build.check(lib.repro_dequantize_rows(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), 1, t, d, 1,
            p["shift"], p["mul"], p["shr"], grid,
            torch.cuda.current_stream().cuda_stream), "variant dequantize")
        return out
    return call


def run(rounds: int = 3):
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    xs = [torch.randn(ROWS, D, generator=gen, device="cuda").bfloat16()
          for _ in range(2)]
    qs = [ops.compress_rows(x) for x in xs]
    qr, sr = ref.quantize_rows_ref(xs[0])
    yr = ref.dequantize_rows_ref(qr, sr, torch.bfloat16)
    extra = _compile("extra", EXTRA)
    extra.sweep_deq_two_stores.argtypes = [_P, _P, _P, _U, _I, _I, _P]
    extra.sweep_read.argtypes = [_P, _S, _P, _I, _P]
    extra.sweep_write.argtypes = [_P, _S, _I, _P]
    stream = torch.cuda.current_stream().cuda_stream

    def two_stores(q, s):
        out = torch.empty(q.shape, dtype=torch.bfloat16, device=q.device)
        build.check(extra.sweep_deq_two_stores(
            q.data_ptr(), s.data_ptr(), out.data_ptr(), q.numel() // 16,
            (D // 16).bit_length() - 1, sms * 4, stream), "two stores")
        return out

    quant = {"plan (4 groups, 4 blocks/SM)": ops.compress_rows}
    for loads, blocks in ((2, 6), (8, 2)):
        lib = variant(f"q{loads}b{blocks}", [
            ("constexpr int kLoads = 4;", f"constexpr int kLoads = {loads};"),
            ("v >= 8 ? 2 : 4; }", f"v >= 8 ? 2 : {blocks}; }}")])
        quant[f"{loads} groups, {blocks} blocks/SM"] = quantize_with(
            lib, loads, blocks)
    deq = {"plan (8 pieces in flight)": lambda q, s: ops.decompress_rows(
               q, s, dtype=torch.bfloat16),
           "4 pieces in flight": dequantize_with(
               variant("d4", [("constexpr int kDeqLoads = 8;",
                               "constexpr int kDeqLoads = 4;")]), 4),
           "16-byte q vector a lane, two stores": two_stores}
    results = {}
    for n, f in quant.items():
        q, s = f(xs[0])
        if not (torch.equal(q, qr) and torch.equal(s.view(torch.int32),
                                                   sr.view(torch.int32))):
            raise SystemExit(f"int8_sweep: quantize '{n}' is not bit-exact")
    for n, f in deq.items():
        if not torch.equal(f(qr, sr).view(torch.int16), yr.view(torch.int16)):
            raise SystemExit(f"int8_sweep: dequantize '{n}' is not "
                             f"bit-exact")
    results["quantize"] = ab.interleaved(quant, [(x,) for x in xs], rounds,
                                         20)
    results["dequantize"] = ab.interleaved(deq, qs, rounds, 20)
    bufs = [torch.empty(ROWS * D * 2, dtype=torch.uint8, device="cuda")
            for _ in range(2)]
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    n16 = ROWS * D * 2 // 16
    results["yardsticks"] = ab.interleaved(
        {"read 84 MB": lambda b: extra.sweep_read(
            b.data_ptr(), n16, sink.data_ptr(), sms * 8, stream),
         "write 84 MB": lambda b: extra.sweep_write(
            b.data_ptr(), n16, sms * 8, stream)},
        [(b,) for b in bufs], rounds, 20)
    for group, r in results.items():
        for n, t in r.items():
            print(f"{group} {n}: median {t['median_ms']:.4f} ms, spread "
                  f"{t['spread_ms']:.4f} ms {[round(v, 4) for v in t['ms']]}",
                  flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("int8_sweep: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)
    results = run()
    results["card"] = smi.stdout.strip()
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
