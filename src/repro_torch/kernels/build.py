"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``.
Libraries go to ``build/repro_torch/`` at the repository root, named by a
hash of the source and the flags, so an edited source is rebuilt at its
first use and an unchanged one is loaded as it is.  Nothing is built at
import time: the first launch on a CUDA tensor builds what it needs, and
``build_all()`` builds every kernel at once, one ``nvcc`` per source, all
started together.  A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = {
    "paged_attention": CSRC / "paged_attention.cu",
    "paged_mla": CSRC / "paged_mla.cu",
    "exit_head": CSRC / "exit_head.cu",
    "feature_compress": CSRC / "feature_compress.cu",
    "flash_attention": CSRC / "flash_attention.cu",
    "flash_attention_bwd": CSRC / "flash_attention_bwd.cu",
    "w8a8_expert": CSRC / "w8a8_expert.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L, _U = ctypes.c_longlong, ctypes.c_uint
# C entry points of each library: name -> (argtypes, restype)
SIGNATURES = {
    "paged_attention": {
        "repro_paged_gqa_supported": ([_I, _I, _I], _I),
        "repro_paged_gqa_attention": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _F, _P], _I),
    },
    "paged_mla": {
        "repro_paged_mla_supported": ([_I, _I, _I, _I], _I),
        "repro_paged_mla_attention": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _I, _F, _P], _I),
    },
    "exit_head": {
        "repro_exit_head_block_v": ([], _I),
        "repro_exit_head_blocks_per_sm": ([_I], _I),
        "repro_exit_head_entropy": ([_P, _P, _P, _P, _I, _I, _I, _I, _P],
                                    _I),
    },
    "feature_compress": {
        "repro_quantize_rows": ([_P, _I, _P, _P, _L, _I, _I, _I, _I, _I,
                                 _P], _I),
        "repro_dequantize_rows": ([_P, _P, _P, _I, _L, _I, _I, _I, _U, _I,
                                   _I, _P], _I),
    },
    "flash_attention": {
        "repro_flash_attention": (
            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    },
    "flash_attention_bwd": {
        "repro_flash_attention_bwd": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
             _I, _I, _I, _F, _I, _P], _I),
    },
    "w8a8_expert": {
        "repro_w8a8_k_step": ([], _I),
        "repro_w8a8_expert_matmul": ([_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _P], _I),
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("repro_torch: nvcc not found; the CUDA kernels "
                           "are built on a machine with the CUDA toolkit")
    return found


def lib_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> subprocess.Popen:
    out = lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def build_all(names: List[str] = None) -> Dict[str, str]:
    """Compile every kernel whose library is missing, in parallel.  Returns
    each built kernel's compiler output (register and spill report)."""
    names = list(SOURCES) if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {n: _start(n) for n in names if not lib_path(n).exists()}
    logs: Dict[str, str] = {}
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        out = lib_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        if proc.returncode != 0:
            failed.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n"
                          + log)
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(log)
    if failed:
        raise RuntimeError("repro_torch: kernel build failed\n"
                           + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not lib_path(name).exists():
            build_all([name])
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"repro_torch: {what} failed with CUDA error "
                           f"{err}")
