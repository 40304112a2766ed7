"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``src/repro_torch/csrc/*.cu`` file has a plain C interface (no
PyTorch headers), so ``nvcc`` compiles each in seconds.  All sources are
compiled at once, one ``nvcc`` process per file, then linked into one
shared library under ``build/repro_torch_kernels/<hash>/`` at the root of
the checkout.  The hash covers the sources and the flags, so an edit
rebuilds and an unchanged tree reuses the library.  A missing ``nvcc`` or a
failed build raises; there is no fallback.

Each C entry point launches on the stream it is given (PyTorch's current
stream) and returns ``cudaGetLastError()``; ``check`` raises on non-zero.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
LIB_NAME = "librepro_torch_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: the flash-attention entry points' common tail: B, H, KV, Sq, Skv, hd,
#: causal, has_window, window, softcap, scale, dtype, stream
_FLASH_TAIL = [_I] * 9 + [_F, _F, _I, _P]

#: C signature of every entry point: name -> argtypes (restype is c_int)
SIGNATURES = {
    # lhs, rhs, tile_expert, n_used_tiles, out, m_pad, K, N, E, block_m,
    # trans_rhs, dtype, stream
    "repro_grouped_gemm": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    # q, k_pool, v_pool, pos_pool, page_table, t, out, B, H, KV, hd, P,
    # page, n_pages, kv_len, window, softcap, dtype, stream
    "repro_paged_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                              _I, _I, _I, _I, _I, _F, _I, _P],
    # q, k, v, o, lse, then _FLASH_TAIL
    "repro_flash_fwd": [_P] * 5 + _FLASH_TAIL,
    # q, k, v, do, lse, delta, dq, then _FLASH_TAIL
    "repro_flash_bwd_dq": [_P] * 7 + _FLASH_TAIL,
    # q, k, v, do, lse, delta, dk, dv, then _FLASH_TAIL
    "repro_flash_bwd_dkv": [_P] * 8 + _FLASH_TAIL,
    # r, k, v, lw, u, out, B, H, S, C, T, stream
    "repro_rwkv6_scan": [_P] * 6 + [_I] * 5 + [_P],
    # x, scale, out, rows, d, eps, dtype, stream
    "repro_rmsnorm": [_P] * 3 + [_I, _I, _F, _I, _P],
}

#: dtype codes shared with the C side
DTYPE_CODES = {"float32": 0, "bfloat16": 1}

_LIB: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cands = []
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc not found (CUDA_HOME/bin/nvcc or PATH): the port's CUDA "
        "kernels are built from src/repro_torch/csrc at first use")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds, verbose: bool):
    """Start every command at once; raise with the compiler output of the
    first one that fails.  Every process is waited for."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if verbose and out.strip():
            print(out.rstrip(), flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"kernel build failed ({' '.join(cmd)}):\n{out}")


def build(verbose: bool = False) -> pathlib.Path:
    """Compile (if needed) and return the path of the shared library."""
    global BUILD_SECONDS
    srcs = _sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib = out_dir / LIB_NAME
    if lib.exists():
        BUILD_SECONDS = 0.0
        return lib
    nvcc = _nvcc()
    t0 = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        objs = [os.path.join(tmp, s.stem + ".o") for s in srcs]
        _run_all([[nvcc, *FLAGS, *extra, "-c", str(s), "-o", o]
                  for s, o in zip(srcs, objs)], verbose)
        staged = os.path.join(tmp, LIB_NAME)
        _run_all([[nvcc, ARCH, "-shared", "-o", staged, *objs]], verbose)
        os.replace(staged, lib)       # atomic publish: processes may build at once
    BUILD_SECONDS = time.perf_counter() - t0
    return lib


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build(verbose)))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def check(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")


def dtype_code(dtype) -> int:
    name = str(dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"kernel dtype {dtype} not supported "
                        f"(have {sorted(DTYPE_CODES)})")
    return DTYPE_CODES[name]
