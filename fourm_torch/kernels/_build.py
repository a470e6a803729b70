"""Build and load the hand-written CUDA kernels (csrc/*.cu) with nvcc + ctypes.

Each source compiles on first use into its own shared library with a plain C
interface, under fourm_torch/kernels/_build/ (ignored by git), named after
the hash of the source, every shared header (csrc/*.cuh) and the flags, so
an edited source or header rebuilds and an unchanged one loads at once. No
library links libcuda: gemm_sm90.cuh, whose TMA tensor maps the GEMMs, the
attention kernels and the decode-step weight streams (gemv_sm90.cuh) use, fetches libcuda's cuTensorMapEncodeTiled through
the CUDA runtime at first use. All missing libraries compile
in parallel, one nvcc process per source. Importing this module needs no
nvcc; `library()` does, and raises if the toolkit is absent.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("ln_matmul", "ln_mlp", "attention", "self_decode", "decode_attn", "residual_mlp",
           "attn_block", "vq_codebook", "attention_train", "fused_adamw")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_IA = ctypes.POINTER(ctypes.c_int)  # a host int array (ctypes.c_int * n)
# each C entry point: its source, its symbol and its argtypes (restype is
# int: cudaGetLastError(), or a *_fits answer)
SIGNATURES = {
    "ln_matmul": ("ln_matmul", "fourm_ln_matmul", [_P] * 7 + [_I, _I, _I, _F, _P]),
    "ln_mlp": ("ln_mlp", "fourm_ln_mlp", [_P] * 12 + [_I, _I, _I, _I, _F, _P]),
    "attention": ("attention", "fourm_attention",
                  [_P, _P, _P, _P] + [_I] * 12 + [_P] + [_I] * 4 + [_P] * 5 + [_I] * 4
                  + [_F, _F, _I, _P, _P]),
    "self_decode": ("self_decode", "fourm_self_decode",
                    [_P] * 8 + [_I] + [_P] * 6 + [_I] * 4 + [_F, _I, _IA, _P]),
    "decode_attention": ("decode_attn", "fourm_decode_attention",
                         [_P, _I, _I, _P, _P] + [_I] * 6 + [_P, _P, _I, _P] + [_I] * 3
                         + [_P] + [_I] * 3 + [_F, _I, _I, _I, _IA, _P]),
    "cross_decode_q": ("decode_attn", "fourm_cross_q",
                       [_P] * 6 + [_I] + [_P, _P] + [_I] * 2 + [_F, _IA, _P]),
    "residual_mlp": ("residual_mlp", "fourm_residual_mlp",
                     [_P] * 12 + [_I] + [_P] * 3 + [_I] * 6 + [_F, _IA, _P]),
    "attn_block": ("attn_block", "fourm_attn_block", [_P] * 11 + [_I] * 4 + [_F, _F, _I, _P]),
    "attn_block_fits": ("attn_block", "fourm_attn_block_fits", [_I, _I]),
    "nearest_code": ("vq_codebook", "fourm_nearest_code",
                     [_P] * 5 + [_I] * 6 + [_F] * 3 + [_P]),
    "attention_train_bwd": ("attention_train", "fourm_attention_train_bwd",
                            [_P] * 11 + [_IA, _F, _P]),
    "fused_adamw": ("fused_adamw", "fourm_fused_adamw", [_P] * 3 + [_I] + [_F] * 9 + [_P, _F, _P]),
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the fourm_torch CUDA kernels build on a "
                       "machine with the CUDA toolkit (set CUDA_HOME or PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every missing library, all sources at once. Returns seconds."""
    t0 = time.perf_counter()
    todo = [(n, _lib_path(n)) for n in SOURCES if not _lib_path(n).exists()]
    if todo:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for name, out in todo:
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        errors = []
        for name, out, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{log}")
            else:
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def library(source: str) -> ctypes.CDLL:
    """The loaded library built from csrc/<source>.cu, built on first use,
    with the argtypes of its entry points set."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(_lib_path(source)))
            for src, sym, argtypes in SIGNATURES.values():
                if src == source:
                    fn = getattr(lib, sym)
                    fn.argtypes = argtypes
                    fn.restype = ctypes.c_int
            _libs[source] = lib
        return lib


def entry(name: str):
    """The C entry point `name` of SIGNATURES, with argtypes set."""
    source, sym, _ = SIGNATURES[name]
    return getattr(library(source), sym)


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error (refused launch)."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {code}")
