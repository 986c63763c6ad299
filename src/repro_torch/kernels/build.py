"""Build and load the port's CUDA kernels.

``csrc/paged_attention.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. The library lands in ``build/repro_torch_kernels/`` of the
checkout, named by a hash of the source and flags, and is built at first
use; a changed source gets a new name, so a stale library is never
loaded. Nothing here runs at import time, and nothing is downloaded.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise when that is not zero.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

SOURCE = Path(__file__).resolve().parent / "csrc" / "paged_attention.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point
ARGTYPES = {
    # q, kp, vp, table, lengths, out, B, Hq, Hkv, D, page, npages, window,
    # softcap, dtype, stream
    "paged_decode_launch": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    # q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D, page,
    # npages, window, softcap, dtype, stream
    "paged_prefill_launch": [_P] * 7 + [_I] * 8 + [_F, _I, _P],
}


@dataclasses.dataclass
class Built:
    path: Path
    seconds: float        # nvcc wall time; 0.0 when the library was cached
    log: str              # nvcc output (ptxas register / smem report)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built on the machine with the card")


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libpaged_attention-{h.hexdigest()[:16]}.so"


def build() -> Built:
    """Compile the source unless its library exists. Raises with the
    compiler's output when nvcc fails."""
    out = lib_path()
    if out.exists():
        return Built(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, out)
    return Built(out, time.perf_counter() - t0, proc.stdout)


_LIB: Optional[ctypes.CDLL] = None


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build().path))
        for fn, argtypes in ARGTYPES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIB = lib
    return _LIB
