"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` process per source, or per part of a source that names its parts
(a ``// nvcc parts: N`` line: part i compiled with ``-DREPRO_PART=i``, so
that the padded-width instantiations build beside the rest), all started
together, and the objects are linked into one shared library with a plain
C interface, loaded with ``ctypes``. The library lands in
``build/repro_torch_kernels/`` of the checkout, named by a hash of all the
sources (headers ``csrc/*.cuh`` included) and the flags, and is built at
first use; a changed source gets a new name, so a stale library is never
loaded. The compiler's output
(the ``ptxas -v`` report of registers, shared memory and spills per
function) is kept beside the library, so ``Built.log`` holds it for a
cached library too. Nothing here runs at import time, and nothing is
downloaded.

Every C entry point returns ``cudaGetLastError()`` after its launch; the
Python wrappers raise when that is not zero.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every C entry point
ARGTYPES = {
    # q, kp, vp, table, lengths, out, B, Hq, Hkv, D, page, npages, window,
    # softcap, dtype, stream
    "paged_decode_launch": [_P] * 6 + [_I] * 7 + [_F, _I, _P],
    # q, kp, vp, table, lengths, starts, out, B, C, Hq, Hkv, D, page,
    # npages, window, softcap, dtype, splits, stream
    "paged_prefill_launch": [_P] * 7 + [_I] * 8 + [_F, _I, _I, _P],
    # logits, targets, logp, ent, lse, T, V, dtype, stream
    "logprob_fwd_launch": [_P] * 5 + [_I] * 3 + [_P],
    # logits, targets, lse, mu, g_lp, g_ent, dlogits, T, V, dtype, stream
    "logprob_bwd_launch": [_P] * 7 + [_I] * 3 + [_P],
    # q, k, v, out, B, Sq, Sk, Hq, Hkv, D, causal, window, softcap, dtype,
    # splits, stream
    "flash_attention_launch": [_P] * 4 + [_I] * 8 + [_F, _I, _I, _P],
    # x, dt, a, b, c, y, scratch, scratch_bytes, B, S, H, G, P, N, L,
    # nsplit, dtype, stream
    "ssd_scan_launch": [_P] * 7 + [ctypes.c_size_t] + [_I] * 9 + [_P],
    # B, S, H, G, P, N, L, out (7 long longs): K6's float32 plan
    "ssd_f32_plan": [_I] * 7 + [_P],
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


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def parts(src: Path) -> int:
    """The parts a source is compiled in: its ``// nvcc parts: N`` line,
    else 1."""
    m = re.search(r"^// nvcc parts: (\d+)$", src.read_text(), re.M)
    return int(m.group(1)) if m else 1


def lib_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_kernels-{h.hexdigest()[:16]}.so"


def build() -> Built:
    """Compile every source unless the library exists: one nvcc per
    source in parallel, then one link. Raises with the compiler's output
    when nvcc fails."""
    out = lib_path()
    log_path = out.with_suffix(".log")
    if out.exists():
        return Built(out, 0.0,
                     log_path.read_text() if log_path.exists() else "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    jobs = []
    for src in sources():
        n = parts(src)
        for i in range(n):
            name = src.name if n == 1 else f"{src.name} part {i}"
            obj = BUILD_DIR / f"{tag}.{src.stem}.{i}.o"
            part = [] if n == 1 else [f"-DREPRO_PART={i}"]
            jobs.append((name, obj, [nvcc, *NVCC_FLAGS, *part, "-c", "-o",
                                     str(obj), str(src)]))

    def compile_one(cmd):
        t = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        return proc.returncode, proc.stdout, time.perf_counter() - t

    with ThreadPoolExecutor(len(jobs)) as pool:
        results = list(pool.map(compile_one, (cmd for _, _, cmd in jobs)))
    logs, failed = [], []
    for (name, _, _), (rc, text, secs) in zip(jobs, results):
        logs.append(f"== {name} ({secs:.1f}s)\n{text}")
        if rc != 0:
            failed.append(f"{name} (exit {rc})")
    if failed:
        raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n"
                           + "\n".join(logs))
    tmp = BUILD_DIR / f"{tag}.so.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                           *(str(obj) for _, obj, _ in jobs)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                          text=True)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n"
                           f"{link.stdout}")
    built = Built(out, time.perf_counter() - t0, "\n".join(logs))
    log_path.write_text(built.log)
    os.replace(tmp, out)
    return built


def ptxas_report(log: str) -> Dict[str, Dict[str, int]]:
    """Per compiled function of a ``ptxas -v`` log (mangled name):
    ``registers``, ``spill_stores`` and ``spill_loads`` (bytes)."""
    out: Dict[str, Dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )([^'\s]+)", line)
        if m:
            name = m.group(1)
            out.setdefault(name, {})
        elif name is None:
            continue
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        elif m := re.search(r"Used (\d+) registers", line):
            out[name]["registers"] = int(m.group(1))
    return out


def sass_functions(path: Path, names: Optional[Iterable[str]] = None
                   ) -> Dict[str, str]:
    """The SASS of the kernels in the library, by mangled name, from
    ``cuobjdump -sass`` of the toolkit that builds it: every kernel, or
    only ``names`` (mangled), disassembled by one ``cuobjdump -fun`` per
    core over its share of them."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    cmds = [[str(tool), "-sass", str(path)]]
    if names is not None:
        names = sorted(names)
        n = max(1, min(len(names), os.cpu_count() or 1))
        cmds = [[str(tool), "-sass", "-fun", ",".join(names[i::n]),
                 str(path)] for i in range(n) if names[i::n]]

    def dump(cmd):
        return subprocess.run(cmd, check=True, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True).stdout

    with ThreadPoolExecutor(len(cmds)) as pool:
        texts = list(pool.map(dump, cmds))
    out: Dict[str, str] = {}
    for text in texts:
        for part in text.split("Function : ")[1:]:
            name, _, body = part.partition("\n")
            out[name.strip()] = body
    return out


_LIB: Optional[ctypes.CDLL] = None
# threads share one library (the threaded HeteroRL runtime's nodes launch
# from their own threads): the first load builds it once, and launch
# counts are read-modify-writes that a thread switch must not split
_LOAD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()


def load() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed; one build when
    several threads ask at once."""
    global _LIB
    if _LIB is None:
        with _LOAD_LOCK:
            if _LIB is None:
                lib = ctypes.CDLL(str(build().path))
                for fn, argtypes in ARGTYPES.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _LIB = lib
    return _LIB


def count_launch(counts: Dict[str, int], name: str) -> None:
    """``counts[name] += 1`` under a lock: a kernel wrapper's launch
    count, exact when threads launch together."""
    with _COUNT_LOCK:
        counts[name] += 1
