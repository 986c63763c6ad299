"""Where the float32 tile core's time goes, on the card.

K5's float32 kernel (one launch, no key split) at two rows of
``chip_smoke.py``: the static engine's prefill (B 16, S 832, Hq 16, Hkv 8,
D 128, causal) and the small models' width (the same at Hq 8, Hkv 4,
D 32). Each is built from ``csrc/attention_f32.cuh`` as it is and from
copies of it with the S loop, the P V loop or both compiled out (their
trip counts set to 0), and timed with CUDA events: the full kernel less
a cut variant is that loop's share; what remains with both loops cut is
the rest (Q staging, the K/V copies and barriers, the softmax and the
epilogue). The cut variants' outputs are wrong by design; only their
times are read, and the full kernel is held to the twin.

    python3 tools/profile_f32_core.py

It needs a card and ``nvcc`` (the machine that runs ``chip_smoke.py``)
and prints one line per row and variant, with the card's name and power
limit first.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

S_LOOP = "for (int e = 0; e < DP; e += 4) {"
PV_LOOP = "for (int n = 0; n < BK; n += 4) {"
VARIANTS = {"full": (), "no S": (S_LOOP,), "no P V": (PV_LOOP,),
            "neither": (S_LOOP, PV_LOOP)}
# (label, B, S, Hq, Hkv, D)
ROWS = (("static prefill D 128", 16, 832, 16, 8, 128),
        ("small models' D 32", 16, 832, 8, 4, 32))

KERNEL = r'''
#include "attention_f32.cuh"

template <int DP>
__global__ void __launch_bounds__(128, attn_f32::Tile<DP>::kMinBlocks)
k5(const float* __restrict__ q, const float* __restrict__ k,
   const float* __restrict__ v, float* __restrict__ out, int Sq, int Hq,
   int Hkv) {
  constexpr int M = attn_f32::kRows;
  const int rep = Hq / Hkv;
  const int hr = min(rep, M), ng = (rep + hr - 1) / hr, tq = M / hr;
  const int tile = gridDim.x - 1 - blockIdx.x;
  const int hg = blockIdx.y % ng, kvh = (blockIdx.y / ng) % Hkv;
  const int b = blockIdx.y / (ng * Hkv), tok0 = tile * tq;
  attn_f32::TileArgs a;
  const size_t qoff = (size_t(b) * Sq + tok0) * Hq * DP +
                      (size_t(kvh) * rep + size_t(hg) * hr) * DP;
  a.q = q + qoff;
  a.out = out + qoff;
  a.tok_stride = size_t(Hq) * DP;
  a.hr = hr;
  a.nh = min(hr, rep - hg * hr);
  a.ntok = min(tq, Sq - tok0);
  a.pos0 = tok0;
  a.nkeys = Sq;
  a.lo = 0;
  a.hi = min(Sq, tok0 + a.ntok);
  a.d = DP;
  a.causal = 1;
  a.window = 0;
  a.softcap = 0.f;
  a.scale = 1.0f / sqrtf(float(DP));
  a.splits = 1;
  const attn_f32::DenseKeys keys{size_t(b) * Sq * Hkv * DP + size_t(kvh) * DP,
                                 size_t(Hkv) * DP};
  attn_f32::attend_f32<DP, false>(a, k, v, keys);
}

template <int DP>
int run(const void* q, const void* k, const void* v, void* out, int B,
        int Sq, int Hq, int Hkv, void* stream) {
  const int rep = Hq / Hkv, hr = rep < 64 ? rep : 64;
  return attn_f32::launch(
      k5<DP>, dim3((Sq + 64 / hr - 1) / (64 / hr), B * Hkv * ((rep + hr - 1) / hr)),
      1, attn_f32::smem_bytes<DP>(), static_cast<cudaStream_t>(stream),
      false, static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), Sq, Hq, Hkv);
}

extern "C" int profile_launch(int d, const void* q, const void* k,
                              const void* v, void* out, int B, int Sq,
                              int Hq, int Hkv, void* stream) {
  return d == 32 ? run<32>(q, k, v, out, B, Sq, Hq, Hkv, stream)
                 : run<128>(q, k, v, out, B, Sq, Hq, Hkv, stream);
}
'''


def compile_variant(work: Path, name: str, cuts) -> Path:
    """A library of the profiling kernel over a copy of the core with the
    loops in ``cuts`` compiled out."""
    d = work / name.replace(" ", "_")
    d.mkdir()
    core = (build.CSRC / "attention_f32.cuh").read_text()
    for loop in cuts:
        if core.count(loop) != 1:
            raise RuntimeError(f"the core no longer has one `{loop}`")
        core = core.replace(loop, loop.replace("e < DP", "e < 0")
                            .replace("n < BK", "n < 0"))
    (d / "attention_f32.cuh").write_text(core)
    shutil.copy(build.CSRC / "attention_tc.cuh", d)
    (d / "k5.cu").write_text(KERNEL)
    lib = d / "libprofile.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
                    str(lib), str(d / "k5.cu")], check=True,
                   capture_output=True, text=True)
    return lib


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_f32_core: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        with ThreadPoolExecutor(len(VARIANTS)) as ex:
            libs = dict(zip(VARIANTS, ex.map(
                lambda kv: compile_variant(Path(tmp), *kv),
                VARIANTS.items())))
        gen = torch.Generator(device=dev).manual_seed(0)
        for label, b, s, hq, hkv, d in ROWS:
            q = torch.randn((b, s, hq, d), generator=gen, device=dev)
            k, v = (torch.randn((b, s, hkv, d), generator=gen, device=dev)
                    for _ in range(2))
            want = fa.flash_attention_ref(q, k, v)
            times = {}
            for name, path in libs.items():
                lib = ctypes.CDLL(str(path))
                lib.profile_launch.argtypes = ([ctypes.c_int]
                                               + [ctypes.c_void_p] * 4
                                               + [ctypes.c_int] * 4
                                               + [ctypes.c_void_p])
                out = torch.empty_like(q)

                def launch():
                    err = lib.profile_launch(
                        d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(), b, s, hq, hkv,
                        torch.cuda.current_stream(dev).cuda_stream)
                    if err:
                        raise RuntimeError(f"launch failed: cudaError {err}")
                times[name] = time_ms(launch)
                if name == "full":
                    err = float((out - want).abs().max())
                    if not err <= 2e-5:
                        raise AssertionError(f"{label}: max|err| {err:.3e}")
            full = times["full"]
            print(f"{label}: full {full:.4f} ms; S loop "
                  f"{full - times['no S']:.4f} ms, P V loop "
                  f"{full - times['no P V']:.4f} ms, the rest (both loops "
                  f"cut) {times['neither']:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
