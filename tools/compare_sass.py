"""Hold the kernels a change leaves alone to the parent's machine code.

Builds the checkout's kernel library (``repro_torch.kernels.build``) and
the parent's ``csrc/*.cu`` (one ``nvcc`` each, the same flags), and
compares, instantiation by instantiation, the SASS of the named kernels
(all their template instantiations, exact and padded) with the
constant-bank offsets of their parameters masked: a parameter added to or
removed from a kernel moves those offsets and nothing else. Prints one
line per instantiation that differs and a tally; exits 1 on a difference
or an instantiation missing on either side.

    python3 tools/compare_sass.py PARENT_CSRC [KERNEL ...]

PARENT_CSRC is the parent's ``src/repro_torch/kernels/csrc`` (for example
unpacked with ``git archive PARENT src/repro_torch/kernels/csrc``); the
kernels default to every kernel but K6's float32 route (the one whose
code changed with its chunk-parallel redesign): K1, K2, K3, both bodies
of K4 and K5, and the bf16 body of K6. It needs
``nvcc`` and ``cuobjdump`` (the machine with the card).
"""
from __future__ import annotations

import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.kernels import build  # noqa: E402

KERNELS = ("logprob_fwd_kernel", "logprob_bwd_kernel", "paged_decode_kernel",
           "paged_prefill_tc_kernel", "paged_prefill_kernel",
           "flash_attention_tc_kernel", "flash_attention_kernel",
           "ssd_scan_tc_kernel")


def parent_library(csrc: Path, out: Path):
    """The parent's sources built into one library: (path, nvcc log)."""
    def compile_one(src: Path) -> str:
        r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-c", "-o",
                            str(out / (src.stem + ".o")), str(src)],
                           capture_output=True, text=True, check=True)
        return r.stdout + r.stderr
    with ThreadPoolExecutor(8) as ex:
        log = "\n".join(ex.map(compile_one, sorted(csrc.glob("*.cu"))))
    lib = out / "libparent.so"
    subprocess.run([build._nvcc(), "-shared", "-o", str(lib),
                    *map(str, sorted(out.glob("*.o")))], check=True)
    return lib, log


def key(name: str, kernels):
    """(kernel, its template arguments) of a mangled name, or None."""
    for k in kernels:
        if k + "I" in name:
            return k, name.split(k + "I", 1)[1].split("EEEv")[0]
    return None


def instructions(sass: str):
    """The instruction text of a function's SASS, parameter offsets
    masked."""
    out = []
    for line in sass.splitlines():
        m = re.search(r"/\*[0-9a-f]{4,6}\*/\s+(.*?);", line)
        if m:
            out.append(re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[P]",
                              m.group(1)))
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    csrc, kernels = Path(argv[0]), tuple(argv[1:]) or KERNELS
    new = build.build()
    with tempfile.TemporaryDirectory() as tmp:
        lib, log = parent_library(csrc, Path(tmp))
        old_names = [n for n in build.ptxas_report(log) if key(n, kernels)]
        new_names = [n for n in build.ptxas_report(new.log)
                     if key(n, kernels)]
        old = {key(n, kernels): s for n, s in
               build.sass_functions(lib, old_names).items()}
        cur = {key(n, kernels): s for n, s in
               build.sass_functions(new.path, new_names).items()}
    same = 0
    for k in sorted(set(old) | set(cur)):
        if k not in old or k not in cur:
            print(f"only in the {'change' if k in cur else 'parent'}: "
                  f"{k[0]}<{k[1]}>")
            continue
        a, b = instructions(old[k]), instructions(cur[k])
        if a and a == b:
            same += 1
        else:
            print(f"differs: {k[0]}<{k[1]}> ({len(a)} instructions in the "
                  f"parent, {len(b)} now)")
    total = len(set(old) | set(cur))
    print(f"{same} of {total} instantiations of {', '.join(kernels)} have "
          f"the parent's SASS (parameter offsets masked)")
    return 0 if same == total else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
