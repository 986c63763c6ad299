"""K6's float32 route at its main shapes, from a given tree of the repo.

Builds that tree's kernel library (its own ``build/`` directory) and runs
K6 (``ssd_scan.ssd_scan``) on float32 inputs at three shapes: the width
row (B 8, S 1024, H 16, P 32, G 1, N 48, chunk 256), mamba2-1.3b's
recompute layer (B 16, S 1024, H 64, P 64, N 128) and its long layer
(B 1, S 8192). For each it prints the error ratio against the tree's
twin, the CUDA-event mean over 20 back-to-back calls and the profiler's
device span of each kernel, as one JSON line. The inputs, the timing and
the spans are ``chip_smoke.py``'s (``ssd_inputs``, ``time_ms``,
``ssd_steps_ms``) from this checkout; the kernels and the twin are the
tree's.

    python3 tools/k6_f32_probe.py TREE

TREE is the root of a checkout, for example this one (``.``) or the
parent commit unpacked under ``build/`` (``git archive HEAD~1 | tar -x -C
build/parent``). Run one process per tree, in the order parent, this,
this, parent, so that both are timed on the same card in turns. Needs a
CUDA card.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

SHAPES = (("width", 8, 1024, 16, 32, 1, 48, 256),
          ("mamba2", 16, 1024, 64, 64, 1, 128, 256),
          ("long", 1, 8192, 64, 64, 1, 128, 256))


def main(argv) -> int:
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    root = Path(argv[0]).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import build, ssd_scan as ss   # the tree's
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(1, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    # the float32 route's steps, and the first design's one kernel
    names = {**cs.SSD_F32_STEPS, "first design": "ssd_scan_kernel"}
    built = build.build()
    dev = torch.device("cuda")
    out = dict(tree=str(root), library=built.path.name,
               card=torch.cuda.get_device_name(0))
    for label, b, s, h, p, g, n, chunk in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(12)
        args = cs.ssd_inputs(gen, dev, b, s, h, p, g, n, torch.float32)

        def call():
            return ss.ssd_scan(*args, chunk=chunk)

        spans = cs.ssd_steps_ms(call, steps=names)
        out[label] = dict(
            ratio=ss.error_ratio(call(), cs.ssd_twin(args, chunk)),
            ms=cs.time_ms(call), spans={k: v for k, v in spans.items() if v})
        del args
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
