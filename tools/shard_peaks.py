"""Phase 14's two-rank part (the sharded learner over gloo, two ranks on
the one card) from given trees of the repo, alone, one tree after another.

For each TREE in turn: builds that tree's kernel library (its own
``build/``), starts two rank processes that run the tree's
``chip_smoke.shard_rank_main`` (the float32 pair against ``train_step``
and its control, two bf16 steps of qwen3-1.7b on the 2x1 ``train_fsdp``
and 1x2 ``train`` plans, the expert-parallel MoE layer), and prints one
JSON line: for each plan the bf16 steps' ms (rank 0) and peak GiB of each
rank (``torch.cuda.max_memory_allocated`` over each step), the gathered
weights' high-water mark of each rank where the tree records it, the
float32 pair's parity record; the tree's seconds; the card.

    python3 tools/shard_peaks.py TREE [TREE ...]

TREE is the root of a checkout: this one (``.``) or another commit
unpacked under ``build/`` (``git archive HEAD | tar -x -C build/parent``
while the change is uncommitted). Give the trees in the order parent,
this, this, parent, so that both are measured on one card in turns.
Needs a CUDA card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BUILD = "import sys; sys.path.insert(0, {src!r}); " \
    "from repro_torch.kernels import build; build.build()"
RANK = "import sys; sys.path.insert(0, {root!r}); import chip_smoke as cs; " \
    "cs.shard_rank_main({r}, 2, {work!r}, 0, {card!r})"


def run(root: Path, card: str) -> dict:
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-c", BUILD.format(src=str(root / "src"))],
                   check=True, timeout=900)
    work = Path(tempfile.mkdtemp(prefix="shard-peaks-"))
    logs = [open(work / f"log{r}.txt", "w") for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK.format(root=str(root), r=r,
                                           work=str(work), card=card)],
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(2)]
    try:
        for p in procs:
            p.wait(timeout=900)
    finally:
        for p in procs:
            p.kill()
            p.wait()
        for fh in logs:
            fh.close()
    if any(p.returncode for p in procs):
        raise RuntimeError("\n".join((work / f"log{r}.txt").read_text()[-3000:]
                                     for r in range(2)))
    recs = [json.loads((work / f"rank{r}.json").read_text())
            for r in range(2)]
    out = {"tree": str(root), "card": card,
           "seconds": time.perf_counter() - t0}
    for name in recs[0]["plans"]:
        per = [rec["plans"][name] for rec in recs]
        out[name] = {
            "step_ms": per[0]["bf16_ms"],
            "peak_gib": [p["bf16_peak_gib"] for p in per],
            "gathered_high": [p.get("bf16_gathered_high") for p in per],
            "gathered_bound": per[0].get("bf16_gathered_bound"),
            "parity": {k: v for k, v in per[0].items()
                       if k.startswith(("sharded", "control"))}}
    return out


def main(argv) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    for tree in argv:
        print(json.dumps(run(Path(tree).resolve(), card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
