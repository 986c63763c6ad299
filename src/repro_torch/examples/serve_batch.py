"""Batched serving with the KV-cache engine on the port: what a HeteroRL
sampler node runs, on the reduced Qwen2-family variant.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch [--arch qwen2-7b ...]

The port of ``examples/serve_batch.py``: ``repro_torch.launch.serve.main``
with the same default flags, plus ``--smoke``, which the port's launcher
needs to serve the reduced variant that the JAX launcher always serves.
Flags given replace the defaults, as in the JAX example; ``--device
cpu`` serves on the CPU.
"""
from __future__ import annotations

import sys
from typing import Optional, Sequence

from repro_torch.launch.serve import main as serve_main

DEFAULTS = ("--arch", "qwen2-7b", "--batch", "8", "--max-new", "12",
            "--rounds", "2")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = list(argv or DEFAULTS)
    if "--smoke" not in args:
        args.append("--smoke")
    serve_main(args)


if __name__ == "__main__":
    main(sys.argv[1:])
