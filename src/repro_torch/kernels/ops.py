"""Public paged-attention entry points the model calls, with the impl knob.

``impl`` is ``ModelConfig.paged_attn_impl``:

- "pallas": the hand-written Hopper kernel; raises on a CPU tensor;
- "ref": the plain PyTorch twin, on any device;
- "auto" / None: the kernel for CUDA tensors, the twin for CPU tensors;
- "gather": the dense gather path of the JAX package; not ported yet.

``kind``/``window`` follow the JAX package: the sliding-window band
applies only when ``kind == "local"``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.config import PAGED_IMPLS
from repro_torch.kernels import paged_attention as pa

_GATHER_TODO = ("paged_attn_impl='gather' (the dense gather path that keeps "
                "the static engine bit-identical) is not ported yet: it "
                "lands with the static engine, ROADMAP queue 1 'Static "
                "engine and the bit-exact threefry'")


def _resolve(impl: Optional[str], q: torch.Tensor, kind: str) -> str:
    if impl not in PAGED_IMPLS + (None,):
        raise ValueError(f"unknown paged-attention impl {impl!r}")
    if kind not in ("causal", "local"):
        raise ValueError(f"paged attention is causal-only, got kind={kind!r}")
    if impl == "gather":
        raise NotImplementedError(_GATHER_TODO)
    if impl == "pallas" and q.device.type != "cuda":
        raise ValueError(f"paged_attn_impl='pallas' launches the CUDA kernel "
                         f"and needs CUDA tensors, got {q.device}")
    return "ref" if impl == "ref" else "kernel"


def paged_decode(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                 page_table: torch.Tensor, lengths: torch.Tensor, *,
                 kind: str = "causal", window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Decode-step attention against paged pools. q (B, 1, Hq, D); kp/vp
    (num_pages, page_size, Hkv, D); page_table (B, npages); lengths (B,)
    valid tokens per slot. Returns (B, 1, Hq, D)."""
    path = _resolve(impl, q, kind)
    eff_window = window if kind == "local" else None
    fn = pa.paged_decode_ref if path == "ref" else pa.paged_attention
    o = fn(q[:, 0].contiguous(), kp, vp, page_table, lengths,
           window=eff_window, softcap=softcap)
    return o[:, None]


def paged_prefill(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                  page_table: torch.Tensor, positions: torch.Tensor, *,
                  kind: str = "causal", window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  impl: Optional[str] = None) -> torch.Tensor:
    """Chunked-prefill attention against paged pools. q (B, C, Hq, D);
    positions (B, C) absolute query positions, ``starts + arange(C)`` per
    slot. Returns (B, C, Hq, D)."""
    path = _resolve(impl, q, kind)
    eff_window = window if kind == "local" else None
    starts = positions[:, 0].to(torch.int32)
    lengths = (positions[:, -1] + 1).to(torch.int32)
    fn = pa.paged_prefill_ref if path == "ref" else pa.paged_prefill
    return fn(q, kp, vp, page_table, lengths, starts, window=eff_window,
              softcap=softcap)
