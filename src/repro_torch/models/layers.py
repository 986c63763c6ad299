"""Elementary layers: RMSNorm, rotary embeddings, SwiGLU MLP, softcap.

Each follows ``repro/models/layers.py``: normalization and rotary math in
float32, cast back to the input dtype.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import runtime_context


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary position embedding. x (..., S, H, D) with D even;
    positions broadcastable to (..., S)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    angles = positions[..., None].float() * freq               # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                      # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, p: Dict[str, torch.Tensor]) -> torch.Tensor:
    """On a tensor-parallel serving forward the weights are this rank's
    FFN columns (``w_gate``/``w_up``) and rows (``w_down``), and the
    product is summed over 'model' (``runtime_context.serve_shard``)."""
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    y = h @ p["w_down"]
    tp = runtime_context.serve_shard()
    return y if tp is None else tp.reduce_ffn(y)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap)
