"""Group-relative advantage estimation (``repro/core/advantage.py``).

Baseline is the within-group mean reward (GRPO, §2). Variants:

- ``grpo``/``gspo``/``gepo``: A = (r - mean) [/ std if ``normalize``]
- ``dr_grpo``: no std normalization
- ``bnpo``: A = (r - rho) / sqrt(rho (1 - rho)), rho the batch success rate

Standard deviations are population ones (``correction=0``), as
``jnp.std`` computes them. Statistics are per group (App. F).
"""
from __future__ import annotations

import torch


def group_advantages(rewards: torch.Tensor, group_size: int, *,
                     normalize: bool = True, kind: str = "grpo",
                     eps: float = 1e-6) -> torch.Tensor:
    """rewards (B,) with group-contiguous layout -> advantages (B,)."""
    b = rewards.shape[0]
    r = rewards.reshape(b // group_size, group_size)
    if kind == "bnpo":
        rho = r.mean().clamp(eps, 1.0 - eps)          # batch success rate
        return ((r - rho) / torch.sqrt(rho * (1.0 - rho))).reshape(b)
    a = r - r.mean(dim=-1, keepdim=True)
    if normalize and kind != "dr_grpo":
        a = a / (r.std(dim=-1, keepdim=True, correction=0) + eps)
    return a.reshape(b)
