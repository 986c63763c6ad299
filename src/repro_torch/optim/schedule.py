"""Learning-rate schedules (``repro/optim/schedule.py``). The paper uses
1e-6 with 3% linear warm-up. Each returns a 0-dim float32 tensor on the
device of ``step`` (the CPU for a Python int)."""
from __future__ import annotations

import math
from typing import Union

import torch

from repro_torch.config import TrainConfig


def _step_f32(step: Union[int, torch.Tensor]) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_schedule(tc: TrainConfig, step) -> torch.Tensor:
    warm = max(int(tc.warmup_frac * tc.total_steps), 1)
    s = _step_f32(step)
    frac = torch.clamp((s + 1.0) / warm, max=1.0)   # first step has lr > 0
    return tc.learning_rate * frac


def cosine_schedule(tc: TrainConfig, step, final_frac: float = 0.1
                    ) -> torch.Tensor:
    warm = max(int(tc.warmup_frac * tc.total_steps), 1)
    s = _step_f32(step)
    lr = tc.learning_rate
    warm_lr = lr * torch.clamp(s / warm, max=1.0)
    t = torch.clamp((s - warm) / max(tc.total_steps - warm, 1), 0.0, 1.0)
    cos = final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * t))
    return torch.where(s < warm, warm_lr, lr * cos)
