"""Token log-probabilities by the masked-sum formulation.

The port of ``repro/core/logprob.py``. These are the *materializing*
reference implementations: the training hot path goes through
``repro_torch.kernels.ops.fused_token_logprob`` (the K1/K2 kernels on the
card, their chunked twin elsewhere), which computes the same values and
gradients without a V-sized float32 activation.

Target-id contract (shared with the fused kernels): target ids are
clamped to [0, V) before the gather, so padded positions carrying any id
(0, -1, a PAD beyond the vocabulary) give the finite log-prob of a valid
token; the loss masks them out.
"""
from __future__ import annotations

from typing import Tuple

import torch


def clamp_target_ids(targets: torch.Tensor, vocab: int) -> torch.Tensor:
    """The shared target-id contract: int32 ids clamped to [0, vocab)."""
    return targets.to(torch.int32).clamp(0, vocab - 1)


def _target_logit(lg: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Masked-sum gather of the (clamped) target column of f32 ``lg``."""
    tgt = clamp_target_ids(targets, lg.shape[-1])
    iota = torch.arange(lg.shape[-1], device=lg.device, dtype=torch.int32)
    hit = iota == tgt[..., None]
    return torch.where(hit, lg, 0.0).sum(-1)


def token_logprob_from_logits(logits: torch.Tensor, targets: torch.Tensor
                              ) -> torch.Tensor:
    """logits (..., V) [any float dtype], targets (...) int -> (...) f32."""
    lg = logits.float()
    return _target_logit(lg, targets) - torch.logsumexp(lg, dim=-1)


def token_logprob_entropy_lse(logits: torch.Tensor, targets: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """(logp, entropy, lse) over the last axis, all f32: the one source
    of the masked-sum math, used whole-array here and chunk by chunk by
    the twin of the fused kernels (``kernels.fused_logprob``)."""
    lg = logits.float()
    m = lg.amax(dim=-1)
    p_un = torch.exp(lg - m[..., None])
    l = torch.clamp(p_un.sum(-1), min=1e-30)
    lse = m + torch.log(l)
    tl = _target_logit(lg, targets)
    ent = lse - (p_un * lg).sum(-1) / l
    return tl - lse, ent, lse


def token_logprob_and_entropy(logits: torch.Tensor, targets: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    lp, ent, _ = token_logprob_entropy_lse(logits, targets)
    return lp, ent
