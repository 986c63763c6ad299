"""Importance weights: token, sequence and group level
(``repro/core/importance.py``; paper Listing 1 and Table 11), in log
space.

Token level  (GRPO / Dr.GRPO / BNPO):   w_t = p_t / q_t
Sequence lvl (GSPO):                    w   = p(y|x) / q(y|x)
Group level  (GEPO):                    w   = p(y|x) / E_q[q(y|x)]
  with  E_q[q] = sum_i q_i^2 / sum_i q_i  over the G responses of the
  group (eq. 2), the denominator detached (it is sampler-side).

Sequence log-probs are length-normalized (eq. 61). Sequences of a group
are contiguous: shape (n_groups * G, T). ``gepo_smooth`` is the App. H
defensive denominator (0 recovers the paper). ``.detach()`` stands where
the JAX package has ``stop_gradient``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

TOKEN_LEVEL = ("grpo", "dr_grpo", "bnpo")
SEQ_LEVEL = ("gspo", "tis", "topr")
GROUP_LEVEL = ("gepo",)
RATIO_METHODS = TOKEN_LEVEL + ("gspo", "gepo")
ASYNC_METHODS = ("tis", "cispo", "topr")
ALL_METHODS = TOKEN_LEVEL + ("gspo", "gepo") + ASYNC_METHODS


def seq_logprob(token_lp: torch.Tensor, mask: torch.Tensor,
                length_normalize: bool = True) -> torch.Tensor:
    """(B, T) token log-probs -> (B,) sequence log-prob."""
    s = (token_lp * mask).sum(-1)
    if length_normalize:
        s = s / torch.clamp(mask.sum(-1), min=1.0)
    return s


def group_expectation_log_denominator(
        sampler_seq_lp: torch.Tensor, group_size: int, smooth: float = 0.0,
        learner_seq_lp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """log E_q[q] per sequence (eq. 2), broadcast back to (B,):
    logsumexp(2 log q) - logsumexp(log q) per group. ``smooth`` > 0 mixes
    in the detached learner probability: (1 - s) E_q[q] + s p(y|x)."""
    b = sampler_seq_lp.shape[0]
    lp = sampler_seq_lp.reshape(b // group_size, group_size)
    log_den = (torch.logsumexp(2.0 * lp, dim=-1)
               - torch.logsumexp(lp, dim=-1))
    log_den = torch.repeat_interleave(log_den, group_size)
    if smooth > 0.0:
        if learner_seq_lp is None:
            raise ValueError("gepo_smooth > 0 needs learner_seq_lp")
        log_den = torch.logaddexp(math.log1p(-smooth) + log_den,
                                  math.log(smooth) + learner_seq_lp.detach())
    return log_den


def importance_weights(loss_type: str, learner_lp: torch.Tensor,
                       sampler_lp: torch.Tensor, mask: torch.Tensor, *,
                       group_size: int, length_normalize: bool = True,
                       gepo_smooth: float = 0.0
                       ) -> Tuple[torch.Tensor, str]:
    """``(log_w, level)``: ``log_w`` is (B, T) for token-level methods and
    (B,) for sequence/group-level ones. Gradients flow through the
    learner log-probs only."""
    sampler_lp = sampler_lp.detach()
    if loss_type in TOKEN_LEVEL or loss_type == "cispo":
        return learner_lp - sampler_lp, "token"
    p_seq = seq_logprob(learner_lp, mask, length_normalize)
    q_seq = seq_logprob(sampler_lp, mask, length_normalize)
    if loss_type in ("gspo", "tis", "topr"):
        return p_seq - q_seq, "seq"
    if loss_type == "gepo":
        log_den = group_expectation_log_denominator(
            q_seq, group_size, smooth=gepo_smooth, learner_seq_lp=p_seq)
        return p_seq - log_den.detach(), "seq"
    raise ValueError(f"unknown loss_type {loss_type!r}")
