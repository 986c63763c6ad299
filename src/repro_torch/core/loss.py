"""Policy-optimization loss for every method of the paper
(``repro/core/loss.py``).

Ratio family (GRPO / Dr.GRPO / BNPO / GSPO / GEPO): the PPO-style clipped
surrogate on the (token|seq|group)-level ratio,
    L = -E[min(w A, clip(w, 1 +- eps) A)].
Async family (Table 11), a detached weight on a REINFORCE term:
    Truncated-IS:  -E[ sg(clip(w, 0, 1)) A log p ]           (seq level)
    CISPO:         -E[ sg(clip(w_t, 1 - e_l, 1 + e_h)) A log p_t ]
    TOPR:          -E[ (1{A>0} + 1{A<=0} sg(clip(w, 0, 1))) A log p ]
KL: CPPO-KL against the sampler policy, k3 estimator. The metrics dict
carries the stability diagnostics of Fig. 4/5 (IW variance, KL,
estimation error of E[A]); variances and standard deviations are
population ones (``correction=0``), as in ``jnp.var``/``jnp.std``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import RLConfig
from repro_torch.core.importance import (ALL_METHODS, importance_weights,
                                         seq_logprob)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (x * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _per_seq_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B,): mean over the valid tokens of each sequence."""
    return (x * mask).sum(-1) / torch.clamp(mask.sum(-1), min=1.0)


def kl_k3(learner_lp: torch.Tensor, sampler_lp: torch.Tensor,
          mask: torch.Tensor, clamp: float = 20.0) -> torch.Tensor:
    """k3 estimator of KL(p||q) on sampled tokens, E[exp(q-p) - (q-p) - 1],
    with only the exponential term clamped to +-``clamp`` nats."""
    d = sampler_lp.detach() - learner_lp
    return _masked_mean(torch.exp(d.clamp(-clamp, clamp)) - d - 1.0, mask)


def policy_loss(rl: RLConfig, learner_lp: torch.Tensor,
                sampler_lp: torch.Tensor, mask: torch.Tensor,
                advantages: torch.Tensor,
                entropy: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """learner_lp/sampler_lp/mask (B, T); advantages (B,). ``entropy``
    (B, T), when given, feeds ``entropy_bonus`` with the true policy
    entropy (else the -log p surrogate). Returns (scalar loss, metrics)."""
    if rl.loss_type not in ALL_METHODS:
        raise ValueError(f"unknown loss_type {rl.loss_type!r}")
    log_w, level = importance_weights(
        rl.loss_type, learner_lp, sampler_lp, mask,
        group_size=rl.group_size, length_normalize=rl.seq_len_normalize,
        gepo_smooth=rl.gepo_smooth)
    adv = advantages.detach()
    f32 = torch.float32

    if rl.loss_type in ("grpo", "dr_grpo", "bnpo", "gspo", "gepo"):
        w = torch.exp(log_w)
        if level == "token":
            a = adv[:, None]
            w_clip = w.clamp(1.0 - rl.clip_eps, 1.0 + rl.clip_eps)
            per_tok = -torch.minimum(w * a, w_clip * a)
            clip_frac = _masked_mean(
                ((w - 1.0).abs() > rl.clip_eps).to(f32), mask)
            if rl.loss_type == "dr_grpo":
                # Dr.GRPO: no per-sequence length normalization
                loss = (per_tok * mask).sum() / (mask.shape[0]
                                                 * mask.shape[1])
            else:
                loss = _per_seq_mean(per_tok, mask).mean()
            w_seq = torch.exp((seq_logprob(learner_lp, mask)
                               - seq_logprob(sampler_lp, mask)).detach())
        else:                                               # seq / group
            w_clip = w.clamp(1.0 - rl.clip_eps, 1.0 + rl.clip_eps)
            loss = -torch.minimum(w * adv, w_clip * adv).mean()
            clip_frac = ((w.detach() - 1.0).abs() > rl.clip_eps).to(
                f32).mean()
            w_seq = w.detach()
    elif rl.loss_type == "tis":
        w = torch.exp(log_w).clamp(0.0, 1.0).detach()
        loss = -(w * adv * _per_seq_mean(learner_lp, mask)).mean()
        clip_frac = (torch.exp(log_w.detach()) > 1.0).to(f32).mean()
        w_seq = torch.exp(log_w).detach()
    elif rl.loss_type == "cispo":
        w_t = torch.exp(log_w).clamp(1.0 - rl.cispo_eps_low,
                                     1.0 + rl.cispo_eps_high).detach()
        per_tok = -(w_t * adv[:, None] * learner_lp)
        loss = _per_seq_mean(per_tok, mask).mean()
        ew = torch.exp(log_w.detach())
        clip_frac = _masked_mean(((ew > 1.0 + rl.cispo_eps_high)
                                  | (ew < 1.0 - rl.cispo_eps_low)).to(f32),
                                 mask)
        w_seq = torch.exp((seq_logprob(learner_lp, mask)
                           - seq_logprob(sampler_lp, mask)).detach())
    else:                                                   # topr
        w = torch.exp(log_w).clamp(0.0, 1.0).detach()
        coef = torch.where(adv > 0, 1.0, w)
        loss = -(coef * adv * _per_seq_mean(learner_lp, mask)).mean()
        clip_frac = ((adv <= 0) & (torch.exp(log_w.detach()) > 1.0)).to(
            f32).mean()
        w_seq = torch.exp(log_w).detach()

    kl = kl_k3(learner_lp, sampler_lp, mask)
    if rl.beta_kl > 0.0:
        loss = loss + rl.beta_kl * kl
    if rl.entropy_bonus > 0.0:
        if entropy is not None:
            loss = loss - rl.entropy_bonus * _masked_mean(entropy, mask)
        else:
            loss = loss - rl.entropy_bonus * _masked_mean(-learner_lp, mask)

    est = (w_seq * adv).mean()          # Monte-Carlo E_q[w A]; E_p[A] ~ 0
    metrics = {
        "loss": loss.detach(),
        "kl": kl.detach(),
        "iw_mean": w_seq.mean(),
        "iw_var": w_seq.var(correction=0),
        "iw_max": w_seq.max(),
        "clip_frac": clip_frac,
        "est_error": est.abs(),
        "adv_mean": adv.mean(),
        "adv_std": adv.std(correction=0),
    }
    if entropy is not None:
        metrics["entropy"] = _masked_mean(entropy, mask).detach()
    return loss, metrics
