"""Engine construction from a ``ServeConfig``, and the teacher-forced
log-prob recompute.

The port so far has one engine, the continuous-batching engine over the
paged KV cache. The static engine of ``repro/sampling/engine.py`` is a
later slice, so a static ``ServeConfig`` raises here. ``token_logps`` is
the App. B.1 untrusted-sampler recompute of that module.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

from repro_torch.config import ModelConfig, RLConfig, ServeConfig
from repro_torch.kernels.ops import fused_token_logprob
from repro_torch.models.model import forward
from repro_torch.sampling.continuous import ContinuousEngine
from repro_torch.sampling.paged_cache import paged_cache_supported


def build_engine(cfg: ModelConfig, params: Dict[str, Any],
                 serve: ServeConfig, *, rl: Optional[RLConfig] = None,
                 vocab_limit: Optional[int] = None,
                 seed: Optional[int] = None) -> ContinuousEngine:
    """The continuous engine a ``ServeConfig`` describes, on the device
    ``params`` live on. ``rl`` carries the sampling profile every request
    must match; ``seed`` (default ``serve.seed``) keys the token draws."""
    rl = rl or RLConfig(engine=serve.engine)
    if serve.engine != "continuous":
        raise NotImplementedError(
            "the static engine is not ported yet: ROADMAP queue 1 'Static "
            "engine and the bit-exact threefry'")
    if serve.paged_attn_impl:
        cfg = dataclasses.replace(cfg, paged_attn_impl=serve.paged_attn_impl)
    if not paged_cache_supported(cfg):
        raise ValueError(f"{cfg.name}: the continuous engine serves "
                         "attention-only decoders")
    return ContinuousEngine(
        cfg, params, rl=rl, max_total_tokens=serve.max_total_tokens,
        num_slots=serve.num_slots, page_size=serve.page_size,
        sync_every=serve.sync_every,
        prefill_chunk=serve.prefill_chunk or None,
        num_pages=serve.resolved_num_pages, vocab_limit=vocab_limit,
        prefix_cache=serve.prefix_cache,
        prefix_cache_entries=serve.prefix_cache_entries,
        spec_k=serve.spec_k,
        seed=serve.seed if seed is None else seed)


@torch.no_grad()
def token_logps(cfg: ModelConfig, params: Dict[str, Any],
                tokens: torch.Tensor, *,
                logprob_impl: Optional[str] = None) -> torch.Tensor:
    """Teacher-forced log p(tokens[t] | tokens[<t]) -> (B, T-1) float32.

    The App. B.1 untrusted-sampler recompute: one dense forward, then the
    same streaming log-prob path as the learner's loss (the K1 kernel on
    the card) instead of a (B*T, V) log-softmax. ``logprob_impl`` takes
    the ``TrainConfig.logprob_impl`` vocabulary; None or "fused"
    auto-dispatches."""
    logits, _, _ = forward(cfg, params, tokens[:, :-1])
    impl = None if logprob_impl == "fused" else logprob_impl
    lp, _ = fused_token_logprob(logits, tokens[:, 1:], impl=impl)
    return lp
