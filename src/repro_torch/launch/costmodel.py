"""Analytic per-step cost model (the port of ``repro/launch/costmodel.py``,
the same arithmetic in the same order).

The dry-run's compute and memory roofline terms come from this model,
the napkin math a performance engineer does by hand; the collective
term comes from the bytes the port's collectives move in the dry-run's
step (``parallel.collectives.COLLECTIVE_BYTES``).

Conventions:
- FLOPs are *as-computed*: the chunked attention path computes the full
  (masked) Sq x Sk rectangle, so causal attention costs 2x the ideal;
  the ideal is also reported.
- Train steps: matmul FLOPs x4 (fwd + recompute-under-remat + 2x bwd);
  inference x1.

Parameter counts are the JAX package's (``reference_param_count``, its
``ModelConfig.param_count`` copied here), not the port's fuller
``ModelConfig.param_count`` (which also counts the final norm, the QKV
biases and an encoder-decoder model's cross-attention): the model's
numbers equal the reference's.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.config import (ATTN, CROSS, LOCAL, MAMBA, MLP, MOE,
                                ModelConfig, ShapeConfig)

BF16 = 2
F32 = 4


def reference_param_count(cfg: ModelConfig, active_only: bool = False
                          ) -> int:
    """The JAX package's parameter count (``repro.config.ModelConfig.
    param_count``): embedding, untied head, per layer the mixer, the FFN
    (``active_only``: the experts a token runs) and two norms, and the
    encoder's layers."""
    d, h = cfg.d_model, cfg.head_dim
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    total = cfg.padded_vocab * d                 # embedding
    if not cfg.tie_embeddings:
        total += cfg.padded_vocab * d            # lm head
    for li in range(cfg.num_layers):
        kind = cfg.block_pattern[li % cfg.period]
        if kind in (ATTN, LOCAL, CROSS):
            total += d * (n_q * h) + 2 * d * (n_kv * h) + (n_q * h) * d
        elif kind == MAMBA:
            di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
            total += d * (2 * di + 2 * g * n + cfg.ssm_heads)   # in_proj
            total += di * d                                     # out_proj
            total += cfg.ssm_conv * (di + 2 * g * n)            # conv
        fk = cfg.ffn_kind(li % cfg.period)
        if fk == MLP:
            total += 3 * d * cfg.d_ff
        elif fk == MOE:
            n_e = (cfg.experts_per_token if active_only
                   else cfg.num_experts)
            total += 3 * d * cfg.d_ff * n_e
            total += d * cfg.num_experts                        # router
            if cfg.shared_expert:
                total += 3 * d * cfg.d_ff
        total += 2 * d                                           # norms
    if cfg.encoder_layers:
        total += cfg.encoder_layers * (4 * d * (cfg.num_heads * h)
                                       + 3 * d * cfg.d_ff + 2 * d)
    return total


def _attn_flops_per_token(cfg: ModelConfig, kv_len: float, ideal: bool,
                          kind: str, seq_len: int) -> float:
    """Score+value matmul FLOPs for one query token against kv_len keys."""
    if ideal:
        if kind == ATTN:
            kv_eff = (kv_len + 1) / 2          # causal average
        elif kind == LOCAL:
            kv_eff = min(cfg.sliding_window, kv_len / 2)
        else:
            kv_eff = kv_len
    else:
        # the chunked path computes the full rectangle, then masks
        kv_eff = kv_len
    return 4.0 * cfg.num_heads * cfg.head_dim * kv_eff


def _layer_matmul_params(cfg: ModelConfig, kind: str, ffn_kind: str) -> int:
    """Active matmul params for one layer (used at 2 FLOPs/param/token)."""
    d, h = cfg.d_model, cfg.head_dim
    n = 0
    if kind in (ATTN, LOCAL, CROSS):
        n += d * (cfg.num_heads * h) + 2 * d * (cfg.num_kv_heads * h) \
            + (cfg.num_heads * h) * d
    elif kind == MAMBA:
        di, N, G = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
        n += d * (2 * di + 2 * G * N + cfg.ssm_heads) + di * d
    if ffn_kind == MLP:
        n += 3 * d * cfg.d_ff
    elif ffn_kind == MOE:
        n += 3 * d * cfg.d_ff * cfg.experts_per_token + d * cfg.num_experts
        if cfg.shared_expert:
            n += 3 * d * cfg.d_ff
    return n


def _ssd_flops_per_token(cfg: ModelConfig) -> float:
    """Chunked SSD: intra-chunk quadratic + state update, per token."""
    if not cfg.ssm_state:
        return 0.0
    l = cfg.ssm_chunk
    h, p, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    # per chunk: C B^T (L^2 N), y_intra (L^2 P) per head; states in/out
    per_chunk = 2.0 * h * (l * l * n + l * l * p + 2 * l * n * p)
    return per_chunk / l


def flops_estimate(cfg: ModelConfig, shape: ShapeConfig, *,
                   ideal: bool = False) -> float:
    """Global FLOPs per step (whole mesh)."""
    if shape.kind == "decode":
        tokens = shape.global_batch
        kv_len = shape.seq_len
        mult = 1.0
    elif shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        kv_len = shape.seq_len
        mult = 1.0
    else:
        tokens = shape.global_batch * shape.seq_len
        kv_len = shape.seq_len
        mult = 4.0                              # fwd + remat + 2 bwd

    total = 0.0
    for li in range(cfg.num_layers):
        kind = cfg.block_pattern[li % cfg.period]
        ffn_kind = cfg.ffn_kind(li % cfg.period)
        total += 2.0 * _layer_matmul_params(cfg, kind, ffn_kind) * tokens
        if kind in (ATTN, LOCAL):
            if shape.kind == "decode":
                kv_eff = (min(cfg.sliding_window, kv_len)
                          if kind == LOCAL else kv_len)
                total += 4.0 * cfg.num_heads * cfg.head_dim * kv_eff * tokens
            else:
                total += _attn_flops_per_token(cfg, kv_len, ideal, kind,
                                               shape.seq_len) * tokens
        elif kind == CROSS:
            total += 4.0 * cfg.num_heads * cfg.head_dim * cfg.memory_seq \
                * tokens
        elif kind == MAMBA:
            if shape.kind == "decode":
                total += 2.0 * cfg.ssm_heads * cfg.ssm_headdim \
                    * cfg.ssm_state * 2 * tokens
            else:
                total += _ssd_flops_per_token(cfg) * tokens
    # encoder (runs once per step on encoder_seq frames)
    if cfg.encoder_layers:
        enc_tokens = shape.global_batch * cfg.encoder_seq
        if shape.kind == "decode":
            enc_tokens = 0                      # encoder output cached
        per = (4 * cfg.d_model * cfg.num_heads * cfg.head_dim
               + 3 * cfg.d_model * cfg.d_ff)
        total += 2.0 * per * cfg.encoder_layers * enc_tokens
        total += 4.0 * cfg.num_heads * cfg.head_dim * cfg.encoder_seq \
            * enc_tokens
        # decoder cross-attention to the encoder's memory
        total += 4.0 * cfg.num_heads * cfg.head_dim * cfg.encoder_seq \
            * tokens
    # lm head + embedding
    total += 2.0 * cfg.d_model * cfg.padded_vocab * tokens
    return total * mult


def bytes_estimate(cfg: ModelConfig, shape: ShapeConfig, n_dev: int,
                   optimizer: str = "adamw") -> Dict[str, float]:
    """Per-device HBM bytes per step (read+write), by component."""
    n_params = reference_param_count(cfg)
    p_dev = n_params * BF16 / n_dev             # params fully sharded
    if shape.kind == "train":
        tokens_dev = shape.global_batch * shape.seq_len / n_dev
        opt_mult = (4 * F32 if optimizer == "adamw" else 2 * BF16)
        # fwd read + bwd read + grad write (f32) + opt read/write
        weights = p_dev * (2 + 2) + n_params * F32 / n_dev \
            + n_params * opt_mult / n_dev
        # saved residual per block: write in fwd, read in bwd
        resid = 2 * cfg.num_blocks * tokens_dev * cfg.d_model * BF16
        logits = 3 * tokens_dev * cfg.padded_vocab * F32 / \
            (16 if n_dev >= 16 else 1)          # vocab-sharded logits r/w
        act = 6 * cfg.num_layers * tokens_dev * cfg.d_model * BF16
        return {"weights": weights, "residuals": resid, "logits": logits,
                "activations": act,
                "total": weights + resid + logits + act}
    if shape.kind == "prefill":
        tokens_dev = shape.global_batch * shape.seq_len / n_dev * \
            (16 if n_dev >= 16 else 1)          # batch only over dp
        p_serve = n_params * BF16 / min(n_dev, 16)   # TP-16 weights
        act = 4 * cfg.num_layers * tokens_dev * cfg.d_model * BF16
        cache_w = _cache_bytes(cfg, shape, n_dev)
        return {"weights": p_serve, "activations": act, "cache": cache_w,
                "total": p_serve + act + cache_w}
    # decode: one token, read all params + the whole KV cache
    p_serve = n_params * BF16 / min(n_dev, 16 if shape.name != "long_500k"
                                    else n_dev)
    cache = _cache_bytes(cfg, shape, n_dev)
    return {"weights": p_serve, "cache": cache, "total": p_serve + cache}


def _cache_bytes(cfg: ModelConfig, shape: ShapeConfig, n_dev: int) -> float:
    """Per-device KV/SSM cache bytes."""
    total = 0.0
    for li in range(cfg.num_layers):
        kind = cfg.block_pattern[li % cfg.period]
        if kind in (ATTN, LOCAL):
            total += (2 * shape.global_batch * shape.seq_len
                      * cfg.num_kv_heads * cfg.head_dim * BF16)
        elif kind == CROSS:
            total += (2 * shape.global_batch * cfg.memory_seq
                      * cfg.num_kv_heads * cfg.head_dim * BF16)
        elif kind == MAMBA:
            total += (shape.global_batch * cfg.ssm_heads * cfg.ssm_headdim
                      * cfg.ssm_state * F32)
    if cfg.encoder_layers:
        total += (2 * cfg.num_layers * shape.global_batch * cfg.encoder_seq
                  * cfg.num_kv_heads * cfg.head_dim * BF16)
    return total / n_dev


__all__ = ["BF16", "F32", "reference_param_count", "flops_estimate",
           "bytes_estimate"]
