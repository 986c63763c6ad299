"""Step functions and abstract inputs for the production launcher and the
multi-pod dry-run (the port of ``repro/launch/step_fns.py``).

The abstract inputs are tensors on torch's ``meta`` device in the place
of the JAX package's ``ShapeDtypeStruct``s: shapes and dtypes, no
storage, so no full-size config is ever allocated. The dry-run cuts each
leaf to a rank's fitted shard and runs the step on fake tensors of those
shapes (``launch.dryrun``).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from repro_torch import runtime_context
from repro_torch.config import (ATTN, CROSS, LOCAL, MAMBA, ModelConfig,
                                RLConfig, ShapeConfig, TrainConfig)
from repro_torch.launch.costmodel import reference_param_count
from repro_torch.models import (decode_step, encode, forward, init_cache,
                                param_templates)
from repro_torch.optim import AdafactorState, AdamWState, tree_map
from repro_torch.training import TrainState

# Architectures whose optimizer state cannot be full-precision Adam at
# single-pod scale: the production choice is Adafactor (factored second
# moment), as MaxText defaults for very large models.
ADAFACTOR_ARCHS = ("jamba-1.5-large-398b", "llama4-maverick-400b-a17b",
                   "llama4-scout-17b-a16e")


def optimizer_for(cfg: ModelConfig) -> str:
    return "adafactor" if cfg.name in ADAFACTOR_ARCHS else "adamw"


def grad_accum_for(cfg: ModelConfig) -> int:
    """Micro-batches per step, by the JAX package's parameter count (the
    thresholds its dry-run memory sweeps chose)."""
    n = reference_param_count(cfg)
    if n > 50e9:
        return 16
    if n > 8e9:
        return 8
    if n > 3e9:
        return 4
    return 1


# --------------------------------------------------------------------------
# step functions


def make_train_fn(cfg: ModelConfig, rl: RLConfig, tc: TrainConfig,
                  plan=None):
    """The RL train step (state, batch) -> (state, metrics) for the
    launcher and the dry-run: ``parallel.make_sharded_train_step`` on
    ``plan`` (``training.train_step`` on none) with the arch's optimizer.
    The state is updated in place."""
    from repro_torch.parallel import local_plan, make_sharded_train_step
    return make_sharded_train_step(cfg, rl, tc, plan or local_plan("train"),
                                   optimizer=optimizer_for(cfg))


def _serving(cfg: ModelConfig, plan, max_len: int, batch: int,
             mem_len: int):
    """The serve context of a dense-cache step on ``plan`` over ``batch``
    global rows and a cache of ``max_len`` positions, as the static engine
    opens it: the rank holds its rows (``row_span``) and its part of the
    cache. A null context off a live plan."""
    shard = None if plan is None else plan.serve_shard(cfg)
    if shard is None:
        return contextlib.nullcontext()
    ax = shard.row_span(batch)[0]
    return runtime_context.serve_context(
        shard.with_cache(max_len, mem_len).with_held_rows(ax))


def make_prefill_fn(cfg: ModelConfig, max_len: int, plan=None,
                    batch: Optional[int] = None):
    """(params, batch) -> (next tokens, cache): a prompt prefill into a
    fresh dense cache of ``max_len`` positions, through ``init_cache`` and
    ``forward``. On a ``serve`` or ``long`` plan the params are the rank's
    shards and ``batch`` holds the rank's rows of ``batch`` global rows
    (default: its rows are all of them); the step runs under the plan's
    ``serve_shard`` and returns the rank's part of the cache."""
    @torch.no_grad()
    def step(params, inputs: Dict[str, torch.Tensor]):
        tokens = inputs["tokens"]
        rows = tokens.shape[0] if batch is None else batch
        memory = inputs.get("image_embeds")
        mem_len = cfg.encoder_seq if cfg.is_encdec else cfg.memory_seq
        with _serving(cfg, plan, max_len, rows, mem_len):
            if cfg.is_encdec:
                memory = encode(cfg, params, inputs["frames"])
            cache = init_cache(cfg, params, tokens.shape[0], max_len,
                               memory=memory)
            logits, cache, _ = forward(cfg, params, tokens, cache=cache,
                                       memory=memory, last_only=True)
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32), cache
    return step


def make_decode_fn(cfg: ModelConfig, plan=None, *, max_len: int = 0,
                   batch: Optional[int] = None):
    """(params, cache, token, pos) -> (next tokens, cache): one decode
    step over a dense cache, in place. On a plan, as ``make_prefill_fn``:
    the rank's part of a cache of ``max_len`` positions and its rows of
    ``batch``."""
    @torch.no_grad()
    def step(params, cache, token: torch.Tensor, pos: int):
        rows = token.shape[0] if batch is None else batch
        mem_len = cfg.encoder_seq if cfg.is_encdec else cfg.memory_seq
        with _serving(cfg, plan, max_len, rows, mem_len):
            logits, cache = decode_step(cfg, params, cache, token, pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), cache
    return step


# --------------------------------------------------------------------------
# abstract inputs


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def abstract_params(cfg: ModelConfig) -> Dict[str, Any]:
    """The param tree as ``meta`` tensors in ``cfg.dtype``."""
    return tree_map(lambda t: _meta(t.shape, _dtype(cfg)),
                    param_templates(cfg))


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    out = {"tokens": _meta((b, s), torch.int32),
           "mask": _meta((b, s - 1), torch.float32),
           "sampler_lp": _meta((b, s - 1), torch.float32),
           "rewards": _meta((b,), torch.float32)}
    if cfg.is_encdec:
        out["frames"] = _meta((b, cfg.encoder_seq, cfg.d_model), _dtype(cfg))
    elif cfg.memory_seq:
        out["image_embeds"] = _meta((b, cfg.memory_seq, cfg.d_model),
                                    _dtype(cfg))
    return out


def abstract_cache(cfg: ModelConfig, batch: int, max_len: int) -> Dict:
    """The ``meta`` twin of ``models.init_cache``'s dense cache."""
    dt = _dtype(cfg)
    nb = cfg.num_blocks
    mem_len = cfg.encoder_seq if cfg.is_encdec else cfg.memory_seq
    kv = (cfg.num_kv_heads, cfg.head_dim)

    def mem() -> Dict[str, torch.Tensor]:
        return {n: _meta((nb, batch, mem_len) + kv, dt)
                for n in ("k_mem", "v_mem")}
    cache: Dict[str, Any] = {}
    for i, kind in enumerate(cfg.block_pattern):
        lc: Dict[str, Any] = {}
        if kind in (ATTN, LOCAL):
            ml = max_len
            if cfg.local_ring_kv and kind == LOCAL:
                ml = min(max_len, cfg.sliding_window)
            lc["self"] = {n: _meta((nb, batch, ml) + kv, dt)
                          for n in ("k", "v")}
            if cfg.is_encdec:
                lc["mem"] = mem()
        elif kind == CROSS:
            lc["mem"] = mem()
        elif kind == MAMBA:
            conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
            lc["ssm_c"] = {
                "conv": _meta((nb, batch, cfg.ssm_conv - 1, conv_ch), dt),
                "ssm": _meta((nb, batch, cfg.ssm_heads, cfg.ssm_headdim,
                              cfg.ssm_state), torch.float32)}
        cache[f"layer_{i}"] = lc
    return cache


def abstract_opt_state(cfg: ModelConfig, optimizer: str):
    """``adamw_init`` / ``adafactor_init`` of ``abstract_params``, on
    ``meta``."""
    params = abstract_params(cfg)
    step = _meta((), torch.int32)
    if optimizer == "adamw":
        def f32(p):
            return _meta(p.shape, torch.float32)
        return AdamWState(step=step, m=tree_map(f32, params),
                          v=tree_map(f32, params))

    def row(p):
        return _meta(p.shape[:-1] if p.dim() >= 2 else p.shape,
                     torch.float32)

    def col(p):
        return _meta(p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else (1,),
                     torch.float32)
    return AdafactorState(step=step, vr=tree_map(row, params),
                          vc=tree_map(col, params))


def abstract_state(cfg: ModelConfig) -> TrainState:
    return TrainState(params=abstract_params(cfg),
                      opt=abstract_opt_state(cfg, optimizer_for(cfg)),
                      step=_meta((), torch.int32))


__all__ = ["ADAFACTOR_ARCHS", "optimizer_for", "grad_accum_for",
           "make_train_fn", "make_prefill_fn", "make_decode_fn",
           "abstract_params", "abstract_batch", "abstract_cache",
           "abstract_opt_state", "abstract_state"]
