"""Generation engines (the sampler node's workhorse), engine construction
from a ``ServeConfig``, and the teacher-forced log-prob recompute.

The port of ``repro/sampling/engine.py``. Two engines share one
request-level contract (``repro_torch.serving.api``):

- **static** (:class:`StaticEngine`): one prefill of the whole batch over a
  dense cache (through the flash kernel K5 under ``attn_impl=
  "pallas"``; Mamba2 layers keep a conv window and an SSM state), then a
  decode loop to the batch's largest token budget.
  Every sequence runs every step, even after EOS (finished rows decode
  PAD). The JAX package scans the loop in one executable; here it is a
  Python loop of eager steps with no host sync until the batch ends.
- **continuous** (:class:`repro_torch.sampling.continuous.ContinuousEngine`):
  a slot pool over a paged KV cache.

A model with a modality memory (a CROSS layer) or an encoder takes
``memory=`` (B, M, d), one row per request of the batch (the encoder's
output for an encoder-decoder model): the static engine projects it once
into its cache (``init_cache(memory=)``). Such a model serves static
only, as in the JAX package: ``build_engine`` and ``generate`` warn and
fall back under ``engine="continuous"``, and ``ContinuousEngine``
refuses it.

Draw ``t`` of request ``rid`` uses the threefry key
``fold_in(fold_in(key, rid), t)`` (``sampling.prng``), as in the JAX
package: keyed per request and never per batch row, so a request draws
the same tokens whichever engine serves it, and the JAX package's tokens
given the same key, rid and logits.

``generate(cfg, rl, params, prompts, ...)`` is the legacy batch entry
point, a thin shim over the engines. ``token_logps`` is the App. B.1
untrusted-sampler recompute.

Every entry point takes ``plan=`` (default ``plan_for_params(params,
"serve")``, the local plan on the params' device). On a live ``serve``
plan the continuous engine serves tensor-parallel
(``sampling/continuous.py``); on a live ``serve`` or ``long`` plan the
static engine serves context-parallel (``StaticEngine``: its dense cache
shards the sequence over 'model', or 'data' x 'model' on ``long``, and a
decode merges the ranks' partial softmaxes) and ``token_logps`` runs its
forward on the rank's shard.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig, RLConfig, ServeConfig
from repro_torch.data.tasks import EOS, PAD
from repro_torch.kernels.ops import fused_token_logprob
from repro_torch import runtime_context
from repro_torch.models.model import decode_step, forward, init_cache
from repro_torch.parallel.collectives import broadcast_object
from repro_torch.parallel.plan import (ExecutionPlan, ServeShard,
                                       plan_for_params, plan_from_flag)
from repro_torch.sampling.continuous import (ContinuousEngine,
                                             generate_continuous)
from repro_torch.sampling.paged_cache import paged_cache_supported
from repro_torch.sampling.prng import PRNGKey, as_key, fold_in
from repro_torch.sampling.sample import (mask_vocab, model_logp,
                                         sample_token_rows)
from repro_torch.serving.api import GenerationResult, Request

# --------------------------------------------------------------------------
# static engine: one prefill, then a decode loop to max_new


@torch.no_grad()
def _generate_static(cfg: ModelConfig, rl: RLConfig, params: Dict[str, Any],
                     prompts: torch.Tensor, key: torch.Tensor, max_new: int,
                     vocab_limit: int, rids: Optional[torch.Tensor] = None,
                     memory: Optional[torch.Tensor] = None,
                     shard: Optional[ServeShard] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """prompts (B, Tp) on the params' device -> (completions (B, max_new),
    sampler_lp (B, max_new) float32, comp_mask (B, max_new) float32).
    Draw ``t`` of row ``r`` uses ``fold_in(fold_in(key, rids[r]), t)``;
    ``rids`` default to the batch rows. ``memory`` (B, M, d) is projected
    into the cache once.

    With ``shard`` (a serving plan's, ``ExecutionPlan.serve_shard``) the
    params are this rank's shards: the rank runs its rows of the batch
    (``ServeShard.row_span``) over its part of the dense cache, and the
    rows' tokens are gathered, so every rank returns every row's."""
    b, tp = prompts.shape
    if rids is None:
        rids = torch.arange(b, device=prompts.device)
    ctx, ax = contextlib.nullcontext(), ()
    if shard is not None:
        ax, r0, rn = shard.row_span(b)
        prompts, rids = prompts[r0:r0 + rn], rids[r0:r0 + rn]
        memory = None if memory is None else memory[r0:r0 + rn]
        shard = shard.with_cache(tp + max_new, 0 if memory is None
                                 else memory.shape[1]).with_held_rows(ax)
        ctx = runtime_context.serve_context(shard)
    with ctx:
        toks, lps, valid = _static_loop(cfg, rl, params, prompts, key,
                                        max_new, vocab_limit, rids, memory)
    if ax:
        toks, lps, valid = (shard.gather(t, ax, 0)
                            for t in (toks, lps, valid))
    return toks, lps, valid


def _static_loop(cfg, rl, params, prompts, key, max_new, vocab_limit, rids,
                 memory):
    b, tp = prompts.shape
    cache = init_cache(cfg, params, b, tp + max_new, memory=memory)
    logits, cache, _ = forward(cfg, params, prompts, cache=cache,
                               memory=memory, last_only=True)
    last = logits[:, -1]
    del logits
    row_keys = fold_in(as_key(key, prompts.device), rids)
    done = torch.zeros((b,), dtype=torch.bool, device=prompts.device)
    toks, lps, valid = [], [], []
    for t in range(max_new):
        lg = mask_vocab(last, vocab_limit)
        tok = sample_token_rows(fold_in(row_keys, t), lg,
                                temperature=rl.temperature, top_k=rl.top_k,
                                top_p=rl.top_p)
        tok = torch.where(done, PAD, tok)
        valid.append(~done)
        lps.append(torch.where(done, 0.0, model_logp(last, tok)))
        toks.append(tok)
        if t + 1 < max_new:        # the last step's logits are never read
            last, cache = decode_step(cfg, params, cache, tok, tp + t)
        done = done | (tok == EOS)
    return (torch.stack(toks, 1), torch.stack(lps, 1),
            torch.stack(valid, 1).float())


class StaticEngine:
    """Request-level wrapper over the static path.

    The batch is rectangular, so it must share one prompt length (use the
    continuous engine for ragged or streaming workloads);
    ``max_new_tokens`` may vary per request: the loop runs to the batch
    max and each request is trimmed on the host, which is exact because
    draw ``t`` of request ``rid`` never depends on the loop's length.
    Runs on the device its params live on; ``key`` (default
    ``PRNGKey(0)``) keys the draws. ``memory`` (B, M, d), for a memory or
    encoder-decoder model, gives row i of every batch memory row i, so a
    batch has B requests, as in the JAX package.

    ``plan`` (default the local plan on the params' device) is the
    ``serve`` or ``long`` plan the engine runs on. On a live one the
    engine is one of the plan's ranks: ``params`` are full leaves, cut
    here, or this rank's shards, taken as they are; every rank calls
    ``generate`` together and serves rank 0's requests and key (broadcast
    with the call), and every rank returns every request's tokens. The
    rank runs its rows of the batch (split over 'data' on ``serve``,
    every row on ``long``) over its part of the dense cache: the heads and
    FFN columns of its weights, its span of the cache's positions (over
    'model' on ``serve``, 'data' x 'model' on ``long``) with every KV
    head, a context-parallel decode whose partial softmaxes the ranks
    merge (``models/model.py``). ``memory`` is every row's, the same on
    every rank.
    """

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any], *,
                 rl: RLConfig, vocab_limit: Optional[int] = None,
                 memory: Optional[torch.Tensor] = None,
                 key: Optional[torch.Tensor] = None,
                 plan: Optional[ExecutionPlan] = None) -> None:
        self.cfg, self.rl = cfg, rl
        self.plan = plan if plan is not None else \
            plan_for_params(params, "serve")
        # this rank's part of the model; None off a live mesh
        self.shard = self.plan.serve_shard(cfg)
        self.params = params if self.shard is None else \
            self.plan.adopt_params(cfg, params)
        self.memory = memory
        self.device = self.params["embed"].device
        self.vocab_limit = vocab_limit or cfg.padded_vocab
        self.key = PRNGKey(0) if key is None else as_key(key)

    @property
    def profile(self) -> tuple:
        return (self.rl.temperature, self.rl.top_k, self.rl.top_p)

    def update_params(self, params: Any) -> None:
        """Serve ``params`` from now on (re-placed on a live plan: full
        leaves cut, shards taken)."""
        self.params = params if self.shard is None else \
            self.plan.adopt_params(self.cfg, params)

    def generate(self, requests: Sequence[Request],
                 key: Optional[torch.Tensor] = None
                 ) -> List[GenerationResult]:
        if key is not None:
            self.key = as_key(key)
        if self.shard is not None:           # lockstep: rank 0's batch
            requests, k = broadcast_object(
                (list(requests), self.key.cpu()), self.plan.mesh)
            self.key = as_key(k)
        for req in requests:
            if req.params.profile != self.profile:
                raise ValueError(
                    f"request {req.rid}: sampling profile "
                    f"{req.params.profile} != engine profile {self.profile}")
        plens = {r.prompt_len for r in requests}
        if len(plens) > 1:
            raise ValueError(
                "static engine scans a rectangular batch: got prompt "
                f"lengths {sorted(plens)} — pad, or use the continuous "
                "engine for ragged prompts")
        t0 = time.perf_counter()
        prompts = torch.from_numpy(np.stack(
            [np.asarray(r.prompt, np.int64) for r in requests])).to(
                self.device)
        rids = torch.tensor([r.rid for r in requests], device=self.device)
        max_new = max(r.params.max_new_tokens for r in requests)
        completions, sampler_lp, comp_mask = _generate_static(
            self.cfg, self.rl, self.params, prompts, self.key, max_new,
            self.vocab_limit, rids, self.memory, self.shard)
        # the one host sync: the batch ends here by design
        comp_np = completions.cpu().numpy()
        lp_np = sampler_lp.cpu().numpy()
        mask_np = comp_mask.cpu().numpy()
        elapsed = time.perf_counter() - t0
        out: List[GenerationResult] = []
        for i, req in enumerate(requests):
            budget = req.params.max_new_tokens
            n = int(mask_np[i, :budget].sum())
            toks = comp_np[i, :n]
            reason = "eos" if n and toks[-1] == EOS else "length"
            out.append(GenerationResult(
                rid=req.rid, tokens=toks.astype(np.int32),
                logps=lp_np[i, :n].astype(np.float32),
                finish_reason=reason, prompt_len=req.prompt_len,
                ttft_s=elapsed, latency_s=elapsed))
        return out


# --------------------------------------------------------------------------
# factory


def build_engine(cfg: ModelConfig, params: Dict[str, Any],
                 serve: ServeConfig, *, rl: Optional[RLConfig] = None,
                 vocab_limit: Optional[int] = None,
                 memory: Optional[torch.Tensor] = None,
                 key: Optional[torch.Tensor] = None,
                 plan: Optional[ExecutionPlan] = None
                 ) -> Union[StaticEngine, ContinuousEngine]:
    """The engine a ``ServeConfig`` describes, on ``plan`` (default the
    plan of ``serve.mesh`` on the params' device: the local plan for
    1x1, else a live mesh over the process group). ``rl`` carries the
    sampling profile every request must
    match; ``key`` (default the engine's ``PRNGKey(0)``) keys the token
    draws; ``memory`` is the static engine's. Falls back to the static
    engine, with a warning, for architectures the paged cache cannot
    serve (Mamba2 layers, an encoder) and whenever a memory is given, as
    the JAX package does."""
    rl = rl or RLConfig(engine=serve.engine)
    if plan is None:
        plan = plan_for_params(params, "serve")
        if serve.mesh != "1x1":
            plan = plan_from_flag(serve.mesh, "serve", plan.device)
    if serve.paged_attn_impl:
        cfg = dataclasses.replace(cfg, paged_attn_impl=serve.paged_attn_impl)
    if serve.engine == "continuous":
        if memory is None and paged_cache_supported(cfg):
            return ContinuousEngine(
                cfg, params, rl=rl, max_total_tokens=serve.max_total_tokens,
                num_slots=serve.num_slots, page_size=serve.page_size,
                sync_every=serve.sync_every,
                prefill_chunk=serve.prefill_chunk or None,
                num_pages=serve.resolved_num_pages, vocab_limit=vocab_limit,
                prefix_cache=serve.prefix_cache,
                prefix_cache_entries=serve.prefix_cache_entries,
                spec_k=serve.spec_k, spec_ngram_max=serve.spec_ngram_max,
                spec_ngram_min=serve.spec_ngram_min,
                spec_rescore=serve.spec_rescore, key=key, plan=plan)
        warnings.warn(f"{cfg.name}: continuous engine unsupported for this "
                      "architecture/memory setup; serving static",
                      stacklevel=2)
    return StaticEngine(cfg, params, rl=rl, vocab_limit=vocab_limit,
                        memory=memory, key=key, plan=plan)


# --------------------------------------------------------------------------
# legacy batch entry point


def generate(cfg: ModelConfig, rl: RLConfig, params: Dict[str, Any],
             prompts: Union[np.ndarray, torch.Tensor],
             key: Optional[torch.Tensor] = None, *,
             max_new: Optional[int] = None,
             vocab_limit: Optional[int] = None,
             memory: Optional[torch.Tensor] = None,
             engine: Optional[str] = None,
             plan: Optional[ExecutionPlan] = None,
             **continuous_kwargs) -> Dict[str, Any]:
    """Batched generation over ``prompts`` (B, Tp). Returns the rollout
    dict, tensors on the params' device: tokens (B, Tp + max_new),
    completions (B, max_new), sampler_lp (B, max_new) engine-side logps,
    comp_mask (B, max_new), and prompt_len.

    The pre-request-API surface, kept as a thin shim for the training
    loop; new code builds an engine once and feeds it ``Request``s.
    ``engine`` (default ``rl.engine``) picks the static path or the
    continuous slot pool (which takes ``continuous_kwargs``);
    architectures the paged cache cannot serve fall back to the static
    path with a warning that names the ignored ``continuous_kwargs``, as
    in the JAX package, and so does a call with a ``memory``. ``key``
    (default ``PRNGKey(0)``) keys the draws; row ``i`` is request ``i``.
    ``plan`` defaults to the local plan on the params' device; on a live
    one every rank calls this together, rank 0's prompts and key are
    served (``StaticEngine``), and ``params`` are full leaves or this
    rank's shards."""
    key = PRNGKey(0) if key is None else key
    engine = engine or rl.engine
    plan = plan or plan_for_params(params, "serve")
    if engine not in ("static", "continuous"):
        raise ValueError(f"unknown engine {engine!r}")
    if engine == "static" and continuous_kwargs:
        # don't silently ignore num_slots=... etc. on the static path
        raise TypeError("static engine takes no continuous-engine kwargs: "
                        f"{sorted(continuous_kwargs)}")
    max_new = max_new or rl.max_new_tokens
    vocab_limit = vocab_limit or cfg.padded_vocab
    if engine == "continuous":
        if memory is None and paged_cache_supported(cfg):
            return generate_continuous(cfg, rl, params, prompts, key,
                                       max_new=max_new,
                                       vocab_limit=vocab_limit, plan=plan,
                                       **continuous_kwargs)
        dropped = (f"; ignoring {sorted(continuous_kwargs)}"
                   if continuous_kwargs else "")
        warnings.warn(f"{cfg.name}: continuous engine unsupported for this "
                      f"architecture/memory setup; falling back to "
                      f"static{dropped}", stacklevel=2)
    shard = plan.serve_shard(cfg)
    if shard is not None:
        params = plan.adopt_params(cfg, params)
        prompts, key = broadcast_object(
            (np.asarray(torch.as_tensor(prompts).cpu()),
             as_key(key).cpu()), plan.mesh)
    dev = params["embed"].device
    prompts = torch.as_tensor(prompts).to(dev, torch.int64)
    completions, sampler_lp, comp_mask = _generate_static(
        cfg, rl, params, prompts, key, max_new, vocab_limit, memory=memory,
        shard=shard)
    return {"tokens": torch.cat([prompts.to(torch.int32),
                                 completions.to(torch.int32)], 1),
            "completions": completions.to(torch.int32),
            "sampler_lp": sampler_lp, "comp_mask": comp_mask,
            "prompt_len": prompts.shape[1]}


@torch.no_grad()
def token_logps(cfg: ModelConfig, params: Dict[str, Any],
                tokens: torch.Tensor, *,
                memory: Optional[torch.Tensor] = None,
                logprob_impl: Optional[str] = None,
                plan: Optional[ExecutionPlan] = None) -> torch.Tensor:
    """Teacher-forced log p(tokens[t] | tokens[<t]) -> (B, T-1) float32.

    The App. B.1 untrusted-sampler recompute: one dense forward (through
    K5 under ``cfg.attn_impl == "pallas"``, through K6 under
    ``cfg.ssd_impl == "pallas"``), then the same streaming
    log-prob path as the learner's loss (the K1 kernel on the card)
    instead of a (B*T, V) log-softmax. ``logprob_impl`` takes the
    ``TrainConfig.logprob_impl`` vocabulary; None or "fused"
    auto-dispatches. ``memory`` (B, M, d) is what a memory or
    encoder-decoder model cross-attends (through K5 under
    ``attn_impl="pallas"``). ``params`` on a live ``serve`` or ``long``
    ``plan`` are this rank's shards: the forward runs on them (every rank
    the whole batch: its heads through K5, its SSM heads through K6) and
    gathers the logits over the vocab."""
    shard = None if plan is None else plan.serve_shard(cfg)
    with runtime_context.serve_context(shard):
        logits, _, _ = forward(cfg, params, tokens[:, :-1], memory=memory)
    impl = None if logprob_impl == "fused" else logprob_impl
    lp, _ = fused_token_logprob(logits, tokens[:, 1:], impl=impl)
    return lp
