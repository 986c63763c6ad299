"""The RL train step: forward -> policy loss -> grads -> clipped optimizer
update (the port of ``repro/training.py``), plus the SFT loss and the SFT
warm-start step.

Batch layout (targets are tokens shifted by one):
  tokens (B, T) int | mask (B, T-1) f32 over target positions |
  sampler_lp (B, T-1) f32 | rewards (B,) f32, group-contiguous.

The token log-probs and entropies come from
``repro_torch.kernels.ops.fused_token_logprob`` (``TrainConfig.
logprob_impl``): on the card the K1 kernel in the forward and the K2
kernel in the backward of every microbatch.

``train_step`` and ``sft_step`` update the state **in place** (params and optimizer
moments; see ``repro_torch.optim``), as the JAX package's jitted step
donates it: treat the state passed in as consumed. It returns 0-dim
tensors on the params' device and reads nothing back to the host.
``jit_train_step``/``jit_sft_step`` build the step through an
``ExecutionPlan`` (``repro_torch.parallel``), from ``TrainConfig.mesh``
when no plan is passed: on the 1x1 local plan they are ``train_step`` and
``sft_step`` themselves.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, RLConfig, TrainConfig
from repro_torch.core import group_advantages, policy_loss
from repro_torch.core.logprob import token_logprob_from_logits
from repro_torch.kernels.ops import fused_token_logprob
from repro_torch.models import encode, forward
from repro_torch.optim import (adafactor_init, adafactor_update, adamw_init,
                               adamw_update, clip_by_global_norm, tree_leaves,
                               warmup_schedule)

# Metrics that aggregate across grad-accum microbatches with `max` rather
# than a mean (the worst importance weight of the step, Fig. 4).
MAX_METRICS = frozenset({"iw_max"})


def _token_lp_ent(logits: torch.Tensor, targets: torch.Tensor, impl: str
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(logp, entropy) per target token under ``TrainConfig.logprob_impl``;
    entropy is None on the naive path."""
    if impl == "naive":
        return token_logprob_from_logits(logits, targets), None
    return fused_token_logprob(logits, targets,
                               impl=None if impl == "fused" else impl)


class TrainState(NamedTuple):
    params: Any
    opt: Any
    step: torch.Tensor           # 0-dim int32 on the params' device


def init_state(cfg: ModelConfig, tc: TrainConfig, params: Any,
               optimizer: str = "adamw", plan=None) -> TrainState:
    """Fresh optimizer state (float32 moments beside the params). With an
    ``ExecutionPlan`` the whole state is placed onto it: on a live mesh
    each rank keeps its shard of every leaf (``params`` are the full
    leaves, or already this rank's shards)."""
    if optimizer not in ("adamw", "adafactor"):
        raise ValueError(f"unknown optimizer {optimizer!r}")
    init = adamw_init if optimizer == "adamw" else adafactor_init
    if plan is not None:
        params = plan.device_put_params(cfg, params)
    dev = tree_leaves(params)[0].device
    return TrainState(params=params, opt=init(params),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def _forward_stats(cfg: ModelConfig, params: Any,
                   batch: Dict[str, torch.Tensor],
                   memory: Optional[torch.Tensor], impl: str):
    """(learner log-probs, entropies or None, router aux) of the batch's
    rows. The modality stubs ride in the batch, so they microbatch with
    it: ``frames`` (B, S_enc, d) go through ``encode`` (which then takes
    gradients), ``image_embeds`` (B, M, d) are the memory itself; an
    explicit ``memory`` takes precedence, as in the JAX package."""
    if memory is None and "frames" in batch:
        memory = encode(cfg, params, batch["frames"])
    elif memory is None and "image_embeds" in batch:
        memory = batch["image_embeds"]
    tokens = batch["tokens"]
    logits, _, aux = forward(cfg, params, tokens[:, :-1], memory=memory)
    lp, ent = _token_lp_ent(logits, tokens[:, 1:], impl)
    return lp, ent, aux


def _objective(cfg: ModelConfig, rl: RLConfig, learner_lp: torch.Tensor,
               learner_ent: Optional[torch.Tensor], aux: Dict,
               batch: Dict[str, torch.Tensor]
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The policy loss and its metrics over the batch's rows, from the
    learner's log-probs of those rows."""
    sampler_lp = batch["sampler_lp"]
    if not rl.recompute_sampler_logps:
        # trust engine-side logps verbatim (the paper shows this is unstable)
        sampler_lp = sampler_lp.detach()
    adv = group_advantages(
        batch["rewards"], rl.group_size, normalize=rl.adv_normalize,
        kind=rl.loss_type if rl.loss_type in ("bnpo", "dr_grpo") else "grpo")
    loss, metrics = policy_loss(rl, learner_lp, sampler_lp, batch["mask"],
                                adv, entropy=learner_ent)
    for k, v in aux.items():
        metrics[k] = v / max(cfg.num_blocks, 1)
    metrics["reward_mean"] = batch["rewards"].mean()
    return loss, metrics


def rl_loss_fn(cfg: ModelConfig, rl: RLConfig, params: Any,
               batch: Dict[str, torch.Tensor],
               memory: Optional[torch.Tensor] = None,
               logprob_impl: str = "fused"
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The GEPO (or ``rl.loss_type``) loss of one batch and its metrics
    (see ``_forward_stats`` for ``frames``, ``image_embeds`` and
    ``memory``)."""
    lp, ent, aux = _forward_stats(cfg, params, batch, memory, logprob_impl)
    return _objective(cfg, rl, lp, ent, aux, batch)


def _grads(cfg, rl, tc, params, mb, memory=None, rows=None, gather=None
           ) -> Tuple[list, Dict[str, torch.Tensor]]:
    """Gradients of one loss evaluation as a list in ``tree_leaves``
    order, and its detached metrics. With ``rows`` (this rank's rows of
    ``mb``) and ``gather`` (their log-probs -> those of all of ``mb``'s
    rows), the forward runs on ``rows`` and the loss on the whole of
    ``mb``: the global-batch loss of the sharded step, whose ``params``
    are the rank's shards (the model gathers them,
    ``runtime_context.param_gather``), so the gradients are the shards'
    too, already summed over the row axes."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    lp, ent, aux = _forward_stats(cfg, params, mb if rows is None else rows,
                                  memory, tc.logprob_impl)
    if gather is not None:
        lp = gather(lp)
        ent = None if ent is None else gather(ent)
    loss, metrics = _objective(cfg, rl, lp, ent, aux, mb)
    grads = list(torch.autograd.grad(loss, leaves))
    return grads, {k: v.detach() for k, v in metrics.items()}


def _accumulate(cfg, rl, tc, params, batch, memory=None, mb_constraint=None,
                gather=None) -> Tuple[list, Dict[str, torch.Tensor]]:
    """Gradients (a list in ``tree_leaves`` order) and metrics of one
    update. With ``grad_accum > 1`` the batch (``frames`` /
    ``image_embeds`` included) is cut as ``x.reshape((accum, -1) +
    x.shape[1:])`` does, the gradients are summed in float32 from zeros
    and divided by ``accum``, and the metrics are averaged, except
    ``MAX_METRICS`` (max over microbatches). ``mb_constraint`` maps the
    cut (accum, mb, ...) tree to the rows the forward runs on (a plan's
    ``constrain_microbatches``); ``gather`` is handed to ``_grads``. The
    accumulator has the shapes of ``params``: a rank's shards in the
    sharded step."""
    accum = tc.grad_accum
    if accum == 1 and mb_constraint is None:
        return _grads(cfg, rl, tc, params, batch, memory)
    mbs = {k: v.reshape((accum, -1) + tuple(v.shape[1:]))
           for k, v in batch.items()}
    rows = mb_constraint(mbs) if mb_constraint is not None else None

    def piece(i):
        return ({k: v[i] for k, v in mbs.items()},
                None if rows is None else {k: v[i] for k, v in rows.items()})
    if accum == 1:
        mb, r = piece(0)
        return _grads(cfg, rl, tc, params, mb, memory, r, gather)
    acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
           for p in tree_leaves(params)]
    msum: Dict[str, torch.Tensor] = {}
    for i in range(accum):
        mb, r = piece(i)
        grads, m = _grads(cfg, rl, tc, params, mb, memory, r, gather)
        with torch.no_grad():
            for a, g in zip(acc, grads):
                a.add_(g)
        del grads
        for k, v in m.items():
            if k not in msum:
                msum[k] = v
            elif k in MAX_METRICS:
                msum[k] = torch.maximum(msum[k], v)
            else:
                msum[k] = msum[k] + v
    with torch.no_grad():
        for a in acc:
            a.div_(accum)
    return acc, {k: (v if k in MAX_METRICS else v / accum)
                 for k, v in msum.items()}


def train_step(cfg: ModelConfig, rl: RLConfig, tc: TrainConfig,
               state: TrainState, batch: Dict[str, torch.Tensor], *,
               optimizer: str = "adamw",
               memory: Optional[torch.Tensor] = None
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One (optionally micro-batched) RL update, in place on ``state``
    (see ``_accumulate`` for the microbatch cut). ``memory`` is handed to
    every microbatch whole, as the JAX package's step closes over it.
    The step on a live plan is ``parallel.make_sharded_train_step``,
    which runs each rank's rows of every microbatch and gathers their
    log-probs back into the loss of the whole batch."""
    params = state.params
    flat, metrics = _accumulate(cfg, rl, tc, params, batch, memory)
    # the flat list in tree_leaves order stands for the gradient tree
    grads, gnorm = clip_by_global_norm(flat, tc.grad_clip)
    lr = warmup_schedule(tc, state.step)
    update = adamw_update if optimizer == "adamw" else adafactor_update
    new_params, new_opt = update(tc, grads, state.opt, params, lr)
    metrics["grad_norm"] = gnorm
    metrics["lr"] = lr
    return TrainState(new_params, new_opt, state.step + 1), metrics


def sft_loss_fn(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
                mask: torch.Tensor, logprob_impl: str = "fused"
                ) -> torch.Tensor:
    """Masked mean next-token NLL (the supervised warm start)."""
    return _sft_loss(cfg, params, tokens, mask, logprob_impl)


def _sft_loss(cfg: ModelConfig, params: Any, tokens: torch.Tensor,
              mask: torch.Tensor, impl: str, gather=None) -> torch.Tensor:
    """``sft_loss_fn`` with the forward on ``tokens``' rows and, with
    ``gather``, the mean over all of ``mask``'s rows (the sharded step)."""
    logits, _, _ = forward(cfg, params, tokens[:, :-1])
    lp, _ = _token_lp_ent(logits, tokens[:, 1:], impl)
    if gather is not None:
        lp = gather(lp)
    return (-lp * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def sft_step(cfg: ModelConfig, tc: TrainConfig, state: TrainState,
             tokens: torch.Tensor, mask: torch.Tensor
             ) -> Tuple[TrainState, torch.Tensor]:
    """One supervised warm-start update, in place on ``state`` (the JAX
    package's SFT step, ``repro/parallel/step.py``): value and gradient
    of ``sft_loss_fn``, global-norm clipping, the warm-up schedule, AdamW.
    Returns ``(state, loss)``, the loss a 0-dim tensor on the params'
    device."""
    leaves = tree_leaves(state.params)
    for p in leaves:
        p.requires_grad_(True)
    loss = sft_loss_fn(cfg, state.params, tokens, mask,
                       logprob_impl=tc.logprob_impl)
    grads = list(torch.autograd.grad(loss, leaves))
    grads, _ = clip_by_global_norm(grads, tc.grad_clip)
    lr = warmup_schedule(tc, state.step)
    new_params, new_opt = adamw_update(tc, grads, state.opt, state.params,
                                       lr)
    return TrainState(new_params, new_opt, state.step + 1), loss.detach()


def jit_train_step(cfg: ModelConfig, rl: RLConfig, tc: TrainConfig,
                   optimizer: str = "adamw", plan=None):
    """The train step through the execution layer: ``(state, batch) ->
    (state, metrics)`` on ``plan`` (default: the ``TrainConfig.mesh``
    knob, the 1x1 local plan unless set). The state is updated in place
    (the JAX package donates it): treat the state passed in as
    consumed."""
    from repro_torch.parallel import make_sharded_train_step, plan_from_flag
    plan = plan or plan_from_flag(tc.mesh, "train")
    return make_sharded_train_step(cfg, rl, tc, plan, optimizer=optimizer)


def jit_sft_step(cfg: ModelConfig, tc: TrainConfig, plan=None):
    """The SFT step through the same execution layer as the RL step
    (``TrainConfig.mesh`` decides when no plan is passed)."""
    from repro_torch.parallel import make_sharded_sft_step, plan_from_flag
    return make_sharded_sft_step(cfg, tc, plan or plan_from_flag(tc.mesh,
                                                                 "train"))


__all__ = ["MAX_METRICS", "TrainState", "init_state", "rl_loss_fn",
           "train_step", "sft_loss_fn", "sft_step", "jit_train_step",
           "jit_sft_step"]
