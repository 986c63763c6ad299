"""Sharded step builders (the port of ``repro/parallel/step.py``).

``make_sharded_train_step`` is how the port builds a runnable train step
on a plan. On the 1x1 local plan it is ``training.train_step`` itself. On
a live mesh:

- between steps, params and optimizer state live sharded as the plan
  says (``ExecutionPlan.state_shardings``): each rank holds its shard;
- a step gathers the whole param tree (one all-gather per split dim of
  each leaf), cuts the global batch into microbatches and takes this
  rank's rows of each (``constrain_microbatches``), and runs forward and
  backward on those rows, through the K1/K2 kernels on the card;
- the loss is the global batch's: the rows' log-probs and entropies are
  all-gathered over the row axes (autograd-aware, ``gather_rows``) and
  every rank computes the loss of the whole microbatch, as
  ``train_step`` does. GEPO's group expectation, the group advantages
  and the token and sequence means therefore see every group whole;
- the gradients are summed over the row axes only (ranks along ``model``
  that saw the same rows are not counted twice), so every rank holds the
  full gradient. Its global norm is taken on that full gradient, each
  element once whatever the leaf's spec replicates;
- AdamW updates each rank's shards from its slice of the gradient;
  Adafactor gathers its factored moments (row and column statistics of
  the full leaf), updates the full leaf and keeps its shards.

The state is updated in place, as ``train_step`` does (the JAX package
donates it): treat the state passed in as consumed. The step takes the
global batch, the same on every rank. Tensor-parallel compute is not
done: ``ModelConfig.act_sharding`` / ``attn_gather_qkv`` change no number
(ROADMAP queue 3).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.config import ModelConfig, RLConfig, TrainConfig
from repro_torch.optim import (AdafactorState, adafactor_update,
                               adamw_update, clip_by_global_norm,
                               tree_leaves, warmup_schedule)
from repro_torch.parallel.collectives import all_reduce_sum, gather_rows
from repro_torch.parallel.plan import ExecutionPlan, placement_device
from repro_torch.runtime_context import mesh_context


def _to_device(plan: ExecutionPlan, batch: Dict[str, Any]
               ) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(placement_device(plan.device, t.device))
    return out


def _reduce_grads(plan: ExecutionPlan, grads: list,
                  rows: Tuple[str, ...]) -> list:
    """Sum each gradient over the row axes, in float32, back in its own
    dtype (exact on one rank)."""
    out = []
    for g in grads:
        g32 = all_reduce_sum(g.float(), plan.mesh, rows)
        out.append(g32 if g32.dtype == g.dtype else g32.to(g.dtype))
    return out


@torch.no_grad()
def _update_shards(tc: TrainConfig, plan: ExecutionPlan, sh: Any,
                   state: Any, full: Any, grads: list, optimizer: str):
    """The optimizer step on this rank's shards from the full gradient
    (``grads`` in ``tree_leaves`` order; ``full`` the gathered params)."""
    rank = plan.mesh.rank
    shardings = tree_leaves(sh.params)
    shards = tree_leaves(state.params)
    lr = warmup_schedule(tc, state.step)
    if optimizer == "adamw":
        gsl = [g[s.index(rank, tuple(g.shape))]
               for g, s in zip(grads, shardings)]
        _, new_opt = adamw_update(tc, gsl, state.opt, state.params, lr)
        return new_opt, lr
    vr = plan.gather(state.opt.vr, sh.opt.vr)
    vc = plan.gather(state.opt.vc, sh.opt.vc)
    pfull = tree_leaves(full)
    _, new_opt = adafactor_update(
        tc, grads, AdafactorState(step=state.opt.step, vr=vr, vc=vc),
        pfull, lr)
    for p, pf, s in zip(shards, pfull, shardings):
        p.copy_(pf[s.index(rank, tuple(pf.shape))])
    for part, whole, shs in ((state.opt.vr, vr, sh.opt.vr),
                             (state.opt.vc, vc, sh.opt.vc)):
        for d, f, s in zip(tree_leaves(part), tree_leaves(whole),
                           tree_leaves(shs)):
            d.copy_(f[s.index(rank, tuple(f.shape))])
    return AdafactorState(step=new_opt.step, vr=state.opt.vr,
                          vc=state.opt.vc), lr


def make_sharded_train_step(cfg: ModelConfig, rl: RLConfig, tc: TrainConfig,
                            plan: ExecutionPlan, *,
                            optimizer: str = "adamw") -> Callable:
    """(state, batch) -> (state, metrics) on ``plan``, the state updated
    in place."""
    from repro_torch.training import TrainState, _accumulate, train_step
    if not plan.mesh.live:
        def local_step(state, batch):
            return train_step(cfg, rl, tc, state, batch,
                              optimizer=optimizer)
        return local_step
    sh = plan.state_shardings(cfg, optimizer)
    mesh = plan.mesh

    def step_fn(state, batch):
        batch = _to_device(plan, batch)
        rows = plan.row_axes(cfg, {
            "tokens": batch["tokens"][:batch["tokens"].shape[0]
                                      // tc.grad_accum]})
        full = plan.gather(state.params, sh.params)
        with mesh_context(mesh, rows):
            flat, metrics = _accumulate(
                cfg, rl, tc, full, batch,
                mb_constraint=functools.partial(
                    plan.constrain_microbatches, cfg),
                gather=functools.partial(gather_rows, mesh=mesh,
                                         axes=rows))
        flat = _reduce_grads(plan, flat, rows)
        flat, gnorm = clip_by_global_norm(flat, tc.grad_clip)
        new_opt, lr = _update_shards(tc, plan, sh, state, full, flat,
                                     optimizer)
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return TrainState(state.params, new_opt, state.step + 1), metrics

    return step_fn


def make_sharded_sft_step(cfg: ModelConfig, tc: TrainConfig,
                          plan: ExecutionPlan) -> Callable:
    """(state, tokens, mask) -> (state, loss) on ``plan``: the SFT
    warm-start twin of the RL step (AdamW, no microbatches; the loss is
    the masked mean over the whole batch)."""
    from repro_torch.training import TrainState, _sft_loss, sft_step
    if not plan.mesh.live:
        def local_step(state, tokens, mask):
            return sft_step(cfg, tc, state, tokens, mask)
        return local_step
    sh = plan.state_shardings(cfg, "adamw")
    mesh = plan.mesh

    def step_fn(state, tokens, mask):
        placed = _to_device(plan, {"tokens": tokens, "mask": mask})
        tokens, mask = placed["tokens"], placed["mask"]
        rows = plan.row_axes(cfg, {"tokens": tokens})
        mine = plan.constrain_microbatches(cfg, {"tokens": tokens[None]})
        full = plan.gather(state.params, sh.params)
        leaves = tree_leaves(full)
        for p in leaves:
            p.requires_grad_(True)
        with mesh_context(mesh, rows):
            loss = _sft_loss(cfg, full, mine["tokens"][0], mask,
                             tc.logprob_impl,
                             gather=functools.partial(gather_rows, mesh=mesh,
                                                      axes=rows))
            grads = list(torch.autograd.grad(loss, leaves))
        grads = _reduce_grads(plan, grads, rows)
        grads, _ = clip_by_global_norm(grads, tc.grad_clip)
        new_opt, _ = _update_shards(tc, plan, sh, state, full, grads,
                                    "adamw")
        return TrainState(state.params, new_opt, state.step + 1), \
            loss.detach()

    return step_fn


__all__ = ["make_sharded_train_step", "make_sharded_sft_step"]
