"""Sharded step builders (the port of ``repro/parallel/step.py``).

``make_sharded_train_step`` is how the port builds a runnable train step
on a plan. On the 1x1 local plan it is ``training.train_step`` itself. On
a live mesh a rank holds shards, never the whole model:

- between steps, params and optimizer state live sharded as the plan
  says (``ExecutionPlan.state_shardings``): each rank holds its shard;
- a step cuts the global batch into microbatches and takes this rank's
  rows of each (``constrain_microbatches``), and runs forward and
  backward on those rows, through the K1/K2 kernels on the card. The
  model takes the rank's param shards and gathers them where it uses
  them (``ShardGather``, through ``runtime_context.param_gather``): the
  leaves outside the blocks (``embed``, ``lm_head``, ``final_norm``, the
  encoder's ``final_norm``) at the start of each forward, and each
  block's leaves inside that block, in the function ``cfg.remat``
  checkpoints, so under remat one block's weights are whole at a time and
  the backward's recompute gathers the block again (the reference scans
  its blocks under ``jax.checkpoint`` and GSPMD gathers each block's
  weights inside the scan step). Without remat autograd keeps every
  gathered block for the backward;
- the loss is the global batch's: the rows' log-probs and entropies are
  all-gathered over the row axes (autograd-aware, ``gather_rows``) and
  every rank computes the loss of the whole microbatch, as
  ``train_step`` does. GEPO's group expectation, the group advantages
  and the token and sequence means therefore see every group whole;
- the gradient of each gathered set of leaves is summed over the row
  axes only, in float32 (ranks along ``model`` that saw the same rows
  are not counted twice), and cut to this rank's shard in the gather's
  backward (``collectives.gather_shards``): one block's full gradient is
  alive at a time, where XLA would reduce-scatter it. The float32
  accumulator over microbatches is the shard's, so a rank's sum over the
  rows comes before the sum over microbatches;
- the global norm is taken on the shards: each element counts once, on
  the ranks at index 0 of every axis its leaf's spec does not split, and
  one all-reduce of a float32 scalar gives the total;
- AdamW updates each rank's shards from its shard of the gradient;
  Adafactor works one leaf at a time: it gathers that leaf's gradient,
  parameter and factored moments (row and column statistics of the full
  leaf), updates them, keeps its shards and frees the rest before the
  next leaf.

The state is updated in place, as ``train_step`` does (the JAX package
donates it): treat the state passed in as consumed. The step takes the
global batch, the same on every rank. Tensor-parallel compute is not
done: ``ModelConfig.act_sharding`` / ``attn_gather_qkv`` change no number
(ROADMAP queue 3).
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.config import ModelConfig, RLConfig, TrainConfig
from repro_torch.optim import (AdafactorState, adafactor_update,
                               adamw_update, clip_by_global_norm,
                               sum_of_squares, tree_leaves, warmup_schedule)
from repro_torch.parallel import axes
from repro_torch.parallel.collectives import (all_reduce_sum, gather_leaf,
                                              gather_rows, gather_shards)
from repro_torch.parallel.plan import ExecutionPlan, placement_device
from repro_torch.runtime_context import gather_context, mesh_context

_EXPERTS = ("w_gate", "w_up", "w_down")


def _to_device(plan: ExecutionPlan, batch: Dict[str, Any]
               ) -> Dict[str, torch.Tensor]:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        out[k] = t.to(placement_device(plan.device, t.device))
    return out


def _flat(tree: Any, path: Tuple[str, ...] = ()
          ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flat(tree[k], path + (k,))]
    return [(path, tree)]


def _at(tree: Any, path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


class ShardGather:
    """This rank's param shards made whole where the model uses them, on a
    live ``plan`` whose forward rows split over ``rows`` (the model reads
    it through ``runtime_context.param_gather``; see the module note).

    ``top(tree, *path)`` gathers the tensor entries of the dict at
    ``path`` of the param tree (the leaves outside the blocks), ``block
    (tree, *path)`` one block's leaves of the stacked subtree at ``path``
    (``"blocks"``, or ``"encoder", "blocks"``). Under ``moe_ep="train"``
    an expert leaf stays cut over 'model' on its experts' dim, so a block
    holds this rank's experts (``models/moe_ep.py``). Each call is one
    ``collectives.gather_shards``."""

    def __init__(self, plan: ExecutionPlan, cfg: ModelConfig,
                 rows: Tuple[str, ...]):
        self.mesh, self.rows = plan.mesh, tuple(rows)
        self._sh = plan.param_shardings(cfg)
        self._shapes = axes.param_shapes(cfg)
        self._ep = cfg.moe_ep == "train"
        self._plans: Dict[Tuple, Any] = {}

    def _leaf(self, s: axes.NamedSharding, shape: Tuple[int, ...],
              block: bool, keep: Tuple[int, ...]):
        """(the dims a leaf gathers along, the index of this rank's slice
        of the gathered leaf)."""
        index = s.index(self.mesh.rank, tuple(shape))
        dims = s.sharded_dims()
        if block:
            if any(d == 0 for d, _ in dims):
                raise ValueError(f"{s.spec} splits the blocks' axis")
            index, dims = index[1:], tuple((d - 1, a) for d, a in dims)
        dims = tuple((d, a) for d, a in dims if d not in keep)
        cut = {d for d, _ in dims}
        return dims, tuple(index[d] if d in cut else slice(None)
                           for d in range(len(index)))

    def _plan(self, path: Tuple[str, ...], block: bool):
        key = (path, block)
        if key not in self._plans:
            sh, shapes = _at(self._sh, path), _at(self._shapes, path)
            out = []
            for keys, s in _flat(sh):
                if not block and len(keys) != 1:      # a subtree's leaf
                    continue
                expert = self._ep and len(keys) == 3 and \
                    keys[1] == "moe" and keys[2] in _EXPERTS
                out.append((keys, self._leaf(s, _at(shapes, keys), block,
                                             (0,) if expert else ())))
            self._plans[key] = out
        return self._plans[key]

    def _gather(self, tree: Dict, plan, out: Dict) -> Dict:
        full = gather_shards(tuple(_at(tree, k) for k, _ in plan), self.mesh,
                             self.rows, [leaf for _, leaf in plan])
        for (keys, _), t in zip(plan, full):
            node = out
            for k in keys[:-1]:
                node = node.setdefault(k, {})
            node[keys[-1]] = t
        return out

    def top(self, tree: Dict, *path: str) -> Dict:
        return self._gather(tree, self._plan(tuple(path), False), dict(tree))

    def block(self, tree: Dict, *path: str) -> Dict:
        return self._gather(tree, self._plan(tuple(path), True), {})


def _clip(plan: ExecutionPlan, shardings: Any, grads: list,
          max_norm: float) -> Tuple[list, torch.Tensor]:
    """``clip_by_global_norm`` of the shards' gradients with the norm of
    the whole gradient: a rank counts a leaf where it sits at index 0 of
    every axis the leaf's spec does not split, then one all-reduce over
    the mesh (exact on one rank)."""
    mesh = plan.mesh
    coords = mesh.coords_of(mesh.rank)
    counted = []
    for s in tree_leaves(shardings):
        split = {a for _, ax in s.sharded_dims() for a in ax}
        counted.append(all(coords[a] == 0 for a in mesh.axis_names
                           if a not in split))
    sq = all_reduce_sum(sum_of_squares(grads, counted), mesh,
                        mesh.axis_names)
    return clip_by_global_norm(grads, max_norm, norm=torch.sqrt(sq))


@torch.no_grad()
def _update_shards(tc: TrainConfig, plan: ExecutionPlan, sh: Any,
                   state: Any, grads: list, optimizer: str):
    """The optimizer step on this rank's shards from their gradients
    (``grads`` in ``tree_leaves`` order, shard-shaped)."""
    lr = warmup_schedule(tc, state.step)
    if optimizer == "adamw":
        _, new_opt = adamw_update(tc, grads, state.opt, state.params, lr)
        return new_opt, lr
    rank, mesh = plan.mesh.rank, plan.mesh
    for g, p, vr, vc, s, sr, sc in zip(
            grads, tree_leaves(state.params), tree_leaves(state.opt.vr),
            tree_leaves(state.opt.vc), tree_leaves(sh.params),
            tree_leaves(sh.opt.vr), tree_leaves(sh.opt.vc), strict=True):
        gf, pf, rf, cf = (gather_leaf(t, mesh, x.sharded_dims())
                          for t, x in ((g, s), (p, s), (vr, sr), (vc, sc)))
        adafactor_update(tc, [gf], AdafactorState(state.opt.step, [rf],
                                                  [cf]), [pf], lr)
        for dst, f, x in ((p, pf, s), (vr, rf, sr), (vc, cf, sc)):
            dst.copy_(f[x.index(rank, tuple(f.shape))])
        del gf, pf, rf, cf
    return AdafactorState(step=state.opt.step + 1, vr=state.opt.vr,
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
        with mesh_context(mesh, rows), \
                gather_context(ShardGather(plan, cfg, rows)):
            flat, metrics = _accumulate(
                cfg, rl, tc, state.params, batch,
                mb_constraint=functools.partial(
                    plan.constrain_microbatches, cfg),
                gather=functools.partial(gather_rows, mesh=mesh,
                                         axes=rows))
        flat, gnorm = _clip(plan, sh.params, flat, tc.grad_clip)
        new_opt, lr = _update_shards(tc, plan, sh, state, flat, optimizer)
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
        leaves = tree_leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        with mesh_context(mesh, rows), \
                gather_context(ShardGather(plan, cfg, rows)):
            loss = _sft_loss(cfg, state.params, mine["tokens"][0], mask,
                             tc.logprob_impl,
                             gather=functools.partial(gather_rows, mesh=mesh,
                                                      axes=rows))
            grads = list(torch.autograd.grad(loss, leaves))
        grads, _ = _clip(plan, sh.params, grads, tc.grad_clip)
        new_opt, _ = _update_shards(tc, plan, sh, state, grads, "adamw")
        return TrainState(state.params, new_opt, state.step + 1), \
            loss.detach()

    return step_fn


__all__ = ["make_sharded_train_step", "make_sharded_sft_step",
           "ShardGather"]
