"""Optimizers: AdamW (the paper's setting) and Adafactor (factored second
moment), the port of ``repro/optim/adamw.py``.

Parameters, gradients and optimizer state are nested dicts of tensors
(the JAX package's pytrees). The JAX functions are pure; these update
**in place** under ``torch.no_grad``: ``adamw_update`` and
``adafactor_update`` overwrite the params and the state's moment tensors
and return the same objects, and ``clip_by_global_norm`` scales the
gradients in place. This keeps one copy of the weights and the moments on
the card. The arithmetic follows the JAX package: moments in float32, the
update in float32, cast back to the param dtype once.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.config import TrainConfig


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in sorted-key order (the order jax flattens a dict tree); a
    list or tuple is flattened in order, so a flat list of gradients in
    this order stands for the tree it came from."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _first(tree: Any) -> torch.Tensor:
    return tree_leaves(tree)[0]


class AdamWState(NamedTuple):
    step: torch.Tensor           # 0-dim int32, on the params' device
    m: Any
    v: Any


def adamw_init(params: Any, dtype: torch.dtype = torch.float32
               ) -> AdamWState:
    def z(p):
        return torch.zeros(p.shape, dtype=dtype, device=p.device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=_first(params).device),
        m=tree_map(z, params), v=tree_map(z, params))


@torch.no_grad()
def adamw_update(tc: TrainConfig, grads: Any, state: AdamWState,
                 params: Any, lr: torch.Tensor) -> Tuple[Any, AdamWState]:
    """One AdamW step, in place on ``params`` and ``state.m``/``state.v``.
    ``lr`` is a 0-dim float32 tensor (or a float)."""
    step = state.step + 1
    b1, b2, eps = tc.b1, tc.b2, tc.eps
    sf = step.to(torch.float32)
    c1 = 1.0 - b1 ** sf
    c2 = 1.0 - b2 ** sf
    for g, m, v, p in zip(tree_leaves(grads), tree_leaves(state.m),
                          tree_leaves(state.v), tree_leaves(params),
                          strict=True):
        g32 = g.float()
        m.mul_(b1).add_(g32 * (1 - b1))
        v.mul_(b2).add_(g32 * (1 - b2) * g32)
        delta = (m / c1).div_((v / c2).sqrt_().add_(eps))
        if tc.weight_decay:
            delta.add_(p.float() * tc.weight_decay)
        p.copy_(p.float().sub_(lr * delta))
    return params, AdamWState(step=step, m=state.m, v=state.v)


# --------------------------------------------------------------------------
# Adafactor (Shazeer & Stern 2018): factored second moment, no first moment


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any      # row statistics (>= 2-D leaves) or the full v (1-D)
    vc: Any      # column statistics (a (1,) placeholder for 1-D)


def _factored(p: torch.Tensor) -> bool:
    return p.dim() >= 2


def adafactor_init(params: Any) -> AdafactorState:
    def r(p):
        shape = p.shape[:-1] if _factored(p) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def c(p):
        shape = (p.shape[:-2] + p.shape[-1:]) if _factored(p) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    return AdafactorState(
        step=torch.zeros((), dtype=torch.int32, device=_first(params).device),
        vr=tree_map(r, params), vc=tree_map(c, params))


@torch.no_grad()
def adafactor_update(tc: TrainConfig, grads: Any, state: AdafactorState,
                     params: Any, lr: torch.Tensor, decay: float = 0.999
                     ) -> Tuple[Any, AdafactorState]:
    """One Adafactor step, in place on ``params``, ``state.vr`` and
    ``state.vc``."""
    eps = 1e-30
    for g, vr, vc, p in zip(tree_leaves(grads), tree_leaves(state.vr),
                            tree_leaves(state.vc), tree_leaves(params),
                            strict=True):
        g32 = g.float()
        g2 = g32 * g32 + eps
        if _factored(p):
            vr.copy_(decay * vr + (1 - decay) * g2.mean(dim=-1))
            vc.copy_(decay * vc + (1 - decay) * g2.mean(dim=-2))
            r = vr / torch.clamp(vr.mean(dim=-1, keepdim=True), min=eps)
            denom = torch.sqrt(r[..., None] * vc[..., None, :])
        else:
            vr.copy_(decay * vr + (1 - decay) * g2)
            denom = torch.sqrt(vr)
        delta = g32 / torch.clamp(denom, min=eps)
        rms = torch.sqrt(torch.mean(delta * delta) + eps)   # update clipping
        delta = delta / torch.clamp(rms, min=1.0)
        if tc.weight_decay:
            delta = delta + tc.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    return params, AdafactorState(step=state.step + 1, vr=state.vr,
                                  vc=state.vc)


def sum_of_squares(tree: Any, counted: Optional[List[bool]] = None
                   ) -> torch.Tensor:
    """The sum of squares of every leaf, in float32 (0-dim), leaf by leaf
    in ``tree_leaves`` order; with ``counted``, of the leaves it marks
    True (a rank's part of a sharded norm)."""
    leaves = tree_leaves(tree)
    total = None
    for i, leaf in enumerate(leaves):
        if counted is not None and not counted[i]:
            continue
        sq = leaf.float().square().sum()
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    return total


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in float32 (0-dim)."""
    return torch.sqrt(sum_of_squares(tree))


@torch.no_grad()
def clip_by_global_norm(tree: Any, max_norm: float,
                        norm: Optional[torch.Tensor] = None
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale every leaf in place by min(1, max_norm / norm); returns
    (tree, norm before clipping). ``norm`` is the tree's global norm where
    the caller took it (the sharded step, over every rank's shards);
    default ``global_norm(tree)``."""
    n = global_norm(tree) if norm is None else norm
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-12), max=1.0)
    for leaf in tree_leaves(tree):
        leaf.mul_(scale.to(leaf.dtype))
    return tree, n
