"""The collectives of the sharded learner and of tensor-parallel serving,
over a mesh's axis groups.

``all_gather`` (the list form), ``all_reduce`` and
``broadcast_object_list`` are used: gloo and NCCL serve them, on CPU and
on CUDA tensors. Over no axes every function is the identity and
launches nothing, so a local plan never touches ``torch.distributed``;
over axes of size 1 on a live mesh the collective still runs.

Serving's collectives are forward-only (no autograd): ``all_reduce_sum``
after the row-parallel products, ``all_gather_dim`` of the logits' vocab
shards and of a step's rows over the data axes, ``all_reduce_max`` of a
round's statistic, and ``broadcast_object`` of rank 0's round inputs.

The autograd-aware pieces:

- ``gather_rows``: rows of every rank along the row axes, concatenated in
  rank order. Its backward keeps this rank's rows of the incoming
  gradient and sends nothing: it is used where every rank computes the
  same function of the gathered rows (the loss of the global batch), or
  where an output row depends on its own input row alone (the MoE
  dispatch), so the rank's slice is the whole gradient of its rows.
- ``copy_to`` (Megatron's f): identity forward, all-reduce backward.
- ``reduce_from`` (Megatron's g): all-reduce forward, identity backward.
- ``slice_from``: a rank's block of dim 0 forward, all-gather backward
  (each model rank holds the gradient of its own experts).
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import Mesh


def _gather_list(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
                 ) -> List[torch.Tensor]:
    n = mesh.axes_size(axes)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group(axes))
    return parts


def all_gather_dim(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...],
                   dim: int) -> torch.Tensor:
    """Concatenate every rank's ``t`` along ``dim``, in the row-major
    order of ``axes`` (no autograd)."""
    if not axes:
        return t
    return torch.cat(_gather_list(t, mesh, axes), dim=dim)


def all_reduce_sum(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
                   ) -> torch.Tensor:
    """Sum of ``t`` over ``axes``, in place on ``t`` (no autograd)."""
    if axes:
        dist.all_reduce(t, group=mesh.group(axes))
    return t


def all_reduce_mean(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
                    ) -> torch.Tensor:
    if not axes:
        return t
    return all_reduce_sum(t, mesh, axes).div_(mesh.axes_size(axes))


def all_reduce_max(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
                   ) -> torch.Tensor:
    """Max of ``t`` over ``axes``, in place on ``t`` (no autograd)."""
    if axes:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group(axes))
    return t


def broadcast_object(obj, mesh: Mesh):
    """Mesh rank 0's ``obj`` (pickled) on every rank of a live mesh; the
    object itself off one. A mesh spans the whole process group, so its
    rank 0 is the group's."""
    if not mesh.live:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group(mesh.axis_names))
    return box[0]


def gather_leaf(shard: torch.Tensor, mesh: Mesh,
                sharded: Tuple[Tuple[int, Tuple[str, ...]], ...]
                ) -> torch.Tensor:
    """The full leaf from this rank's shard: one all-gather per split dim
    (``NamedSharding.sharded_dims``). On a live mesh the result is a new
    tensor even where nothing is split; off a live mesh it is ``shard``
    itself."""
    if not mesh.live:
        return shard
    full = shard
    for dim, axes in sharded:
        full = all_gather_dim(full, mesh, axes, dim)
    return full if sharded else shard.clone()


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes, ctx.n = mesh, axes, t.shape[0]
        return torch.cat(_gather_list(t, mesh, axes), dim=0)

    @staticmethod
    def backward(ctx, g):
        i = ctx.mesh.axis_index(ctx.axes)
        return g[i * ctx.n:(i + 1) * ctx.n], None, None


def gather_rows(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
                ) -> torch.Tensor:
    """Every rank's rows (dim 0) along ``axes``, concatenated in rank
    order; the backward keeps this rank's rows (see the module note)."""
    if not axes:
        return t
    return _GatherRows.apply(t, mesh, axes)


def own_rows(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
             ) -> torch.Tensor:
    """This rank's block of dim 0 when it is split over ``axes``."""
    if not axes:
        return t
    n = t.shape[0] // mesh.axes_size(axes)
    i = mesh.axis_index(axes)
    return t[i * n:(i + 1) * n]


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.mesh.group(ctx.axes))
        return g, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        out = t.contiguous().clone()
        dist.all_reduce(out, group=mesh.group(axes))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SliceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes, lo, n):
        ctx.mesh, ctx.axes = mesh, axes
        return t[lo:lo + n]

    @staticmethod
    def backward(ctx, g):
        full = torch.cat(_gather_list(g.contiguous(), ctx.mesh, ctx.axes),
                         dim=0)
        return full, None, None, None, None


def copy_to(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
            ) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``axes``."""
    return _CopyTo.apply(t, mesh, axes) if axes else t


def reduce_from(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
                ) -> torch.Tensor:
    """Sum over ``axes`` forward; identity backward."""
    return _ReduceFrom.apply(t, mesh, axes) if axes else t


def slice_from(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
               ) -> torch.Tensor:
    """This rank's block of dim 0 over ``axes`` (dim 0 divisible by their
    size); the backward all-gathers the blocks' gradients, so the full
    tensor's gradient holds every rank's block."""
    if not axes:
        return t
    n = t.shape[0] // mesh.axes_size(axes)
    return _SliceFrom.apply(t, mesh, axes, mesh.axis_index(axes) * n, n)


__all__ = ["all_gather_dim", "all_reduce_sum", "all_reduce_mean",
           "all_reduce_max", "broadcast_object",
           "gather_leaf", "gather_rows", "own_rows", "copy_to",
           "reduce_from", "slice_from"]
