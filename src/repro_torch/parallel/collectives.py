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
- ``gather_shards``: the sharded learner's weights where the model uses
  them. Its forward all-gathers a set of shard leaves (one block's, or
  the leaves outside the blocks) along the dims a plan gives; its
  backward sums each leaf's full gradient over the row axes (one
  all-reduce of it in float32: the transient is that leaf) and returns
  this rank's slice, a fresh shard-shaped tensor in the leaf's dtype. No
  collective but these two lists ever runs: gloo and NCCL serve both.

``COLLECTIVE_BYTES`` counts, by kind ("all-gather", "all-reduce",
"broadcast"), the bytes of the result of every collective this process
issues (a broadcast object's pickled size), as the kernels' ``LAUNCHES``
count launches; ``reset_collective_bytes`` zeroes it. The dry-run reads
it as its collective term (``launch.dryrun``). ``GATHERED_BYTES`` holds
the bytes of ``gather_shards``' outputs alive now (``"alive"``: added at
each gather, taken off when the gathered tensor is freed) and the most
alive at once since ``reset_gathered_high_water`` (``"high"``).
"""
from __future__ import annotations

import pickle
import threading
import weakref
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel.mesh import Mesh

COLLECTIVE_BYTES: Dict[str, int] = {"all-gather": 0, "all-reduce": 0,
                                    "broadcast": 0}
_bytes_lock = threading.Lock()        # the threaded runtime's threads
GATHERED_BYTES: Dict[str, int] = {"alive": 0, "high": 0}
# reentrant: a finalizer may run inside the lock's block (a collection)
_gathered_lock = threading.RLock()


def reset_collective_bytes() -> None:
    with _bytes_lock:
        for k in COLLECTIVE_BYTES:
            COLLECTIVE_BYTES[k] = 0


def reset_gathered_high_water() -> None:
    """Start a new high-water mark of ``gather_shards``' alive bytes."""
    with _gathered_lock:
        GATHERED_BYTES["high"] = GATHERED_BYTES["alive"]


def _alive(nbytes: int) -> None:
    with _gathered_lock:
        GATHERED_BYTES["alive"] += nbytes
        GATHERED_BYTES["high"] = max(GATHERED_BYTES["high"],
                                     GATHERED_BYTES["alive"])


def _add(kind: str, nbytes: int) -> None:
    with _bytes_lock:
        COLLECTIVE_BYTES[kind] += nbytes


def _count(kind: str, t: torch.Tensor, n: int = 1) -> None:
    _add(kind, n * t.numel() * t.element_size())


def _all_reduce(t: torch.Tensor, group, **kw) -> None:
    dist.all_reduce(t, group=group, **kw)
    _count("all-reduce", t)


def _gather_list(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
                 ) -> List[torch.Tensor]:
    n = mesh.axes_size(axes)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=mesh.group(axes))
    _count("all-gather", t, n)
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
        _all_reduce(t, mesh.group(axes))
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
        _all_reduce(t, mesh.group(axes), op=dist.ReduceOp.MAX)
    return t


def broadcast_object(obj, mesh: Mesh):
    """Mesh rank 0's ``obj`` (pickled) on every rank of a live mesh; the
    object itself off one. A mesh spans the whole process group, so its
    rank 0 is the group's."""
    if not mesh.live:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group(mesh.axis_names))
    _add("broadcast", len(pickle.dumps(box[0])))
    return box[0]


def gather_leaf(shard: torch.Tensor, mesh: Mesh,
                sharded: Tuple[Tuple[int, Tuple[str, ...]], ...]
                ) -> torch.Tensor:
    """The full leaf from this rank's shard: one all-gather per split dim
    (``NamedSharding.sharded_dims``). On a live mesh the result is a new
    tensor even where nothing is split, outside autograd; off a live mesh
    it is ``shard`` itself."""
    if not mesh.live:
        return shard
    full = shard.detach()
    for dim, axes in sharded:
        full = all_gather_dim(full, mesh, axes, dim)
    return full if sharded else full.clone()


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
        _all_reduce(g, ctx.mesh.group(ctx.axes))
        return g, None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, mesh, axes):
        out = t.contiguous().clone()
        _all_reduce(out, mesh.group(axes))
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, spec, *shards):
        mesh, _, leaves = spec
        ctx.spec = spec
        out = []
        for s, (dims, _) in zip(shards, leaves, strict=True):
            full = gather_leaf(s, mesh, dims)
            n = full.numel() * full.element_size()
            _alive(n)
            weakref.finalize(full, _alive, -n)
            out.append(full)
        return tuple(out)

    @staticmethod
    def backward(ctx, *grads):
        mesh, rows, leaves = ctx.spec
        out = []
        for g, (_, index) in zip(grads, leaves, strict=True):
            g32 = g.to(torch.float32, memory_format=torch.contiguous_format,
                       copy=True)
            out.append(all_reduce_sum(g32, mesh, rows)[index].to(
                g.dtype, copy=True))
        return (None,) + tuple(out)


def copy_to(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
            ) -> torch.Tensor:
    """Identity forward; the backward sums the gradient over ``axes``."""
    return _CopyTo.apply(t, mesh, axes) if axes else t


def reduce_from(t: torch.Tensor, mesh: Mesh, axes: Tuple[str, ...]
                ) -> torch.Tensor:
    """Sum over ``axes`` forward; identity backward."""
    return _ReduceFrom.apply(t, mesh, axes) if axes else t


def gather_shards(shards: Tuple[torch.Tensor, ...], mesh: Mesh,
                  rows: Tuple[str, ...], leaves) -> Tuple[torch.Tensor, ...]:
    """The gathered leaves of ``shards`` on a live mesh: ``leaves`` holds,
    for each, the (dim, axes) it is all-gathered along (in
    ``NamedSharding.sharded_dims`` order) and the index of this rank's
    slice of the gathered leaf. The backward sums each gathered leaf's
    gradient over ``rows`` and returns that slice (see the module note)."""
    return _GatherShards.apply((mesh, tuple(rows), tuple(leaves)), *shards)


__all__ = ["COLLECTIVE_BYTES", "reset_collective_bytes", "GATHERED_BYTES",
           "reset_gathered_high_water", "all_gather_dim", "all_reduce_sum",
           "all_reduce_mean", "all_reduce_max", "broadcast_object",
           "gather_leaf", "gather_rows", "gather_shards", "own_rows",
           "copy_to", "reduce_from"]
