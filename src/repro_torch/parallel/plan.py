"""ExecutionPlan: the one object that owns placement for a running system
(the port of ``repro/parallel/plan.py``).

A plan is (mesh, mode), frozen and hashable, so caches key on it. From it
every layer derives its fitted ``NamedSharding`` trees (params, optimizer
state, batch, KV cache) out of the logical-axis rules in
``repro_torch.parallel.axes``:

- the learner step keeps params and optimizer state sharded as the plan
  says between steps (``repro_torch.parallel.step``);
- ``device_put_*`` cut a rank's shard of each full leaf (a rank keeps
  only its own shard), ``gather``/``host_gather`` put the full leaves
  back together;
- the publisher cuts checkpoint chunks on the plan's shard grid
  (``repro_torch.transport``).

A torch tensor does not carry its placement, so the trees a plan places
and gathers are matched with the sharding trees by position; a leaf whose
shape is the global one is cut, a leaf whose shape is the shard's is
taken as the shard. ``local_plan`` (the 1x1 local mesh) backs
single-device execution: it places tensors on its device and launches no
collective.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import DeviceLike
from repro_torch.parallel import axes
from repro_torch.parallel.collectives import gather_leaf
from repro_torch.parallel.mesh import (Mesh, data_axes, local_mesh,
                                       mesh_from_flag)


def placement_device(target: Optional[torch.device],
                     current: torch.device) -> torch.device:
    """Where a plan whose device is ``target`` puts a tensor now on
    ``current``: ``target``, or ``current`` when the plan names none.
    Placement never moves a tensor off the card: a CUDA tensor on a plan
    whose device is not CUDA raises."""
    if target is None:
        return current
    if current.type == "cuda" and target.type != "cuda":
        raise RuntimeError(f"the plan places on {target}, but the tensor is "
                           f"on {current}: placement does not move a tensor "
                           "off the card")
    return target


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Mesh + parameter-sharding mode. Frozen and hashable: equal plans
    mean equal placement."""
    mesh: Mesh
    mode: str = "train"            # train | train_fsdp | serve | long

    def __post_init__(self):
        if self.mode not in axes.MODES:
            raise ValueError(f"mode {self.mode!r} not in {axes.MODES}")

    # ---- descriptive ----------------------------------------------------
    @property
    def num_devices(self) -> int:
        return int(self.mesh.devices.size)

    @property
    def dp_axes(self) -> Tuple[str, ...]:
        return data_axes(self.mesh)

    @property
    def device(self) -> Optional[torch.device]:
        return self.mesh.device

    def describe(self) -> str:
        shape = "x".join(f"{self.mesh.shape[a]}{a[0]}"
                         for a in self.mesh.axis_names)
        return (f"ExecutionPlan(mode={self.mode}, mesh={shape}, "
                f"devices={self.num_devices})")

    # ---- fitted NamedSharding trees -------------------------------------
    def _fit(self, spec: axes.P, shape: Tuple[int, ...]
             ) -> axes.NamedSharding:
        return axes.NamedSharding(self.mesh, axes.fit_spec(
            self.mesh, spec, tuple(shape)))

    def param_shardings(self, cfg: ModelConfig) -> Any:
        return _param_shardings(self, cfg)

    def state_shardings(self, cfg: ModelConfig,
                        optimizer: str = "adamw") -> Any:
        """``TrainState``-shaped tree of fitted shardings (params + opt
        buffers + step), the opt shapes those of the optimizer's init."""
        return _state_shardings(self, cfg, optimizer)

    def batch_shardings(self, cfg: ModelConfig, batch: Dict[str, Any]
                        ) -> Dict[str, axes.NamedSharding]:
        """Fitted shardings for the keys present in ``batch`` (anything
        with a ``.shape``). Unknown keys are an error — placement must be
        total."""
        specs = axes.batch_specs(cfg, self.mesh)
        unknown = sorted(set(batch) - set(specs))
        if unknown:
            raise ValueError(f"no batch sharding rule for keys {unknown}")
        return {k: self._fit(specs[k], tuple(v.shape))
                for k, v in batch.items()}

    def row_axes(self, cfg: ModelConfig, batch: Dict[str, Any]
                 ) -> Tuple[str, ...]:
        """The axes the rows of ``batch`` split over on this plan (the
        fitted batch spec's first entry); () off a live mesh."""
        if not self.mesh.live:
            return ()
        sh = self.batch_shardings(cfg, {"tokens": batch["tokens"]})
        return axes.entry_axes(sh["tokens"].spec[0])

    # ---- microbatches ---------------------------------------------------
    def constrain_microbatches(self, cfg: ModelConfig,
                               mbs: Dict[str, Any]) -> Dict[str, Any]:
        """The cut (accum, mb, ...) tree -> this rank's rows of every
        microbatch, each microbatch data-sharded on its own axis. The
        batch is cut into microbatches first and each is then sharded, so
        rank r's rows of microbatch i are a slice of microbatch i (cutting
        the rank's rows of the whole batch into microbatches would give
        other microbatches and another result)."""
        specs = axes.batch_specs(cfg, self.mesh)
        out = {}
        for k, v in mbs.items():
            sh = self._fit(axes.P(None, *specs[k]), tuple(v.shape))
            out[k] = v[sh.index(self._rank, tuple(v.shape))] \
                if self.mesh.live else v
        return out

    @property
    def _rank(self) -> int:
        return self.mesh.rank if self.mesh.rank is not None else 0

    # ---- placement / gather ---------------------------------------------
    def _place(self, leaf: torch.Tensor, sh: axes.NamedSharding,
               shape: Tuple[int, ...], copy: bool) -> torch.Tensor:
        dev = placement_device(self.device, leaf.device)
        if not self.mesh.live:
            return leaf.detach().to(dev, copy=copy)
        if tuple(leaf.shape) == tuple(shape):
            piece = leaf.detach()[sh.index(self._rank, shape)]
        elif tuple(leaf.shape) == sh.shard_shape(shape):
            piece = leaf.detach()
        else:
            raise ValueError(f"leaf of shape {tuple(leaf.shape)} is neither "
                             f"the global {shape} nor the shard "
                             f"{sh.shard_shape(shape)}")
        return torch.empty(piece.shape, dtype=piece.dtype,
                           device=dev).copy_(piece)

    def _place_tree(self, tree: Any, shardings: Any, shapes: Any,
                    copy: bool) -> Any:
        if isinstance(tree, dict):
            return {k: self._place_tree(tree[k], shardings[k], shapes[k],
                                        copy) for k in tree}
        return self._place(tree, shardings, shapes, copy)

    def device_put_params(self, cfg: ModelConfig, params: Any, *,
                          copy: bool = False) -> Any:
        """This rank's shard of every param leaf, on the plan's device.
        On a local plan the leaves move to its device (fresh tensors with
        ``copy=True``); on a live mesh every shard is a fresh tensor."""
        return self._place_tree(params, self.param_shardings(cfg),
                                axes.param_shapes(cfg), copy)

    def device_put_state(self, cfg: ModelConfig, state: Any,
                         optimizer: str = "adamw", *,
                         copy: bool = False) -> Any:
        """Place a ``TrainState`` onto the plan (params and optimizer
        buffers per ``state_shardings``, the step counters whole)."""
        sh = self.state_shardings(cfg, optimizer)
        pshapes = axes.param_shapes(cfg)
        oshapes = axes.opt_shapes(pshapes, optimizer)
        opt = type(state.opt)(*(
            self._place_tree(leaf, s, shp, copy)
            for leaf, s, shp in zip(state.opt, sh.opt, oshapes)))
        return type(state)(
            params=self._place_tree(state.params, sh.params, pshapes, copy),
            opt=opt, step=self._place(state.step, sh.step, (), copy))

    def device_put_batch(self, cfg: ModelConfig,
                         batch: Dict[str, Any]) -> Dict[str, Any]:
        """This rank's rows of every batch leaf, on the plan's device
        (numpy arrays or tensors; unknown keys raise)."""
        sh = self.batch_shardings(cfg, batch)
        out = {}
        for k, v in batch.items():
            t = torch.as_tensor(v)
            out[k] = self._place(t, sh[k], tuple(t.shape), copy=False)
        return out

    def gather(self, tree: Any, shardings: Any) -> Any:
        """The full leaves of a placed tree (matched with its sharding
        tree by position): one all-gather per split dim of each leaf, new
        tensors on a live mesh; the tree itself off one."""
        if isinstance(tree, dict):
            return {k: self.gather(tree[k], shardings[k]) for k in tree}
        return gather_leaf(tree, self.mesh, shardings.sharded_dims())

    def gather_params(self, cfg: ModelConfig, params: Any) -> Any:
        return self.gather(params, self.param_shardings(cfg))

    def host_gather(self, tree: Any, shardings: Any = None) -> Any:
        """Full leaves as host numpy arrays (bf16 widened to float32,
        which numpy lacks; exact). ``shardings`` None: the leaves are
        already full."""
        full = tree if shardings is None else self.gather(tree, shardings)

        def host(t):
            t = t.detach().cpu()
            return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
        return axes._map(host, full)


# Fitted-tree builders are pure in (plan, cfg[, optimizer]) — all
# hashable — so they are memoised here.
@functools.lru_cache(maxsize=64)
def _param_shardings(plan: ExecutionPlan, cfg: ModelConfig) -> Any:
    return axes.to_named_fit(plan.mesh,
                             axes.param_specs(cfg, plan.mode, plan.mesh),
                             axes.param_shapes(cfg))


@functools.lru_cache(maxsize=64)
def _state_shardings(plan: ExecutionPlan, cfg: ModelConfig,
                     optimizer: str) -> Any:
    from repro_torch.training import TrainState
    pshapes = axes.param_shapes(cfg)
    pspecs = axes.param_specs(cfg, plan.mode, plan.mesh)
    ospecs = axes.opt_specs(pspecs, optimizer)
    oshapes = axes.opt_shapes(pshapes, optimizer)
    opt = type(ospecs)(*(
        axes.to_named_fit(plan.mesh, s, shp) if isinstance(s, dict)
        else plan._fit(s, shp) for s, shp in zip(ospecs, oshapes)))
    return TrainState(params=axes.to_named_fit(plan.mesh, pspecs, pshapes),
                      opt=opt, step=plan._fit(axes.P(), ()))


def make_plan(mesh: Optional[Mesh] = None,
              mode: str = "train") -> ExecutionPlan:
    return ExecutionPlan(mesh=mesh if mesh is not None else local_mesh(),
                         mode=mode)


@functools.lru_cache(maxsize=16)
def _local_plan(mode: str, device: Optional[str]) -> ExecutionPlan:
    return ExecutionPlan(mesh=local_mesh(device), mode=mode)


def local_plan(mode: str = "train",
               device: Optional[DeviceLike] = None) -> ExecutionPlan:
    """Single-device (1x1 local mesh) plan — the default execution path.
    ``device`` is where it places tensors (None: where they are)."""
    return _local_plan(mode, None if device is None else str(device))


@functools.lru_cache(maxsize=32)
def _plan_from_flag(spec: Optional[str], mode: str,
                    device: Optional[str]) -> ExecutionPlan:
    if spec is None or spec in ("", "1x1"):
        return local_plan(mode, device)
    return ExecutionPlan(mesh=mesh_from_flag(spec, device), mode=mode)


def plan_from_flag(spec: Optional[str], mode: str,
                   device: Optional[DeviceLike] = None) -> ExecutionPlan:
    """Plan from a ``--mesh``/config knob ("DxM" or "PxDxM"); None or
    "1x1" gives the local plan. Any other mesh is live over the
    initialised process group and raises ``RuntimeError`` when the group
    is smaller than the mesh."""
    return _plan_from_flag(spec, mode, None if device is None
                           else str(device))


def plan_for_params(params: Any, mode: str = "serve") -> ExecutionPlan:
    """The local plan on the device the params live on (a torch tensor
    carries no mesh, so placed params cannot name a larger one)."""
    from repro_torch.optim import tree_leaves
    leaves = tree_leaves(params)
    return local_plan(mode, leaves[0].device if leaves else None)


__all__ = ["ExecutionPlan", "placement_device", "make_plan", "local_plan", "plan_from_flag",
           "plan_for_params"]
