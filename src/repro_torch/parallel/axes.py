"""Logical-axis -> mesh-axis resolution per execution mode (the port of
``repro/parallel/axes.py``, rule for rule).

This is the one source of placement rules: ``ExecutionPlan``
(``repro_torch.parallel.plan``) turns these specs into fitted
``NamedSharding`` trees, which say what shard of each leaf a rank keeps.

Modes:
  train        FSDP(+pod) on d_model rows x tensor parallel on heavy dims,
               Megatron-SP residual sharding (batch->dp, seq->model).
  train_fsdp   ZeRO-3: every weight sharded on one fan-out dim over the
               whole mesh, batch data-parallel over the whole mesh.
  serve        tensor parallel weights (replicated over data), batch->dp;
               expert FFN additionally sharded over data (big-MoE serving).
  long         context-parallel decode (batch=1): weight heavy dims over
               (data x model) [(pod x data x model) multi-pod], KV-cache
               sequence over data(+pod), heads over model.

A spec is a ``PartitionSpec``: one entry per dim, each an axis name, a
tuple of axis names (the dim split over their product, the first axis
major) or None (replicated). ``fit_spec`` prunes the axes that do not
divide a dim, as the JAX package does at its jit boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

from repro_torch.config import ModelConfig
from repro_torch.models.params import param_templates
from repro_torch.optim import AdafactorState, AdamWState
from repro_torch.parallel.mesh import Mesh, data_axes

MODES = ("train", "train_fsdp", "serve", "long")


class PartitionSpec(tuple):
    """``P(*entries)``: a tuple of per-dim entries (axis name, tuple of
    axis names, or None)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(tuple(self))


P = PartitionSpec


def entry_axes(entry) -> Tuple[str, ...]:
    """The axes of one spec entry, as a tuple (() for None)."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: which slice of a leaf each rank holds."""
    mesh: Mesh
    spec: PartitionSpec

    def index(self, rank: int, shape: Tuple[int, ...]) -> Tuple[slice, ...]:
        """The slices of a ``shape`` leaf that ``rank`` holds."""
        out = []
        entries = list(self.spec) + [None] * (len(shape) - len(self.spec))
        for dim, entry in zip(shape, entries, strict=True):
            axes = entry_axes(entry)
            n = self.mesh.axes_size(axes)
            if dim % n:
                raise ValueError(f"dim {dim} of {shape} does not divide "
                                 f"over {axes} ({n}); fit the spec first")
            size = dim // n
            i = self.mesh.axis_index(axes, rank)
            out.append(slice(i * size, (i + 1) * size))
        return tuple(out)

    def shard_shape(self, shape: Tuple[int, ...]) -> Tuple[int, ...]:
        return tuple(s.stop - s.start for s in self.index(0, shape))

    def devices_indices_map(self, shape: Tuple[int, ...]
                            ) -> Dict[int, Tuple[slice, ...]]:
        """rank -> the slices it holds, for every rank of the mesh."""
        return {r: self.index(r, tuple(shape)) for r in range(self.mesh.size)}

    def sharded_dims(self) -> Tuple[Tuple[int, Tuple[str, ...]], ...]:
        """(dim, axes) of every dim the spec splits."""
        return tuple((i, entry_axes(e)) for i, e in enumerate(self.spec)
                     if entry_axes(e))


def _rules(mode: str, mesh: Mesh) -> Dict[Any, Any]:
    dp = data_axes(mesh)                     # ("pod","data") or ("data",)
    dm = dp[:-1] + ("data", "model") if "pod" in mesh.axis_names \
        else ("data", "model")               # full fold for long mode
    if mode == "train":
        return {"vocab": "model", "embed": dp, "ffn": "model",
                "qkv": "model", "kv": "model", "experts": "model",
                "expert_ffn": None, "ssm_in": "model", "dinner": "model",
                "heads": "model", None: None}
    if mode == "train_fsdp":
        return {"vocab": dm, "embed": None, "ffn": dm, "qkv": dm,
                "kv": dm, "experts": "model", "expert_ffn": dp[-1],
                "ssm_in": dm, "dinner": dm, "heads": None, None: None}
    if mode == "serve":
        return {"vocab": "model", "embed": None, "ffn": "model",
                "qkv": "model", "kv": "model", "experts": "model",
                "expert_ffn": "data", "ssm_in": "model", "dinner": "model",
                "heads": "model", None: None}
    if mode == "long":
        return {"vocab": dm, "embed": None, "ffn": dm, "qkv": dm,
                "kv": dm, "experts": "model", "expert_ffn": "data",
                "ssm_in": dm, "dinner": dm, "heads": dm, None: None}
    raise ValueError(mode)


def _map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _map2(fn, a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(a, b)


def resolve_spec(axes: Tuple[Optional[str], ...], mode: str,
                 mesh: Mesh) -> PartitionSpec:
    rules = _rules(mode, mesh)
    return P(*[rules.get(a) for a in axes])


def param_shapes(cfg: ModelConfig) -> Any:
    """Tree of the params' global shapes."""
    return _map(lambda t: tuple(t.shape), param_templates(cfg))


def param_specs(cfg: ModelConfig, mode: str, mesh: Mesh) -> Any:
    return _map(lambda t: resolve_spec(t.axes, mode, mesh),
                param_templates(cfg))


def _row(spec: PartitionSpec) -> PartitionSpec:
    return P(*spec[:-1]) if len(spec) >= 2 else spec


def _col(spec: PartitionSpec) -> PartitionSpec:
    return P(*(spec[:-2] + spec[-1:])) if len(spec) >= 2 else P(None)


def opt_specs(pspecs: Any, optimizer: str):
    """Optimizer-state specs derived from the parameter specs."""
    if optimizer == "adamw":
        return AdamWState(step=P(), m=pspecs, v=pspecs)
    if optimizer != "adafactor":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return AdafactorState(step=P(), vr=_map(_row, pspecs),
                          vc=_map(_col, pspecs))


def opt_shapes(pshapes: Any, optimizer: str):
    """The optimizer state's shapes (``adamw_init`` / ``adafactor_init``)."""
    if optimizer == "adamw":
        return AdamWState(step=(), m=pshapes, v=pshapes)
    return AdafactorState(
        step=(),
        vr=_map(lambda s: s[:-1] if len(s) >= 2 else s, pshapes),
        vc=_map(lambda s: s[:-2] + s[-1:] if len(s) >= 2 else (1,),
                pshapes))


def batch_specs(cfg: ModelConfig, mesh: Mesh) -> Dict[str, PartitionSpec]:
    dp = data_axes(mesh)
    out = {"tokens": P(dp, None), "mask": P(dp, None),
           "sampler_lp": P(dp, None), "rewards": P(dp)}
    if cfg.is_encdec:
        out["frames"] = P(dp, None, None)
    elif cfg.memory_seq:
        out["image_embeds"] = P(dp, None, None)
    return out


def cache_specs(cfg: ModelConfig, cache: Any, mode: str, mesh: Mesh):
    """Specs for a decode-cache tree built by ``init_cache``, or a paged
    page pool built by ``init_paged_pool``; leaf roles are recognised by
    path name. The dense KV-cache sequence dim is sharded over 'model'
    (serve) or the whole mesh (long); paged pools (``kp``/``vp``, shape
    (nb, pages, page, Hkv, hd)) shard kv heads over 'model'."""
    dp = data_axes(mesh)
    long = mode == "long"
    if long and "pod" in mesh.axis_names:
        seq_axes: Any = ("pod", "data", "model")
    elif long:
        seq_axes = ("data", "model")
    else:
        seq_axes = "model"
    batch_axes = None if long else dp

    def spec_for(names) -> PartitionSpec:
        if "kp" in names or "vp" in names:      # (nb, pages, page, Hkv, hd)
            return P(None, None, None, "model", None)
        if "k" in names or "v" in names or "k_mem" in names \
                or "v_mem" in names:            # (nb, B, S, Hkv, hd)
            return P(None, batch_axes, seq_axes, None, None)
        if "conv" in names:                     # (nb, B, K-1, conv_ch)
            return P(None, batch_axes, None, seq_axes if long else "model")
        if "ssm" in names:                      # (nb, B, H, P, N)
            return P(None, batch_axes, seq_axes if long else "model",
                     None, None)
        raise ValueError(f"unknown cache leaf {names}")

    def walk(tree, names):
        if isinstance(tree, dict):
            return {k: walk(v, names + [str(k)]) for k, v in tree.items()}
        return spec_for(names)
    return walk(cache, [])


def act_sharding_for(mode: str, mesh: Mesh) -> Optional[Tuple]:
    """Residual-stream constraint handed to the model config (recorded in
    ``ModelConfig.act_sharding``; the port's step computes replicated
    activations per rank, so it changes no number)."""
    dp = data_axes(mesh)
    if mode == "train":
        return (dp, "model", None)             # batch->dp, seq->model (SP)
    if mode == "train_fsdp":
        return (dp + ("model",), None, None)   # batch over the whole mesh
    return None


def fit_spec(mesh: Mesh, spec: PartitionSpec,
             shape: Tuple[int, ...]) -> PartitionSpec:
    """Prune mesh axes that do not evenly divide the dimension (e.g. 8 kv
    heads cannot shard over model=16)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries, strict=True):
        if entry is None:
            out.append(None)
            continue
        keep = []
        prod = 1
        for ax in entry_axes(entry):
            n = mesh.shape[ax]
            if dim % (prod * n) == 0:
                keep.append(ax)
                prod *= n
            else:
                break
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return P(*out)


def to_named(mesh: Mesh, spec_tree: Any) -> Any:
    return _map(lambda s: NamedSharding(mesh, s), spec_tree)


def to_named_fit(mesh: Mesh, spec_tree: Any, shape_tree: Any) -> Any:
    """NamedShardings with divisibility-fitted specs (shapes from the
    matching tree of shape tuples)."""
    return _map2(lambda s, shape: NamedSharding(mesh, fit_spec(mesh, s,
                                                               shape)),
                 spec_tree, shape_tree)


__all__ = ["MODES", "P", "PartitionSpec", "NamedSharding", "entry_axes",
           "resolve_spec", "param_shapes", "param_specs",
           "opt_specs", "opt_shapes", "batch_specs", "cache_specs",
           "act_sharding_for", "fit_spec", "to_named", "to_named_fit"]
