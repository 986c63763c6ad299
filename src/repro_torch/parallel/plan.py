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
  (``repro_torch.transport``);
- on a live ``serve`` or ``long`` plan, ``serve_shard`` reads this
  rank's part of a model from the fitted shardings (its q and KV heads,
  the axes the output projections' rows, the FFN and the vocab split
  over, its experts and expert-FFN columns, its Mamba2 channels and
  heads, and how a dense cache splits its sequence and rows), which the
  engines hand the model around each forward
  (``runtime_context.serve_context``), and ``cache_shardings``
  fits the dense cache (sequence over 'model' on ``serve``, over
  'data' x 'model' on ``long``) and the paged pools (KV heads over
  'model').

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
from repro_torch.parallel.collectives import (all_gather_dim, all_reduce_sum,
                                              gather_leaf, own_rows)
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


QUEUE_ITEM = "ROADMAP queue 1 item 5"


def _live(mesh: Mesh, axes_: Tuple[str, ...]) -> Tuple[str, ...]:
    """The axes of ``axes_`` of size > 1: a split over an axis of size 1
    splits nothing and runs no collective."""
    return tuple(a for a in axes_ if mesh.shape[a] > 1)


@dataclasses.dataclass(frozen=True)
class SsmSplit:
    """This rank's part of a Mamba2 block (the reference's contiguous cuts
    of the fitted param specs, kept as they are): ``in_axes`` the axes
    ``in_proj``'s fused columns split over (the rank gathers the
    activations); ``conv`` (first, count) of the conv channels of its
    ``conv_w``/``conv_b`` and conv cache, split over ``conv_axes``;
    ``heads`` (first, count) of the SSM heads of its ``A_log``/``D``/
    ``dt_bias`` and state cache, whose ``d_inner`` channels are its
    ``gate_norm`` and ``out_proj`` rows, split over ``inner_axes``."""
    in_axes: Tuple[str, ...]
    conv: Tuple[int, int]
    conv_axes: Tuple[str, ...]
    heads: Tuple[int, int]
    inner_axes: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ServeShard:
    """This rank's part of a model on a live ``serve`` or ``long`` plan,
    read from the plan's fitted shardings, and the forward-only
    collectives a tensor-parallel forward runs with it (Megatron's column
    and row splits over the plan's tensor axes: 'model' on ``serve``,
    'data' x 'model' on ``long``):

    - ``q_heads`` / ``kv_heads``: (first, count) of the q heads of this
      rank's ``wq``/``wo`` columns and rows, and of the KV heads its page
      pools hold (split over ``pool_axes``, 'model'). Where the rank's
      ``wk``/``wv`` columns are cut finer than its pools' heads (Hkv does
      not split over 'model' but the columns do, or a ``long`` plan cuts
      them over 'data' x 'model'), they are gathered and the pools' heads
      kept (``kv_gather``). The paged kernels take the q heads of the
      pools' KV-head groups (``pool_q``) at their GQA layout: a rank
      whose q heads lie in them pads its heads with zeros to them
      (``attn_heads``) and keeps its own outputs (``own_heads``); where
      some rank's q heads do not (``regroup``: a ``long`` plan over
      'data' and 'model'), every rank gathers q to every head, attends
      its pools' groups, and gathers the outputs over ``pool_axes``;
    - ``head_axes`` / ``kv_axes`` / ``ffn_axes``: the axes ``wq``'s
      columns (and ``wo``'s rows), ``wk``'s columns and the FFN's columns
      (``w_down``'s rows) split over; the row-parallel products are summed
      over them;
    - ``vocab``: (first, count) of the ``embed`` rows (and ``lm_head``
      columns) this rank holds over ``vocab_axes``, None when whole: the
      lookup masks the ids outside the range and all-reduces, the logits
      are gathered;
    - ``rows``: the data axes the forward's batch rows split over (the
      paged engine's decode and verify chunks' slots): the model takes
      every row, runs its own and gathers each layer's new K/V rows, so
      every data rank writes every row and the pools stay equal over
      'data'; ``held_rows``: the data axes over which the rows a forward
      is given are this rank's already (the static engine's row split,
      ``row_span``). A MoE layer gathers the rows over either
      (``token_rows``) before it routes;
    - ``experts`` / ``expert_ffn``: (first, count) of the experts of this
      rank's ``moe`` leaves, split over ``expert_axes`` ('model'), and of
      their FFN columns (``w_gate``/``w_up``; ``w_down``'s rows), split
      over ``expert_ffn_axes`` ('data'); None where the MoE is absent.
      ``models/moe.py`` runs the rank's experts on its columns over every
      token and sums the partial outputs over both; ``models/moe_ep.py``
      (``moe_ep="serve"``) gathers the columns in the layer;
    - the dense cache (the static engine's): ``tp`` the mode's tensor
      axes, over which a dense cache splits its sequence (``span``) and
      a Mamba2 layer its channels and heads; ``batch`` the axes its rows
      split over (the data axes on ``serve``, none on ``long``);
      ``cache_len`` and ``mem_len`` the global rows of this forward's
      cache and memory (``with_cache``), from which each rank reads the
      span of positions it holds. A decode gathers q over the head axes,
      attends its span with every head and merges the ranks' partial
      softmaxes (``combine``);
    - ``ssm``: the Mamba2 split (``SsmSplit``), None without Mamba2
      layers.

    A split over an axis of size 1 splits nothing, so it runs no
    collective: a Dx1 serve plan reduces nothing over 'model', and a 1xM
    plan's rows are whole (on a 1x1 live mesh only the engines' lockstep
    broadcast runs)."""
    mesh: Mesh
    q_heads: Tuple[int, int]
    kv_heads: Tuple[int, int]
    num_heads: int
    group: int                         # q heads per KV head
    kv_gather: bool
    head_axes: Tuple[str, ...]
    kv_axes: Tuple[str, ...]
    ffn_axes: Tuple[str, ...]
    vocab: Optional[Tuple[int, int]]
    vocab_axes: Tuple[str, ...]
    tp: Tuple[str, ...]
    batch: Tuple[str, ...]
    ssm: Optional[SsmSplit] = None
    pool_axes: Tuple[str, ...] = ()
    regroup: bool = False
    experts: Optional[Tuple[int, int]] = None
    expert_axes: Tuple[str, ...] = ()
    expert_ffn: Optional[Tuple[int, int]] = None
    expert_ffn_axes: Tuple[str, ...] = ()
    rows: Tuple[str, ...] = ()
    held_rows: Tuple[str, ...] = ()
    cache_len: int = 0
    mem_len: int = 0

    def with_rows(self, rows: Tuple[str, ...]) -> "ServeShard":
        return dataclasses.replace(self, rows=tuple(rows))

    def with_held_rows(self, rows: Tuple[str, ...]) -> "ServeShard":
        """This shard for a forward given this rank's rows over ``rows``."""
        return dataclasses.replace(self, held_rows=tuple(rows))

    @property
    def moe_axes(self) -> Tuple[str, ...]:
        """The axes a MoE layer's partial outputs are summed over (its
        experts' and their columns', in mesh order)."""
        split = set(self.expert_axes + self.expert_ffn_axes)
        return tuple(a for a in self.mesh.axis_names if a in split)

    @property
    def token_rows(self) -> Tuple[str, ...]:
        """The axes this forward's rows (its tokens) split over."""
        return self.rows or self.held_rows

    def with_cache(self, cache_len: int, mem_len: int = 0) -> "ServeShard":
        """This shard over a dense cache of ``cache_len`` positions (and a
        memory of ``mem_len`` rows)."""
        return dataclasses.replace(self, cache_len=int(cache_len),
                                   mem_len=int(mem_len))

    # ---- spans of a dense cache -----------------------------------------
    def _span(self, axes_: Tuple[str, ...], length: int
              ) -> Tuple[Tuple[str, ...], int, int]:
        spec = axes.fit_spec(self.mesh, axes.P(axes_ or None), (length,))
        live = _live(self.mesh, axes.entry_axes(spec[0]))
        n = length // self.mesh.axes_size(live)
        return live, self.mesh.axis_index(live) * n, n

    def span(self, length: int) -> Tuple[Tuple[str, ...], int, int]:
        """(axes, first, count) of the rows of a ``length``-row dense
        cache (its sequence, or a memory's rows) this rank holds, as the
        fitted ``cache_specs`` cut them: axes () where ``length`` does not
        split, and the rank holds every row."""
        return self._span(self.tp, length)

    def row_span(self, batch: int) -> Tuple[Tuple[str, ...], int, int]:
        """(axes, first, count) of the batch rows of a dense cache this
        rank computes (split over the data axes on ``serve`` where they
        divide the batch; every row on ``long``)."""
        return self._span(self.batch, batch)

    # ---- heads -----------------------------------------------------------
    @property
    def pool_q(self) -> Tuple[int, int]:
        """(first, count) of the q heads of the pools' KV-head groups."""
        k0, kn = self.kv_heads
        return k0 * self.group, kn * self.group

    def own_rows(self, t: torch.Tensor) -> torch.Tensor:
        return own_rows(t, self.mesh, self.rows)

    def all_rows(self, t: torch.Tensor) -> torch.Tensor:
        return all_gather_dim(t, self.mesh, self.rows, 0)

    def kv_columns(self, t: torch.Tensor) -> torch.Tensor:
        """k or v columns (..., cols) of this rank -> those of its pools'
        KV heads (gathered over ``kv_axes`` where cut finer)."""
        if not self.kv_gather:
            return t
        t = all_gather_dim(t, self.mesh, self.kv_axes, -1)
        k0, kn = self.kv_heads
        hd = t.shape[-1] // (self.num_heads // self.group)
        return t[..., k0 * hd:(k0 + kn) * hd]

    def kv_all(self, t: torch.Tensor) -> torch.Tensor:
        """k or v columns (..., cols) of this rank -> every KV head's."""
        return all_gather_dim(t, self.mesh, self.kv_axes, -1)

    def gather_heads(self, q: torch.Tensor) -> torch.Tensor:
        """q (B, S, Hq_local, D) -> every q head (B, S, Hq, D)."""
        return all_gather_dim(q, self.mesh, self.head_axes, 2)

    def kv_span(self) -> Optional[Tuple[int, int]]:
        """(first, count) of the KV heads this rank's q heads attend, when
        they form whole groups of one contiguous run; None when the
        rank's q heads straddle a group (then pad them, ``attn_heads``)."""
        q0, qn = self.q_heads
        g = self.group
        if q0 % g == 0 and qn % g == 0:
            return q0 // g, qn // g
        if q0 // g == (q0 + qn - 1) // g:
            return q0 // g, 1
        return None

    def attn_heads(self, q: torch.Tensor) -> torch.Tensor:
        """q (..., Hq_local, D) as the paged kernels take it: the q heads
        of the pools' groups (``pool_q``), this rank's padded with zeros
        to them, or gathered from every rank (``regroup``)."""
        p0, pn = self.pool_q
        if self.regroup:
            return self.gather_heads(q)[..., p0:p0 + pn, :]
        return q if self.q_heads == (p0, pn) else self.pad_heads(q, p0, pn)

    def pad_heads(self, q: torch.Tensor, b0: int = 0,
                  bn: Optional[int] = None) -> torch.Tensor:
        """q of this rank's heads padded with zeros to the heads [b0, b0 +
        bn) (default every head)."""
        bn = self.num_heads if bn is None else bn
        first, n = self.q_heads
        full = q.new_zeros(q.shape[:-2] + (bn, q.shape[-1]))
        full[..., first - b0:first - b0 + n, :] = q
        return full

    def own_heads(self, o: torch.Tensor) -> torch.Tensor:
        """This rank's q heads of the paged kernels' output over
        ``pool_q`` (``attn_heads``)."""
        p0, pn = self.pool_q
        first, n = self.q_heads
        if self.regroup:                 # every head, then this rank's
            o = all_gather_dim(o, self.mesh, self.pool_axes, o.dim() - 2)
            return o[..., first:first + n, :]
        if (first, n) == (p0, pn):
            return o
        return o[..., first - p0:first - p0 + n, :]

    def take_heads(self, o: torch.Tensor) -> torch.Tensor:
        """This rank's q heads of an output over every head."""
        first, n = self.q_heads
        return o[..., first:first + n, :]

    def combine(self, o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                axes_: Tuple[str, ...]) -> torch.Tensor:
        """The ranks' partial attentions over their spans of keys merged
        into the attention over all keys (a log-sum-exp merge over
        ``axes_``): o (..., H, D) each rank's output normalised over its
        keys, m / l (..., H) its running max and sum, float32. One
        all-gather of the packed partials; every rank then weighs each by
        l exp(m - max over ranks) in rank order, so all get the same
        bits."""
        if not axes_:
            return o
        packed = torch.cat([o, m[..., None], l[..., None]], dim=-1)
        parts = self.gather(packed[None], axes_, 0)
        o_r, m_r, l_r = parts[..., :-2], parts[..., -2], parts[..., -1]
        w = l_r * torch.exp(m_r - m_r.amax(dim=0))
        return (o_r * w[..., None]).sum(dim=0) / w.sum(dim=0)[..., None]

    def gather(self, t: torch.Tensor, axes_: Tuple[str, ...],
               dim: int) -> torch.Tensor:
        """Every rank's ``t`` over ``axes_`` concatenated along ``dim``."""
        return all_gather_dim(t, self.mesh, axes_, dim)

    def reduce(self, t: torch.Tensor, axes_: Tuple[str, ...]
               ) -> torch.Tensor:
        """The sum of ``t`` over ``axes_``, in place."""
        return all_reduce_sum(t, self.mesh, axes_)

    # ---- row-parallel sums, vocab ---------------------------------------
    def reduce_attn(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, self.mesh, self.head_axes)

    def reduce_ffn(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, self.mesh, self.ffn_axes)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """The rows of ``tokens`` from this rank's vocab rows of the
        table, zero elsewhere, summed over the vocab axes: exact, since
        each id lives on one rank."""
        if self.vocab is None:
            return table[tokens]
        first, n = self.vocab
        ids = tokens - first
        ok = (ids >= 0) & (ids < n)
        x = torch.where(ok[..., None], table[ids.clamp(0, n - 1)], 0)
        return all_reduce_sum(x, self.mesh, self.vocab_axes)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        if self.vocab is None:
            return logits
        return all_gather_dim(logits, self.mesh, self.vocab_axes, -1)


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

    def cache_shardings(self, cfg: ModelConfig, cache: Any) -> Any:
        """Fitted shardings of a dense decode cache or of paged pools
        (``axes.cache_specs``): ``cache`` is a tree of tensors or of
        their shapes."""
        shapes = axes._map(lambda t: tuple(getattr(t, "shape", t)), cache)
        return axes.to_named_fit(
            self.mesh, axes.cache_specs(cfg, cache, self.mode, self.mesh),
            shapes)

    def serve_shard(self, cfg: ModelConfig) -> Optional[ServeShard]:
        """This rank's part of ``cfg`` on a live ``serve`` or ``long``
        plan (see ``ServeShard``); None off a live mesh. A split that
        cuts a q head, or SSM heads apart from their ``d_inner`` channels,
        raises ``NotImplementedError`` (``QUEUE_ITEM``)."""
        return _serve_shard(self, cfg)

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
    def _piece(self, leaf: torch.Tensor, sh: axes.NamedSharding,
               shape: Tuple[int, ...]) -> torch.Tensor:
        """This rank's slice of ``leaf`` (a view): a leaf of the global
        shape is cut, a leaf of the shard's shape is the shard."""
        if not self.mesh.live:
            return leaf.detach()
        if tuple(leaf.shape) == tuple(shape):
            return leaf.detach()[sh.index(self._rank, shape)]
        if tuple(leaf.shape) == sh.shard_shape(shape):
            return leaf.detach()
        raise ValueError(f"leaf of shape {tuple(leaf.shape)} is neither "
                         f"the global {shape} nor the shard "
                         f"{sh.shard_shape(shape)}")

    def _place(self, leaf: torch.Tensor, sh: axes.NamedSharding,
               shape: Tuple[int, ...], copy: bool,
               keep: bool = False) -> torch.Tensor:
        dev = placement_device(self.device, leaf.device)
        if not self.mesh.live:
            return leaf.detach().to(dev, copy=copy)
        if keep and leaf.device == dev and \
                tuple(leaf.shape) == sh.shard_shape(shape):
            return leaf
        piece = self._piece(leaf, sh, shape)
        return torch.empty(piece.shape, dtype=piece.dtype,
                           device=dev).copy_(piece)

    def _place_tree(self, tree: Any, shardings: Any, shapes: Any,
                    copy: bool, keep: bool = False) -> Any:
        if isinstance(tree, dict):
            return {k: self._place_tree(tree[k], shardings[k], shapes[k],
                                        copy, keep) for k in tree}
        return self._place(tree, shardings, shapes, copy, keep)

    def adopt_params(self, cfg: ModelConfig, params: Any) -> Any:
        """``device_put_params`` that keeps what is placed: a leaf that
        already is this rank's shard on the plan's device is taken as it
        is, so an engine given a node's placed copy makes no second one;
        full leaves are cut into fresh shards."""
        return self._place_tree(params, self.param_shardings(cfg),
                                axes.param_shapes(cfg), False, keep=True)

    def local_shards(self, cfg: ModelConfig, params: Any) -> Any:
        """This rank's slice of every param leaf, as views (nothing is
        copied or moved): full leaves are cut, shard-shaped ones taken as
        they are. The params themselves off a live mesh."""
        return self._shards(params, self.param_shardings(cfg),
                            axes.param_shapes(cfg))

    def _shards(self, tree: Any, shardings: Any, shapes: Any) -> Any:
        if isinstance(tree, dict):
            return {k: self._shards(tree[k], shardings[k], shapes[k])
                    for k in tree}
        return self._piece(tree, shardings, shapes)

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
def _serve_shard(plan: ExecutionPlan, cfg: ModelConfig
                 ) -> Optional[ServeShard]:
    if not plan.mesh.live:
        return None
    if plan.mode not in ("serve", "long"):
        raise ValueError(f"{plan.describe()}: serving runs on 'serve' or "
                         f"'long' plans, not {plan.mode!r}")
    mesh = plan.mesh
    sh, shapes = plan.param_shardings(cfg), axes.param_shapes(cfg)
    rank, hd = plan._rank, cfg.head_dim

    def span(s: axes.NamedSharding, shape: Tuple[int, ...], dim: int
             ) -> Tuple[int, int]:
        cut = s.index(rank, shape)[dim]
        return cut.start, cut.stop - cut.start

    def split(s: axes.NamedSharding, dim: int) -> Tuple[str, ...]:
        spec = list(s.spec) + [None] * (dim + 1 - len(s.spec))
        return _live(mesh, axes.entry_axes(spec[dim]))

    def first(key: str):
        """The fitted shardings and shapes of the first layer slot that
        holds ``key`` (every slot holding it has the same leaf shapes)."""
        for name, layer in sh["blocks"].items():
            if key in layer:
                return layer[key], shapes["blocks"][name][key]
        return None, None

    tp = ("model",) if plan.mode == "serve" else \
        axes.entry_axes(axes._rules("long", mesh)["qkv"])
    out = dict(mesh=mesh, num_heads=cfg.num_heads, tp=tp,
               batch=plan.dp_axes if plan.mode == "serve" else (),
               vocab=None, vocab_axes=split(sh["embed"], 0),
               q_heads=(0, cfg.num_heads), kv_heads=(0, cfg.num_kv_heads),
               group=max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1),
               kv_gather=False, head_axes=(), kv_axes=(), ffn_axes=())
    if out["vocab_axes"]:
        out["vocab"] = span(sh["embed"], shapes["embed"], 0)
    attn, ashape = first("attn")
    if attn is not None:
        q0, qn = span(attn["wq"], ashape["wq"], 2)
        if q0 % hd or qn % hd:
            raise NotImplementedError(
                f"{cfg.name}: {cfg.num_heads} q heads do not split over "
                f"{plan.describe()} (wq is cut inside a head); a "
                f"head-misaligned split is {QUEUE_ITEM}")
        pool_shape = (cfg.num_blocks, 2, 1, cfg.num_kv_heads, hd)
        pool = plan.cache_shardings(
            cfg, {"layer_0": {"self": {"kp": pool_shape}}})["layer_0"][
                "self"]["kp"]
        k0, kn = span(pool, pool_shape, 3)
        _, cn = span(attn["wk"], ashape["wk"], 2)
        g = out["group"]

        def inside(r: int) -> bool:
            """Rank ``r``'s q heads lie in its pools' groups."""
            qc = attn["wq"].index(r, ashape["wq"])[2]
            kc = pool.index(r, pool_shape)[3]
            return kc.start * g * hd <= qc.start and \
                qc.stop <= kc.stop * g * hd
        out.update(q_heads=(q0 // hd, qn // hd), kv_heads=(k0, kn),
                   kv_gather=cn != kn * hd, head_axes=split(attn["wq"], 2),
                   kv_axes=split(attn["wk"], 2), pool_axes=split(pool, 3),
                   regroup=not all(inside(r) for r in range(mesh.size)))
    mlp, _ = first("mlp")
    moe, eshape = first("moe")
    if mlp is not None:
        out["ffn_axes"] = split(mlp["w_down"], 1)
    elif moe is not None and "shared" in moe:
        out["ffn_axes"] = split(moe["shared"]["w_down"], 1)
    if moe is not None:                 # (nb, E, d, f)
        out.update(experts=span(moe["w_gate"], eshape["w_gate"], 1),
                   expert_axes=split(moe["w_gate"], 1),
                   expert_ffn=span(moe["w_gate"], eshape["w_gate"], 3),
                   expert_ffn_axes=split(moe["w_gate"], 3))
    mb, mshape = first("mamba")
    if mb is not None:
        h0, hn = span(mb["A_log"], mshape["A_log"], 1)
        i0, i_n = span(mb["gate_norm"], mshape["gate_norm"], 1)
        if (i0, i_n) != (h0 * cfg.ssm_headdim, hn * cfg.ssm_headdim):
            raise NotImplementedError(
                f"{cfg.name}: the SSM heads and d_inner split differently "
                f"over {plan.describe()}; such a split is {QUEUE_ITEM}")
        out["ssm"] = SsmSplit(
            in_axes=split(mb["in_proj"], 2),
            conv=span(mb["conv_b"], mshape["conv_b"], 1),
            conv_axes=split(mb["conv_b"], 1), heads=(h0, hn),
            inner_axes=split(mb["gate_norm"], 1))
    return ServeShard(**out)


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


__all__ = ["ExecutionPlan", "ServeShard", "placement_device", "make_plan",
           "local_plan", "plan_from_flag", "plan_for_params"]
