"""The decoder forward: dense full-sequence (with or without a dense
cache), and paged prefill/decode; the encoder of an encoder-decoder model.

The port of ``repro/models/model.py``: token embedding, then for every
layer RMSNorm and its mixer, either self-attention (q/k/v projections
with rotary embeddings, attention, the output projection),
cross-attention to a modality memory (a CROSS layer), or a Mamba2 block
(``models.ssm.mamba_block``), then a SwiGLU MLP, a MoE FFN
(``models.moe.moe_ffn``) or no FFN (``ffn_pattern`` NONE), then the final
norm and the (tied or separate) head in float32. In an encoder-decoder
model (Whisper) every decoder layer adds, after its self-attention, a
``cross_norm`` and cross-attention to the memory. The memory (B, M, d) is
what a forward or ``init_cache`` takes as ``memory=``: stub image patch
embeddings for a CROSS model, the output of ``encode`` (the encoder's
bidirectional attention + MLP layers over stub frame embeddings, then its
final norm) for an encoder-decoder model. ``init_cache(memory=)``
projects the memory's keys and values once per layer into the cache
(``"mem"``: ``k_mem`` / ``v_mem``), which every later forward and decode
step over that cache reads. Cross-attention masks nothing and has no
positions, so it always takes K5 under ``attn_impl="pallas"``
(non-causal, Sq != Sk), as the JAX package's jitted forward does with its
traced zero positions. A config with MoE layers
sums each layer's router metrics (``moe_load_balance``, ``moe_z_loss``,
``moe_drop_frac``) into the ``aux`` that ``forward`` returns, from float32
zeros in layer order, as the JAX package's scan carries them. Three ways
through the attention:

- dense (``forward`` with ``cache=None``): the training and
  teacher-forced forward over positions ``arange(S)``, through
  ``models.attention.attention`` (``cfg.attn_impl``, ``cfg.attn_chunk``;
  "pallas" is the flash kernel K5). With ``cfg.remat`` (and autograd
  recording) each block runs under ``torch.utils.checkpoint``, as the JAX
  package wraps its scan body in ``jax.checkpoint``: only block inputs are
  kept for the backward;
- dense KV cache (``init_cache``; the static engine): ``forward`` with
  the cache runs the dense path and writes the prompt's K/V at
  ``[0, S)``; ``decode_step`` writes one token's K/V at ``pos`` and
  attends through ``models.attention.decode_attention``. Written in
  place, like the pools below. A Mamba2 layer's part of the cache is its
  conv window and float32 SSM state (``ssm_c``), which a prefill and each
  decode step overwrite in place;
- paged (``forward`` with page pools and a ``page_table``, and
  ``decode_step``): the K/V write into the page pools, then paged
  attention through ``repro_torch.kernels.ops``. The pools are written
  *in place*: a forward returns the same cache object it was given.

On a serving plan (``runtime_context.serve_shard``) every layer runs
this rank's shard: the paged path attends its KV heads through K3/K4;
the dense path (the static engine and the recompute) runs its q heads
through K5 in a prefill and decodes context-parallel, its part of the
dense cache a span of positions with every KV head
(``_self_attn_plan``, ``_cross_attn_plan``), and a Mamba2 layer runs its
SSM heads (``models.ssm.mamba_block``).

Parameters are the JAX package's tree: block leaves are stacked
``(nb, ...)`` and applied one block at a time in a Python loop (the JAX
package scans them). With ``cfg.local_ring_kv`` the dense cache of a
local layer is a ring of ``min(max_len, sliding_window)`` rows: a prefill
stores the prompt's last W keys in ring order (``fill_ring``), a decode
step writes at ``pos mod W`` and attends the ring
(``ring_decode_attention``); the prefill's attention itself is unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from repro_torch import runtime_context
from repro_torch.config import (ATTN, CROSS, LOCAL, MAMBA, MLP, MOE, NONE,
                                ModelConfig)
from repro_torch.kernels.ops import paged_decode, paged_prefill
from repro_torch.models.attention import (attention, decode_attention,
                                          fill_ring, memory_attention,
                                          ring_decode_attention,
                                          standard_positions)
from repro_torch.models.layers import rmsnorm, rope, softcap, swiglu
from repro_torch.models.moe import moe_ffn
from repro_torch.models.moe_ep import moe_ffn_ep
from repro_torch.models.ssm import mamba_block

# sampling.paged_cache.SCRATCH_PAGE (not imported: sampling imports this
# module)
SCRATCH_PAGE = 0


def _unstack(tree: Any, n: int) -> List[Any]:
    """Stacked (n, ...) leaves -> a list of n trees of views."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in parts} for i in range(n)]
    return list(torch.unbind(tree, 0))


def _rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's batch rows of ``t`` when the serving forward splits
    them over the data axes (``runtime_context.serve_shard``), else
    ``t``."""
    tp = runtime_context.serve_shard()
    return t if tp is None else tp.own_rows(t)


def _project_qkv(cfg: ModelConfig, p: Dict, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v (B, S, H, D). On a tensor-parallel serving forward the
    weights are this rank's columns, so the heads are its own: its q heads
    and the KV heads its pools hold (k/v columns cut finer than those are
    gathered over 'model' first)."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    hq, hkv = cfg.num_heads, cfg.num_kv_heads
    tp = runtime_context.serve_shard()
    if tp is not None:
        k, v = tp.kv_columns(k), tp.kv_columns(v)
        hq, hkv = tp.q_heads[1], tp.kv_heads[1]
    q = q.reshape(b, s, hq, cfg.head_dim)
    k = k.reshape(b, s, hkv, cfg.head_dim)
    v = v.reshape(b, s, hkv, cfg.head_dim)
    return q, k, v


def _attn_out(p: Dict, o: torch.Tensor, own: bool = False) -> torch.Tensor:
    """The output projection of the attention output o (B, S, H, D); on a
    tensor-parallel serving forward, of this rank's heads through its rows
    of ``wo``, summed over the head axes (``own``: o holds exactly this
    rank's heads already)."""
    b, sq = o.shape[0], o.shape[1]
    tp = runtime_context.serve_shard()
    if tp is None:
        return o.reshape(b, sq, -1) @ p["wo"]
    if not own:
        o = tp.own_heads(o)
    return tp.reduce_attn(o.reshape(b, sq, -1) @ p["wo"])


def _project_local(cfg: ModelConfig, p: Dict, x: torch.Tensor, tp
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q of this rank's heads (B, S, Hq_local, D) and k, v of every KV
    head (B, S, Hkv, D): the dense-cache forward of a serving plan (its
    cache holds a span of positions with every KV head)."""
    b, s, _ = x.shape
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(b, s, tp.q_heads[1], cfg.head_dim),
            tp.kv_all(k).reshape(b, s, cfg.num_kv_heads, cfg.head_dim),
            tp.kv_all(v).reshape(b, s, cfg.num_kv_heads, cfg.head_dim))


def _heads_attention(tp, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     **kw) -> torch.Tensor:
    """``attention`` of this rank's q heads (B, S, Hq_local, D) against
    every KV head (B, Sk, Hkv, D): the KV heads of their groups where the
    rank's heads are whole groups (or lie in one), else its heads padded
    to all heads. Returns the rank's heads' outputs."""
    kv = tp.kv_span()
    if kv is not None:
        k0, kn = kv
        return attention(q, k[:, :, k0:k0 + kn], v[:, :, k0:k0 + kn], **kw)
    return tp.take_heads(attention(tp.pad_heads(q), k, v, **kw))


def _self_attn_plan(cfg: ModelConfig, p: Dict, x: torch.Tensor, tp, *,
                    kind: str, mask_kind: str, positions: torch.Tensor,
                    decode: bool, dense: Optional[Tuple],
                    contiguous: Optional[bool]) -> torch.Tensor:
    """Self-attention over a dense cache (or none) on a serving plan: a
    context-parallel decode. The rank's cache holds its span of positions
    (``ServeShard.span`` of ``cache_len``, or of the ring's rows) with
    every KV head.

    - prefill (or no cache): the rank's q heads attend the whole prompt
      (K5 under ``attn_impl="pallas"``), and its span of the cache is
      filled from every KV head;
    - decode: the new K/V row is written by the rank whose span holds
      its slot (``pos``, or ``pos mod W`` in a ring), q is gathered to
      every head, each rank attends its span and the ranks' partials are
      merged (``ServeShard.combine``); where the cache does not split,
      every rank attends all of it (the plain path). The rank keeps its
      own heads for the row-parallel ``wo``."""
    q, k, v = _project_local(cfg, p, x, tp)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    ring = cfg.local_ring_kv and kind == LOCAL
    glen = min(tp.cache_len, cfg.sliding_window) if ring else tp.cache_len
    if dense is not None and decode:
        kc, vc, pos = dense
        pos = pos if isinstance(pos, int) else int(pos)
        ax, s0, n = tp.span(glen)
        j = (pos % glen if ring else pos) - s0
        if 0 <= j < n:
            kc[:, j] = k[:, 0].to(kc.dtype)
            vc[:, j] = v[:, 0].to(vc.dtype)
        qa = tp.gather_heads(q)
        if ring:
            out = ring_decode_attention(qa, kc, vc, pos=pos,
                                        softcap=cfg.attn_softcap,
                                        slots=(s0, glen), partial=bool(ax))
        else:
            out = decode_attention(qa, kc, vc, pos=pos, kind=mask_kind,
                                   window=cfg.sliding_window,
                                   softcap=cfg.attn_softcap, length=pos + 1,
                                   offset=s0, partial=bool(ax))
        o = tp.combine(*out, ax).to(q.dtype) if ax else out
        return _attn_out(p, tp.take_heads(o), own=True)
    if dense is not None:
        kc, vc, _ = dense
        _, s0, n = tp.span(glen)
        if ring:
            kc.copy_(fill_ring(k, glen)[:, s0:s0 + n])
            vc.copy_(fill_ring(v, glen)[:, s0:s0 + n])
        else:
            cnt = max(0, min(n, x.shape[1] - s0))
            kc[:, :cnt] = k[:, s0:s0 + cnt].to(kc.dtype)
            vc[:, :cnt] = v[:, s0:s0 + cnt].to(vc.dtype)
    o = _heads_attention(tp, q, k, v, pos_q=positions, pos_k=positions,
                         kind=mask_kind, window=cfg.sliding_window,
                         softcap=cfg.attn_softcap, impl=cfg.attn_impl,
                         chunk=cfg.attn_chunk, contiguous=contiguous)
    return _attn_out(p, o, own=True)


def _kv_write_index(positions: torch.Tensor, page_table: torch.Tensor,
                    page_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where each (slot, token) K/V row goes: flat (phys, off) over the
    B * S rows.

    The JAX package gathers an out-of-range sentinel for logical pages
    past the table width and lets the scatter drop the write; a dead
    decode slot sits at ``width * page_size`` for exactly that. A torch
    index_put raises (or device-asserts) on such an index, so those rows
    are routed to the scratch page instead: it is never handed out and
    every reader masks it, so a dead slot changes no page a request owns.
    No host sync; computed once per forward and shared by every layer.
    """
    width = page_table.shape[1]
    pos = positions.long()
    page = pos // page_size
    valid = (page >= 0) & (page < width)
    phys = torch.gather(page_table.long(), 1, page.clamp(0, width - 1))
    phys = torch.where(valid, phys, SCRATCH_PAGE)
    return phys.reshape(-1), (pos % page_size).reshape(-1)


def _self_attn(cfg: ModelConfig, p: Dict, x: torch.Tensor, *, kind: str,
               positions: torch.Tensor, paged: Optional[Tuple],
               decode: bool, dense: Optional[Tuple] = None,
               contiguous: Optional[bool] = None,
               tape: Optional[List] = None,
               bidir: bool = False) -> torch.Tensor:
    """Self-attention sub-layer (input already normed); ``bidir`` (the
    encoder's layers) masks nothing. On a tensor-parallel serving forward
    (``runtime_context.serve_shard``) it runs this rank's heads: the paged
    kernels take its q heads against the KV heads of its pools, and a
    chunk whose rows are split over 'data' gathers its new K/V rows first,
    so every data rank writes them all.

    ``paged`` is None for the dense paths, else (kp, vp, page_table,
    widx): this chunk's K/V are written into the pools in place, then
    attended through the decode kernel (``decode_step``) or the prefill
    kernel (``forward``, whatever the chunk length: a one-token chunk is
    still prefill). ``dense`` is None without a cache, else (k_cache,
    v_cache, pos) of this layer: a prefill (``pos`` None) writes K/V at
    [0, S) and attends as without a cache; a decode step writes at ``pos``
    and attends the cache. ``contiguous`` says whether ``positions`` is
    ``arange(S)`` (``attention``'s argument). ``tape`` (paged prefill
    only) gets this layer's post-rope queries and attention outputs, both
    (B, S, Hq, D), appended as a pair."""
    sq = x.shape[1]
    mask_kind = ("bidir" if bidir else
                 "local" if kind == LOCAL else "causal")
    tp = runtime_context.serve_shard()
    if tp is not None and paged is None:
        return _self_attn_plan(cfg, p, x, tp, kind=kind, mask_kind=mask_kind,
                               positions=positions, decode=decode,
                               dense=dense, contiguous=contiguous)
    q, k, v = _project_qkv(cfg, p, x)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if tp is not None:
        q = tp.attn_heads(q)
    if paged is None:
        ring = cfg.local_ring_kv and kind == LOCAL
        if dense is not None and decode:
            kc, vc, pos = dense
            w_pos = pos % kc.shape[1] if ring else pos
            kc[:, w_pos] = k[:, 0].to(kc.dtype)
            vc[:, w_pos] = v[:, 0].to(vc.dtype)
            if ring:
                o = ring_decode_attention(q, kc, vc, pos=pos,
                                          softcap=cfg.attn_softcap)
                return _attn_out(p, o)
            o = decode_attention(
                q, kc, vc, pos=pos, kind=mask_kind,
                window=cfg.sliding_window, softcap=cfg.attn_softcap,
                length=pos + 1 if isinstance(pos, int) else None)
            return _attn_out(p, o)
        if dense is not None and ring:                    # prefill fills it
            kc, vc, _ = dense
            kc.copy_(fill_ring(k, kc.shape[1]))
            vc.copy_(fill_ring(v, vc.shape[1]))
        elif dense is not None:
            kc, vc, _ = dense
            kc[:, :sq] = k.to(kc.dtype)
            vc[:, :sq] = v.to(vc.dtype)
        o = attention(q, k, v, pos_q=positions, pos_k=positions,
                      kind=mask_kind, window=cfg.sliding_window,
                      softcap=cfg.attn_softcap, impl=cfg.attn_impl,
                      chunk=cfg.attn_chunk, contiguous=contiguous)
        return _attn_out(p, o)
    kp, vp, page_table, (phys, off) = paged
    if tp is not None:                   # every data rank writes every row
        k, v = tp.all_rows(k), tp.all_rows(v)
    kp[phys, off] = k.reshape((-1,) + k.shape[2:]).to(kp.dtype)
    vp[phys, off] = v.reshape((-1,) + v.shape[2:]).to(vp.dtype)
    if decode:
        o = paged_decode(q, kp, vp, page_table, positions[:, 0] + 1,
                         kind=mask_kind, window=cfg.sliding_window,
                         softcap=cfg.attn_softcap, impl=cfg.paged_attn_impl)
        if MOE in cfg.ffn_pattern:
            # a dead slot (decoding PAD past its table) gets what the
            # backend leaves there: zeros from K3, its stale pages from the
            # twin and "gather". Its row shares the MoE's capacity with the
            # live slots, so it is zeroed here: live tokens never depend on
            # the backend's dead rows (ROADMAP queue 3)
            dead = positions[:, 0] >= page_table.shape[1] * kp.shape[1]
            o = o.masked_fill(dead[:, None, None, None], 0)
    else:                                                 # chunked prefill
        o = paged_prefill(q, kp, vp, page_table, positions,
                          kind=mask_kind, window=cfg.sliding_window,
                          softcap=cfg.attn_softcap, impl=cfg.paged_attn_impl,
                          attn_impl=cfg.attn_impl, chunk=cfg.attn_chunk)
        if tape is not None:
            tape.append((q, o))
    return _attn_out(p, o)


def _cross_attn(cfg: ModelConfig, p: Dict, x: torch.Tensor, *,
                memory: Optional[torch.Tensor],
                mem: Optional[Tuple[torch.Tensor, torch.Tensor]]
                ) -> torch.Tensor:
    """Cross-attention sub-layer (input already normed) to a modality or
    encoder memory: the keys and values are ``mem`` (this layer's
    (k_mem, v_mem) of a cache from ``init_cache``) when given, else
    projected from ``memory`` (B, M, d). Every query attends every memory
    row, with no positions ("bidir" over zeros, as in the JAX package),
    so the call tells ``attention`` that the layout is contiguous: under
    ``attn_impl="pallas"`` it launches K5 non-causal at Sq != Sk instead
    of checking zeros that are not ``arange`` and falling back."""
    b, sq, _ = x.shape
    tp = runtime_context.serve_shard()
    if tp is not None:
        return _cross_attn_plan(cfg, p, x, tp, memory=memory, mem=mem)
    q = (x @ p["wq"]).reshape(b, sq, cfg.num_heads, cfg.head_dim)
    if mem is not None:
        k, v = mem
    elif memory is None:
        raise ValueError(f"{cfg.name}: cross-attention needs memory= (or a "
                         "cache from init_cache(memory=...))")
    else:
        m = memory.shape[1]
        k = (memory @ p["wk"]).reshape(b, m, cfg.num_kv_heads, cfg.head_dim)
        v = (memory @ p["wv"]).reshape(b, m, cfg.num_kv_heads, cfg.head_dim)
    zeros = torch.zeros((b, 1), dtype=torch.long, device=x.device)
    o = attention(q, k, v, pos_q=zeros.expand(b, sq),
                  pos_k=zeros.expand(b, k.shape[1]), kind="bidir",
                  impl=cfg.attn_impl, chunk=cfg.attn_chunk, contiguous=True)
    return o.reshape(b, sq, -1) @ p["wo"]


def _cross_attn_plan(cfg: ModelConfig, p: Dict, x: torch.Tensor, tp, *,
                     memory: Optional[torch.Tensor],
                     mem: Optional[Tuple[torch.Tensor, torch.Tensor]]
                     ) -> torch.Tensor:
    """Cross-attention on a serving plan, from this rank's q heads. A
    cached memory holds the rank's span of its rows (``span`` of
    ``mem_len``) with every KV head: a decode step attends its rows with
    every head and merges the ranks' partials; a prefill gathers the rows
    and runs K5 (under ``attn_impl="pallas"``) on its heads. A memory that
    does not split (every rank holds every row), or one projected here,
    takes K5 on the rank's heads with no merge."""
    b, sq, _ = x.shape
    q = (x @ p["wq"]).reshape(b, sq, tp.q_heads[1], cfg.head_dim)
    if mem is not None:
        k, v = mem
        ax, _, _ = tp.span(tp.mem_len)
        if ax and sq == 1:
            o = tp.combine(*memory_attention(tp.gather_heads(q), k, v), ax)
            return _attn_out(p, tp.take_heads(o.to(q.dtype)), own=True)
        k, v = tp.gather(k, ax, 1), tp.gather(v, ax, 1)
    elif memory is None:
        raise ValueError(f"{cfg.name}: cross-attention needs memory= (or a "
                         "cache from init_cache(memory=...))")
    else:
        m = memory.shape[1]
        k = tp.kv_all(memory @ p["wk"]).reshape(b, m, cfg.num_kv_heads,
                                                cfg.head_dim)
        v = tp.kv_all(memory @ p["wv"]).reshape(b, m, cfg.num_kv_heads,
                                                cfg.head_dim)
    zeros = torch.zeros((b, 1), dtype=torch.long, device=x.device)
    o = _heads_attention(tp, q, k, v, pos_q=zeros.expand(b, sq),
                         pos_k=zeros.expand(b, k.shape[1]), kind="bidir",
                         impl=cfg.attn_impl, chunk=cfg.attn_chunk,
                         contiguous=True)
    return _attn_out(p, o, own=True)


def _aux_init(cfg: ModelConfig, device: torch.device
              ) -> Dict[str, torch.Tensor]:
    if MOE in cfg.ffn_pattern:
        return {k: torch.zeros((), dtype=torch.float32, device=device)
                for k in ("moe_load_balance", "moe_z_loss", "moe_drop_frac")}
    return {}


def _apply_layer(cfg: ModelConfig, kind: str, ffn_kind: str, p: Dict,
                 x: torch.Tensor, *, positions, paged: Optional[Tuple],
                 decode: bool, dense: Union[None, Tuple, Dict] = None,
                 contiguous: Optional[bool] = None,
                 tape: Optional[List] = None,
                 aux: Optional[Dict[str, torch.Tensor]] = None,
                 memory: Optional[torch.Tensor] = None,
                 mem: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                 encoder: bool = False) -> torch.Tensor:
    """One layer. ``dense`` is this layer's part of a dense cache: (k, v,
    pos) of a self-attention layer, the ``{"conv", "ssm"}`` of a Mamba2
    layer; ``mem`` its cached memory (k_mem, v_mem), if any, and
    ``memory`` the memory its cross-attention projects otherwise. An
    ``encoder`` layer is bidirectional self-attention + MLP. A MoE layer
    adds its router metrics to ``aux`` (from ``_aux_init``) in place."""
    if kind not in (ATTN, LOCAL, CROSS, MAMBA) or \
            ffn_kind not in (MLP, MOE, NONE):
        raise ValueError(f"unknown layer ({kind!r}, {ffn_kind!r})")
    h = rmsnorm(x, p["norm"], cfg.norm_eps)
    if kind == MAMBA:
        x = x + mamba_block(cfg, p["mamba"], h, cache=dense, decode=decode)
    elif kind == CROSS:
        x = x + _cross_attn(cfg, p["attn"], h, memory=memory, mem=mem)
    else:
        x = x + _self_attn(cfg, p["attn"], h, kind=kind, positions=positions,
                           paged=paged, decode=decode, dense=dense,
                           contiguous=contiguous, tape=tape, bidir=encoder)
        if cfg.is_encdec and not encoder:                # whisper decoder
            h = rmsnorm(x, p["cross_norm"], cfg.norm_eps)
            x = x + _cross_attn(cfg, p["cross"], h, memory=memory, mem=mem)
    if ffn_kind == MLP:
        x = x + swiglu(rmsnorm(x, p["ffn_norm"], cfg.norm_eps), p["mlp"])
    elif ffn_kind == MOE:
        ffn = moe_ffn if cfg.moe_ep is None else moe_ffn_ep
        y, a = ffn(cfg, p["moe"], rmsnorm(x, p["ffn_norm"], cfg.norm_eps))
        for k, v in a.items():
            aux[k] = aux[k] + v
        x = x + y
    return x


# cache layouts: layer kind -> (key of its cache dict, leaves it holds)
_DENSE = {ATTN: ("self", ("k", "v")), LOCAL: ("self", ("k", "v")),
          MAMBA: ("ssm_c", ("conv", "ssm")), CROSS: ("mem", ("k_mem", "v_mem"))}
_PAGED = {ATTN: ("self", ("kp", "vp")), LOCAL: ("self", ("kp", "vp"))}


def _has_leaves(cfg: ModelConfig, cache: Optional[Dict],
                layout: Dict[str, Tuple[str, Tuple[str, ...]]]) -> bool:
    """True when every layer of the pattern has its leaves of ``layout``
    in ``cache`` (a layer kind the layout lacks never does)."""
    if not isinstance(cache, dict):
        return False
    for i, kind in enumerate(cfg.block_pattern):
        if kind not in layout:
            return False
        key, names = layout[kind]
        lc = cache.get(f"layer_{i}", {}).get(key)
        if not isinstance(lc, dict) or any(n not in lc for n in names):
            return False
    return True


def _is_paged(cfg: ModelConfig, cache: Optional[Dict]) -> bool:
    return _has_leaves(cfg, cache, _PAGED)


_CACHE_KINDS = ("a cache is the page pools of "
                "repro_torch.sampling.paged_cache (with a page_table) or the "
                "dense KV cache of init_cache (without one)")


def _run_dense(cfg: ModelConfig, params: Dict, x: torch.Tensor, *,
               positions: torch.Tensor, contiguous: Optional[bool],
               cache: Optional[Dict] = None,
               pos: Union[None, int, torch.Tensor] = None,
               memory: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Full-sequence layers (``pos`` None) or one decode step at ``pos``
    over a dense ``cache``; returns (x, aux). Without a cache, one
    checkpointed block at a time under ``cfg.remat`` while autograd
    records (``jax.checkpoint(body)``); the block takes the running aux
    sums and returns them, so its recomputation in the backward adds
    nothing twice."""
    if cache is not None and not _has_leaves(cfg, cache, _DENSE):
        raise ValueError(_CACHE_KINDS)
    decode = pos is not None

    def block(x: torch.Tensor, bp: Dict, bc, aux: Dict[str, torch.Tensor],
              memory: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        aux = dict(aux)
        for i, kind in enumerate(cfg.block_pattern):
            dense, mem = (None, None) if bc is None else bc[i]
            x = _apply_layer(cfg, kind, cfg.ffn_kind(i), bp[f"layer_{i}"], x,
                             positions=positions, paged=None, decode=decode,
                             dense=dense, contiguous=contiguous, aux=aux,
                             memory=memory, mem=mem)
        return x, aux

    def layer_views(bi: int, i: int, kind: str):
        """Block ``bi`` of layer slot ``i``'s stacked cache, as
        ``_apply_layer`` takes it: ((k, v, pos) views, the Mamba2 dict or
        None; the (k_mem, v_mem) views or None)."""
        lc = cache[f"layer_{i}"]
        mem = lc.get("mem")
        mem = None if mem is None else (mem["k_mem"][bi], mem["v_mem"][bi])
        if kind == CROSS:
            return None, mem
        key, names = _DENSE[kind]
        if kind == MAMBA:
            return {n: lc[key][n][bi] for n in names}, mem
        return tuple(lc[key][n][bi] for n in names) + (pos,), mem

    remat = cfg.remat and torch.is_grad_enabled() and cache is None
    aux = _aux_init(cfg, x.device)
    for bi, bp in enumerate(_unstack(params["blocks"], cfg.num_blocks)):
        bc = None if cache is None else [
            layer_views(bi, i, kind)
            for i, kind in enumerate(cfg.block_pattern)]
        if remat:
            x, aux = torch.utils.checkpoint.checkpoint(
                block, x, bp, bc, aux, memory, use_reentrant=False)
        else:
            x, aux = block(x, bp, bc, aux, memory)
    return x, aux


def _run_paged(cfg: ModelConfig, params: Dict, x: torch.Tensor, *,
               positions: torch.Tensor, cache: Optional[Dict],
               page_table: Optional[torch.Tensor],
               decode: bool, tape: Optional[List] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The layers over page pools; returns (x, aux). With ``tape``
    (prefill only) every layer appends its (q, o) pair, block-major: layer
    ``bi * period + i`` is pattern slot ``i`` of block ``bi``, the order
    the block-stacked pools fold in (``sampling.spec.stacked_pools``)."""
    if not _is_paged(cfg, cache) or page_table is None:
        raise ValueError(_CACHE_KINDS)
    page_size = cache["layer_0"]["self"]["kp"].shape[2]
    # every row's write index; a serving forward whose rows are split
    # over 'data' attends its own rows (``x`` holds them already)
    widx = _kv_write_index(positions, page_table, page_size)
    positions, page_table = _rows(positions), _rows(page_table)
    blocks = _unstack(params["blocks"], cfg.num_blocks)
    pools = [(list(torch.unbind(cache[f"layer_{i}"]["self"]["kp"], 0)),
              list(torch.unbind(cache[f"layer_{i}"]["self"]["vp"], 0)))
             for i in range(cfg.period)]
    aux = _aux_init(cfg, x.device)
    for bi in range(cfg.num_blocks):
        for i, kind in enumerate(cfg.block_pattern):
            paged = (pools[i][0][bi], pools[i][1][bi], page_table, widx)
            x = _apply_layer(cfg, kind, cfg.ffn_kind(i),
                             blocks[bi][f"layer_{i}"], x,
                             positions=positions, paged=paged, decode=decode,
                             tape=tape, aux=aux)
    return x, aux


def _embed(cfg: ModelConfig, params: Dict, tokens: torch.Tensor
           ) -> torch.Tensor:
    tp = runtime_context.serve_shard()
    x = params["embed"][tokens] if tp is None else \
        tp.embed(params["embed"], tokens)
    if cfg.scale_embed:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits(cfg: ModelConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = (x @ head).float()
    tp = runtime_context.serve_shard()
    if tp is not None:                   # this rank's vocab columns
        logits = tp.gather_vocab(logits)
    if cfg.final_softcap is not None and torch.is_grad_enabled():
        logits = softcap(logits, cfg.final_softcap)
    elif cfg.final_softcap is not None:
        # the same ops in place on the fresh (B, S, V) float32 logits: no
        # three more of them alive at once (a Gemma2-9B forward at 8192
        # tokens holds 8.4 GB of logits)
        cap = cfg.final_softcap
        logits = logits.div_(cap).tanh_().mul_(cap)
    return logits


def _encoder_layer(cfg: ModelConfig, p: Dict, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    return _apply_layer(cfg, ATTN, MLP, p, x, positions=positions,
                        paged=None, decode=False, contiguous=True,
                        encoder=True)


def encode(cfg: ModelConfig, params: Dict, frames: torch.Tensor
           ) -> torch.Tensor:
    """The encoder of an encoder-decoder model (Whisper) over stub frame
    embeddings (B, S_enc, d): ``encoder_layers`` layers of bidirectional
    self-attention at positions ``arange(S_enc)`` (K5 non-causal under
    ``attn_impl="pallas"``) and an MLP, then the encoder's final norm.
    Returns the memory (B, S_enc, d) the decoder cross-attends to. Under
    ``cfg.remat`` (and autograd recording) each layer runs under
    ``torch.utils.checkpoint``, as the JAX package checkpoints its
    encoder scan body."""
    if not cfg.is_encdec:
        raise ValueError(f"{cfg.name} has no encoder (encoder_layers 0)")
    b, s, _ = frames.shape
    positions = torch.arange(s, device=frames.device).expand(b, s)
    enc = params["encoder"]
    remat = cfg.remat and torch.is_grad_enabled()
    x = frames
    for lp in _unstack(enc["blocks"], cfg.encoder_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                _encoder_layer, cfg, lp, x, positions, use_reentrant=False)
        else:
            x = _encoder_layer(cfg, lp, x, positions)
    return rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def forward(cfg: ModelConfig, params: Dict, tokens: torch.Tensor, *,
            memory: Optional[torch.Tensor] = None,
            positions: Optional[torch.Tensor] = None,
            cache: Optional[Dict] = None,
            page_table: Optional[torch.Tensor] = None,
            record_queries: bool = False,
            last_only: bool = False,
            ) -> Tuple[torch.Tensor, Optional[Dict], Dict]:
    """Full-sequence forward. tokens (B, S) at ``positions`` (B, S)
    (default ``arange(S)``). Without ``page_table`` the dense path
    (training, teacher forcing), which with a dense ``cache`` from
    ``init_cache`` also writes the K/V of positions [0, S) into it (the
    static engine's prefill); with page pools and ``page_table`` a chunked
    prefill whose K/V are written into the pools. Caches are written in
    place. Returns (logits (B, S, V_padded) f32, cache, aux). ``memory``
    (B, M, d) is what the cross-attention of a CROSS or encoder-decoder
    model attends, unless ``cache`` holds its projections already.

    ``record_queries`` (paged prefill only) puts ``q_tape`` and ``o_tape``
    in ``aux``: every layer's post-rope queries and attention outputs,
    (L, B, S, Hq, D) block-major, so a speculative verifier can replay all
    layers' attention through one ``paged_prefill_layers`` launch. A
    config with MoE layers puts the sums over layers of their router
    metrics in ``aux`` (``moe_load_balance``, ``moe_z_loss``,
    ``moe_drop_frac``); otherwise ``aux`` holds no more. ``last_only``
    returns the logits of the last position alone (B, 1, V_padded): an
    engine's prefill draws from them, and the head (and, on a plan, the
    logits' gather over the vocab) then runs on one row, not S."""
    b, s = tokens.shape
    contiguous = positions is None
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    elif cfg.attn_impl == "pallas" and page_table is None:
        contiguous = standard_positions(positions)   # once, not per layer
    x = _embed(cfg, params, _rows(tokens))
    if page_table is None and not _is_paged(cfg, cache):
        if record_queries:
            raise ValueError(
                f"record_queries needs every layer on the paged attention "
                f"path; layer kind {cfg.block_pattern[0]!r} is not")
        x, aux = _run_dense(cfg, params, x, positions=positions,
                            contiguous=contiguous, cache=cache,
                            memory=memory)
    else:
        tape: Optional[List] = [] if record_queries else None
        x, aux = _run_paged(cfg, params, x, positions=positions, cache=cache,
                            page_table=page_table, decode=False, tape=tape)
        if tape is not None:
            aux["q_tape"] = torch.stack([q for q, _ in tape])
            aux["o_tape"] = torch.stack([o for _, o in tape])
    if last_only:
        x = x[:, -1:]
    return _logits(cfg, params, x), cache, aux


def decode_step(cfg: ModelConfig, params: Dict, cache: Dict,
                token: torch.Tensor, pos: Union[int, torch.Tensor], *,
                memory: Optional[torch.Tensor] = None,
                page_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step. token (B,). Over a paged cache (with
    ``page_table``) ``pos`` is a scalar or a (B,) vector of write
    positions; over a dense cache it is one position shared by the batch
    (an int or a 0-d tensor), as the dense layout has one write column.
    Cross-attention reads the memory's keys and values from the cache
    (``init_cache(memory=)``), or projects ``memory`` when the cache has
    none. Returns (logits (B, V_padded) f32, cache)."""
    b = token.shape[0]
    x = _embed(cfg, params, _rows(token)[:, None])
    if page_table is None and not _is_paged(cfg, cache):
        if isinstance(pos, int):
            positions = torch.full((b, 1), pos, dtype=torch.int64,
                                   device=token.device)
        elif pos.dim() == 0:
            positions = pos.to(torch.int64).expand(b)[:, None]
        else:
            raise ValueError(f"a dense cache decodes at one position shared "
                             f"by the batch, got pos of shape "
                             f"{tuple(pos.shape)}")
        x, _ = _run_dense(cfg, params, x, positions=positions,
                          contiguous=None, cache=cache, pos=pos,
                          memory=memory)
        return _logits(cfg, params, x)[:, 0], cache
    pos = torch.as_tensor(pos, device=token.device)
    if pos.dim() == 0:
        positions = pos.to(torch.int64).expand(b)[:, None]
    else:
        positions = pos.to(torch.int64)[:, None]
    x, _ = _run_paged(cfg, params, x, positions=positions, cache=cache,
                      page_table=page_table, decode=True)
    return _logits(cfg, params, x)[:, 0], cache


def init_cache(cfg: ModelConfig, params: Dict, batch: int, max_len: int,
               *, memory: Optional[torch.Tensor] = None) -> Dict:
    """The dense decode cache, zeros on the params' device in the JAX
    layout, stacked on the block axis: ``cache["layer_i"]["self"]["k" |
    "v"]`` (nb, batch, max_len, Hkv, D) in ``cfg.dtype`` for a
    self-attention layer; ``cache["layer_i"]["ssm_c"]`` for a Mamba2
    layer, ``"conv"`` (nb, batch, K - 1, conv channels) in ``cfg.dtype``
    and ``"ssm"`` (nb, batch, H, P, N) in float32. With
    ``cfg.local_ring_kv`` a local layer's k/v hold ``min(max_len,
    sliding_window)`` rows, a ring. A CROSS layer, and every decoder layer
    of an encoder-decoder model, holds ``cache["layer_i"]["mem"]["k_mem" |
    "v_mem"]`` (nb, batch, M, Hkv, D) in ``cfg.dtype``: ``memory`` (batch,
    M, d) projected once here through its cross-attention's wk / wv.

    Under a serving plan's shard (``runtime_context.serve_shard``, set
    with ``ServeShard.with_cache``) the cache is this rank's part, as the
    plan's fitted ``cache_specs`` cut it: ``batch`` is the rank's rows,
    and each self-attention layer holds its span of the ``max_len``
    positions (or of the ring's rows), a memory its span of the M rows,
    both with every KV head; a Mamba2 layer its conv channels and SSM
    heads."""
    dt = getattr(torch, cfg.dtype)
    dev = params["embed"].device
    cache: Dict[str, Any] = {}
    nb = cfg.num_blocks
    tp = runtime_context.serve_shard()

    def mem_kv(i: int) -> Dict[str, torch.Tensor]:
        if memory is None:
            raise ValueError(f"{cfg.name}: a cross-attention layer's cache "
                             "needs memory=")
        if memory.shape[0] != batch:
            raise ValueError(f"memory batch {memory.shape[0]} != cache "
                             f"batch {batch}")
        w = params["blocks"][f"layer_{i}"]["cross" if cfg.is_encdec
                                           else "attn"]
        m = memory.shape[1]

        def proj(wt: torch.Tensor) -> torch.Tensor:
            kv = torch.einsum("bmd,ndh->nbmh", memory, wt)
            if tp is not None:                    # every KV head, its rows
                _, r0, rn = tp.span(m)
                kv = tp.kv_all(kv)[:, :, r0:r0 + rn]
            return kv.reshape(nb, batch, kv.shape[2], cfg.num_kv_heads,
                              cfg.head_dim).to(dt)
        return {"k_mem": proj(w["wk"]), "v_mem": proj(w["wv"])}

    for i, kind in enumerate(cfg.block_pattern):
        if kind == MAMBA:
            conv_ch = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
            heads = cfg.ssm_heads
            if tp is not None:                # its channels and heads
                conv_ch, heads = tp.ssm.conv[1], tp.ssm.heads[1]
            cache[f"layer_{i}"] = {"ssm_c": {
                "conv": torch.zeros((nb, batch, cfg.ssm_conv - 1, conv_ch),
                                    dtype=dt, device=dev),
                "ssm": torch.zeros((nb, batch, heads,
                                    cfg.ssm_headdim, cfg.ssm_state),
                                   dtype=torch.float32, device=dev)}}
            continue
        if kind == CROSS:
            cache[f"layer_{i}"] = {"mem": mem_kv(i)}
            continue
        rows = max_len
        if cfg.local_ring_kv and kind == LOCAL:
            rows = min(max_len, cfg.sliding_window)
        if tp is not None:                    # its span of positions
            rows = tp.span(rows)[2]
        shape = (nb, batch, rows, cfg.num_kv_heads, cfg.head_dim)
        cache[f"layer_{i}"] = {"self": {
            n: torch.zeros(shape, dtype=dt, device=dev) for n in ("k", "v")}}
        if cfg.is_encdec:
            cache[f"layer_{i}"]["mem"] = mem_kv(i)
    return cache
