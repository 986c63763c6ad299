"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The port of ``repro/models/moe.py::moe_ffn``. Tokens are routed top-k
(router in float32), sorted by expert id, placed into a dense (E, C, d)
buffer (capacity C per expert, overflow dropped, Switch-style), run
through batched expert matmuls and gathered and combined back. The JAX
package computes the expert products outside any Pallas kernel, so they
are ``torch.bmm`` here: the MoE adds no kernel.

Where a literal transcription of the reference goes wrong:

- ``jnp.argsort`` is stable and decides which tokens are dropped; the
  sort here is ``stable=True`` too.
- ``jax.lax.top_k`` breaks ties toward the lower expert id; the selection
  here is a stable descending sort, which keeps that order.
- ``out_buf[sorted_ids, rank]`` reads rank >= C out of range, which JAX
  clamps and torch refuses: the rank is clamped, then multiplied by
  ``keep``, as the reference's product does.
- The reference scatters every dropped entry as a zero row onto the slot
  (E-1, C-1) with ``mode="drop"``. That slot is real (the last kept token
  of expert E-1), so when expert E-1 overflows, the later zero writes win
  on XLA's CPU scatter and that kept token is zeroed as well (on a TPU
  the order of duplicate writes is unspecified). Here only the kept
  entries are written, so exactly the entries of rank >= C are dropped,
  which is what ``moe_drop_frac`` reports (ROADMAP queue 3).

C = max(int(T k / E * capacity_factor), 4) depends on the token count T
of the forward, so the callers feed the MoE the reference's token counts:
every slot of a decode step, a prefill chunk, the padded verify window, a
learner microbatch. Nothing here reads back to the host.

On a serving plan (``runtime_context.serve_shard`` with an expert split)
the layer keeps the reference's GSPMD semantics, a global dispatch: the
rows a rank was given (its decode slots, or the static engine's rows) are
gathered over the data axes, all T tokens are routed with the replicated
router and dispatched at the global capacity, and the rank runs its
experts (``ServeShard.experts``, over 'model') on its FFN columns
(``expert_ffn``, over 'data'). ``silu(x Wg) * (x Wu)`` is columnwise, so
a rank's columns give its columns of ``h`` and its rows of ``w_down`` a
partial output; the partials are summed over both axes and the rank
keeps its rows. The same tokens drop as on one device, and the router
metrics are the global batch's.
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import runtime_context
from repro_torch.config import ModelConfig
from repro_torch.models.layers import swiglu
from repro_torch.parallel.collectives import gather_rows, own_rows

if TYPE_CHECKING:
    from repro_torch.parallel.plan import ServeShard


def route(cfg: ModelConfig, router: torch.Tensor, xf: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Router of T tokens (T, d): (logits (T, E) f32, probs (T, E) f32,
    gate (T, k) f32, ids (T, k)); the k largest probabilities, ties to
    the lower expert id as ``jax.lax.top_k``; gates renormalised for
    k > 1."""
    k = cfg.experts_per_token
    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]
    if k > 1:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return logits, probs, gate, ids


def dispatch(cfg: ModelConfig, ids: torch.Tensor
             ) -> Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor, torch.Tensor]:
    """Capacity dispatch of the routed ids (T, k): (cap, order, sorted_ids,
    rank, keep, counts), each over the T k entries in expert-sorted order
    (stable: within an expert, token order), ``rank`` an entry's place in
    its expert's segment, ``keep`` rank < cap, ``counts`` (E,) the entries
    routed to each expert."""
    e = cfg.num_experts
    t, k = ids.shape
    cap = max(int(t * k / e * cfg.capacity_factor), 4)
    flat_ids = ids.reshape(-1)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    # segment starts from the per-expert counts (scatter_add: no host
    # read, which bincount's output size would need on the card)
    counts = torch.zeros(e, dtype=torch.long, device=ids.device)
    counts.scatter_add_(0, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(t * k, device=ids.device) - starts[sorted_ids]
    return cap, order, sorted_ids, rank, rank < cap, counts


def moe_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B, S, d) -> (y (B, S, d), aux metrics): ``moe_load_balance``
    (Switch), ``moe_z_loss`` (router z-loss) and ``moe_drop_frac``, 0-dim
    float32 tensors, for logging.

    Under a live mesh whose rows are split (the sharded step registers
    it, ``runtime_context``), ``x`` is this rank's rows. The reference's
    dispatch is global, its capacity a function of all T tokens, so the
    rows of every rank are gathered over the row axes (autograd-aware),
    dispatched as one batch, and this rank's rows kept: the same tokens
    drop as on one device, and the router metrics are the global
    batch's. On a serving plan's expert split, see the module note."""
    tp = runtime_context.serve_shard()
    if tp is not None and tp.experts is not None:
        rows = tp.token_rows
        y, aux = _moe_ffn(cfg, p, tp.gather(x, rows, 0), tp)
        return own_rows(y, tp.mesh, rows), aux
    mesh, rows = runtime_context.active_mesh(), runtime_context.row_axes()
    if mesh is not None and rows:
        y, aux = _moe_ffn(cfg, p, gather_rows(x, mesh, rows))
        return own_rows(y, mesh, rows), aux
    return _moe_ffn(cfg, p, x)


def _moe_ffn(cfg: ModelConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
             tp: Optional["ServeShard"] = None
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    xf = x.reshape(t, d)
    logits, probs, gate, ids = route(cfg, p["router"], xf)
    cap, order, sorted_ids, rank, keep, counts = dispatch(cfg, ids)
    tok_of = order // k

    # kept entries to their (expert, rank) row; dropped ones to one spare
    # row past the buffer, cut off before the expert products
    slot = torch.where(keep, sorted_ids * cap + rank, e * cap)
    buf = xf.new_zeros((e * cap + 1, d)).index_copy(0, slot, xf[tok_of])
    buf = buf[:e * cap].reshape(e, cap, d)

    # batched expert MLPs: (E, C, d) x (E, d, f) -> (E, C, f); on a
    # serving plan the rank's experts on its columns, a partial output
    e0, en = (0, e) if tp is None else tp.experts
    part = buf[e0:e0 + en]
    h = F.silu(torch.bmm(part, p["w_gate"])) * torch.bmm(part, p["w_up"])
    out_buf = torch.bmm(h, p["w_down"])                       # (E, C, d)
    if en != e:
        out_buf = buf.new_zeros((e, cap, d)).index_copy(
            0, torch.arange(e0, e0 + en, device=x.device), out_buf)

    y_sorted = (out_buf[sorted_ids, rank.clamp(max=cap - 1)]
                * keep[:, None].to(x.dtype))                   # (T k, d)
    y_flat = y_sorted.new_zeros((t * k, d)).index_copy(0, order, y_sorted)
    y = (y_flat.reshape(t, k, d) * gate[..., None].to(x.dtype)).sum(dim=1)
    if tp is not None:                   # the partials over both splits
        y = tp.reduce(y, tp.moe_axes)

    if cfg.shared_expert:
        y = y + swiglu(xf, p["shared"])

    # aux metrics (Switch-style load balance + z-loss)
    me = probs.mean(dim=0)                                    # (E,)
    ce = counts.float() / (t * k)
    aux = {
        "moe_load_balance": e * torch.sum(me * ce),
        "moe_z_loss": torch.mean(torch.logsumexp(logits, dim=-1) ** 2),
        "moe_drop_frac": 1.0 - keep.float().mean(),
    }
    return y.reshape(b, s, d), aux


__all__ = ["dispatch", "moe_ffn", "route"]
