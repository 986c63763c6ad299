"""Expert-parallel MoE over the mesh's 'model' axis (the port of
``repro/models/moe_ep.py``).

Layout, as in the JAX package's ``shard_map`` version:

- tokens stay split over the data axes (each rank's own rows),
  replicated over 'model';
- experts are split over 'model': model rank m computes experts
  [m E/M, (m+1) E/M) on its rows, each with a per-shard capacity
  ``max(int(t_loc k / E * capacity_factor), 4)``, the routed rows first
  by a stable sort (``jnp.argsort`` is stable), and one all-reduce over
  'model' combines the experts' outputs (Megatron's row-parallel sum);
- the router metrics are averaged over 'model' and then over the data
  axes, as the reference's ``pmean`` chain does (so ``moe_drop_frac`` is
  the mean over model ranks of each rank's drops over t_loc k).

In the learner (``moe_ep="train"``) the weights arrive whole: the
sharded step gathers the param tree before the forward, so the
reference's in-shard gather of the expert weights over a data axis (dim
1 in ``train`` mode) is that tree gather here; a per-layer gather of a
rank's own experts is ROADMAP queue 2. On a serving plan
(``moe_ep="serve"``, ``runtime_context.serve_shard``) the weights are the
rank's shards, its experts with their FFN columns cut over 'data'
(``(E_loc, d, f/D)`` and ``(E_loc, f/D, d)``), and the layer gathers the
columns over 'data' (dims 2 and 1), as the reference does; the rows are
those the forward was given (``ServeShard.token_rows``), cut over the
config's ``ep_dp_axes`` where they divide the batch, as the reference's
``shard_map`` cuts them. It is forward-only there. In the learner the
backward is exact on every rank: the rows and the router pass through
``copy_to`` (their gradients summed over 'model'), a rank's experts
through ``slice_from`` (each expert's gradient from its rank), so every
model rank ends with the same full gradient.

The expert products are plain ``torch`` matmuls, as the reference's are
outside any Pallas kernel: the MoE adds no kernel. Requires a live mesh
registered with ``runtime_context.mesh_context`` (the sharded step, or a
caller that runs the layer alone).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import runtime_context
from repro_torch.config import ModelConfig
from repro_torch.models.layers import swiglu
from repro_torch.models.moe import route

if TYPE_CHECKING:
    from repro_torch.parallel.plan import ServeShard


def moe_ffn_ep(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B_loc, S, d), this rank's rows -> (y (B_loc, S, d), aux)."""
    tp = runtime_context.serve_shard()
    if tp is not None:
        return _moe_ffn_ep_serve(cfg, p, x, tp)
    from repro_torch.parallel.collectives import (copy_to, reduce_from,
                                                  slice_from)
    mesh = runtime_context.get_mesh()
    if not mesh.live:
        raise RuntimeError("moe_ep needs a live mesh (runtime_context); "
                           "the local plan runs models/moe.py")
    e = cfg.num_experts
    tp = ("model",)
    if e % mesh.shape["model"]:
        raise ValueError(f"{e} experts do not split over model="
                         f"{mesh.shape['model']}")
    # the axes the rows are split over: the step's, else the config's
    dp = runtime_context.row_axes() or tuple(cfg.ep_dp_axes or ())
    b, s, d = x.shape
    t = b * s
    xf = copy_to(x.reshape(t, d), mesh, tp)
    router = copy_to(p["router"], mesh, tp)
    w_gate = slice_from(p["w_gate"], mesh, tp)           # (E_loc, d, f)
    w_up = slice_from(p["w_up"], mesh, tp)
    w_down = slice_from(p["w_down"], mesh, tp)           # (E_loc, f, d)
    e_loc = w_gate.shape[0]
    lo = mesh.axis_index(tp) * e_loc

    logits, probs, gate, ids = route(cfg, router, xf)
    y, drop = _local_experts(cfg, xf, gate, ids, (w_gate, w_up, w_down), lo)
    y = reduce_from(y, mesh, tp)                          # combine experts
    aux = _metrics(cfg, logits, probs, ids, drop, mesh, tp, dp)
    y = y.reshape(b, s, d)
    if cfg.shared_expert:
        y = y + swiglu(x, p["shared"])
    return y, aux


def _local_experts(cfg: ModelConfig, xf: torch.Tensor, gate: torch.Tensor,
                   ids: torch.Tensor, w: Tuple[torch.Tensor, ...], lo: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Experts [lo, lo + E_loc) of the weights ``w`` = (w_gate, w_up,
    w_down) on the routed rows of xf (T_loc, d), each at the per-shard
    capacity, the routed rows first by a stable sort: (y (T_loc, d), the
    count of routed rows past the capacity)."""
    w_gate, w_up, w_down = w
    t, d = xf.shape
    cap = max(int(t * cfg.experts_per_token / cfg.num_experts
                  * cfg.capacity_factor), 4)
    y = xf.new_zeros((t, d))
    drop = torch.zeros((), dtype=torch.float32, device=xf.device)
    for el in range(w_gate.shape[0]):
        sel = ids == lo + el                              # (T_loc, k)
        tok_gate = (gate * sel).sum(-1)
        routed = sel.any(-1)
        order = torch.argsort((~routed).to(torch.int8), stable=True)
        idx = order[:cap]                                 # routed first
        valid = routed[idx]
        xe = xf[idx] * valid[:, None].to(xf.dtype)
        h = F.silu(xe @ w_gate[el]) * (xe @ w_up[el])
        out = h @ w_down[el]
        out = out * (tok_gate[idx] * valid)[:, None].to(out.dtype)
        y = y.index_add(0, idx, out.to(y.dtype))
        drop = drop + (routed.sum() - valid.sum()).float()
    return y, drop


def _metrics(cfg: ModelConfig, logits: torch.Tensor, probs: torch.Tensor,
             ids: torch.Tensor, drop: torch.Tensor, mesh, tp, dp
             ) -> Dict[str, torch.Tensor]:
    """The router metrics of a rank's T_loc rows, averaged over the expert
    axes ``tp`` and then over each data axis of ``dp``, as the
    reference's ``pmean`` chain."""
    from repro_torch.parallel.collectives import all_reduce_mean
    e, k = cfg.num_experts, cfg.experts_per_token
    t = ids.shape[0]
    with torch.no_grad():
        me = probs.detach().mean(dim=0)
        ce = torch.zeros(e, dtype=torch.float32, device=ids.device)
        ce.scatter_add_(0, ids.reshape(-1), torch.ones(
            ids.numel(), dtype=torch.float32, device=ids.device))
        ce = ce / (t * k)
        aux = torch.stack([
            e * torch.sum(me * ce),
            torch.mean(torch.logsumexp(logits.detach(), dim=-1) ** 2),
            drop / (t * k)])
        all_reduce_mean(aux, mesh, tp)
        for ax in dp:
            all_reduce_mean(aux, mesh, (ax,))
    return {"moe_load_balance": aux[0], "moe_z_loss": aux[1],
            "moe_drop_frac": aux[2]}


def _moe_ffn_ep_serve(cfg: ModelConfig, p: Dict[str, torch.Tensor],
                      x: torch.Tensor, tp: "ServeShard"
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``moe_ep="serve"`` on a serving plan's shard (module note)."""
    from repro_torch.parallel.collectives import all_gather_dim, own_rows
    if cfg.moe_ep != "serve":
        raise ValueError(f"moe_ep={cfg.moe_ep!r} on a serving plan: the "
                         "expert-parallel MoE serves with moe_ep='serve'")
    mesh, e = tp.mesh, cfg.num_experts
    if tp.experts is None or e % mesh.shape["model"]:
        raise ValueError(f"{e} experts do not split over model="
                         f"{mesh.shape['model']}")
    rows = tp.token_rows
    # the reference's rows: cut over ep_dp_axes where they divide the batch
    dp = tuple(a for a in (cfg.ep_dp_axes or ()) if mesh.shape[a] > 1)
    if (x.shape[0] * mesh.axes_size(rows)) % mesh.axes_size(dp):
        dp = ()
    xl = x if dp == rows else own_rows(all_gather_dim(x, mesh, rows, 0),
                                       mesh, dp)
    b, s, d = xl.shape
    xf = xl.reshape(b * s, d)
    ax = tp.expert_ffn_axes                 # gather the columns over 'data'
    w = (all_gather_dim(p["w_gate"], mesh, ax, 2),
         all_gather_dim(p["w_up"], mesh, ax, 2),
         all_gather_dim(p["w_down"], mesh, ax, 1))
    logits, probs, gate, ids = route(cfg, p["router"], xf)
    y, drop = _local_experts(cfg, xf, gate, ids, w, tp.experts[0])
    y = tp.reduce(y, tp.expert_axes).reshape(b, s, d)     # combine experts
    aux = _metrics(cfg, logits, probs, ids, drop, mesh, ("model",), dp)
    if dp != rows:
        y = own_rows(all_gather_dim(y, mesh, dp, 0), mesh, rows)
    if cfg.shared_expert:
        y = y + swiglu(x, p["shared"])
    return y, aux


__all__ = ["moe_ffn_ep"]
