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

The weights arrive whole: the sharded step gathers the param tree before
the forward, so the reference's in-shard gather of the expert weights
over a data axis (dim 1 in ``train`` mode, dim 2 in ``serve``) is that
tree gather here; a per-layer gather of a rank's own experts is ROADMAP
queue 2. The backward is exact on every rank: the rows and the router
pass through ``copy_to`` (their gradients summed over 'model'), a rank's
experts through ``slice_from`` (each expert's gradient from its rank),
so every model rank ends with the same full gradient.

The expert products are plain ``torch`` matmuls, as the reference's are
outside any Pallas kernel: the MoE adds no kernel. Requires a live mesh
registered with ``runtime_context.mesh_context`` (the sharded step, or a
caller that runs the layer alone).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import runtime_context
from repro_torch.config import ModelConfig
from repro_torch.models.layers import swiglu


def moe_ffn_ep(cfg: ModelConfig, p: Dict[str, torch.Tensor],
               x: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x (B_loc, S, d), this rank's rows -> (y (B_loc, S, d), aux)."""
    from repro_torch.parallel.collectives import (all_reduce_mean, copy_to,
                                                  reduce_from, slice_from)
    mesh = runtime_context.get_mesh()
    if not mesh.live:
        raise RuntimeError("moe_ep needs a live mesh (runtime_context); "
                           "the local plan runs models/moe.py")
    e, k = cfg.num_experts, cfg.experts_per_token
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

    logits = xf.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)                 # (T_loc, E)
    gate, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, ids = gate[:, :k], ids[:, :k]
    if k > 1:
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    cap = max(int(t * k / e * cfg.capacity_factor), 4)
    y = xf.new_zeros((t, d))
    drop = torch.zeros((), dtype=torch.float32, device=x.device)
    for el in range(e_loc):
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
    y = reduce_from(y, mesh, tp)                          # combine experts

    with torch.no_grad():
        me = probs.detach().mean(dim=0)
        ce = torch.zeros(e, dtype=torch.float32, device=x.device)
        ce.scatter_add_(0, ids.reshape(-1), torch.ones(
            ids.numel(), dtype=torch.float32, device=x.device))
        ce = ce / (t * k)
        aux = torch.stack([
            e * torch.sum(me * ce),
            torch.mean(torch.logsumexp(logits.detach(), dim=-1) ** 2),
            drop / (t * k)])
        all_reduce_mean(aux, mesh, tp)
        for ax in dp:
            all_reduce_mean(aux, mesh, (ax,))
    y = y.reshape(b, s, d)
    if cfg.shared_expert:
        y = y + swiglu(x, p["shared"])
    return y, {"moe_load_balance": aux[0], "moe_z_loss": aux[1],
               "moe_drop_frac": aux[2]}


__all__ = ["moe_ffn_ep"]
