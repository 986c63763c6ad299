"""Public kernel entry points the model and the learner call, with their
impl knobs.

Paged attention (``paged_decode``, ``paged_prefill``): ``impl`` is
``ModelConfig.paged_attn_impl``:

- "pallas": the hand-written Hopper kernel; raises on a CPU tensor;
- "ref": the plain PyTorch twin, on any device;
- "auto" / None: the kernel for CUDA tensors, the twin for CPU tensors;
- "gather": the JAX package's dense gather path: the slot's logical
  (B, npages * page, Hkv, D) view is materialised from the pools and the
  dense ``decode_attention`` / ``attention`` of ``models.attention`` run
  over it. Plain PyTorch on any device, no kernel; chosen only by name.

``kind``/``window`` follow the JAX package: the sliding-window band
applies only when ``kind == "local"``. ``paged_decode_layers`` and
``paged_prefill_layers`` fold a leading layer axis into the slot axis, so
one K3 or K4 launch serves every layer's pools (the speculative verify
round's rescore).

Dense flash attention (``flash_attention``, ``attn_impl="pallas"``): the
K5 kernel for CUDA tensors, its twin for CPU tensors, as the JAX package
runs its Pallas kernel in interpret mode off the TPU. Forward only.

Mamba2 SSD chunk scan (``ssd_scan``, ``ssd_impl="pallas"``): the K6
kernel for CUDA tensors, its twin for CPU tensors. Forward only.

Token log-probs (``fused_token_logprob``): ``impl`` takes the
``TrainConfig.logprob_impl`` vocabulary or None (see the function).

Every dispatch records its kernel, its route ("kernel", "twin",
"gather" or "naive") and the shapes a jit would key on with
``analysis.sentinel.record_launch`` (batch rows, chunk or sequence
widths, block-table width), whichever route it takes: the launch-shape
sentinel's count.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.analysis.sentinel import record_launch
from repro_torch.config import LOGPROB_IMPLS, PAGED_IMPLS
from repro_torch.core.logprob import token_logprob_and_entropy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_logprob as fl
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ss

# the sentinel's route names of _resolve's paths
_ROUTES = {"gather": "gather", "ref": "twin", "kernel": "kernel"}


def _resolve(impl: Optional[str], q: torch.Tensor, kind: str) -> str:
    if impl not in PAGED_IMPLS + (None,):
        raise ValueError(f"unknown paged-attention impl {impl!r}")
    if kind not in ("causal", "local"):
        raise ValueError(f"paged attention is causal-only, got kind={kind!r}")
    if impl == "gather":
        return "gather"
    if impl == "pallas" and q.device.type != "cuda":
        raise ValueError(f"paged_attn_impl='pallas' launches the CUDA kernel "
                         f"and needs CUDA tensors, got {q.device}")
    return "ref" if impl == "ref" else "kernel"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Full-sequence attention in the contiguous layout (row i, column j at
    positions i, j). q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) -> (B, Sq, Hq,
    D). On a CUDA tensor the K5 kernel (or an exception), on a CPU tensor
    its twin; either raises in a backward. ``window`` applies only when
    ``causal``."""
    record_launch("flash_attention", "twin" if q.device.type == "cpu"
                  else "kernel", q.shape[0], q.shape[1], k.shape[1])
    if q.device.type == "cpu":
        return fa.forward_only(fa.flash_attention_ref, q, k, v,
                               causal=causal, window=window, softcap=softcap)
    return fa.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log_neg: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """The SSD chunk scan with a zero initial state, y only, in the JAX
    package's layouts: x (B, S, H, P), dt (B, S, H), a_log_neg (H,), b, c
    (B, S, G, N) -> y (B, S, H, P) in x's dtype; S % min(chunk, S) == 0.
    On a CUDA tensor the K6 kernel (or an exception), on a CPU tensor its
    twin. Raises when autograd records the call: K6 has no backward (nor
    has the Pallas kernel)."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a_log_neg, b, c)):
        raise RuntimeError(
            "ssd_scan (K6, ssd_impl='pallas') is forward-only, as in the JAX "
            "package: train with ssd_impl='chunked'")
    record_launch("ssd_scan", "twin" if x.device.type == "cpu"
                  else "kernel", x.shape[0], x.shape[1])
    if x.device.type == "cpu":
        return ss.ssd_scan_ref(x, dt, a_log_neg, b, c, chunk=chunk)
    return ss.ssd_scan(x, dt, a_log_neg, b, c, chunk=chunk)


def _gather_view(kp: torch.Tensor, vp: torch.Tensor,
                 page_table: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each slot's logical (B, npages * page, Hkv, D) K/V view, gathered
    from the pools through its block-table row."""
    b, npages = page_table.shape
    shape = (b, npages * kp.shape[1], kp.shape[2], kp.shape[3])
    idx = page_table.long()
    return kp[idx].reshape(shape), vp[idx].reshape(shape)


def paged_decode(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                 page_table: torch.Tensor, lengths: torch.Tensor, *,
                 kind: str = "causal", window: Optional[int] = None,
                 softcap: Optional[float] = None,
                 impl: Optional[str] = None) -> torch.Tensor:
    """Decode-step attention against paged pools. q (B, 1, Hq, D); kp/vp
    (num_pages, page_size, Hkv, D); page_table (B, npages); lengths (B,)
    valid tokens per slot. Returns (B, 1, Hq, D)."""
    path = _resolve(impl, q, kind)
    record_launch("paged_decode", _ROUTES[path], q.shape[0],
                  page_table.shape[1])
    if path == "gather":
        from repro_torch.models.attention import decode_attention
        kc, vc = _gather_view(kp, vp, page_table)
        return decode_attention(q, kc, vc, pos=lengths - 1, kind=kind,
                                window=window, softcap=softcap)
    eff_window = window if kind == "local" else None
    fn = pa.paged_decode_ref if path == "ref" else pa.paged_attention
    o = fn(q[:, 0].contiguous(), kp, vp, page_table, lengths,
           window=eff_window, softcap=softcap)
    return o[:, None]


def paged_prefill(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                  page_table: torch.Tensor, positions: torch.Tensor, *,
                  kind: str = "causal", window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  impl: Optional[str] = None, attn_impl: str = "chunked",
                  chunk: int = 512) -> torch.Tensor:
    """Chunked-prefill attention against paged pools. q (B, C, Hq, D);
    positions (B, C) absolute query positions, ``starts + arange(C)`` per
    slot. Returns (B, C, Hq, D). ``attn_impl`` and ``chunk`` feed the
    dense attention of the "gather" path, where "pallas" drops to
    "chunked": K5 assumes query positions ``arange(C)``, and a chunk runs
    at an offset."""
    path = _resolve(impl, q, kind)
    record_launch("paged_prefill", _ROUTES[path], q.shape[0], q.shape[1],
                  page_table.shape[1])
    if path == "gather":
        from repro_torch.models.attention import attention
        kc, vc = _gather_view(kp, vp, page_table)
        pos_k = torch.arange(kc.shape[1], device=q.device).expand(
            q.shape[0], -1)
        return attention(q, kc, vc, pos_q=positions, pos_k=pos_k,
                         kind=kind, window=window, softcap=softcap,
                         impl="chunked" if attn_impl == "pallas"
                         else attn_impl, chunk=chunk)
    eff_window = window if kind == "local" else None
    starts = positions[:, 0].to(torch.int32)
    lengths = (positions[:, -1] + 1).to(torch.int32)
    fn = pa.paged_prefill_ref if path == "ref" else pa.paged_prefill
    return fn(q, kp, vp, page_table, lengths, starts, window=eff_window,
              softcap=softcap)


def _fold_layers(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                 page_table: torch.Tensor):
    """Fold a leading layer axis into the slot axis, so ONE kernel launch
    serves every layer's pools.

    q (L, B, ...), kp/vp (L, P, page, Hkv, D), page_table (B, W) -> q
    (L·B, ...), pools (L·P, ...) and table (L·B, W), layer l's rows
    offset by l·P so they index the l-th pool slab. The pools and q are
    reshaped, which is a view of a contiguous tensor: only the table is
    new. Slots never mix in K3/K4, so the folded launch gives the bits of
    L per-layer launches."""
    lyr, pool_pages, b = q.shape[0], kp.shape[1], q.shape[1]
    kpf = kp.reshape((lyr * pool_pages,) + kp.shape[2:])
    vpf = vp.reshape((lyr * pool_pages,) + vp.shape[2:])
    offs = torch.arange(lyr, dtype=torch.int32,
                        device=page_table.device) * pool_pages
    tablef = (page_table.to(torch.int32)[None] + offs[:, None, None]
              ).reshape(lyr * b, -1)
    return q.reshape((lyr * b,) + q.shape[2:]), kpf, vpf, tablef


def paged_decode_layers(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                        page_table: torch.Tensor, lengths: torch.Tensor, *,
                        kind: str = "causal", window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        impl: Optional[str] = None) -> torch.Tensor:
    """``paged_decode`` over all layers' pools in ONE launch of K3.

    q (L, B, 1, Hq, D) per-layer queries; kp/vp (L, P, page, Hkv, D)
    stacked pools (the block-stacked leaves of ``init_paged_pool``);
    page_table (B, W) and lengths (B,) shared by every layer. Returns
    (L, B, 1, Hq, D), bit-exact against L separate ``paged_decode``
    calls. A forward cannot use it (layer l's query needs layer l-1's
    output); it serves callers that hold every layer's queries."""
    lyr, b = q.shape[0], q.shape[1]
    qf, kpf, vpf, tablef = _fold_layers(q, kp, vp, page_table)
    o = paged_decode(qf, kpf, vpf, tablef, lengths.repeat(lyr), kind=kind,
                     window=window, softcap=softcap, impl=impl)
    return o.reshape((lyr, b) + o.shape[1:])


def paged_prefill_layers(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                         page_table: torch.Tensor, positions: torch.Tensor, *,
                         kind: str = "causal", window: Optional[int] = None,
                         softcap: Optional[float] = None,
                         impl: Optional[str] = None) -> torch.Tensor:
    """``paged_prefill`` over all layers' pools in ONE launch of K4: q
    (L, B, C, Hq, D), kp/vp (L, P, page, Hkv, D), positions (B, C) shared
    across layers. Returns (L, B, C, Hq, D), bit-exact against L separate
    calls: the same folding as ``paged_decode_layers``."""
    lyr, b = q.shape[0], q.shape[1]
    qf, kpf, vpf, tablef = _fold_layers(q, kp, vp, page_table)
    o = paged_prefill(qf, kpf, vpf, tablef, positions.repeat(lyr, 1),
                      kind=kind, window=window, softcap=softcap, impl=impl)
    return o.reshape((lyr, b) + o.shape[1:])


def fused_token_logprob(logits: torch.Tensor, targets: torch.Tensor, *,
                        impl: Optional[str] = None, chunk: int = 256
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training-stack entry for memory-bounded token log-probs.

    logits (..., V) [float32 or bfloat16 for the kernels; any float dtype
    for the twin], targets (...) int -> (logp (...), entropy (...)), both
    float32, differentiable w.r.t. ``logits`` with a streaming backward.

    ``impl``:
      - None / "fused": the K1/K2 kernels for CUDA tensors, the chunked
        twin for CPU tensors;
      - "pallas": the kernels; raises on a CPU tensor;
      - "chunked": the twin ``chunked_logprob`` on any device;
      - "naive": the materializing reference
        (``repro_torch.core.logprob``).

    Out-of-range target ids are clamped to [0, V). The kernels take any
    (T, V), so there is no block-size search and no ragged fallback.
    """
    if impl not in LOGPROB_IMPLS + (None,):
        raise ValueError(f"unknown logprob impl {impl!r}")
    if impl == "naive":
        record_launch("fused_token_logprob", "naive", targets.numel())
        return token_logprob_and_entropy(logits, targets)
    if logits.dim() == 1:                      # single token, no batch dim
        lp, ent = fused_token_logprob(logits[None], targets.reshape(1),
                                      impl=impl, chunk=chunk)
        return lp.reshape(targets.shape), ent.reshape(targets.shape)
    if impl == "pallas" and logits.device.type != "cuda":
        raise ValueError(f"logprob impl 'pallas' launches the CUDA kernels "
                         f"and needs CUDA tensors, got {logits.device}")
    if impl == "chunked" or logits.device.type == "cpu":
        record_launch("fused_token_logprob", "twin", targets.numel())
        return fl.chunked_logprob(logits, targets, chunk=chunk)
    record_launch("fused_token_logprob", "kernel", targets.numel())
    lead, v = logits.shape[:-1], logits.shape[-1]
    lp, ent = fl.fused_logprob(logits.reshape(-1, v), targets.reshape(-1))
    return lp.reshape(lead), ent.reshape(lead)
