"""Fused, differentiable token log-prob and entropy: CUDA kernels and twin.

The learner's loss and the App. B.1 sampler-logp recompute need log p(y_t)
and the entropy of every token. Materializing log_softmax over a
152064-wide vocabulary costs (T, V) float32 activations in both passes;
both paths here stream the vocabulary instead and save only O(T) state.

- ``fused_logprob(logits, targets)``: a ``torch.autograd.Function`` whose
  forward is K1 and whose backward is K2, the hand-written Hopper kernels
  of ``csrc/fused_logprob.cu`` (replacing the Pallas kernels
  ``_fwd_kernel`` and ``_bwd_kernel`` of
  ``repro/kernels/fused_logprob.py``). It saves logits, targets, ``lse``
  and ``mu = lse - ent``; the backward recomputes p = exp(x - lse).
  ``logprob_fwd``/``logprob_bwd`` launch the kernels or raise: they take
  CUDA tensors only (``ops.fused_token_logprob`` sends CPU tensors to the
  twin).
- ``chunked_logprob(logits, targets, chunk=256)``: the plain PyTorch twin
  with the same saved state (``_chunked_fwd_pass``/``_chunked_bwd_rule``
  of the JAX package): the token axis (second to last) is cut into
  ``chunk``-row pieces, each a full-vocabulary reduction in float32 by the
  masked-sum math of ``repro_torch.core.logprob``.

Target ids are clamped to [0, V) once, before either path
(``clamp_target_ids``), so the kernels read only valid ids.

``LAUNCHES`` counts kernel launches, one per wrapper call that launched.
``dlogits_error_ratio`` is the element-wise bound that holds K2 against
the twin.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core.logprob import (clamp_target_ids,
                                      token_logprob_entropy_lse)
from repro_torch.kernels import build

# launches of each CUDA kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {"logprob_fwd": 0, "logprob_bwd": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# --------------------------------------------------------------------------
# plain PyTorch twin: chunks of the token axis, same saved state


def _chunk_bwd(x, tgt, lse, mu, g_lp, g_ent):
    """dlogits for one token chunk, recomputing p = exp(x - lse)."""
    lg = x.float()
    p = torch.exp(lg - lse[..., None])
    iota = torch.arange(lg.shape[-1], device=lg.device, dtype=torch.int32)
    hit = (iota == tgt[..., None]).float()
    d = (g_lp[..., None] * (hit - p)
         - g_ent[..., None] * p * (lg - mu[..., None]))
    return d.to(x.dtype)


def _chunked_fwd_pass(logits, targets, chunk: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logp, ent, lse) over the token axis in ``chunk`` pieces (the last
    one ragged), each (..., T) float32."""
    t = logits.shape[-2]
    if t == 0:
        return tuple(logits.new_zeros(logits.shape[:-1], dtype=torch.float32)
                     for _ in range(3))
    parts = [token_logprob_entropy_lse(logits[..., s:s + chunk, :],
                                       targets[..., s:s + chunk])
             for s in range(0, t, chunk)]
    return tuple(torch.cat(ps, dim=-1) for ps in zip(*parts))


def _chunked_bwd_pass(logits, targets, lse, mu, g_lp, g_ent, chunk: int
                      ) -> torch.Tensor:
    """dlogits in the logits dtype, written chunk by chunk into one
    buffer."""
    dlogits = torch.empty_like(logits)
    for s in range(0, logits.shape[-2], chunk):
        sl = slice(s, s + chunk)
        dlogits[..., sl, :] = _chunk_bwd(
            logits[..., sl, :], targets[..., sl], lse[..., sl], mu[..., sl],
            g_lp[..., sl], g_ent[..., sl])
    return dlogits


class _ChunkedLogprob(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, chunk):
        logp, ent, lse = _chunked_fwd_pass(logits, targets, chunk)
        ctx.save_for_backward(logits, targets, lse, lse - ent)
        ctx.chunk = chunk
        return logp, ent

    @staticmethod
    def backward(ctx, g_lp, g_ent):
        logits, targets, lse, mu = ctx.saved_tensors
        return (_chunked_bwd_pass(logits, targets, lse, mu, g_lp.float(),
                                  g_ent.float(), ctx.chunk), None, None)


def chunked_logprob(logits: torch.Tensor, targets: torch.Tensor, *,
                    chunk: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin of ``fused_logprob``: logits (..., T, V), targets (..., T)
    -> (logp, entropy) (..., T) float32, on any device and shape;
    differentiable w.r.t. ``logits``."""
    tgt = clamp_target_ids(targets, logits.shape[-1])
    return _ChunkedLogprob.apply(logits, tgt,
                                 max(1, min(chunk, logits.shape[-2])))


def dlogits_error_ratio(got: torch.Tensor, want: torch.Tensor,
                        logits: torch.Tensor, targets: torch.Tensor,
                        lse: torch.Tensor, mu: torch.Tensor,
                        g_lp: torch.Tensor, g_ent: torch.Tensor, *,
                        rtol: float, atol: float = 1e-30,
                        rows: int = 512) -> float:
    """max over (T, V) of |got - want| / (rtol * scale + atol) for two
    dlogits computed from the same (logits, targets, lse, mu, g_lp, g_ent);
    at most 1 means within the bound.

    ``scale = |g_lp| (onehot + p) + |g_ent| p |x - mu|`` is the sum of the
    magnitudes of the terms of dlogits (p = exp(x - lse)). Two float32
    evaluations of the formula differ by a few float32 ulps of ``scale``,
    not of |dlogits|, which may be far smaller where the terms cancel; one
    rounding of each to bfloat16 adds at most one bfloat16 ulp, 2^-7 of
    |dlogits| <= scale. A result that drops a term, or zeroes an entry
    whose terms do not cancel, is off by about ``scale`` there. Computed
    ``rows`` token rows at a time."""
    worst = 0.0
    for s in range(0, logits.shape[0], rows):
        sl = slice(s, s + rows)
        x = logits[sl].float()
        p = torch.exp(x - lse[sl, None])
        iota = torch.arange(x.shape[-1], device=x.device)
        hit = (iota == targets[sl, None]).float()
        scale = (g_lp[sl, None].abs() * (hit + p)
                 + g_ent[sl, None].abs() * p * (x - mu[sl, None]).abs())
        err = (got[sl].float() - want[sl].float()).abs()
        if err.numel():           # a NaN in either counts as out of bound
            ratio = torch.nan_to_num(err / (rtol * scale + atol),
                                     nan=float("inf"))
            worst = max(worst, float(ratio.max()))
    return worst


# --------------------------------------------------------------------------
# kernel wrappers

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _check(logits: torch.Tensor, targets: torch.Tensor, *rows: torch.Tensor
           ) -> Tuple[int, int, int]:
    """Validate what the kernels take; returns (T, V, dtype code)."""
    if logits.device.type != "cuda":
        raise ValueError(f"the log-prob kernels run on cuda tensors, got "
                         f"{logits.device}")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"the log-prob kernels take float32 or bfloat16 "
                        f"logits, got {logits.dtype}")
    if logits.dim() != 2:
        raise ValueError(f"logits must be (T, V), got {tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    t, v = logits.shape
    if not 0 < v <= _INT_MAX or t > _INT_MAX:
        raise ValueError(f"(T, V) = {(t, v)} outside the kernels' int range")
    if targets.dtype != torch.int32 or targets.shape != (t,) \
            or not targets.is_contiguous():
        raise ValueError("targets must be contiguous int32 (T,) (clamped "
                         "by fused_logprob)")
    for r in (targets, *rows):
        if r.device != logits.device:
            raise ValueError(f"operand on {r.device}, logits on "
                             f"{logits.device}")
    for r in rows:
        if r.dtype != torch.float32 or r.shape != (t,) \
                or not r.is_contiguous():
            raise ValueError("row vectors must be contiguous float32 (T,)")
    return t, v, _DTYPES[logits.dtype]


def logprob_fwd(logits: torch.Tensor, targets: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(logp, ent, lse), each (T,) float32, for CUDA logits (T, V) and
    int32 targets in [0, V): the K1 kernel."""
    t, v, code = _check(logits, targets)
    logp, ent, lse = (torch.empty((t,), dtype=torch.float32,
                                  device=logits.device) for _ in range(3))
    lib = build.load()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.logprob_fwd_launch(
            logits.data_ptr(), targets.data_ptr(), logp.data_ptr(),
            ent.data_ptr(), lse.data_ptr(), t, v, code, stream)
    _raise_on(err, "logprob_fwd_kernel")
    build.count_launch(LAUNCHES, "logprob_fwd")
    return logp, ent, lse


def logprob_bwd(logits: torch.Tensor, targets: torch.Tensor,
                lse: torch.Tensor, mu: torch.Tensor, g_lp: torch.Tensor,
                g_ent: torch.Tensor) -> torch.Tensor:
    """dlogits (T, V) in the logits dtype for CUDA logits: the K2 kernel.
    The cotangents may come from autograd expanded or in another float
    dtype; they are made contiguous float32 here."""
    g_lp = g_lp.to(torch.float32).contiguous()
    g_ent = g_ent.to(torch.float32).contiguous()
    t, v, code = _check(logits, targets, lse, mu, g_lp, g_ent)
    dlogits = torch.empty_like(logits)
    lib = build.load()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.logprob_bwd_launch(
            logits.data_ptr(), targets.data_ptr(), lse.data_ptr(),
            mu.data_ptr(), g_lp.data_ptr(), g_ent.data_ptr(),
            dlogits.data_ptr(), t, v, code, stream)
    _raise_on(err, "logprob_bwd_kernel")
    build.count_launch(LAUNCHES, "logprob_bwd")
    return dlogits


class _FusedLogprob(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets):
        logp, ent, lse = logprob_fwd(logits, targets)
        # O(T) residuals only: mu = E_p[x] = lse - H
        ctx.save_for_backward(logits, targets, lse, lse - ent)
        return logp, ent

    @staticmethod
    def backward(ctx, g_lp, g_ent):
        logits, targets, lse, mu = ctx.saved_tensors
        return logprob_bwd(logits, targets, lse, mu, g_lp, g_ent), None


def fused_logprob(logits: torch.Tensor, targets: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits (T, V) float32 or bfloat16, contiguous; targets (T,) int ->
    (logp (T,), entropy (T,)) float32, differentiable w.r.t. ``logits``
    (backward: K2). Any T and V: the kernels mask ragged rows themselves."""
    tgt = clamp_target_ids(targets, logits.shape[-1]).contiguous()
    return _FusedLogprob.apply(logits, tgt)
