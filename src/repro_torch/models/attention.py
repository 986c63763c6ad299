"""Attention for the full-sequence forward (naive, chunked, the K5 flash
kernel) and for one decode step against a dense KV cache, or against the
ring-buffered cache of a local layer (``ring_decode_attention``,
``fill_ring``). On a context-parallel decode each rank runs the decode
functions on its span of the cache (``offset``, ``slots``) and returns
its partial softmax (``partial=True``: the output over its keys with the
running max and sum), which the ranks merge (``ServeShard.combine``);
``memory_attention`` is the same partial over a rank's rows of a
cross-attention memory. All of it is plain PyTorch, as the JAX package
computes the decode outside any Pallas kernel.

The port of ``repro/models/attention.py``. GQA is handled with grouped
einsums (no repeated K/V); causal, sliding-window and bidirectional
masks; Gemma-2 attention-logit softcap. Scores are float32, masked scores
are ``NEG_INF`` (a finite -1e30, not -inf), and padded keys carry the
``PAD_POS`` sentinel position.

``chunked_attention`` is flash-style in both directions: a
``torch.autograd.Function`` whose forward scans kv blocks with running
(m, l, acc) and saves only (o, lse), and whose backward recomputes the
scores block by block. It is plain PyTorch, as the JAX package computes it
outside any Pallas kernel. ``attention(impl="pallas")`` sends contiguous
positions to the dense flash kernel K5 (``kernels.ops.flash_attention``:
the CUDA kernel on the card, its twin on the CPU; forward only).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch.kernels.ops import flash_attention

NEG_INF = -1e30
PAD_POS = 2 ** 30          # sentinel position marking padded keys
ATTN_IMPLS = ("naive", "chunked", "pallas")


def _mask(pos_q: torch.Tensor, pos_k: torch.Tensor, kind: str,
          window: int) -> torch.Tensor:
    """(..., Sq, Sk) boolean mask; keys at PAD_POS are masked in every
    kind."""
    valid = (pos_k < PAD_POS)[..., None, :]
    d = pos_q[..., :, None] - pos_k[..., None, :]
    if kind == "causal":
        return (d >= 0) & valid
    if kind == "local":
        return (d >= 0) & (d < window) & valid
    if kind == "bidir":
        return valid.expand(d.shape)
    raise ValueError(kind)


def _scores(q: torch.Tensor, k: torch.Tensor,
            cap: Optional[float]) -> torch.Tensor:
    """q (B,Sq,G,R,D), k (B,Sk,G,D) -> (B,G,R,Sq,Sk), pre-softmax, f32."""
    s = torch.einsum("bqgrd,bkgd->bgrqk", q.float(), k.float())
    s = s * (q.shape[-1] ** -0.5)
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    return s


def naive_attention(q, k, v, *, pos_q, pos_k, kind="causal", window=4096,
                    softcap=None):
    """Reference O(Sq*Sk) attention. q (B,Sq,Hq,D); k,v (B,Sk,Hkv,D)."""
    b, sq, hq, d = q.shape
    g = k.shape[2]
    qg = q.reshape(b, sq, g, hq // g, d)
    s = _scores(qg, k, softcap)
    m = _mask(pos_q, pos_k, kind, window)[:, None, None]
    p = torch.softmax(torch.where(m, s, NEG_INF), dim=-1)
    o = torch.einsum("bgrqk,bkgd->bqgrd", p, v.float())
    return o.reshape(b, sq, hq, d).to(q.dtype)


def _pad_blocks(q, k, v, pos_q, pos_k, q_chunk, kv_chunk):
    sq, sk = q.shape[1], k.shape[1]
    pad_q, pad_k = (-sq) % q_chunk, (-sk) % kv_chunk
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        pos_q = torch.nn.functional.pad(pos_q, (0, pad_q))
    if pad_k:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad_k))
        pos_k = torch.nn.functional.pad(pos_k, (0, pad_k), value=PAD_POS)
    return q, k, v, pos_q, pos_k


def _chunked_fwd(q, k, v, pos_q, pos_k, kind, window, softcap, q_chunk,
                 kv_chunk):
    """Returns (o (B,Sq,Hq,D) in q's dtype, lse (B,G,R,Sq) f32)."""
    b, sq0, hq, d = q.shape
    g = k.shape[2]
    r = hq // g
    q, k, v, pos_q, pos_k = _pad_blocks(q, k, v, pos_q, pos_k, q_chunk,
                                        kv_chunk)
    sq, sk = q.shape[1], k.shape[1]
    qg = q.reshape(b, sq, g, r, d)
    dev = q.device
    outs, lses = [], []
    for i in range(0, sq, q_chunk):
        qi, pq = qg[:, i:i + q_chunk], pos_q[:, i:i + q_chunk]
        m = torch.full((b, g, r, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, g, r, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, g, r, q_chunk, d), dtype=torch.float32,
                          device=dev)
        for j in range(0, sk, kv_chunk):
            msk = _mask(pq, pos_k[:, j:j + kv_chunk], kind,
                        window)[:, None, None]
            s = torch.where(msk, _scores(qi, k[:, j:j + kv_chunk], softcap),
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            scale = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * scale + p.sum(dim=-1)
            acc = acc * scale[..., None] + torch.einsum(
                "bgrqk,bkgd->bgrqd", p, v[:, j:j + kv_chunk].float())
            m = m_new
        l_safe = torch.clamp(l, min=1e-30)
        outs.append((acc / l_safe[..., None]).permute(0, 3, 1, 2, 4))
        lses.append(m + torch.log(l_safe))
    o = torch.cat(outs, dim=1).reshape(b, sq, hq, d)
    lse = torch.cat(lses, dim=-1)
    return o[:, :sq0].to(q.dtype), lse[..., :sq0]


def _chunked_bwd(q, k, v, pos_q, pos_k, o, lse, do, kind, window, softcap,
                 q_chunk, kv_chunk):
    """Flash backward: scores recomputed block by block, nothing O(Sq*Sk)
    kept. The JAX package runs two passes (q-major for dq, kv-major for
    dk/dv); one q-major double loop here computes each block pair's
    probabilities once and adds to dq, dk and dv in the same order as the
    two passes do."""
    b, sq0, hq, d = q.shape
    sk0, g = k.shape[1], k.shape[2]
    r = hq // g
    q, k, v, pos_q, pos_k = _pad_blocks(q, k, v, pos_q, pos_k, q_chunk,
                                        kv_chunk)
    sq, sk = q.shape[1], k.shape[1]
    pad = sq - sq0
    f32 = torch.float32
    if pad:
        o = torch.nn.functional.pad(o, (0, 0, 0, 0, 0, pad))
        do = torch.nn.functional.pad(do, (0, 0, 0, 0, 0, pad))
        lse = torch.nn.functional.pad(lse, (0, pad))
    qg = q.reshape(b, sq, g, r, d).to(f32)
    dog = do.reshape(b, sq, g, r, d).to(f32)
    # D_i = sum_d dO_id O_id, (B, G, R, Sq)
    dd = (dog * o.reshape(b, sq, g, r, d).to(f32)).sum(-1).permute(0, 2, 3, 1)
    kf, vf = k.to(f32), v.to(f32)
    scale = d ** -0.5
    dq = torch.zeros((b, sq, g, r, d), dtype=f32, device=q.device)
    dk = torch.zeros((b, sk, g, d), dtype=f32, device=q.device)
    dv = torch.zeros((b, sk, g, d), dtype=f32, device=q.device)
    for i in range(0, sq, q_chunk):
        qs = slice(i, i + q_chunk)
        qi, pq, do_i = qg[:, qs], pos_q[:, qs], dog[:, qs]
        lse_i, d_i = lse[..., qs], dd[..., qs]
        for j in range(0, sk, kv_chunk):
            ks = slice(j, j + kv_chunk)
            ki, vi = kf[:, ks], vf[:, ks]
            u = torch.einsum("bqgrd,bkgd->bgrqk", qi, ki) * scale
            if softcap is not None:
                s = softcap * torch.tanh(u / softcap)
                dchain = 1.0 - (s / softcap) ** 2
            else:
                s, dchain = u, 1.0
            msk = _mask(pq, pos_k[:, ks], kind, window)[:, None, None]
            p = torch.where(msk, torch.exp(s - lse_i[..., None]), 0.0)
            dp = torch.einsum("bqgrd,bkgd->bgrqk", do_i, vi)
            ds = p * (dp - d_i[..., None]) * dchain
            dq[:, qs] += torch.einsum("bgrqk,bkgd->bqgrd", ds, ki) * scale
            dv[:, ks] += torch.einsum("bgrqk,bqgrd->bkgd", p, do_i)
            dk[:, ks] += torch.einsum("bgrqk,bqgrd->bkgd", ds, qi) * scale
    return (dq.reshape(b, sq, hq, d)[:, :sq0].to(q.dtype),
            dk[:, :sk0].to(k.dtype), dv[:, :sk0].to(v.dtype))


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, pos_q, pos_k, kind, window, softcap, q_chunk,
                kv_chunk):
        o, lse = _chunked_fwd(q, k, v, pos_q, pos_k, kind, window, softcap,
                              q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, pos_q, pos_k, o, lse)
        ctx.opts = (kind, window, softcap, q_chunk, kv_chunk)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, pos_q, pos_k, o, lse = ctx.saved_tensors
        dq, dk, dv = _chunked_bwd(q, k, v, pos_q, pos_k, o, lse, do,
                                  *ctx.opts)
        return (dq, dk, dv) + (None,) * 7


def chunked_attention(q, k, v, *, pos_q, pos_k, kind="causal", window=4096,
                      softcap=None, q_chunk=512, kv_chunk=512):
    """Flash-style attention with a flash backward: neither direction
    materializes the (Sq, Sk) score matrix, and autograd never records
    the online-softmax loop."""
    return _Flash.apply(q, k, v, pos_q, pos_k, kind, window, softcap,
                        min(q_chunk, q.shape[1]), min(kv_chunk, k.shape[1]))


def _partial(s: torch.Tensor, v: torch.Tensor, b: int, hq: int, d: int):
    """Masked scores s (B,G,R,K) and values v (B,K,G,D) -> the attention
    over these keys alone, normalised over them, with its running max and
    sum: (o (B,1,Hq,D), m (B,1,Hq), l (B,1,Hq)), float32."""
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, v.float()) / l[..., None]
    return (o.reshape(b, 1, hq, d), m.reshape(b, 1, hq),
            l.reshape(b, 1, hq))


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *,
                     pos: Union[int, torch.Tensor], kind: str = "causal",
                     window: int = 4096, softcap: Optional[float] = None,
                     length: Optional[int] = None, offset: int = 0,
                     partial: bool = False):
    """Single-token attention against a (B, Smax, Hkv, D) cache.

    q (B, 1, Hq, D); ``pos`` the current position, a scalar or a (B,)
    vector. Entries > pos are masked (and those <= pos - window for
    ``kind == "local"``). ``length`` (an int) is an optional upper bound on
    ``pos + 1``: the cache is sliced to it, so the masked tail is never
    read.

    ``offset`` is the position of the cache's first row: a rank of a
    context-parallel decode holds the rows [offset, offset + Smax) of the
    sequence and masks by their absolute positions. With ``partial`` it
    returns (o, m, l), its attention over these rows alone (float32) with
    the running max and sum a log-sum-exp merge over the ranks takes
    (``ServeShard.combine``); a span with no visible row keeps one masked
    row, whose weight in the merge is 0."""
    b, _, hq, d = q.shape
    if length is not None:
        keep = max(1, min(k_cache.shape[1], length - offset))
        if keep < k_cache.shape[1]:
            k_cache, v_cache = k_cache[:, :keep], v_cache[:, :keep]
    smax, g = k_cache.shape[1], k_cache.shape[2]
    s = _scores(q.reshape(b, 1, g, hq // g, d), k_cache,
                softcap)[:, :, :, 0]                      # (B,G,R,Smax)
    idx = torch.arange(smax, device=q.device)
    if offset:
        idx = idx + offset
    # an int position stays a host scalar: no copy to the device per layer
    posv = pos if isinstance(pos, int) else pos.reshape(-1, 1)   # (1|B, 1)
    valid = idx[None, :] <= posv
    if kind == "local":
        valid &= idx[None, :] > posv - window
    s = torch.where(valid[:, None, None], s, NEG_INF)
    if partial:
        return _partial(s, v_cache, b, hq, d)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", p, v_cache.float())
    return o.reshape(b, 1, hq, d).to(q.dtype)


def ring_decode_attention(q: torch.Tensor, k_ring: torch.Tensor,
                          v_ring: torch.Tensor, *,
                          pos: Union[int, torch.Tensor],
                          softcap: Optional[float] = None,
                          slots: Optional[Tuple[int, int]] = None,
                          partial: bool = False):
    """Single-token attention against a ring-buffered local-window cache.

    k_ring/v_ring (B, W, Hkv, D): slot ``s`` holds the key of position
    ``pos - ((pos - s) mod W)``, the one position congruent to ``s`` in
    (pos - W, pos]; slots whose position is negative are not written yet
    and are masked. ``pos`` is shared by the batch (an int or a 0-d
    tensor). With W the sliding window the ring holds exactly the local
    band, so no other mask applies.

    ``slots`` (first, W) says that these rows are the ring's slots
    [first, first + rows) of a ring of W (a rank's span of a
    context-parallel decode; default the whole ring); ``partial`` returns
    (o, m, l) as ``decode_attention`` does."""
    b, _, hq, d = q.shape
    n, g = k_ring.shape[1], k_ring.shape[2]
    first, w = (0, n) if slots is None else slots
    s = _scores(q.reshape(b, 1, g, hq // g, d), k_ring,
                softcap)[:, :, :, 0]                      # (B,G,R,n)
    slot = torch.arange(n, device=q.device)
    if first:
        slot = slot + first
    p = pos - torch.remainder(pos - slot, w)              # slot position
    s = torch.where((p >= 0)[None, None, None], s, NEG_INF)
    if partial:
        return _partial(s, v_ring, b, hq, d)
    prob = torch.softmax(s, dim=-1)
    o = torch.einsum("bgrk,bkgd->bgrd", prob, v_ring.float())
    return o.reshape(b, 1, hq, d).to(q.dtype)


def memory_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A rank's partial of unmasked attention of q (B, 1, Hq, D) over its
    rows of a memory's keys and values (B, M_local, Hkv, D): (o, m, l) as
    ``decode_attention(partial=True)`` returns them."""
    b, _, hq, d = q.shape
    g = k.shape[2]
    s = _scores(q.reshape(b, 1, g, hq // g, d), k, None)[:, :, :, 0]
    return _partial(s, v, b, hq, d)


def fill_ring(k: torch.Tensor, window: int) -> torch.Tensor:
    """The last ``window`` rows of k (B, S, H, D) in ring order (slot s =
    the position p with p = s mod window). For S < window the tail slots
    are zeros, which ``ring_decode_attention`` masks by position."""
    b, s_len = k.shape[0], k.shape[1]
    if s_len < window:
        pad = torch.zeros((b, window - s_len) + k.shape[2:], dtype=k.dtype,
                          device=k.device)
        return torch.cat([k, pad], dim=1)
    idx = torch.remainder(torch.arange(window, device=k.device)
                          - s_len % window, window)
    return k[:, s_len - window:][:, idx]


def standard_positions(pos: torch.Tensor) -> bool:
    """Whether every row of ``pos`` (..., S) is ``arange(S)``: the layout
    whose masks K5 derives from offsets. One host sync on the card."""
    return bool((pos == torch.arange(pos.shape[-1],
                                     device=pos.device)).all())


def attention(q, k, v, *, pos_q, pos_k, kind="causal", window=4096,
              softcap=None, impl="chunked", chunk=512,
              contiguous: Optional[bool] = None):
    """Full-sequence attention dispatch: naive | chunked | pallas.

    As in the JAX package, ``impl="pallas"`` sends the kinds causal, local
    and bidir to the flash kernel K5 when the positions are the contiguous
    ``arange`` layout its offset-derived masks assume, and otherwise takes
    the paths below; ``window`` reaches the kernel only for "local".
    ``contiguous`` is that fact when the caller knows it (the model's
    forward, which built the positions); None checks ``pos_q`` and
    ``pos_k``. A sequence no longer than ``chunk`` takes the naive path,
    a longer one the chunked path."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {impl!r}; have {ATTN_IMPLS}")
    if impl == "pallas" and kind in ("causal", "local", "bidir"):
        if contiguous is None:
            contiguous = (standard_positions(pos_q)
                          and standard_positions(pos_k))
        if contiguous:
            return flash_attention(
                q, k, v, causal=kind != "bidir",
                window=window if kind == "local" else None, softcap=softcap)
    if impl == "naive" or q.shape[1] <= chunk:
        return naive_attention(q, k, v, pos_q=pos_q, pos_k=pos_k, kind=kind,
                               window=window, softcap=softcap)
    return chunked_attention(q, k, v, pos_q=pos_q, pos_k=pos_k, kind=kind,
                             window=window, softcap=softcap, q_chunk=chunk,
                             kv_chunk=chunk)
