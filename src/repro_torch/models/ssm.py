"""Mamba2 / SSD (state-space duality) blocks.

The port of ``repro/models/ssm.py``. Prefill and the teacher-forced
forward use the chunked SSD algorithm (arXiv:2405.21060): the sequence is
cut into chunks of length L; within a chunk the recurrence is a masked
quadratic form, and chunk states pass from chunk to chunk in a short
sequential loop. Decode is the O(1) recurrent update. Decays are computed
in log space (exponents <= 0, so every exp() is <= 1).

Shapes:  x (B,S,H,P)  dt (B,S,H)  A (H,) [negative]  B,C (B,S,G,N)
State: (B,H,P,N).

Routes of ``mamba_block``'s scan (``cfg.ssd_impl``): "chunked" is
``ssd_chunked``, the JAX package's own path; "pallas" sends a forward
without a cache through the chunk-scan kernel K6
(``kernels.ops.ssd_scan``: zero initial state, y only), which raises under
autograd; a forward that fills a cache keeps ``ssd_chunked``, which also
returns the final state the decode steps start from.

The decode cache (``conv`` window, float32 ``ssm`` state) is updated in
place: ``mamba_block`` writes the new window and state into the tensors of
the cache it is given (the JAX package returns new arrays).
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import runtime_context
from repro_torch.config import ModelConfig
from repro_torch.kernels.ops import ssd_scan
from repro_torch.models.layers import rmsnorm

# elements of one head slice's intra-chunk (B, nc, L, L, heads) working set
HEAD_SLICE_BUDGET = 2 ** 26


def _expand_groups(t: torch.Tensor, h: int) -> torch.Tensor:
    """(B,...,G,N) -> (B,...,H,N) by repeating each group H/G times."""
    return t.repeat_interleave(h // t.shape[-2], dim=-2)


def ssd_chunked(x, dt, a_log_neg, b, c, *, chunk: int,
                init_state: Optional[torch.Tensor] = None,
                head_slice: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD with optional head slicing. Returns (y (B,S,H,P) f32,
    final_state (B,H,P,N) f32).

    The intra-chunk quadratic form materializes (B, nc, L, L, H) decay and
    score tensors. ``head_slice`` > 0 processes heads in slices of that
    size, one after the other, bounding the working set to (B, nc, L, L,
    head_slice); while autograd records, each slice runs under
    ``torch.utils.checkpoint``, so its backward recomputes instead of
    saving (the JAX package's ``jax.checkpoint`` + ``lax.map``). 0 = all
    heads at once. With one B/C group, every slice reads the same b, c (no
    per-slice copy)."""
    bsz, s, h, p = x.shape
    if not head_slice or head_slice >= h:
        return _ssd_chunked_core(x, dt, a_log_neg, b, c, chunk=chunk,
                                 init_state=init_state)
    if h % head_slice:
        raise ValueError(f"head_slice {head_slice} must divide H {h}")
    g = b.shape[2]
    ns = h // head_slice
    if g > 1 and g % ns:               # incommensurate: per-head expansion
        b, c = _expand_groups(b, h), _expand_groups(c, h)
    gs = b.shape[2] // ns
    core = functools.partial(_ssd_chunked_core, chunk=chunk)
    remat = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad
        for t in (x, dt, a_log_neg, b, c, init_state))
    ys, fins = [], []
    for i in range(ns):
        hs = slice(i * head_slice, (i + 1) * head_slice)
        if g == 1:
            bi, ci = b, c
        else:
            gsl = slice(i * gs, (i + 1) * gs)
            bi, ci = b[:, :, gsl], c[:, :, gsl]
        s0 = None if init_state is None else init_state[:, hs]
        args = (x[:, :, hs], dt[:, :, hs], a_log_neg[hs], bi, ci, s0)
        if remat:
            y, fin = torch.utils.checkpoint.checkpoint(core, *args,
                                                       use_reentrant=False)
        else:
            y, fin = core(*args)
        ys.append(y)
        fins.append(fin)
    return torch.cat(ys, 2), torch.cat(fins, 1)


def _ssd_chunked_core(x, dt, a_log_neg, b, c,
                      init_state: Optional[torch.Tensor] = None, *,
                      chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B,S,H,P), final_state (B,H,P,N))."""
    bsz, s, h, p = x.shape
    n = b.shape[3]
    lc = min(chunk, s)
    s_orig = s
    pad = (-s) % lc
    if pad:
        # dt = 0 on padded steps: decay exp(0) = 1, contribution 0; the
        # state and all real outputs are untouched
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
        s += pad
    nc = s // lc

    x, dt = x.float(), dt.float()
    b = _expand_groups(b.float(), h)                 # (B,S,H,N)
    c = _expand_groups(c.float(), h)
    la = a_log_neg.float() * dt                      # log a_t (B,S,H), <= 0
    u = x * dt[..., None]                            # input contribution

    xc = u.reshape(bsz, nc, lc, h, p)
    bc = b.reshape(bsz, nc, lc, h, n)
    cc = c.reshape(bsz, nc, lc, h, n)
    cum = torch.cumsum(la.reshape(bsz, nc, lc, h), dim=2)   # (B,nc,L,H)

    # intra-chunk (quadratic, masked): decay[t,s] = exp(cum_t - cum_s), t>=s
    dec = cum[:, :, :, None] - cum[:, :, None, :, :]         # (B,nc,L,L,H)
    mask = torch.ones((lc, lc), dtype=torch.bool, device=x.device).tril()
    dec = torch.where(mask[None, None, :, :, None], dec, -torch.inf)
    w = torch.einsum("bcthn,bcshn->bctsh", cc, bc) * torch.exp(dec)
    y_intra = torch.einsum("bctsh,bcshp->bcthp", w, xc)

    # chunk-local end states
    w_end = torch.exp(cum[:, :, -1:, :] - cum)               # (B,nc,L,H)
    states = torch.einsum("bcshn,bcsh,bcshp->bchpn", bc, w_end, xc)

    # inter-chunk scan: the state before each chunk
    total_dec = torch.exp(cum[:, :, -1])                     # (B,nc,H)
    carry = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    prev = []
    for i in range(nc):
        prev.append(carry)
        carry = carry * total_dec[:, i, :, None, None] + states[:, i]
    prev_states = torch.stack(prev, 1)                       # (B,nc,H,P,N)

    # inter-chunk contribution
    y_inter = torch.einsum("bcthn,bcth,bchpn->bcthp", cc, torch.exp(cum),
                           prev_states)
    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    return y[:, :s_orig], carry


def ssd_reference(x, dt, a_log_neg, b, c, *,
                  init_state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential recurrence oracle (slow, for tests)."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    bh = _expand_groups(b.float(), h)
    ch = _expand_groups(c.float(), h)
    a = torch.exp(a_log_neg.float() * dt.float())            # (B,S,H)
    u = x.float() * dt.float()[..., None]
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if init_state is None
             else init_state.float())
    ys = []
    for t in range(s):
        state = state * a[:, t, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", u[:, t], bh[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", ch[:, t], state))
    return torch.stack(ys, 1), state


def ssd_decode_step(state, x_t, dt_t, a_log_neg, b_t, c_t):
    """One-token recurrence. state (B,H,P,N); x_t (B,H,P); dt_t (B,H);
    b_t, c_t (B,G,N). Returns (new state, y_t (B,H,P))."""
    h = x_t.shape[1]
    bh = _expand_groups(b_t.float(), h)
    ch = _expand_groups(c_t.float(), h)
    a_t = torch.exp(a_log_neg.float() * dt_t.float())
    u_t = x_t.float() * dt_t.float()[..., None]
    state = state * a_t[:, :, None, None] + torch.einsum("bhp,bhn->bhpn",
                                                         u_t, bh)
    return state, torch.einsum("bhn,bhpn->bhp", ch, state)


# --------------------------------------------------------------------------
# full Mamba2 block


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv. xbc (B,S,ch), w (K,ch)."""
    k, s = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + s] * w[i] for i in range(k))
    return out + bias


def _split_in_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, xbc, dt


def _split_xbc(cfg: ModelConfig, xbc: torch.Tensor):
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_ngroups
    x = xbc[..., :di]
    b = xbc[..., di:di + g * n]
    c = xbc[..., di + g * n:]
    shp = x.shape[:-1]
    return (x.reshape(*shp, cfg.ssm_heads, cfg.ssm_headdim),
            b.reshape(*shp, g, n), c.reshape(*shp, g, n))


def _head_slice(cfg: ModelConfig, bsz: int, s: int,
                heads: Optional[int] = None) -> int:
    """Heads per slice of ``ssd_chunked`` over ``heads`` heads (default
    all): the intra-chunk working set of a slice stays within
    HEAD_SLICE_BUDGET elements (~256 MB float32), as in the JAX package;
    0 = all heads at once."""
    lc = min(cfg.ssm_chunk, s)
    nc = -(-s // lc)
    hc = max(1, HEAD_SLICE_BUDGET // max(bsz * nc * lc * lc, 1))
    h = cfg.ssm_heads if heads is None else heads
    while hc < h and h % hc:               # round down to a divisor
        hc -= 1
    return 0 if hc >= h else hc


def _ssd_kernel(cfg: ModelConfig, xs, dt, a_log_neg, b, c) -> torch.Tensor:
    """y through K6 (``kernels.ops.ssd_scan``), S padded to a multiple of
    the chunk with dt = 0 rows (the kernel asserts divisibility)."""
    s = xs.shape[1]
    pad = (-s) % min(cfg.ssm_chunk, s)
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    return ssd_scan(xs, dt, a_log_neg, b, c, chunk=cfg.ssm_chunk)[:, :s]


def _conv(p: Dict, xbc: torch.Tensor, cache: Optional[Dict], decode: bool
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The causal depthwise conv of xbc (B,S,ch) -> (conv out (B,S,ch),
    the new window (B,K-1,ch)); a decode step continues the cache's
    window."""
    k = p["conv_w"].shape[0]
    if decode:
        if cache is None:
            raise ValueError("a Mamba2 decode step needs a cache")
        window = torch.cat([cache["conv"], xbc], dim=1)        # (B,K,ch)
        conv_out = torch.einsum("bkc,kc->bc", window[:, -k:], p["conv_w"])
        return (conv_out + p["conv_b"])[:, None], window[:, 1:]
    # the last K-1 inputs, zeros before the sequence's start
    return (_causal_conv(xbc, p["conv_w"], p["conv_b"]),
            F.pad(xbc, (0, 0, k - 1, 0))[:, -(k - 1):])


def mamba_block(cfg: ModelConfig, p: Dict, x_in: torch.Tensor,
                cache: Optional[Dict] = None,
                decode: bool = False) -> torch.Tensor:
    """x_in (B,S,d) (S == 1 for decode) -> out (B,S,d). With ``cache`` (a
    layer's ``{"conv", "ssm"}``) a prefill starts from its state and a
    decode step from its window and state; both write the new window and
    state into it in place.

    On a serving plan (``runtime_context.serve_shard`` with a Mamba2
    split, ``ServeShard.ssm``) the weights are the reference's contiguous
    cuts of the fused ``in_proj`` columns, the conv channels and the SSM
    heads, which do not line up (the fused fan-out z | x | B | C | dt is
    cut inside its parts): the rank gathers the projection's columns, runs
    the conv on its channels (its conv weights and cache) and gathers the
    conv's output, then runs the scan (K6 under ``ssd_impl="pallas"``) on
    its heads with their state, keeps its ``d_inner`` channels of their
    output (all of them, or fewer where the heads do not split as far as
    the channels, ``SsmSplit.inner``), then the gated RMSNorm over
    ``d_inner`` with its squares summed over the ranks, and ``out_proj``
    on its rows, summed over the ranks."""
    tp = runtime_context.serve_shard()
    sp = None if tp is None else tp.ssm
    zxbcdt = x_in @ p["in_proj"]                      # (B,S,fan_out)
    if sp is not None:
        zxbcdt = tp.gather(zxbcdt, sp.in_axes, -1)
    z, xbc, dt_raw = _split_in_proj(cfg, zxbcdt)
    if sp is not None:
        c0, cn = sp.conv
        conv_out, new_conv = _conv(p, xbc[..., c0:c0 + cn], cache, decode)
        conv_out = tp.gather(conv_out, sp.conv_axes, -1)
    else:
        conv_out, new_conv = _conv(p, xbc, cache, decode)

    xbc = F.silu(conv_out)
    xs, b, c = _split_xbc(cfg, xbc)
    heads, di = cfg.ssm_heads, cfg.d_inner
    if sp is not None:                    # this rank's heads and channels
        h0, heads = sp.heads
        i0, di = sp.inner
        xs, dt_raw = xs[:, :, h0:h0 + heads], dt_raw[..., h0:h0 + heads]
        z = z[..., i0:i0 + di]
    dt = F.softplus(dt_raw.float() + p["dt_bias"].float())
    a_log_neg = -torch.exp(p["A_log"].float())

    if decode:
        state, y = ssd_decode_step(cache["ssm"], xs[:, 0], dt[:, 0],
                                   a_log_neg, b[:, 0], c[:, 0])
        y = y[:, None]                                          # (B,1,H,P)
    elif cache is None and cfg.ssd_impl == "pallas":
        y, state = _ssd_kernel(cfg, xs, dt, a_log_neg, b, c).float(), None
    else:
        y, state = ssd_chunked(
            xs, dt, a_log_neg, b, c, chunk=cfg.ssm_chunk,
            init_state=None if cache is None else cache["ssm"],
            head_slice=_head_slice(cfg, xs.shape[0], xs.shape[1], heads))
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["ssm"].copy_(state)

    y = y + xs.float() * p["D"].float()[:, None]
    y = y.reshape(*y.shape[:2], -1)                             # (B,S,H P)
    if sp is not None:
        lo = i0 - h0 * cfg.ssm_headdim
        y = y[..., lo:lo + di]
    y = y * F.silu(z.float())
    if sp is None:
        y = rmsnorm(y.to(x_in.dtype), p["gate_norm"], cfg.norm_eps)
        return y @ p["out_proj"]
    # the gated RMSNorm over all of d_inner: its squares summed over ranks
    yf = y.to(x_in.dtype).float()
    ss = tp.reduce((yf * yf).sum(dim=-1, keepdim=True), sp.inner_axes)
    yf = yf * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
    y = (yf * p["gate_norm"].float()).to(x_in.dtype)
    return tp.reduce(y @ p["out_proj"], sp.inner_axes)
