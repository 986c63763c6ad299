"""Paged-attention decode and chunked-prefill: CUDA kernels and their twins.

One decode step attends one query per slot against that slot's KV pages
*in place*: the pools (num_pages, page_size, Hkv, D) are read through the
block table and never regathered into a dense per-slot view. Chunked
prefill does the same for a (B, C, Hq, D) block of queries whose row i
sits at absolute position ``starts[slot] + i``.

- ``paged_attention`` / ``paged_prefill`` are the kernel wrappers. On a
  CUDA tensor they launch the hand-written Hopper kernels of
  ``csrc/paged_attention.cu`` (K3 and K4, replacing the Pallas kernels
  ``_kernel`` and ``_prefill_kernel`` of ``repro/kernels/paged_attention.py``)
  or raise. On a CPU tensor they call the twin. K4 runs bfloat16 pools on
  the tensor cores (the tile core of ``csrc/attention_tc.cuh``, shared
  with K5) and float32 pools on the CUDA cores (the float32 tile core of
  ``csrc/attention_f32.cuh``, shared with K5, each tile's keys split over
  ``K4_F32_SPLITS`` blocks: ``k4_f32_plan``). K3 is split-K: each
  (slot, kv head) is one cluster of ``DECODE_SPLITS`` blocks of
  ``DECODE_WARPS`` warps; each warp takes a contiguous run of the slot's
  key chunks and the cluster combines the 32 partials in worker order,
  in one launch, for both dtypes. Both kernels take every head dim from
  1 to ``MAX_HEAD_DIM``: 64, 128 and 256 run their own instantiations,
  any other D a body instantiated at a padded width that reads past D as
  zeros (no operand is padded or copied).
- ``paged_decode_ref`` / ``paged_prefill_ref`` are the plain PyTorch twins:
  the online softmax of the JAX package's twins, bounded by the batch-max
  live page count, in float32 whatever the input dtype. They step over
  ``TWIN_PAGES`` pages at a time where the JAX twins step over one: the
  same function, summed in fewer, wider steps, so a twin engine at 1600
  keys a slot makes ~30x fewer launches a layer.

Masking follows the JAX package: decode keys ``col < length`` plus the
sliding-window band; prefill keys ``col <= pos_q`` plus the band; masked
scores are ``NEG_INF`` and masked V is *zeroed* (a select, never a
multiply), so NaN in unwritten page tails or in the scratch page never
reaches a live output.

``LAUNCHES`` counts kernel launches, one per wrapper call that launched;
calls that took the twin are not counted. ``F32_LAUNCHES`` counts the
launches of K4's float32 body among them.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import (MAX_GRID_Y, f32_grid,
                                                 f32_width)

NEG_INF = -1e30

# K3's work split (csrc/paged_attention.cu): blocks (one thread-block
# cluster) per (slot, kv head), warps per block, and the bytes of K (and
# of V) in one chunk of keys a warp stages at a time
DECODE_SPLITS = 8
DECODE_WARPS = 8
DECODE_CHUNK_BYTES = 2048

# pages the twins attend in one step of their online softmax
TWIN_PAGES = 32

# what K3 and K4 take: head dims 1 ... MAX_HEAD_DIM, up to MAX_REP query
# heads per kv head, pages of 1 ... MAX_PAGE rows (check_shapes)
MAX_HEAD_DIM = 256
MAX_REP = 32
MAX_PAGE = 64

# blocks of a cluster that split each 64-row tile's keys in K4's float32
# body, whatever the shape: a split that depended on the slots or the kv
# heads would change the bits of a launch folded over layers
# (ops.paged_prefill_layers) or of a rank's heads against one device's.
# On the card 2 gained most where one slot's grid is under a wave and
# cost least where many slots fill it (chip_smoke.py times both beside K4's
# float32 row)
K4_F32_SPLITS = 2

# launches of each CUDA kernel since the last reset_launch_counts(), and
# of them those of K4's float32 body
LAUNCHES: Dict[str, int] = {"paged_decode": 0, "paged_prefill": 0}
F32_LAUNCHES: Dict[str, int] = {"paged_prefill": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, F32_LAUNCHES):
        for k in counts:
            counts[k] = 0


# --------------------------------------------------------------------------
# plain PyTorch twins


def _online_update(m, l, acc, s, v_term):
    """One page of the (m, l, acc) recurrence; ``v_term(p)`` is p @ V."""
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l = l * alpha + p.sum(dim=-1)
    acc = acc * alpha[..., None] + v_term(p)
    return m_new, l, acc


def _n_live(lengths: torch.Tensor, page_size: int, npages: int) -> int:
    if lengths.numel() == 0:
        return 0
    top = int(lengths.max())
    return max(0, min(-(-top // page_size), npages))


def paged_decode_ref(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                     page_table: torch.Tensor, lengths: torch.Tensor, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """Decode attention against paged pools. q (B, Hq, D); kp/vp
    (num_pages, page_size, Hkv, D); page_table (B, npages); lengths (B,)
    valid tokens per slot (the current token's K/V already written).
    Returns (B, Hq, D) in q's dtype."""
    b, hq, d = q.shape
    page_size, hkv = kp.shape[1], kp.shape[2]
    rep = hq // hkv
    npages = page_table.shape[1]
    scale = d ** -0.5
    dev = q.device
    qg = q.reshape(b, hkv, rep, d).float()
    table = page_table.long()
    lengths = lengths.long()
    m = torch.full((b, hkv, rep), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, rep), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, rep, d), dtype=torch.float32, device=dev)
    n_live = _n_live(lengths, page_size, npages)
    for j in range(0, n_live, TWIN_PAGES):
        phys = table[:, j:min(j + TWIN_PAGES, n_live)]    # (B, pages)
        k = kp[phys].float().flatten(1, 2)                # (B, keys, Hkv, D)
        v = vp[phys].float().flatten(1, 2)
        s = torch.einsum("bgrd,bpgd->bgrp", qg, k) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        idx = j * page_size + torch.arange(k.shape[1], device=dev)
        valid = idx[None, :] < lengths[:, None]           # (B, keys)
        if window is not None:
            valid &= idx[None, :] > lengths[:, None] - 1 - window
        s = torch.where(valid[:, None, None, :], s, NEG_INF)
        v = torch.where(valid[:, :, None, None], v, 0.0)
        m, l, acc = _online_update(
            m, l, acc, s, lambda p: torch.einsum("bgrp,bpgd->bgrd", p, v))
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.reshape(b, hq, d).to(q.dtype)


def paged_prefill_ref(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                      page_table: torch.Tensor, lengths: torch.Tensor,
                      starts: torch.Tensor, *, window: Optional[int] = None,
                      softcap: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention against paged pools. q (B, C, Hq, D) with
    row i at absolute position ``starts + i``; lengths (B,) valid tokens
    per slot (the chunk's K/V already written); starts (B,). Returns
    (B, C, Hq, D) in q's dtype."""
    b, c, hq, d = q.shape
    page_size, hkv = kp.shape[1], kp.shape[2]
    rep = hq // hkv
    npages = page_table.shape[1]
    scale = d ** -0.5
    dev = q.device
    qg = q.reshape(b, c, hkv, rep, d).float()
    table = page_table.long()
    lengths = lengths.long()
    pos_q = starts.long()[:, None] + torch.arange(c, device=dev)   # (B, C)
    m = torch.full((b, hkv, rep, c), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, hkv, rep, c), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, rep, c, d), dtype=torch.float32, device=dev)
    n_live = _n_live(lengths, page_size, npages)
    for j in range(0, n_live, TWIN_PAGES):
        phys = table[:, j:min(j + TWIN_PAGES, n_live)]    # (B, pages)
        k = kp[phys].float().flatten(1, 2)                # (B, keys, Hkv, D)
        v = vp[phys].float().flatten(1, 2)
        s = torch.einsum("bcgrd,bpgd->bgrcp", qg, k) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        idx = j * page_size + torch.arange(k.shape[1], device=dev)
        ok = idx[None, None, :] <= pos_q[:, :, None]      # (B, C, keys)
        if window is not None:
            ok &= idx[None, None, :] > pos_q[:, :, None] - window
        s = torch.where(ok[:, None, None], s, NEG_INF)    # (B, g, r, C, keys)
        valid = idx[None, :] < lengths[:, None]           # (B, keys)
        v = torch.where(valid[:, :, None, None], v, 0.0)
        m, l, acc = _online_update(
            m, l, acc, s, lambda p: torch.einsum("bgrcp,bpgd->bgrcd", p, v))
    o = acc / torch.clamp(l, min=1e-30)[..., None]        # (B, g, r, C, D)
    return o.permute(0, 3, 1, 2, 4).reshape(b, c, hq, d).to(q.dtype)


# --------------------------------------------------------------------------
# kernel wrappers

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(q_shape, pool_shape, v_shape, q_dtype, k_dtype,
                 v_dtype) -> int:
    """What K3 and K4 take, from shapes and dtypes alone: q (B, Hq, D) or
    (B, C, Hq, D), pools (P, page, Hkv, D). Raises TypeError on the dtypes
    and ValueError on the shapes they do not take; returns the dtype's
    code."""
    if q_dtype not in _DTYPES or k_dtype != q_dtype or v_dtype != q_dtype:
        raise TypeError(f"paged kernels take float32 or bfloat16 q/kp/vp of "
                        f"one dtype, got {q_dtype}/{k_dtype}/{v_dtype}")
    pool_shape, v_shape = tuple(pool_shape), tuple(v_shape)
    if pool_shape != v_shape or len(pool_shape) != 4:
        raise ValueError(f"pools must be (P, page, Hkv, D), got "
                         f"{pool_shape} / {v_shape}")
    _, page_size, hkv, d = pool_shape
    hq = q_shape[-2]
    if q_shape[-1] != d or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim must match the pools and be 1 to "
                         f"{MAX_HEAD_DIM}, got q {tuple(q_shape)} pools "
                         f"{pool_shape}")
    if hkv < 1 or hq % hkv or hq // hkv > MAX_REP:
        raise ValueError(f"need Hq % Hkv == 0 and Hq/Hkv <= {MAX_REP}, got "
                         f"{hq}/{hkv}")
    if not 1 <= page_size <= MAX_PAGE:
        raise ValueError(f"page_size must be in [1, {MAX_PAGE}], got "
                         f"{page_size}")
    # K4's float32 grid has B * Hkv rows (rep <= MAX_REP fits one tile)
    if len(q_shape) == 4 and q_dtype == torch.float32 \
            and q_shape[0] * hkv > MAX_GRID_Y:
        raise ValueError(f"B * Hkv = {q_shape[0] * hkv} exceeds the float32 "
                         f"grid's {MAX_GRID_Y}")
    return _DTYPES[q_dtype]


def k4_f32_plan(tokens: int, batch: int, hq: int, hkv: int,
                d: int) -> Tuple[int, Tuple[int, int], int]:
    """K4's float32 launch as the kernel computes it: ``(splits, grid,
    padded width)``, the float32 core's 64-row tiles split over
    ``K4_F32_SPLITS`` blocks."""
    return (K4_F32_SPLITS, f32_grid(tokens, batch, hq, hkv, K4_F32_SPLITS),
            f32_width(d))


def _check(q, kp, vp, page_table, ints):
    """Validate what the kernels take; returns (Hkv, D, page, npages,
    dtype code) or raises."""
    dev = q.device
    for name, t in (("kp", kp), ("vp", vp), ("page_table", page_table),
                    *ints.items()):
        if t.device != dev:
            raise ValueError(f"{name} on {t.device}, q on {dev}")
    code = check_shapes(q.shape, kp.shape, vp.shape, q.dtype, kp.dtype,
                        vp.dtype)
    for name, t in (("q", q), ("kp", kp), ("vp", vp)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    _, page_size, hkv, d = kp.shape
    return hkv, d, page_size, page_table.shape[1], code


def _i32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.int32).contiguous()


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _opts(window: Optional[int], softcap: Optional[float]):
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    return (-1 if window is None else int(window),
            0.0 if softcap is None else float(softcap))


def paged_attention(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                    page_table: torch.Tensor, lengths: torch.Tensor, *,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """Decode attention, q (B, Hq, D) -> (B, Hq, D): the K3 kernel on a
    CUDA tensor, the twin on a CPU tensor."""
    if q.device.type == "cpu":
        return paged_decode_ref(q, kp, vp, page_table, lengths,
                                window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if q.dim() != 3:
        raise ValueError(f"q must be (B, Hq, D), got {tuple(q.shape)}")
    table, lens = _i32(page_table), _i32(lengths)
    hkv, d, page_size, npages, code = _check(
        q, kp, vp, table, {"lengths": lens})
    b, hq, _ = q.shape
    if table.shape[0] != b or lens.shape != (b,):
        raise ValueError("page_table (B, npages) and lengths (B,) must match q")
    win, cap = _opts(window, softcap)
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_decode_launch(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            lens.data_ptr(), out.data_ptr(), b, hq, hkv, d, page_size,
            npages, win, cap, code, stream)
    _raise_on(err, "paged_decode_kernel")
    build.count_launch(LAUNCHES, "paged_decode")
    return out


def paged_prefill(q: torch.Tensor, kp: torch.Tensor, vp: torch.Tensor,
                  page_table: torch.Tensor, lengths: torch.Tensor,
                  starts: torch.Tensor, *, window: Optional[int] = None,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill attention, q (B, C, Hq, D) -> (B, C, Hq, D): the K4
    kernel on a CUDA tensor, the twin on a CPU tensor. Any C is taken:
    the kernel masks the ragged last query tile."""
    if q.device.type == "cpu":
        return paged_prefill_ref(q, kp, vp, page_table, lengths, starts,
                                 window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill runs on cuda or cpu, not {q.device}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B, C, Hq, D), got {tuple(q.shape)}")
    table, lens, st = _i32(page_table), _i32(lengths), _i32(starts)
    hkv, d, page_size, npages, code = _check(
        q, kp, vp, table, {"lengths": lens, "starts": st})
    b, c, hq, _ = q.shape
    if table.shape[0] != b or lens.shape != (b,) or st.shape != (b,):
        raise ValueError("page_table (B, npages), lengths (B,) and starts "
                         "(B,) must match q")
    win, cap = _opts(window, softcap)
    splits = K4_F32_SPLITS if code == 0 else 0
    out = torch.empty_like(q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.paged_prefill_launch(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), table.data_ptr(),
            lens.data_ptr(), st.data_ptr(), out.data_ptr(), b, c, hq, hkv,
            d, page_size, npages, win, cap, code, splits, stream)
    _raise_on(err, "paged_prefill_kernel")
    build.count_launch(LAUNCHES, "paged_prefill")
    if code == 0:
        build.count_launch(F32_LAUNCHES, "paged_prefill")
    return out
