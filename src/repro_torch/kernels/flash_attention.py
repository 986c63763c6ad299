"""Dense flash attention (forward): the CUDA kernel K5 and its twin.

Full-sequence attention of q (B, Sq, Hq, D) against k, v (B, Sk, Hkv, D)
with GQA (kv head = q head // (Hq / Hkv)), in the contiguous layout the
model's forward uses: query row i and key column j sit at positions i and
j. Scores are float32, scaled by D^-0.5, then softcapped, then masked
(``NEG_INF``): causal keeps j <= i, and the sliding window, which applies
only when ``causal`` is true, keeps i - j < window.

- ``flash_attention`` is the kernel wrapper. On a CUDA tensor it launches
  the hand-written Hopper kernel of ``csrc/flash_attention.cu`` (K5,
  replacing the Pallas kernel ``_kernel`` of
  ``repro/kernels/flash_attention.py``) or raises; it raises on a CPU
  tensor. bfloat16 inputs run on the tensor cores (the tile core of
  ``csrc/attention_tc.cuh``, which also rounds the softmax weights to
  bfloat16 for the P.V product), float32 inputs on the CUDA cores in
  float32 (the tile core of ``csrc/attention_f32.cuh``, shared with K4's
  float32 body, its key split and grid chosen by ``f32_plan``). Both
  take every head dim from 1 to ``MAX_HEAD_DIM``: 64, 128 and 256 run
  their own instantiations, any other D a body instantiated at a padded
  width that reads past D as zeros (no operand is padded).
  ``kernels.ops.flash_attention`` is the entry point that takes the twin
  for CPU tensors.
- ``flash_attention_ref`` is the plain PyTorch twin: the function of the
  JAX package's oracle (``repro/kernels/ref.py::flash_attention_ref``), a
  softmax over the full masked score rows in float32, a block of query
  rows at a time so that no (Sq, Sk) score matrix is ever whole.

The JAX package has no backward for this kernel: both paths are
forward-only and raise when autograd asks for a gradient through them.

``LAUNCHES`` counts kernel launches, one per wrapper call that launched;
``F32_LAUNCHES`` those of them that ran the float32 body.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

NEG_INF = -1e30
Q_ROWS = 1024       # query rows per block of the twin
MAX_HEAD_DIM = 256  # K5 takes head dims 1 ... MAX_HEAD_DIM (check_shapes)
# the grid's rows: B * Hq for the bf16 body, B * Hkv * ceil(rep / 64) for
# the float32 core
MAX_GRID_Y = 65535
# the float32 core's rows a block (16 a warp), the most blocks of a cluster
# that split a tile's keys, and the SMs of a wave on the H100 (K5's split
# fills one)
F32_ROWS = 64
F32_MAX_SPLITS = 8
WAVE_SMS = 132

# launches of the CUDA kernel since the last reset_launch_counts(), and of
# them those of the float32 body
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
F32_LAUNCHES: Dict[str, int] = {"flash_attention": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, F32_LAUNCHES):
        for k in counts:
            counts[k] = 0


def f32_width(d: int) -> int:
    """The float32 core's instantiated width for head dim d: D at 64, 128
    and 256, else D rounded up to a multiple of 32."""
    return d if d in (64, 128, 256) else -(-d // 32) * 32


def f32_grid(tokens: int, batch: int, hq: int, hkv: int,
             splits: int) -> Tuple[int, int]:
    """The float32 core's grid: (tiles * splits, B * Hkv * head groups), a
    tile of ``F32_ROWS`` rows holding hr = min(rep, 64) heads of 64 // hr
    tokens."""
    rep = hq // hkv
    hr = min(rep, F32_ROWS)
    return (-(-tokens // (F32_ROWS // hr)) * splits,
            batch * hkv * -(-rep // hr))


def f32_plan(tokens: int, keys: int, batch: int, hq: int, hkv: int, d: int,
             sms: int = WAVE_SMS) -> Tuple[int, Tuple[int, int], int]:
    """K5's float32 launch as the kernel computes it from the split:
    ``(splits, grid, padded width)``. Where the tiles leave the grid under
    one wave of ``sms`` blocks, a cluster of 2, 4 or 8 blocks splits each
    tile's keys: the fewest that fill the wave, while each block keeps at
    least 4 key tiles of the ``keys`` (a tile is 64 keys up to width 64,
    else 32)."""
    width = f32_width(d)
    key_tiles = -(-keys // (64 if width <= 64 else 32))
    splits = 1
    while splits < F32_MAX_SPLITS and key_tiles >= 8 * splits:
        x, y = f32_grid(tokens, batch, hq, hkv, splits)
        if x * y >= sms:
            break
        splits *= 2
    return splits, f32_grid(tokens, batch, hq, hkv, splits), width


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True, window: Optional[int] = None,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch twin of K5. q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D) ->
    (B, Sq, Hq, D) in q's dtype, float32 math."""
    b, sq, hq, d = q.shape
    sk, g = k.shape[1], k.shape[2]
    kf = k.float()
    vf = v.float()
    cols = torch.arange(sk, device=q.device)
    outs = []
    for i in range(0, sq, Q_ROWS):
        qi = q[:, i:i + Q_ROWS].float()
        n = qi.shape[1]
        s = torch.einsum("bqgrd,bkgd->bgrqk", qi.reshape(b, n, g, hq // g, d),
                         kf) * (d ** -0.5)
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        if causal:
            diff = (i + torch.arange(n, device=q.device))[:, None] - cols
            keep = diff >= 0
            if window is not None:
                keep &= diff < window
            s = torch.where(keep, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bgrqk,bkgd->bqgrd", p, vf)
                    .reshape(b, n, hq, d))
    return torch.cat(outs, dim=1).to(q.dtype)


class _ForwardOnly(torch.autograd.Function):
    """Records the call for autograd and raises if a backward reaches
    it: K5 and its twin have no gradient (nor does the Pallas kernel)."""

    @staticmethod
    def forward(ctx, fn, opts, q, k, v):
        return fn(q, k, v, **opts)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "flash_attention (K5, attn_impl='pallas') is forward-only, as "
            "in the JAX package: train with attn_impl='chunked'")


def forward_only(fn: Callable, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, **opts) -> torch.Tensor:
    """``fn(q, k, v, **opts)``, through ``_ForwardOnly`` when autograd
    records a tensor of the call."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _ForwardOnly.apply(fn, opts, q, k, v)
    return fn(q, k, v, **opts)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def check_shapes(q_shape, k_shape, v_shape, q_dtype, k_dtype,
                 v_dtype) -> int:
    """What K5 takes, from shapes and dtypes alone: q (B, Sq, Hq, D), k, v
    (B, Sk, Hkv, D). Raises TypeError on the dtypes and ValueError on the
    shapes it does not take; returns the dtype's code."""
    if q_dtype not in _DTYPES or k_dtype != q_dtype or v_dtype != q_dtype:
        raise TypeError(f"K5 takes float32 or bfloat16 q/k/v of one dtype, "
                        f"got {q_dtype}/{k_dtype}/{v_dtype}")
    q_shape, k_shape, v_shape = (tuple(x) for x in (q_shape, k_shape,
                                                    v_shape))
    if len(q_shape) != 4 or len(k_shape) != 4 or k_shape != v_shape:
        raise ValueError(f"need q (B, Sq, Hq, D) and k, v (B, Sk, Hkv, D), "
                         f"got {q_shape}, {k_shape}, {v_shape}")
    b, _, hq, d = q_shape
    hkv = k_shape[2]
    if k_shape[0] != b or k_shape[3] != d or not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"batch and head_dim must match and head_dim be 1 "
                         f"to {MAX_HEAD_DIM}, got q {q_shape} k {k_shape}")
    if hkv < 1 or hq % hkv:
        raise ValueError(f"need Hq % Hkv == 0, got {hq}/{hkv}")
    if q_dtype == torch.float32:
        rep = hq // hkv
        grid_y = b * hkv * -(-rep // min(rep, F32_ROWS))
        if grid_y > MAX_GRID_Y:
            raise ValueError(f"B * Hkv * ceil(rep / 64) = {grid_y} exceeds "
                             f"the grid's {MAX_GRID_Y}")
    elif b * hq > MAX_GRID_Y:
        raise ValueError(f"B * Hq = {b * hq} exceeds the grid's "
                         f"{MAX_GRID_Y}")
    return _DTYPES[q_dtype]


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
            causal: bool, window: Optional[int],
            softcap: Optional[float]) -> torch.Tensor:
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention launches the CUDA kernel K5 and "
                         f"needs CUDA tensors, got {q.device} (the twin is "
                         "kernels.ops.flash_attention on the CPU)")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
    code = check_shapes(q.shape, k.shape, v.shape, q.dtype, k.dtype, v.dtype)
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be > 0 or None, got {softcap}")
    # 16-byte loads: contiguous rows from an aligned start
    q, k, v = (t.contiguous() for t in (q, k, v))
    q, k, v = (t.clone() if t.data_ptr() % 16 else t for t in (q, k, v))
    out = torch.empty_like(q)
    win = -1 if window is None or not causal else int(window)
    cap = 0.0 if softcap is None else float(softcap)
    splits = 0
    if code == 0:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        splits = f32_plan(sq, sk, b, hq, hkv, d, sms)[0]
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            sk, hq, hkv, d, int(causal), win, cap, code, splits, stream)
    _raise_on(err, "flash_attention_kernel")
    build.count_launch(LAUNCHES, "flash_attention")
    if code == 0:
        build.count_launch(F32_LAUNCHES, "flash_attention")
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None) -> torch.Tensor:
    """K5 on CUDA tensors: q (B, Sq, Hq, D), k, v (B, Sk, Hkv, D) ->
    (B, Sq, Hq, D) in q's dtype; float32 or bfloat16, D 1 ... 256, any Sq
    and Sk. Raises on a CPU tensor and in a backward."""
    return forward_only(_launch, q, k, v, causal=causal, window=window,
                        softcap=softcap)
