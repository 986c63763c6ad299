"""Mamba2 SSD chunk scan: the CUDA kernel K6 and its twin.

The state-space-duality scan of one Mamba2 layer with a zero initial
state, output only: x (B, S, H, P), dt (B, S, H), a (H,) negative,
b, c (B, S, G, N), head h reading B/C group h // (H / G). The sequence is
cut into chunks of l = min(chunk, S) rows (S % l == 0); for each (batch,
head) the chunks run in order carrying a float32 state (P, N):

- ``cum`` = inclusive cumsum of a * dt over the chunk, u = x * dt;
- y = [(C B^T) o exp(cum_t - cum_s)]_{t >= s} u + exp(cum) (C state^T);
- state <- state exp(cum_L) + (u o exp(cum_L - cum))^T B.

- ``ssd_scan`` is the kernel wrapper. On a CUDA tensor it launches the
  hand-written Hopper kernel of ``csrc/ssd_scan.cu`` (K6, replacing the
  Pallas kernel ``_kernel`` of ``repro/kernels/ssd_scan.py``) or raises;
  it raises on a CPU tensor. ``kernels.ops.ssd_scan`` is the entry point
  that takes the twin for CPU tensors. bfloat16 inputs run the four
  products of a chunk on the tensor cores (bf16 ``mma.sync``, float32
  accumulation), each float32 operand (the decayed scores, the carried
  state, x scaled for the state update) entering as a bf16 hi + lo pair;
  float32 inputs run float32 on the CUDA cores.
- ``ssd_scan_ref`` is the plain PyTorch twin: the TPU kernel's formula,
  one chunk at a time (masked quadratic form, the carried state's term,
  the state update), batched over (batch, head). It is not the model's
  ``ssd_chunked``, so that a fault of the formula shows against the JAX
  package's recurrence.

Both keep the cumsum, decays and state in float32 and return y in x's
dtype. The JAX package has no
backward for the kernel; ``kernels.ops.ssd_scan`` raises when autograd
records a call.

``LAUNCHES`` counts kernel launches, one per wrapper call that launched.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import build

MAX_CHUNK = 2048       # per-row tables of a chunk sit in shared memory
SIZES = (16, 32, 64, 128)   # head_dim P and state N the kernel takes
ROWS_MAX = 64          # state rows of P one block owns

# launches of the CUDA kernel since the last reset_launch_counts()
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _chunk_len(s: int, chunk: int) -> int:
    lc = min(chunk, s)
    if lc < 1 or s % lc:
        raise ValueError(f"ssd_scan needs S % min(chunk, S) == 0, got S {s}, "
                         f"chunk {chunk} (pad S with dt = 0 rows)")
    return lc


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a_log_neg: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor, *,
                 chunk: int = 128) -> torch.Tensor:
    """Plain PyTorch twin of K6. x (B, S, H, P); dt (B, S, H); a_log_neg
    (H,); b, c (B, S, G, N) -> y (B, S, H, P) in x's dtype, float32
    math."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    lc = _chunk_len(s, chunk)
    rep = h // g
    a = a_log_neg.float()
    mask = torch.ones((lc, lc), dtype=torch.bool, device=x.device).tril()
    keep = mask[None, :, :, None]                            # (1, t, s, 1)
    state = torch.zeros((bsz, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, lc):
        dtc = dt[:, c0:c0 + lc].float()                      # (B, L, H)
        u = x[:, c0:c0 + lc].float() * dtc[..., None]        # (B, L, H, P)
        bc = b[:, c0:c0 + lc].float().repeat_interleave(rep, dim=2)
        cc = c[:, c0:c0 + lc].float().repeat_interleave(rep, dim=2)
        cum = torch.cumsum(a * dtc, dim=1)                   # (B, L, H)
        # mask before the exp: the exponent is > 0 above the diagonal
        dec = torch.where(keep, cum[:, :, None] - cum[:, None], 0.0)
        w = torch.einsum("bthn,bshn->btsh", cc, bc)
        w = torch.where(keep, w * torch.exp(dec), 0.0)
        y = torch.einsum("btsh,bshp->bthp", w, u)
        y = y + torch.exp(cum)[..., None] * torch.einsum(
            "bthn,bhpn->bthp", cc, state)
        w_end = torch.exp(cum[:, -1:] - cum)                 # (B, L, H)
        state = (state * torch.exp(cum[:, -1])[:, :, None, None]
                 + torch.einsum("bshp,bshn->bhpn", u * w_end[..., None], bc))
        ys.append(y)
    return torch.cat(ys, 1).to(x.dtype)


# K6 against its twin on the same inputs, element by element: |K6 - twin|
# <= RTOL[dtype] |twin| + ATOL_REL max|twin|. float32 sums over up to L
# rows and N state columns and the chunk's cumsum run in another order (a
# few float32 ulps); a bfloat16 y carries one rounding more (half an ulp,
# 2^-8 of |y|). The ATOL_REL term covers outputs near zero, where terms of
# size max|y| cancel.
RTOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -8 + 1e-5}
ATOL_REL = 1e-5


def error_ratio(got: torch.Tensor, want: torch.Tensor) -> float:
    """max of |got - want| / (RTOL[got.dtype] |want| + ATOL_REL
    max|want|): at most 1 when K6 (``got``) agrees with its float32 twin
    (``want``); NaN anywhere gives inf."""
    w = want.float()
    err = (got.float() - w).abs()
    scale = RTOL[got.dtype] * w.abs() + ATOL_REL * w.abs().max()
    ratio = (err / scale).max()
    return float("inf") if not torch.isfinite(ratio) else float(ratio)


def p_splits(blocks: int, p: int, sms: int) -> int:
    """Slices of the P state rows per (batch, head): at most ROWS_MAX rows
    a block, halved (down to 16) while twice the blocks still fit one
    wave of ``sms`` blocks. Both K6 bodies run one block per SM, so a grid
    past ``sms`` blocks takes a second wave, and every slice recomputes
    the scores C B^T. The slices compute the same values."""
    n = 1
    while p // n > ROWS_MAX or (2 * blocks * n <= sms and p // (2 * n) >= 16):
        n *= 2
    return n


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log_neg: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """K6 on CUDA tensors: the signature and layouts of the JAX package's
    ``ssd_scan``. x, b, c float32 or bfloat16 of one dtype, P and N in
    16/32/64/128, H % G == 0, S % min(chunk, S) == 0, chunk <= 2048; dt
    and a_log_neg are used in float32. Returns y (B, S, H, P) in x's
    dtype; the P state rows of a head are split across ``p_splits``
    blocks. Raises on a CPU tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan launches the CUDA kernel K6 and needs "
                         f"CUDA tensors, got {x.device} (the twin is "
                         "kernels.ops.ssd_scan on the CPU)")
    for name, t in (("dt", dt), ("a_log_neg", a_log_neg), ("b", b),
                    ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    if x.dtype not in _DTYPES or b.dtype != x.dtype or c.dtype != x.dtype:
        raise TypeError(f"K6 takes float32 or bfloat16 x/b/c of one dtype, "
                        f"got {x.dtype}/{b.dtype}/{c.dtype}")
    if x.dim() != 4 or b.dim() != 4 or b.shape != c.shape:
        raise ValueError(f"need x (B, S, H, P) and b, c (B, S, G, N), got "
                         f"{tuple(x.shape)}, {tuple(b.shape)}, "
                         f"{tuple(c.shape)}")
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    if (tuple(dt.shape) != (bsz, s, h) or tuple(a_log_neg.shape) != (h,)
            or tuple(b.shape[:2]) != (bsz, s)):
        raise ValueError(f"need dt (B, S, H), a (H,) and b/c (B, S, G, N) "
                         f"for x {tuple(x.shape)}, got dt {tuple(dt.shape)}, "
                         f"a {tuple(a_log_neg.shape)}, b {tuple(b.shape)}")
    if g < 1 or h % g:
        raise ValueError(f"need H % G == 0, got H {h}, G {g}")
    if p not in SIZES or n not in SIZES:
        raise ValueError(f"K6 takes P and N in {SIZES}, got P {p}, N {n}")
    lc = _chunk_len(s, chunk)
    if lc > MAX_CHUNK:
        raise ValueError(f"chunk {lc} > {MAX_CHUNK}")
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    nsplit = p_splits(bsz * h, p, sms)
    x, b, c = (_aligned(t) for t in (x, b, c))
    dt, a = (_aligned(t.float()) for t in (dt, a_log_neg))
    y = torch.empty_like(x)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), bsz, s, h, g, p, n, lc, nsplit,
            _DTYPES[x.dtype], stream)
    _raise_on(err, "ssd_scan_kernel")
    build.count_launch(LAUNCHES, "ssd_scan")
    return y
