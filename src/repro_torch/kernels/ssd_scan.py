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
  state, x scaled for the state update) entering as a bf16 hi + lo pair,
  the chunks walked in order inside a block. float32 inputs run float32
  on the CUDA cores in three launches (the chunk-parallel form, planned by
  ``f32_plan`` from the shapes alone): step A, every chunk's cumsum and
  own end state and every (batch, group, chunk)'s scores C B^T; step B,
  the states passed from chunk to chunk; step C, every chunk's y from its
  entering state and the scores, which the heads of a group share. Their
  intermediates live in a float32 scratch the wrapper allocates. Both take
  every head dim P and state width N from 1 to ``MAX_SIZE``: today's sizes
  (16, 32, 64, 128) run their own instantiations, any other a body
  instantiated at a padded width that reads past P and N as zeros (no
  operand is padded).
- ``ssd_scan_ref`` is the plain PyTorch twin: the TPU kernel's formula,
  one chunk at a time (masked quadratic form, the carried state's term,
  the state update), batched over (batch, head). It is not the model's
  ``ssd_chunked``, so that a fault of the formula shows against the JAX
  package's recurrence.

Both keep the cumsum, decays and state in float32 and return y in x's
dtype. The JAX package has no
backward for the kernel; ``kernels.ops.ssd_scan`` raises when autograd
records a call.

``LAUNCHES`` counts wrapper calls that launched, one per call however many
kernels it runs (the float32 route runs three); ``F32_LAUNCHES`` those of
them that took the float32 route.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import build

MAX_CHUNK = 2048       # per-row tables of a chunk sit in shared memory
MAX_SIZE = 128         # head_dim P and state N: 1 ... MAX_SIZE
ROWS_MAX = 64          # state rows of P one block owns

# the float32 route's sizes (csrc/ssd_scan.cu, namespace ssd_f32): t rows
# of a step-C block and score tiles of F32_TILE x F32_TILE; (head, P slice)
# units of a step-C block; step B's threads a block. The card tests hold
# f32_plan, which uses them, to the C source's own plan (ssd_f32_plan).
F32_TILE = 64
F32_UNITS = 4
F32_THREADS_B = 256

# wrapper calls that launched since the last reset_launch_counts(), and of
# them those of the float32 route
LAUNCHES: Dict[str, int] = {"ssd_scan": 0}
F32_LAUNCHES: Dict[str, int] = {"ssd_scan": 0}


def reset_launch_counts() -> None:
    for counts in (LAUNCHES, F32_LAUNCHES):
        for k in counts:
            counts[k] = 0


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
    """The bf16 route's slices of the P state rows per (batch, head): at
    most ROWS_MAX rows a block, halved (down to 16) while twice the blocks
    still fit one wave of ``sms`` blocks. Its body runs one block per SM,
    so a grid past ``sms`` blocks takes a second wave, and every slice
    recomputes the scores C B^T. A slice holds ceil(P / n) rows, the last
    one fewer. The slices compute the same values. (The float32 route
    splits P by shapes alone: ``f32_plan``.)"""
    n = 1
    while -(-p // n) > ROWS_MAX or (2 * blocks * n <= sms
                                    and -(-p // (2 * n)) >= 16):
        n *= 2
    return n


def _pad(v: int, sizes) -> int:
    return next(w for w in sizes if v <= w)


@dataclasses.dataclass(frozen=True)
class F32Plan:
    """The float32 route's launches, from the shapes alone (no SM count):
    P slices; (head, P slice) units a step-C block; the three grids (step
    B's is None with one chunk); the scratch's size in bytes."""
    nsplit: int
    units: int
    grid_a: int
    grid_b: Optional[Tuple[int, int]]
    grid_c: int
    scratch_bytes: int


def f32_plan(b: int, s: int, h: int, g: int, p: int, n: int,
             lc: int) -> F32Plan:
    """``csrc/ssd_scan.cu``'s float32 launches for x (b, s, h, p), b/c
    (b, s, g, n) and chunk length ``lc``: P in ceil(P / 64) slices; step A
    one block per (batch, head, chunk, slice) and per (batch, group,
    chunk, lower 64 x 64 score tile); step B (batch x head, 256-float4
    stretches of a state); step C one block per (batch, chunk, 64-row t
    tile, group, F32_UNITS units). The scratch (ssd_f32::layout): (cum, dt)
    per (b, h, s), a state of padded N x P per (b, h, chunk but the last),
    the score tiles; each region at a multiple of 64 floats. The C entry
    ``ssd_f32_plan`` returns the same fields from the code that launches
    (``test_ssd_f32_plan_matches_the_c_entry`` on the card), and
    ``ssd_scan_launch`` refuses a scratch shorter than its layout."""
    nsplit = -(-p // ROWS_MAX)
    nw = _pad(n, (16, 32, 64, 128))
    pw = nsplit * _pad(-(-p // nsplit), (16, 32, 64))
    nc, nt = s // lc, -(-lc // F32_TILE)
    ntri = nt * (nt + 1) // 2

    def up(v):
        return -(-v // 64) * 64

    floats = (up(b * h * s * 2) + up(b * h * max(nc - 1, 0) * nw * pw)
              + b * g * nc * ntri * F32_TILE ** 2)
    blocks = -(-(h // g) * nsplit // F32_UNITS)
    return F32Plan(
        nsplit=nsplit, units=F32_UNITS,
        grid_a=b * h * nc * nsplit + b * g * nc * ntri,
        grid_b=((b * h, -(-nw * pw // 4 // F32_THREADS_B)) if nc > 1
                else None),
        grid_c=b * nc * nt * g * blocks, scratch_bytes=4 * floats)


_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    t = t.contiguous()
    return t.clone() if t.data_ptr() % 16 else t


def check_shapes(x_shape, dt_shape, a_shape, b_shape, c_shape, x_dtype,
                 b_dtype, c_dtype, chunk: int) -> int:
    """What K6 takes, from shapes and dtypes alone (the JAX package's
    layouts). Raises TypeError on the dtypes and ValueError on the shapes
    it does not take; returns the chunk length."""
    if x_dtype not in _DTYPES or b_dtype != x_dtype or c_dtype != x_dtype:
        raise TypeError(f"K6 takes float32 or bfloat16 x/b/c of one dtype, "
                        f"got {x_dtype}/{b_dtype}/{c_dtype}")
    x_shape, b_shape, c_shape = (tuple(t) for t in (x_shape, b_shape,
                                                    c_shape))
    if len(x_shape) != 4 or len(b_shape) != 4 or b_shape != c_shape:
        raise ValueError(f"need x (B, S, H, P) and b, c (B, S, G, N), got "
                         f"{x_shape}, {b_shape}, {c_shape}")
    bsz, s, h, p = x_shape
    g, n = b_shape[2], b_shape[3]
    if (tuple(dt_shape) != (bsz, s, h) or tuple(a_shape) != (h,)
            or b_shape[:2] != (bsz, s)):
        raise ValueError(f"need dt (B, S, H), a (H,) and b/c (B, S, G, N) "
                         f"for x {x_shape}, got dt {tuple(dt_shape)}, "
                         f"a {tuple(a_shape)}, b {b_shape}")
    if g < 1 or h % g:
        raise ValueError(f"need H % G == 0, got H {h}, G {g}")
    if not (1 <= p <= MAX_SIZE and 1 <= n <= MAX_SIZE):
        raise ValueError(f"K6 takes P and N in 1 ... {MAX_SIZE}, got P {p}, "
                         f"N {n}")
    lc = _chunk_len(s, chunk)
    if lc > MAX_CHUNK:
        raise ValueError(f"chunk {lc} > {MAX_CHUNK}")
    return lc


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a_log_neg: torch.Tensor,
             b: torch.Tensor, c: torch.Tensor, *,
             chunk: int = 128) -> torch.Tensor:
    """K6 on CUDA tensors: the signature and layouts of the JAX package's
    ``ssd_scan``. x, b, c float32 or bfloat16 of one dtype, P and N in
    1 ... 128, H % G == 0, S % min(chunk, S) == 0, chunk <= 2048; dt
    and a_log_neg are used in float32. Returns y (B, S, H, P) in x's
    dtype. bfloat16: the P state rows of a head are split across
    ``p_splits`` blocks; float32: ``f32_plan``'s three launches over a
    scratch allocated here. Raises on a CPU tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan launches the CUDA kernel K6 and needs "
                         f"CUDA tensors, got {x.device} (the twin is "
                         "kernels.ops.ssd_scan on the CPU)")
    for name, t in (("dt", dt), ("a_log_neg", a_log_neg), ("b", b),
                    ("c", c)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
    lc = check_shapes(x.shape, dt.shape, a_log_neg.shape, b.shape, c.shape,
                      x.dtype, b.dtype, c.dtype, chunk)
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    scratch = None
    if x.dtype == torch.float32:
        plan = f32_plan(bsz, s, h, g, p, n, lc)
        nsplit = plan.nsplit
        scratch = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                              device=x.device)
    else:
        sms = torch.cuda.get_device_properties(
            x.device).multi_processor_count
        nsplit = p_splits(bsz * h, p, sms)
    x, b, c = (_aligned(t) for t in (x, b, c))
    dt, a = (_aligned(t.float()) for t in (dt, a_log_neg))
    y = torch.empty_like(x)
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_launch(
            x.data_ptr(), dt.data_ptr(), a.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            0 if scratch is None else scratch.numel() * 4, bsz, s, h, g, p,
            n, lc, nsplit, _DTYPES[x.dtype], stream)
    _raise_on(err, "ssd_scan")
    build.count_launch(LAUNCHES, "ssd_scan")
    if x.dtype == torch.float32:
        build.count_launch(F32_LAUNCHES, "ssd_scan")
    return y
