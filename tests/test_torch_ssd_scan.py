"""The twin of the SSD chunk-scan kernel K6 against the JAX package's
Pallas kernel (interpret mode), and the port's dispatch around it.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the JAX package's own for its sweep (rtol = atol = 2e-4,
``tests/test_kernels.py``: float32 sums in another order, and another
cumsum); bfloat16 inputs give bfloat16 outputs computed in float32 by
both, which may round one bf16 ulp apart (rtol = atol = 2^-7).
"""
import ctypes
import inspect
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import build
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss

TOL = 2e-4
TOL_BF16 = 2 ** -7


def _inputs(shape, seed=0, slow=False):
    """x, dt, a, b, c in float32 numpy. ``slow``: dt in [0.01, 0.1] and a
    in [-0.1, -0.01], so a * dt is near 0 and the state carried across
    chunks stays a large part of y."""
    b, s, h, p, g, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    if slow:
        dt = rng.uniform(0.01, 0.1, (b, s, h)).astype(np.float32)
        a = -rng.uniform(0.01, 0.1, h).astype(np.float32)
    else:
        dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(
            np.float32)
        a = -np.exp(rng.standard_normal(h)).astype(np.float32)
    bb = rng.standard_normal((b, s, g, n)).astype(np.float32)
    cc = rng.standard_normal((b, s, g, n)).astype(np.float32)
    return x, dt, a, bb, cc


def _jax(arrs, chunk, dtype=jnp.float32):
    x, dt, a, bb, cc = arrs
    y = jops.ssd_scan(jnp.asarray(x, dtype), jnp.asarray(dt, dtype),
                      jnp.asarray(a), jnp.asarray(bb, dtype),
                      jnp.asarray(cc, dtype), chunk=chunk, interpret=True)
    return np.asarray(y.astype(jnp.float32))


def _twin(arrs, chunk, dtype=torch.float32):
    x, dt, a, bb, cc = (torch.from_numpy(t) for t in arrs)
    return ss.ssd_scan_ref(x.to(dtype), dt.to(dtype), a, bb.to(dtype),
                           cc.to(dtype), chunk=chunk)


@pytest.mark.parametrize("shape", [
    (1, 64, 2, 16, 1, 8), (2, 128, 4, 32, 2, 16), (1, 256, 8, 64, 1, 32),
])
def test_twin_matches_pallas_kernel_sweep(shape):
    arrs = _inputs(shape, seed=shape[1])
    np.testing.assert_allclose(_twin(arrs, 32).numpy(), _jax(arrs, 32),
                               rtol=TOL, atol=TOL)


def test_twin_matches_pallas_kernel_bf16():
    arrs = _inputs((1, 64, 2, 16, 1, 8), seed=1)
    got = _twin(arrs, 32, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               _jax(arrs, 32, jnp.bfloat16),
                               rtol=TOL_BF16, atol=TOL_BF16)


def test_multi_chunk_slow_decay_and_a_dropped_carry_control():
    """Eight chunks with slow decay: the twin agrees with the Pallas
    kernel, and the twin run chunk by chunk from a zero state (what a
    kernel that drops the inter-chunk term returns) misses by > 100x the
    tolerance."""
    arrs = _inputs((2, 256, 4, 32, 2, 16), seed=2, slow=True)
    want = _jax(arrs, 32)
    np.testing.assert_allclose(_twin(arrs, 32).numpy(), want, rtol=TOL,
                               atol=TOL)
    cut = np.concatenate([
        _twin([t[:, c0:c0 + 32] if t.ndim > 1 else t for t in arrs],
              32).numpy() for c0 in range(0, 256, 32)], 1)
    ratio = np.abs(cut - want) / (TOL + TOL * np.abs(want))
    assert ratio.max() > 100


def test_error_ratio_accepts_float64_and_rejects_the_control():
    """``error_ratio``, the card's K6 check: a float64 evaluation of the
    twin passes against the float32 twin; the no-carry control, a bf16
    rounding of the control and a NaN do not."""
    arrs = _inputs((1, 256, 4, 32, 1, 32), seed=3, slow=True)
    want = _twin(arrs, 64)
    x, dt, a, bb, cc = (torch.from_numpy(t).double() for t in arrs)
    f64 = ss.ssd_scan_ref(x, dt, a, bb, cc, chunk=64).float()
    assert ss.error_ratio(f64, want) <= 1.0
    assert ss.error_ratio(want.bfloat16(), want) <= 1.0
    cut = torch.cat([_twin([t[:, c0:c0 + 64] if t.ndim > 1 else t
                            for t in arrs], 64) for c0 in range(0, 256, 64)],
                    1)
    assert ss.error_ratio(cut, want) > 100
    assert ss.error_ratio(cut.bfloat16(), want) > 100
    bad = want.clone()
    bad[0, 5, 1, 3] = float("nan")
    assert ss.error_ratio(bad, want) == float("inf")


def test_ops_dispatch_on_cpu():
    arrs = _inputs((1, 64, 4, 16, 2, 16), seed=4)
    t = [torch.from_numpy(a) for a in arrs]
    ss.reset_launch_counts()
    torch.testing.assert_close(ops.ssd_scan(*t, chunk=16),
                               ss.ssd_scan_ref(*t, chunk=16), rtol=0, atol=0)
    assert ss.LAUNCHES["ssd_scan"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan(*t, chunk=16)
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.ssd_scan(t[0].clone().requires_grad_(), *t[1:], chunk=16)
    with torch.no_grad():
        ops.ssd_scan(t[0].clone().requires_grad_(), *t[1:], chunk=16)
    with pytest.raises(ValueError, match="S %"):
        ops.ssd_scan(*t, chunk=48)


@pytest.mark.parametrize("blocks,p,splits", [
    (1024, 64, 1), (64, 64, 2), (512, 64, 1), (132, 64, 1), (16, 128, 8),
    (4096, 128, 2), (8, 16, 1)])
def test_p_splits(blocks, p, splits):
    """At most 64 state rows a block, split down to 16 while twice the
    B * H blocks still fit one wave on an H100's 132 SMs."""
    assert ss.p_splits(blocks, p, 132) == splits


def test_argtypes_match_the_c_entry_points():
    """Every C entry point takes as many arguments as its ctypes argtypes
    declare (a short table makes ctypes refuse the call; a long one would
    pass junk); K6's takes the float32 scratch (a pointer, then its size
    as a size_t) after y."""
    found, params = {}, {}
    for src in build.sources():
        for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)',
                             src.read_text()):
            found[m.group(1)] = len(m.group(2).split(","))
            params[m.group(1)] = [" ".join(a.split()) for a in
                                  m.group(2).split(",")]
    assert set(found) == set(build.ARGTYPES)
    for name, n in found.items():
        assert len(build.ARGTYPES[name]) == n, name
    assert (Path(build.CSRC) / "ssd_scan.cu").exists()
    assert params["ssd_scan_launch"][5:8] == [
        "void* y", "void* scratch", "size_t scratch_bytes"]
    types = build.ARGTYPES["ssd_scan_launch"]
    assert types[6] is ctypes.c_void_p and types[7] is ctypes.c_size_t
    # the float32 plan: seven shapes in, seven long longs out
    assert params["ssd_f32_plan"][-1] == "long long* out"
    assert build.ARGTYPES["ssd_f32_plan"][-1] is ctypes.c_void_p


def three_steps(x, dt, a, b, c, *, chunk):
    """K6's float32 route in plain torch, step by step, on float32 inputs:
    A, each chunk's cumsum, its own end state D_c = (x o dt exp(cum_L -
    cum))^T B (all but the last chunk) and each (batch, group, chunk)'s
    scores S = C B^T, made once for the group's heads; B, the states
    entering each chunk, state_in[c + 1] = state_in[c] exp(cum_L[c]) +
    D_c from state_in[0] = 0; C, y = exp(cum_t) C state_in^T + [S o
    exp(cum_t - cum_s) dt_s]_{s <= t} x, the group's S for every head."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep, nc = h // g, s // chunk
    ch = lambda t: t.reshape(bsz, nc, chunk, *t.shape[2:])  # noqa: E731
    xc, dtc, bc, cc = ch(x), ch(dt), ch(b), ch(c)    # (B, nc, L, ...)
    cum = torch.cumsum(a * dtc, dim=2)                # (B, nc, L, H)
    keep = torch.ones((chunk, chunk), dtype=torch.bool).tril()
    # step A: end states (B, nc - 1, H, N, P) and the group's scores
    fw = dtc * torch.exp(cum[:, :, -1:] - cum)
    grp = lambda t: t.repeat_interleave(rep, dim=3)  # noqa: E731
    delta = torch.einsum("bcshp,bcshn->bchnp", xc * fw[..., None],
                         grp(bc))[:, :-1]
    scores = torch.einsum("bctgn,bcsgn->bcgts", cc, bc)   # (B, nc, G, L, L)
    # step B: the states entering each chunk
    state = torch.zeros((bsz, h, n, p))
    states = [state]
    for i in range(nc - 1):
        state = (state * torch.exp(cum[:, i, -1])[..., None, None]
                 + delta[:, i])
        states.append(state)
    states = torch.stack(states, 1)                   # (B, nc, H, N, P)
    # step C
    dec = torch.where(keep[..., None], cum[:, :, :, None] - cum[:, :, None],
                      0.0)                            # (B, nc, t, s, H)
    w = torch.where(keep[..., None],
                    scores.repeat_interleave(rep, dim=2).permute(0, 1, 3, 4, 2)
                    * torch.exp(dec) * dtc[:, :, None], 0.0)
    y = torch.einsum("bctsh,bcshp->bcthp", w, xc)
    y = y + torch.exp(cum)[..., None] * torch.einsum(
        "bcthn,bchnp->bcthp", grp(cc), states)
    return y.reshape(bsz, s, h, p)


@pytest.mark.parametrize("shape,chunk,slow", [
    ((1, 64, 2, 16, 1, 8), 32, False), ((2, 128, 4, 32, 2, 16), 32, False),
    ((1, 256, 8, 64, 1, 32), 32, False), ((1, 1024, 4, 16, 2, 16), 32, True),
])
def test_three_steps_match_the_twin_and_the_pallas_kernel(shape, chunk,
                                                          slow):
    """The float32 route's three steps (``three_steps``) against the twin
    at the float32 bar (``error_ratio`` <= 1) and against the JAX
    package's Pallas kernel in interpret mode at its sweep's tolerance: the
    reference's sweep shapes, and 32 chunks with slow decay (the state
    passed through 31 chunks is a large part of y)."""
    arrs = _inputs(shape, seed=shape[1] + 7, slow=slow)
    got = three_steps(*(torch.from_numpy(t) for t in arrs), chunk=chunk)
    assert ss.error_ratio(got, _twin(arrs, chunk)) <= 1.0
    np.testing.assert_allclose(got.numpy(), _jax(arrs, chunk), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shape,chunk,plan", [
    # mamba2-1.3b's recompute layer: 4736 step-A blocks (4096 chunk
    # states, 640 score tiles), 1024 x 8 step-B blocks, 4096 step-C blocks
    ((16, 1024, 64, 64, 1, 128), 256,
     (1, 4736, (1024, 8), 4096, 119537664)),
    # the width row: step C 512 blocks (the first design: 128)
    ((8, 1024, 16, 32, 1, 48), 256, (1, 832, (128, 2), 512, 9437184)),
    # P 128 in two slices of 64; one chunk: no state pass
    ((1, 384, 2, 128, 1, 64), 384, (2, 25, None, 6, 350208)),
    # P 127, N 1 (padded to 16); two groups of two heads
    ((2, 128, 4, 127, 2, 1), 64, (2, 40, (8, 2), 8, 204800)),
])
def test_f32_plan(shape, chunk, plan):
    """The float32 route's plan at the main path's shapes and at padded
    ones: P slices, the three grids and the scratch's bytes."""
    b, s, h, p, g, n = shape
    got = ss.f32_plan(b, s, h, g, p, n, chunk)
    assert (got.nsplit, got.grid_a, got.grid_b, got.grid_c,
            got.scratch_bytes) == plan
    assert got.units == ss.F32_UNITS == 4


def test_f32_plan_is_a_function_of_the_shapes_alone():
    """No SM count or device enters the float32 plan: its arguments are
    the shapes; P splits by ceil(P / 64) alone; a batch row alone or a
    subset of a group's heads plans the same per-head work (the grids and
    the state scratch scale with B and H), so a head's blocks and their
    summation order do not depend on the call."""
    assert list(inspect.signature(ss.f32_plan).parameters) == [
        "b", "s", "h", "g", "p", "n", "lc"]
    for p, nsplit in ((1, 1), (64, 1), (65, 2), (100, 2), (128, 2)):
        assert ss.f32_plan(1, 64, 2, 1, p, 16, 64).nsplit == nsplit
    whole = ss.f32_plan(16, 1024, 64, 1, 64, 128, 256)
    row = ss.f32_plan(1, 1024, 64, 1, 64, 128, 256)
    heads = ss.f32_plan(1, 1024, 16, 1, 64, 128, 256)
    assert whole.grid_c == 16 * row.grid_c == 64 * heads.grid_c
    assert whole.grid_b[0] == 16 * row.grid_b[0] == 64 * heads.grid_b[0]
    assert whole.grid_b[1] == row.grid_b[1] == heads.grid_b[1]
    # the (cum, dt) pairs and states per (batch, head), the scores per
    # (batch, group)
    per_bh = 4 * (1024 * 2 + 3 * 128 * 64)
    per_b = 4 * 4 * 10 * 64 * 64
    assert whole.scratch_bytes == 16 * 64 * per_bh + 16 * per_b
    assert row.scratch_bytes == 64 * per_bh + per_b
    assert heads.scratch_bytes == 16 * per_bh + per_b


def _bf(t):
    return t.bfloat16().float()


def tc_emulation(x, dt, a, b, c, *, chunk, lo_terms=True):
    """K6's bf16 tensor-core arithmetic in plain torch: C, B, x exact
    (bf16 values), the scores and decays float32, and each float32
    operand of a product (W' = (C B^T) o exp(cum_t - cum_s) o dt_s, the
    carried state, x' = x dt exp(cum_L - cum)) split into bf16 hi + lo
    for two products summed in float32; ``lo_terms=False`` keeps the hi
    products only (one bf16 rounding of each operand). y rounded to
    bf16."""
    bsz, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    rep = h // g

    def split(v):
        hi = _bf(v)
        return hi, (_bf(v - hi) if lo_terms else torch.zeros_like(v))

    keep = torch.ones((chunk, chunk), dtype=torch.bool).tril()[None, None]
    state = torch.zeros((bsz, h, p, n))
    ys = []
    for c0 in range(0, s, chunk):
        xc = x[:, c0:c0 + chunk].float().transpose(1, 2)      # (B, H, L, P)
        dtc = dt[:, c0:c0 + chunk].float().transpose(1, 2)    # (B, H, L)
        bc = b[:, c0:c0 + chunk].float().repeat_interleave(rep, 2
                                                            ).transpose(1, 2)
        cc = c[:, c0:c0 + chunk].float().repeat_interleave(rep, 2
                                                            ).transpose(1, 2)
        cum = torch.cumsum(a.float()[None, :, None] * dtc, -1)
        dec = torch.where(keep, cum[..., :, None] - cum[..., None, :], 0.0)
        w = torch.where(keep, (cc @ bc.transpose(-1, -2)) * torch.exp(dec)
                        * dtc[..., None, :], 0.0)
        sh, sl = split(state)
        y = torch.exp(cum)[..., None] * (cc @ sh.transpose(-1, -2)
                                         + cc @ sl.transpose(-1, -2))
        wh, wl = split(w)
        y = y + wh @ xc + wl @ xc
        xs = xc * (dtc * torch.exp(cum[..., -1:] - cum))[..., None]
        xh, xl = split(xs)
        state = (state * torch.exp(cum[..., -1])[..., None, None]
                 + xh.transpose(-1, -2) @ bc + xl.transpose(-1, -2) @ bc)
        ys.append(y.transpose(1, 2))
    return torch.cat(ys, 1).bfloat16()


def test_tc_hi_lo_arithmetic_meets_the_bf16_bar_and_one_rounding_does_not():
    """K6's tensor-core arithmetic (hi + lo operands), emulated on the
    CPU, against the JAX package's Pallas kernel in interpret mode on the
    same bf16-valued inputs: ``error_ratio`` <= 1, the bar K6's bf16
    route is held to on the card. With one bf16 rounding of each float32
    operand (no lo products) the ratio exceeds 10: the split is what
    passes."""
    arrs = _inputs((1, 1024, 2, 64, 1, 128), seed=16, slow=True)
    for i in (0, 3, 4):                       # x, b, c as bf16 values
        arrs[i][...] = torch.from_numpy(arrs[i]).bfloat16().float().numpy()
    want = torch.from_numpy(_jax(arrs, 256).copy())
    t = [torch.from_numpy(v) for v in arrs]
    assert ss.error_ratio(tc_emulation(*t, chunk=256), want) <= 1.0
    assert ss.error_ratio(tc_emulation(*t, chunk=256, lo_terms=False),
                          want) > 10.0
