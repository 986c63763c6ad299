"""The fused token-log-prob path of the PyTorch port against the JAX package.

The twin ``chunked_logprob`` (directly, and through
``ops.fused_token_logprob``, which takes it for CPU tensors) is held
against the JAX Pallas kernels run in interpret mode (``fused_logprob(...,
interpret=True)``) and against the JAX ``chunked_logprob``: values
(logp, entropy) and the VJP for random cotangents, with and without a
zero ``g_ent``, on ragged T and V, with out-of-range target ids, and with
bfloat16 logits. Inputs come from a numpy seed and go to both packages.

Tolerances: float32 logits 2e-5 abs on values (exp implementations and
the order of the vocabulary sums differ); float32 dlogits 1e-5 abs plus
1e-5 relative (each package recomputes p = exp(x - lse) from its own lse
and mu, a few float32 ulps apart: the error is |g_ent| p |d mu| plus
|dlogits| |d lse|); bfloat16 dlogits are
rounded once to bfloat16 in both packages, so they may differ by one
bfloat16 ulp: 2^-7 relative, plus 1e-6 abs for the float32 differences
where the terms cancel.

``dlogits_error_ratio``, the element-wise bound that holds K2 against the
twin on the card, is checked here both ways: it accepts a float64
evaluation of the same formula rounded to the logits dtype, and it
rejects a backward that zeroes the small entries or drops the entropy
term.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import logprob as jlogprob
from repro.kernels.ops import fused_token_logprob as jfused_token_logprob
from repro_torch.core import logprob as tlogprob
from repro_torch.kernels import fused_logprob as tfl
from repro_torch.kernels import ops

# the module, not the function re-exported under its name by repro.kernels
jfl = importlib.import_module("repro.kernels.fused_logprob")

TOL_VAL = 2e-5
TOL_GRAD = {"float32": (1e-5, 1e-5), "bfloat16": (1e-6, 2 ** -7)}


def _inputs(t, v, seed, dirty=True, scale=3.0):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal((t, v))).astype(np.float32)
    tgt = rng.integers(0, v, t).astype(np.int32)
    if dirty and t >= 2:
        tgt[0], tgt[-1] = -1, v + 5          # clamped to 0 and v - 1
    g_lp = rng.standard_normal(t).astype(np.float32)
    g_ent = rng.standard_normal(t).astype(np.float32)
    return logits, tgt, g_lp, g_ent


def _jax_vjp(fn, logits, tgt, g_lp, g_ent, dtype):
    x = jnp.asarray(logits).astype(dtype)
    (lp, ent), vjp = jax.vjp(lambda a: fn(a, jnp.asarray(tgt)), x)
    (dx,) = vjp((jnp.asarray(g_lp), jnp.asarray(g_ent)))
    return (np.asarray(lp), np.asarray(ent),
            np.asarray(dx.astype(jnp.float32)))


def _torch_vjp(fn, logits, tgt, g_lp, g_ent, dtype):
    x = torch.from_numpy(logits).to(getattr(torch, dtype)).requires_grad_()
    lp, ent = fn(x, torch.from_numpy(tgt))
    (dx,) = torch.autograd.grad((lp, ent), x, (torch.from_numpy(g_lp),
                                                torch.from_numpy(g_ent)))
    return (lp.detach().numpy(), ent.detach().numpy(), dx.float().numpy())


def _close(got, want, dtype):
    np.testing.assert_allclose(got[0], want[0], atol=TOL_VAL, rtol=0)
    np.testing.assert_allclose(got[1], want[1], atol=TOL_VAL, rtol=0)
    atol, rtol = TOL_GRAD[dtype]
    np.testing.assert_allclose(got[2], want[2], atol=atol, rtol=rtol)


SHAPES = [(16, 128, 8, 32),      # several token and vocab tiles
          (13, 77, 13, 77),      # ragged T and V, one tile
          (9, 1001, 9, 1001),    # V not a multiple of 4 or 8
          (1, 5, 1, 5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero_ent", [False, True])
@pytest.mark.parametrize("t,v,bt,bv", SHAPES)
def test_twin_matches_pallas_interpret(t, v, bt, bv, zero_ent, dtype):
    logits, tgt, g_lp, g_ent = _inputs(t, v, seed=t * v)
    if zero_ent:
        g_ent[:] = 0.0
    want = _jax_vjp(lambda a, b: jfl.fused_logprob(
        a, b, block_t=bt, block_v=bv, interpret=True),
        logits, tgt, g_lp, g_ent, getattr(jnp, dtype))
    for fn in (lambda a, b: tfl.chunked_logprob(a, b, chunk=4),
               ops.fused_token_logprob):
        _close(_torch_vjp(fn, logits, tgt, g_lp, g_ent, dtype), want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("chunk", [1, 4, 7, 256])
def test_twin_matches_jax_chunked(chunk, dtype):
    """Batched (B, T, V) logits, T = 11 cut into chunks with a ragged
    tail (or one chunk when chunk >= T)."""
    rng = np.random.default_rng(chunk)
    b, t, v = 3, 11, 96
    logits = (3.0 * rng.standard_normal((b, t, v))).astype(np.float32)
    tgt = rng.integers(-4, v + 4, (b, t)).astype(np.int32)
    g_lp = rng.standard_normal((b, t)).astype(np.float32)
    g_ent = rng.standard_normal((b, t)).astype(np.float32)
    want = _jax_vjp(lambda a, c: jfl.chunked_logprob(a, c, chunk=chunk),
                    logits, tgt, g_lp, g_ent, getattr(jnp, dtype))
    got = _torch_vjp(lambda a, c: tfl.chunked_logprob(a, c, chunk=chunk),
                     logits, tgt, g_lp, g_ent, dtype)
    _close(got, want, dtype)


def test_large_magnitude_logits_stay_finite():
    """The online max keeps exp in range for logits of magnitude 1e3."""
    logits, tgt, g_lp, g_ent = _inputs(6, 300, seed=7, scale=1e3)
    want = _jax_vjp(lambda a, b: jfl.fused_logprob(
        a, b, block_t=6, block_v=100, interpret=True),
        logits, tgt, g_lp, g_ent, jnp.float32)
    got = _torch_vjp(ops.fused_token_logprob, logits, tgt, g_lp, g_ent,
                     "float32")
    for a in got:
        assert np.isfinite(a).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(got[2], want[2], atol=1e-5, rtol=1e-5)


def test_core_logprob_matches_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 40)).astype(np.float32)
    tgt = rng.integers(-3, 45, (2, 5)).astype(np.int32)
    jl, jt = jnp.asarray(logits), jnp.asarray(tgt)
    tl, tt = torch.from_numpy(logits), torch.from_numpy(tgt)
    np.testing.assert_array_equal(
        tlogprob.clamp_target_ids(tt, 40).numpy(),
        np.asarray(jlogprob.clamp_target_ids(jt, 40)))
    np.testing.assert_allclose(
        tlogprob.token_logprob_from_logits(tl, tt).numpy(),
        np.asarray(jlogprob.token_logprob_from_logits(jl, jt)), atol=1e-6)
    for got, want in zip(tlogprob.token_logprob_entropy_lse(tl, tt),
                         jlogprob.token_logprob_entropy_lse(jl, jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("impl", [None, "fused", "chunked", "naive"])
def test_fused_token_logprob_dispatch_matches_jax(impl):
    rng = np.random.default_rng(11)
    logits = rng.standard_normal((2, 6, 50)).astype(np.float32)
    tgt = rng.integers(0, 50, (2, 6)).astype(np.int32)
    jimpl = {None: None, "fused": None, "chunked": "chunked",
             "naive": "naive"}[impl]
    want = jnp.stack(jfused_token_logprob(jnp.asarray(logits),
                                          jnp.asarray(tgt), impl=jimpl))
    got = torch.stack(ops.fused_token_logprob(
        torch.from_numpy(logits), torch.from_numpy(tgt), impl=impl))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    # a single token without batch dims
    lp, ent = ops.fused_token_logprob(torch.from_numpy(logits[0, 0]),
                                      torch.tensor(tgt[0, 0]), impl=impl)
    assert lp.shape == () and ent.shape == ()
    np.testing.assert_allclose(float(lp), float(got[0, 0, 0]), atol=1e-6)


def test_dispatch_contracts_on_cpu():
    x = torch.zeros((2, 4))
    t = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="unknown"):
        ops.fused_token_logprob(x, t, impl="flash")
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_token_logprob(x, t, impl="pallas")
    tfl.reset_launch_counts()
    lp, _ = ops.fused_token_logprob(x.requires_grad_(), t)  # CPU: the twin
    lp.sum().backward()
    assert tfl.LAUNCHES == {"logprob_fwd": 0, "logprob_bwd": 0}
    with pytest.raises(ValueError, match="cuda"):
        tfl.fused_logprob(x, t)                     # the kernel path only
    empty = tfl.chunked_logprob(torch.zeros((0, 4)),
                                torch.zeros(0, dtype=torch.int32))
    assert [e.shape for e in empty] == [(0,), (0,)]


def test_kernel_checks_refuse_cpu_tensors():
    """The kernel wrappers take CUDA tensors only and name the device;
    they never compute the twin instead."""
    x = torch.zeros((2, 4))
    t = torch.zeros(2, dtype=torch.int32)
    row = torch.zeros(2)
    with pytest.raises(ValueError, match="cuda"):
        tfl.logprob_fwd(x, t)
    with pytest.raises(ValueError, match="cuda"):
        tfl.logprob_bwd(x, t, row, row, row, row)


def _bwd_f64(x, tgt, lse, mu, g_lp, g_ent, drop_ent=False):
    """dlogits by the K2 formula in float64, rounded to the logits dtype:
    a correct evaluation that rounds differently from the twin."""
    xd = x.double()
    p = torch.exp(xd - lse.double()[:, None])
    hit = (torch.arange(x.shape[1])[None] == tgt[:, None]).double()
    d = g_lp.double()[:, None] * (hit - p)
    if not drop_ent:
        d = d - g_ent.double()[:, None] * p * (xd - mu.double()[:, None])
    return d.to(x.dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,v", [(77, 1001), (8, 152064)])
def test_dlogits_bound_accepts_rounding_and_rejects_broken_backward(
        t, v, dtype):
    """rtol 1e-5 for float32, 2^-7 + 1e-5 for bfloat16 (one bfloat16
    ulp), as the card tests and the chip smoke use."""
    rtol = {"float32": 1e-5, "bfloat16": 2 ** -7 + 1e-5}[dtype]
    logits, tgt, g_lp, g_ent = _inputs(t, v, seed=t + v)
    x = torch.from_numpy(logits).to(getattr(torch, dtype))
    tgt32 = tlogprob.clamp_target_ids(torch.from_numpy(tgt), v)
    g_lp, g_ent = torch.from_numpy(g_lp), torch.from_numpy(g_ent)
    _, ent, lse = tfl._chunked_fwd_pass(x, tgt32, 256)
    mu = lse - ent
    args = (x, tgt32, lse, mu, g_lp, g_ent)
    want = tfl._chunked_bwd_pass(*args, 256)

    def ratio(got):
        return tfl.dlogits_error_ratio(got, want, *args, rtol=rtol)

    assert ratio(_bwd_f64(*args)) <= 1.0
    # about 80% of the entries of 3 N(0, 1) logits lie below 2.6
    assert ratio(want.masked_fill(x.float() < 2.6, 0)) > 1.0
    assert ratio(_bwd_f64(*args, drop_ent=True)) > 1.0
    nan = want.clone()
    nan[t // 2, v // 2] = float("nan")
    assert ratio(nan) == float("inf")
