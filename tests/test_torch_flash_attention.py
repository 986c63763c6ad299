"""The dense flash kernel K5 in the PyTorch port against the JAX package.

The same numpy-seeded inputs go through the JAX Pallas kernel in interpret
mode (``repro.kernels.ops.flash_attention(..., interpret=True)``) and
through the port's twin and its CPU entry point ``ops.flash_attention``:
the sweep of ``tests/test_kernels.py``. Tolerances are the JAX package's
own: 2e-5 for float32 (summation order only), 2e-2 for bfloat16 (one
rounding of the output). The CUDA kernel itself runs only on a card:
``tests/test_torch_kernels_cuda.py`` holds it against this twin.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.models import attention as tattn

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(b, s, hq, hkv, d, dtype="float32", seed=0):
    """(jax, torch) pairs of q, k, v from one numpy draw, rounded to
    ``dtype`` the same way in both packages."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for h in (hq, hkv, hkv)]
    j = [jnp.asarray(a, JDT[dtype]) for a in arrs]
    t = [torch.from_numpy(a).to(TDT[dtype]) for a in arrs]
    return j, t


def _check(j, t, dtype, block=None, **kw):
    """JAX's Pallas kernel (interpret mode, blocks of ``block`` rows and
    keys, default its own) against the twin and the CPU entry point."""
    blocks = {} if block is None else dict(block_q=block, block_k=block)
    want = np.asarray(jops.flash_attention(*j, interpret=True, **blocks,
                                           **kw), np.float32)
    twin = fa.flash_attention_ref(*t, **kw)
    got = tops.flash_attention(*t, **kw)
    assert got.dtype == t[0].dtype and got.shape == t[0].shape
    np.testing.assert_allclose(twin.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_allclose(got.float().numpy(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("shape", [(1, 128, 4, 4, 32), (2, 256, 8, 2, 64),
                                   (1, 512, 4, 1, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_sweep(shape, dtype):
    j, t = _qkv(*shape, dtype=dtype, seed=sum(shape))
    _check(j, t, dtype, causal=True, block=64)


@pytest.mark.parametrize("window", [64, 128])
def test_sliding_window(window):
    j, t = _qkv(2, 256, 4, 2, 32, seed=window)
    _check(j, t, "float32", causal=True, window=window, block=64)


@pytest.mark.parametrize("causal,cap", [(True, 30.0), (False, None)])
def test_softcap_and_bidir(causal, cap):
    j, t = _qkv(1, 128, 4, 4, 32, seed=3)
    _check(j, t, "float32", causal=causal, softcap=cap, block=32)


@pytest.mark.parametrize("s", [160, 96, 37])
def test_non_divisible_seq(s):
    j, t = _qkv(1, s, 4, 2, 32, seed=s)
    _check(j, t, "float32", causal=True)


def test_window_with_softcap_and_gqa():
    """All three masks at once, the Gemma2 local layer's combination."""
    j, t = _qkv(2, 160, 8, 2, 64, seed=11)
    _check(j, t, "float32", causal=True, window=48, softcap=50.0,
           block=32)


def _pos(b, s):
    return np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))


@pytest.mark.parametrize("kind,window,cap", [("causal", 4096, None),
                                             ("local", 24, 50.0),
                                             ("bidir", 4096, None)])
def test_attention_pallas_dispatch_matches_jax(kind, window, cap):
    """``attention(impl="pallas")`` as the JAX package dispatches it:
    contiguous positions reach the kernel (its twin here), the window only
    for "local"; both packages give the same output."""
    j, t = _qkv(2, 80, 4, 2, 64, seed=5)
    pos = _pos(2, 80)
    kw = dict(kind=kind, window=window, softcap=cap, impl="pallas", chunk=32)
    want = np.asarray(jattn.attention(*j, pos_q=jnp.asarray(pos),
                                      pos_k=jnp.asarray(pos), **kw))
    tp = torch.from_numpy(pos.copy())
    got = tattn.attention(*t, pos_q=tp, pos_k=tp, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    # the caller's word that the layout is contiguous takes the same path
    again = tattn.attention(*t, pos_q=tp, pos_k=tp, contiguous=True, **kw)
    assert torch.equal(again, got)


def test_attention_pallas_noncontiguous_takes_the_jnp_paths(monkeypatch):
    """Offset or padded positions skip the kernel: a chunk of at most
    ``chunk`` rows goes naive, a longer one chunked, as in the JAX
    package."""
    calls = []
    monkeypatch.setattr(tattn, "flash_attention",
                        lambda *a, **k: calls.append(1))
    j, t = _qkv(1, 40, 4, 2, 64, seed=6)
    pos = _pos(1, 40) + 7                      # offset: not arange
    for chunk in (64, 16):                     # naive, then chunked
        kw = dict(kind="causal", impl="pallas", chunk=chunk)
        want = np.asarray(jattn.attention(*j, pos_q=jnp.asarray(pos),
                                          pos_k=jnp.asarray(pos), **kw))
        tp = torch.from_numpy(pos.copy())
        got = tattn.attention(*t, pos_q=tp, pos_k=tp, **kw)
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    padded = torch.from_numpy(_pos(1, 40).copy())
    padded[0, -3:] = tattn.PAD_POS
    tattn.attention(*t, pos_q=padded, pos_k=padded, impl="pallas")
    assert calls == []
    tattn.attention(*t, pos_q=torch.from_numpy(_pos(1, 40).copy()),
                    pos_k=torch.from_numpy(_pos(1, 40).copy()),
                    impl="pallas")
    assert calls == [1]


def test_backward_through_pallas_raises():
    _, t = _qkv(1, 16, 2, 1, 64, seed=7)
    q, k, v = (x.clone().requires_grad_() for x in t)
    pos = torch.arange(16)[None]
    o = tattn.attention(q, k, v, pos_q=pos, pos_k=pos, impl="pallas")
    with pytest.raises(RuntimeError, match="forward-only"):
        o.sum().backward()
    # the forward value is the twin's, grad or not
    torch.testing.assert_close(o.detach(), fa.flash_attention_ref(*t))


def test_kernel_wrapper_refuses_cpu_tensors():
    _, t = _qkv(1, 16, 2, 1, 64, seed=8)
    fa.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(*t)
    assert fa.LAUNCHES["flash_attention"] == 0
    tops.flash_attention(*t)                   # the twin: not a launch
    assert fa.LAUNCHES["flash_attention"] == 0
