"""The dense flash kernel K5 in the PyTorch port against the JAX package.

The same numpy-seeded inputs go through the JAX Pallas kernel in interpret
mode (``repro.kernels.ops.flash_attention(..., interpret=True)``) and
through the port's twin and its CPU entry point ``ops.flash_attention``:
the sweep of ``tests/test_kernels.py``. Tolerances are the JAX package's
own: 2e-5 for float32 (summation order only), 2e-2 for bfloat16 (one
rounding of the output). The CUDA kernel itself runs only on a card:
``tests/test_torch_kernels_cuda.py`` holds it against this twin.

The bf16 route of K5 and K4 (the tensor-core core,
``csrc/attention_tc.cuh``) computes one function more than the twin: it
rounds the softmax weights p to bf16 before the P.V product. Its formula
is written out here and held against the JAX package's oracle
(``repro.kernels.ref.flash_attention_ref``) at the same 2e-2.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import build
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


def _tc_formula(q, k, v, *, causal, window=None, softcap=None, block=64,
                round_p=True):
    """The bf16 tensor-core route's function on bf16 q (B, S, Hq, D), k, v
    (B, S, Hkv, D): scores are bf16 products summed in float32, scaled by
    D^-0.5, softcapped, masked to -1e30 by select; an online softmax over
    tiles of ``block`` keys whose weights p are rounded to bf16
    (``round_p``) before the P.V product and before the row sum; the
    output acc / max(l, 1e-30) rounded to bf16."""
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    qf = q.float().reshape(b, s, hkv, hq // hkv, d)
    kf, vf = k.float(), v.float()
    rows = torch.arange(s)[:, None]
    m = torch.full((b, hkv, hq // hkv, s), fa.NEG_INF)
    l = torch.zeros_like(m)
    acc = torch.zeros((b, hkv, hq // hkv, s, d))
    for k0 in range(0, s, block):
        kt, vt = kf[:, k0:k0 + block], vf[:, k0:k0 + block]
        sc = torch.einsum("bqgrd,bkgd->bgrqk", qf, kt) * d ** -0.5
        if softcap is not None:
            sc = softcap * torch.tanh(sc / softcap)
        if causal:
            diff = rows - (k0 + torch.arange(kt.shape[1]))[None]
            keep = diff >= 0
            if window is not None:
                keep &= diff < window
            sc = torch.where(keep, sc, fa.NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(sc - m_new[..., None])
        if round_p:
            p = p.to(torch.bfloat16).float()
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum("bgrqk,bkgd->bgrqd", p,
                                                    vt)
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(torch.bfloat16)


# the masks of chip_smoke.py's K5 cases at a small size: the qwen3 layers
# (causal), a sliding window, and Gemma2's global (softcap 50) and local
# (window + softcap) layers with q drawn at 40 N(0, 1), so that the scores
# reach the cap
TC_MASKS = {"causal": (dict(causal=True), 1.0),
            "window": (dict(causal=True, window=50), 1.0),
            "softcap": (dict(causal=True, softcap=50.0), 40.0),
            "window+softcap": (dict(causal=True, window=50, softcap=50.0),
                               40.0)}


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("mask", list(TC_MASKS))
def test_bf16_route_formula_matches_jax_oracle(mask, d):
    """The bf16 route's numerical contract: with p rounded to bf16 before
    P.V, the output stays within the bf16 bar (2e-2) of the JAX package's
    oracle on the same bf16 inputs, for every mask of the main path and
    ragged key tiles (S 160 = 64 + 64 + 32). The rounding is live: the
    formula without it differs."""
    kw, q_scale = TC_MASKS[mask]
    rng = np.random.default_rng(d)
    arrs = [rng.standard_normal((2, 160, h, d)).astype(np.float32)
            for h in (4, 2, 2)]
    arrs[0] *= q_scale
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in arrs]
    j = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    want = np.asarray(jref.flash_attention_ref(*j, **kw), np.float32)
    got = _tc_formula(*t, **kw)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=2e-2)
    assert not torch.equal(got, _tc_formula(*t, round_p=False, **kw))


PTXAS_LOG = """== flash_attention.cu
ptxas info    : Compiling entry function '_Z4kernILi128EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z4kernILi128EEvPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 199 registers, used 1 barriers, 416 bytes cmem[0]
ptxas info    : Compiling entry function '_Z4kernILi256EEvPf' for 'sm_90a'
ptxas info    : Function properties for _Z4kernILi256EEvPf
    24 bytes stack frame, 12 bytes spill stores, 16 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 416 bytes cmem[0]
"""


def test_ptxas_report_reads_registers_and_spills():
    """The build's ptxas -v log, as the card test of the tensor-core
    bodies reads it: registers and spill bytes per kernel."""
    rep = build.ptxas_report(PTXAS_LOG)
    assert rep == {
        "_Z4kernILi128EEvPf": dict(registers=199, spill_stores=0,
                                   spill_loads=0),
        "_Z4kernILi256EEvPf": dict(registers=255, spill_stores=12,
                                   spill_loads=16)}
