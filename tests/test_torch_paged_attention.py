"""Paged decode / prefill in the PyTorch port against the JAX package.

The same numpy-seeded inputs go through the JAX twins (and, once each,
the Pallas kernels in interpret mode) and through the port's twins and
wrappers on the CPU. Tolerances: 1e-5 abs for float32, 2e-2 abs for
bfloat16 (the JAX twin rounds p to bf16 before P.V, the port's twin keeps
float32). The CUDA kernels themselves run only on a card:
``tests/test_torch_kernels_cuda.py`` holds them against these twins.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _both(arr, dtype):
    """One numpy array as (jax, torch) in ``dtype`` (identical rounding)."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if np.issubdtype(arr.dtype, np.floating):
        return jnp.asarray(arr, JDT[dtype]), t.to(TDT[dtype])
    return jnp.asarray(arr), t


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def decode_case(*, page=8, rep=2, hkv=2, d=64, b=6, npages=5, seed=0):
    """Ragged lengths incl. 0 and a full table, a dead slot at
    ``oob_pos + 1`` (with real pages, as a slot that finished mid-chunk),
    and NaN in scratch page 0, which every slot's unused table tail
    points at."""
    rng = np.random.default_rng(seed)
    hq = hkv * rep
    pool = 1 + b * npages + 2
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kp = rng.standard_normal((pool, page, hkv, d), dtype=np.float32)
    vp = rng.standard_normal((pool, page, hkv, d), dtype=np.float32)
    kp[0] = np.nan
    vp[0] = np.nan
    lengths = np.array([0, 1, page, page + 3, npages * page,
                        npages * page + 1][:b], np.int32)
    perm = rng.permutation(np.arange(1, pool))
    table = np.zeros((b, npages), np.int32)
    for s in range(b):
        live = min(-(-int(lengths[s]) // page), npages)
        table[s, :live] = perm[s * npages:s * npages + live]
    return q, kp, vp, table, lengths


def prefill_case(*, page=8, rep=2, hkv=2, d=64, b=3, c=11, npages=6,
                 seed=0):
    """Chunks of C tokens at nonzero starts (ragged against the page),
    every position < starts + C written, table tails on the NaN scratch
    page."""
    rng = np.random.default_rng(seed)
    hq = hkv * rep
    pool = 1 + b * npages + 2
    q = rng.standard_normal((b, c, hq, d), dtype=np.float32)
    kp = rng.standard_normal((pool, page, hkv, d), dtype=np.float32)
    vp = rng.standard_normal((pool, page, hkv, d), dtype=np.float32)
    kp[0] = np.nan
    vp[0] = np.nan
    starts = rng.integers(0, npages * page - c + 1, size=b).astype(np.int32)
    starts[0] = 0
    perm = rng.permutation(np.arange(1, pool))
    table = np.zeros((b, npages), np.int32)
    for s in range(b):
        live = -(-int(starts[s] + c) // page)
        table[s, :live] = perm[s * npages:s * npages + live]
    positions = starts[:, None] + np.arange(c, dtype=np.int32)[None]
    return q, kp, vp, table, positions


class TestDecodeTwin:
    @pytest.mark.parametrize("page", [8, 16])
    @pytest.mark.parametrize("rep", [1, 2, 4])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_sweep_vs_jax_twin(self, page, rep, dtype):
        q, kp, vp, table, lengths = decode_case(page=page, rep=rep,
                                                seed=page * 10 + rep)
        (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, kp, vp))
        (jt, tt), (jl, tl) = _both(table, dtype), _both(lengths, dtype)
        want = _f32(jpa.paged_decode_ref(jq, jk, jv, jt, jl))
        got = _f32(tpa.paged_decode_ref(tq, tk, tv, tt, tl))
        assert np.isfinite(got).all()          # NaN scratch page invisible
        np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)

    @pytest.mark.parametrize("window,cap", [(5, None), (12, 30.0),
                                            (None, 5.0)])
    def test_window_and_softcap(self, window, cap):
        q, kp, vp, table, lengths = decode_case(seed=3)
        args = [_both(x, "float32") for x in (q, kp, vp, table, lengths)]
        want = jpa.paged_decode_ref(*[a[0] for a in args], window=window,
                                    softcap=cap)
        got = tpa.paged_decode_ref(*[a[1] for a in args], window=window,
                                   softcap=cap)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)

    def test_matches_pallas_interpret(self):
        q, kp, vp, table, lengths = decode_case(page=8, rep=2, b=4,
                                                npages=3, seed=5)
        lengths = np.array([1, 9, 17, 24], np.int32)
        table = np.arange(1, 13, dtype=np.int32).reshape(4, 3)
        args = [_both(x, "float32") for x in (q, kp, vp, table, lengths)]
        want = jpa.paged_attention(*[a[0] for a in args], window=6,
                                   softcap=20.0, interpret=True)
        got = tpa.paged_attention(*[a[1] for a in args], window=6,
                                  softcap=20.0)
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)


class TestPrefillTwin:
    @pytest.mark.parametrize("page", [8, 16])
    @pytest.mark.parametrize("rep", [1, 2, 4])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_sweep_vs_jax_twin(self, page, rep, dtype):
        q, kp, vp, table, positions = prefill_case(page=page, rep=rep,
                                                   seed=page * 10 + rep)
        (jq, tq), (jk, tk), (jv, tv) = (_both(x, dtype) for x in (q, kp, vp))
        (jt, tt), (jp, tp) = _both(table, dtype), _both(positions, dtype)
        want = _f32(jops.paged_prefill(jq, jk, jv, jt, jp, impl="ref"))
        got = _f32(tops.paged_prefill(tq, tk, tv, tt, tp, impl="ref"))
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=0)

    @pytest.mark.parametrize("window,cap", [(4, None), (9, 25.0)])
    def test_local_window_and_softcap(self, window, cap):
        q, kp, vp, table, positions = prefill_case(c=13, seed=7)
        args = [_both(x, "float32") for x in (q, kp, vp, table, positions)]
        want = jops.paged_prefill(*[a[0] for a in args], kind="local",
                                  window=window, softcap=cap, impl="ref")
        got = tops.paged_prefill(*[a[1] for a in args], kind="local",
                                 window=window, softcap=cap, impl="ref")
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)

    def test_matches_pallas_interpret(self):
        q, kp, vp, table, positions = prefill_case(page=8, rep=2, b=2, c=8,
                                                   npages=3, seed=9)
        positions = np.array([[0 + i for i in range(8)],
                              [5 + i for i in range(8)]], np.int32)
        table = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
        starts, lengths = positions[:, 0], positions[:, -1] + 1
        a = [_both(x, "float32")
             for x in (q, kp, vp, table, lengths, starts)]
        want = jpa.paged_prefill(*[x[0] for x in a], block_q=8,
                                 interpret=True)
        got = tpa.paged_prefill(*[x[1] for x in a])
        np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5, rtol=0)


class TestDispatch:
    def test_pallas_on_cpu_raises(self):
        q, kp, vp, table, lengths = decode_case()
        t = [torch.from_numpy(x) for x in (q, kp, vp, table, lengths)]
        with pytest.raises(ValueError, match="CUDA"):
            tops.paged_decode(t[0][:, None], *t[1:], impl="pallas")
        qp, kpp, vpp, tbl, pos = (torch.from_numpy(x)
                                  for x in prefill_case())
        with pytest.raises(ValueError, match="CUDA"):
            tops.paged_prefill(qp, kpp, vpp, tbl, pos, impl="pallas")

    def test_auto_on_cpu_takes_twin_without_launching(self):
        tpa.reset_launch_counts()
        q, kp, vp, table, lengths = decode_case(seed=1)
        t = [torch.from_numpy(x) for x in (q, kp, vp, table, lengths)]
        auto = tops.paged_decode(t[0][:, None], *t[1:], impl="auto")
        ref = tops.paged_decode(t[0][:, None], *t[1:], impl="ref")
        torch.testing.assert_close(auto, ref, rtol=0, atol=0)
        qp, kpp, vpp, tbl, pos = (torch.from_numpy(x)
                                  for x in prefill_case(seed=2))
        tops.paged_prefill(qp, kpp, vpp, tbl, pos, impl=None)
        assert tpa.LAUNCHES == {"paged_decode": 0, "paged_prefill": 0}

    def test_gather_and_unknown_impls_raise(self):
        q, kp, vp, table, lengths = decode_case()
        t = [torch.from_numpy(x) for x in (q, kp, vp, table, lengths)]
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tops.paged_decode(t[0][:, None], *t[1:], impl="gather")
        with pytest.raises(ValueError, match="unknown"):
            tops.paged_decode(t[0][:, None], *t[1:], impl="flash")
        with pytest.raises(ValueError, match="causal-only"):
            tops.paged_decode(t[0][:, None], *t[1:], kind="bidir")

    def test_window_applies_only_to_local(self):
        q, kp, vp, table, lengths = decode_case(seed=4)
        t = [torch.from_numpy(x) for x in (q, kp, vp, table, lengths)]
        causal = tops.paged_decode(t[0][:, None], *t[1:], kind="causal",
                                   window=3, impl="ref")
        plain = tops.paged_decode(t[0][:, None], *t[1:], impl="ref")
        local = tops.paged_decode(t[0][:, None], *t[1:], kind="local",
                                  window=3, impl="ref")
        torch.testing.assert_close(causal, plain, rtol=0, atol=0)
        assert not torch.equal(local, plain)
