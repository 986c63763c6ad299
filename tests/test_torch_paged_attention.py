"""Paged decode / prefill in the PyTorch port against the JAX package.

The same numpy-seeded inputs go through the JAX twins (and, once each,
the Pallas kernels in interpret mode) and through the port's twins and
wrappers on the CPU. Tolerances: 1e-5 abs for float32, 2e-2 abs for
bfloat16 (the JAX twin rounds p to bf16 before P.V, the port's twin keeps
float32). The CUDA kernels themselves run only on a card:
``tests/test_torch_kernels_cuda.py`` holds them against these twins.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro_torch.kernels import build
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
        """"gather" (the JAX package's dense gather path) runs and matches
        the reference's "gather" within 1e-5 (float32; a finite scratch
        page, since the dense view reads it); unknown impls and non-causal
        kinds raise."""
        q, kp, vp, table, lengths = decode_case()
        kp[0], vp[0] = kp[1], vp[1]
        t = [torch.from_numpy(x) for x in (q, kp, vp, table, lengths)]
        tpa.reset_launch_counts()
        for kind, window, cap in (("causal", None, None),
                                  ("local", 5, 30.0)):
            want = jops.paged_decode(
                jnp.asarray(q)[:, None], *map(jnp.asarray, (kp, vp, table,
                                                           lengths)),
                kind=kind, window=window, softcap=cap, impl="gather")
            got = tops.paged_decode(t[0][:, None], *t[1:], kind=kind,
                                    window=window, softcap=cap,
                                    impl="gather")
            np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5,
                                       rtol=0)
        qp, kpp, vpp, tbl, pos = prefill_case(seed=4)
        kpp[0], vpp[0] = kpp[1], vpp[1]
        for kind, window, cap in (("causal", None, None),
                                  ("local", 4, 25.0)):
            want = jops.paged_prefill(*map(jnp.asarray, (qp, kpp, vpp, tbl,
                                                         pos)),
                                      kind=kind, window=window, softcap=cap,
                                      impl="gather")
            got = tops.paged_prefill(*map(torch.from_numpy, (qp, kpp, vpp,
                                                              tbl, pos)),
                                     kind=kind, window=window, softcap=cap,
                                     impl="gather")
            np.testing.assert_allclose(_f32(got), _f32(want), atol=1e-5,
                                       rtol=0)
        assert tpa.LAUNCHES == {"paged_decode": 0, "paged_prefill": 0}
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


def splitk_decode(q, kp, vp, table, lengths, *, window=None, softcap=None):
    """K3's split-K arithmetic in plain torch (float32): each slot's reach
    [first, length) is cut into chunks of the kernel's chunk keys, the
    chunks into DECODE_SPLITS x DECODE_WARPS contiguous runs (one per
    worker, split-major); each worker keeps (m, l, acc) with masked keys
    at p = 0 (so an empty worker ends with m = -1e30, l = 0); a split
    combines its warps in warp order, then the splits are combined in
    split order. A dead slot gives zeros."""
    b, hq, d = q.shape
    page, hkv = kp.shape[1], kp.shape[2]
    rep = hq // hkv
    npages = table.shape[1]
    kt = tpa.DECODE_CHUNK_BYTES // (d * q.element_size())
    workers = tpa.DECODE_SPLITS * tpa.DECODE_WARPS
    out = torch.zeros((b, hq, d), dtype=torch.float32)
    for slot in range(b):
        n = int(lengths[slot])
        if n > npages * page:
            continue                                   # dead: zeros
        first = max(n - window, 0) if window is not None else 0
        nch = -(-max(n - first, 0) // kt)
        cols = torch.arange(first, n)
        phys = table[slot].long()[cols // page]
        k = kp[phys, cols % page].float()              # (keys, Hkv, D)
        v = vp[phys, cols % page].float()
        for g in range(hkv):
            qg = q[slot, g * rep:(g + 1) * rep].float()  # (rep, D)
            s = qg @ k[:, g].T * d ** -0.5               # (rep, keys)
            if softcap is not None:
                s = softcap * torch.tanh(s / softcap)
            parts = []
            for u in range(workers):
                lo = u * nch // workers * kt         # keys past first
                hi = min((u + 1) * nch // workers * kt, n - first)
                if hi <= lo:
                    parts.append((torch.full((rep,), tpa.NEG_INF),
                                  torch.zeros(rep), torch.zeros(rep, d)))
                    continue
                su = s[:, lo:hi]
                m = su.amax(-1)
                p = torch.exp(su - m[:, None])
                parts.append((m, p.sum(-1), p @ v[lo:hi, g]))
            nw = tpa.DECODE_WARPS                      # warps, then splits
            splits = [_combine(parts[i:i + nw])
                      for i in range(0, workers, nw)]
            _, lsum, acc = _combine(splits)
            out[slot, g * rep:(g + 1) * rep] = acc / torch.clamp(
                lsum, min=1e-30)[:, None]
    return out


def _combine(parts):
    """(m, l, acc) partials combined in list order: M = max m,
    L = sum l exp(m - M), A = sum acc exp(m - M)."""
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum, acc = torch.zeros_like(mx), torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.exp(m - mx)
        lsum = lsum + l * w
        acc = acc + a * w[:, None]
    return mx, lsum, acc


def splitk_case(lengths, *, page=16, rep=2, hkv=2, d=64, seed=0):
    """Slots of the given lengths (a dead one at width * page + 1) on a
    table wide enough for the longest live slot; NaN in scratch page 0 and
    in every pool row past a slot's length on its last page."""
    rng = np.random.default_rng(seed)
    live = [n for n in lengths if n >= 0]
    width = -(-max(live) // page)
    lengths = np.array([width * page + 1 if n < 0 else n for n in lengths],
                       np.int32)
    b = len(lengths)
    pool = 1 + b * width
    q = rng.standard_normal((b, hkv * rep, d), dtype=np.float32)
    kp = rng.standard_normal((pool, page, hkv, d), dtype=np.float32)
    vp = rng.standard_normal((pool, page, hkv, d), dtype=np.float32)
    kp[0] = vp[0] = np.nan
    perm = rng.permutation(np.arange(1, pool))
    table = np.zeros((b, width), np.int32)
    for s, n in enumerate(lengths):
        if n > width * page:
            continue
        nl = -(-int(n) // page)
        table[s, :nl] = perm[s * width:s * width + nl]
        if n % page:
            kp[table[s, nl - 1], n % page:] = np.nan
            vp[table[s, nl - 1], n % page:] = np.nan
    return q, kp, vp, table, lengths


class TestSplitKDecode:
    """K3's split-K arithmetic (partials per worker, combined in worker
    order) against the JAX package's paged decode, float32 at 1e-5."""

    @pytest.mark.parametrize("lengths,window,cap", [
        ([600, 1, 37, -1], None, None),     # a length-1 slot, a dead slot
        ([600, 1, 37, -1], 9, None),        # whole splits outside the band
        ([600, 200, 0, -1], 40, 30.0),      # softcap; a length-0 slot
        ([1, -1, -1], None, 50.0),          # one busy worker
    ])
    def test_matches_jax_twin(self, lengths, window, cap):
        q, kp, vp, table, lens = splitk_case(lengths, seed=len(lengths))
        args = [_both(x, "float32") for x in (q, kp, vp, table, lens)]
        want = _f32(jpa.paged_decode_ref(*[a[0] for a in args],
                                         window=window, softcap=cap))
        got = splitk_decode(*[a[1] for a in args], window=window,
                            softcap=cap).numpy()
        dead = lens > table.shape[1] * kp.shape[1]
        assert np.isfinite(got).all()
        assert not got[dead].any()
        np.testing.assert_allclose(got[~dead], want[~dead], atol=1e-5,
                                   rtol=0)

    def test_matches_pallas_interpret(self):
        q, kp, vp, table, lens = splitk_case([300, 1, 129, -1], page=8,
                                             seed=11)
        args = [_both(x, "float32") for x in (q, kp, vp, table, lens)]
        want = _f32(jpa.paged_attention(*[a[0] for a in args], window=70,
                                        softcap=20.0, interpret=True))
        got = splitk_decode(*[a[1] for a in args], window=70,
                            softcap=20.0).numpy()
        np.testing.assert_allclose(got[:3], want[:3], atol=1e-5, rtol=0)

    def test_constants_match_the_kernel_source(self):
        """The split-K constants the emulation reads are the ones the CUDA
        kernel is compiled with."""
        src = (Path(build.CSRC) / "paged_attention.cu").read_text()
        for name, value in (("kSplits", tpa.DECODE_SPLITS),
                            ("kDecWarps", tpa.DECODE_WARPS),
                            ("kChunkBytes", tpa.DECODE_CHUNK_BYTES)):
            m = re.search(rf"constexpr int {name} = (\d+);", src)
            assert m and int(m.group(1)) == value, name
