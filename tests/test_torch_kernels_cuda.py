"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Imports torch and numpy only, so it runs on a machine with the card and
no jax:  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
Without a card every test skips (the kernels have no CPU mode).

Tolerances, paged attention (K3/K4): the twin runs in float32 on the same
inputs; 1e-5 abs for float32 inputs (summation order only), 2e-2 abs for
bfloat16 (one rounding of the output to bf16).

Tolerances, token log-probs (K1/K2), against the chunked twin on the same
logits: logp/ent/lse 1e-4 abs (float32 sums over up to 152064 terms in
another order, and expf against torch.exp); dlogits given the same lse and
mu, element by element through ``fl.dlogits_error_ratio``: |K2 - twin| <=
rtol * scale with scale = |g_lp| (onehot + p) + |g_ent| p |x - mu|, the
sum of the magnitudes of the formula's terms; rtol 1e-5 for float32 (a
few float32 ulps of the scale), 2^-7 + 1e-5 for bfloat16 (one bfloat16
ulp of |dlogits| <= scale on top).

Tolerances, dense flash attention (K5), against its float32 twin on the
same inputs: the JAX package's own (``tests/test_kernels.py``), 2e-5 abs
for float32 (summation order only), 2e-2 abs for bfloat16 (one rounding
of the output to bf16; the tensor-core route also rounds p to bf16 before
P.V, ~2^-9 relative per weight, within the same bar). K4's bf16 route is
the same tensor-core core and is held to the same 2e-2.

Tolerances, SSD chunk scan (K6), against its float32 twin on the same
inputs, element by element through ``ss.error_ratio``: |K6 - twin| <=
rtol |twin| + 1e-5 max|twin|, rtol 1e-5 for float32 (sums and the chunk's
cumsum in another order), 2^-8 + 1e-5 for bfloat16 (one rounding of y to
bf16 on top). Inputs decay slowly (a * dt in [-0.01, -1e-4]), so the state
carried across chunks is a large part of y.
"""
import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import RLConfig, ServeConfig, TrainConfig
from repro_torch.configs import smoke
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import fused_logprob as fl
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import init_params
from repro_torch.optim import tree_leaves
from repro_torch.sampling import StaticEngine, build_engine, token_logps
from repro_torch.serving.api import Request, SamplingParams
from repro_torch.training import init_state, train_step

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _pools(rng, pool, page, hkv, d):
    kp = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((pool, page, hkv, d)).astype(np.float32)
    kp[0] = vp[0] = np.nan                  # the scratch page holds garbage
    return kp, vp


# K3 slot sets: "ragged" lengths 0, 1, page, ragged, full and a dead slot;
# "long", one slot of 8192 keys (every split busy) beside a length-1 slot
# and a 2048-key slot (under window 9 only 2 of its 32 workers hold a key);
# "dead", every slot dead
DECODE_SETS = ("ragged", "long", "dead")


def decode_inputs(*, page, rep, d, hkv=2, npages=6, seed=0, lengths="ragged"):
    """The slots of ``lengths`` (a DECODE_SETS name) with a dead slot last
    (width*page + 1); unused table entries point at the NaN scratch
    page."""
    rng = np.random.default_rng(seed)
    if lengths == "long":
        npages = 8192 // page
    full = npages * page
    lengths = np.array({
        "ragged": [0, 1, page, page + 3, 3 * page - 1, full, full + 1],
        "long": [full, 1, 2048, full + 1],
        "dead": [full + 1] * 3}[lengths], np.int32)
    b = lengths.shape[0]
    kp, vp = _pools(rng, 1 + b * npages, page, hkv, d)
    table = np.zeros((b, npages), np.int32)
    perm = rng.permutation(np.arange(1, 1 + b * npages))
    for s in range(b):
        live = min(-(-int(lengths[s]) // page), npages)
        table[s, :live] = perm[s * npages:s * npages + live]
    q = rng.standard_normal((b, hkv * rep, d)).astype(np.float32)
    return q, kp, vp, table, lengths


def prefill_inputs(*, page, rep, d, c, hkv=2, b=3, npages=12, seed=0):
    rng = np.random.default_rng(seed)
    kp, vp = _pools(rng, 1 + b * npages, page, hkv, d)
    starts = np.array([0, page + 3, npages * page - c][:b], np.int32)
    table = np.zeros((b, npages), np.int32)
    perm = rng.permutation(np.arange(1, 1 + b * npages))
    for s in range(b):
        live = -(-int(starts[s] + c) // page)
        table[s, :live] = perm[s * npages:s * npages + live]
    q = rng.standard_normal((b, c, hkv * rep, d)).astype(np.float32)
    positions = starts[:, None] + np.arange(c, dtype=np.int32)[None]
    return q, kp, vp, table, positions


def _dev(arrs, dev, dtype):
    out = []
    for a in arrs:
        t = torch.from_numpy(a).to(dev)
        out.append(t.to(dtype) if t.is_floating_point() else t)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,page,rep", [(64, 8, 1), (128, 16, 2),
                                        (256, 16, 4), (128, 64, 8)])
@pytest.mark.parametrize("window,cap", [(None, None), (9, 30.0)])
@pytest.mark.parametrize("lengths", DECODE_SETS)
def test_decode_kernel_matches_twin(cuda, dtype, d, page, rep, window, cap,
                                    lengths):
    q, kp, vp, table, lens = _dev(
        decode_inputs(page=page, rep=rep, d=d, seed=d + page,
                      lengths=lengths), cuda, dtype)
    pa.reset_launch_counts()
    got = pa.paged_attention(q, kp, vp, table, lens, window=window,
                             softcap=cap)
    want = pa.paged_decode_ref(q.float(), kp.float(), vp.float(), table,
                               lens, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == 1
    live = lens <= table.shape[1] * page     # the twin's dead rows are junk
    assert not live[-1]
    torch.testing.assert_close(got[live].float(), want[live], rtol=0,
                               atol=TOL[dtype])
    assert not got[~live].any()              # the kernel's dead rows: zeros


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [1, 64, 77])
@pytest.mark.parametrize("d,page,rep", [(128, 16, 2), (64, 8, 4)])
@pytest.mark.parametrize("window,cap", [(None, None), (20, 50.0)])
def test_prefill_kernel_matches_twin(cuda, dtype, c, d, page, rep, window,
                                     cap):
    q, kp, vp, table, positions = _dev(
        prefill_inputs(page=page, rep=rep, d=d, c=c, seed=c), cuda, dtype)
    kind = "local" if window else "causal"
    pa.reset_launch_counts()
    got = ops.paged_prefill(q, kp, vp, table, positions, kind=kind,
                            window=window, softcap=cap, impl="pallas")
    want = ops.paged_prefill(q.float(), kp.float(), vp.float(), table,
                             positions, kind=kind, window=window,
                             softcap=cap, impl="ref")
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == 1
    torch.testing.assert_close(got.float(), want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_at_a_1x2_ranks_local_heads(cuda, dtype):
    """K3 and K4 at the heads one rank of qwen3-1.7b's 1x2 serve plan
    launches them with (Hq 8, Hkv 4 of 16 / 8, D 128, page 16): the
    (B, Hkv) grids and K3's cluster at half the KV heads, against the
    twins; and each rank's half of the heads gives, bit for bit, the
    rows of those heads of the one-device launch over all 16 / 8."""
    q, kp, vp, table, lens = _dev(decode_inputs(
        page=16, rep=2, d=128, hkv=8, seed=5), cuda, dtype)
    live = lens <= table.shape[1] * 16
    full = pa.paged_attention(q, kp, vp, table, lens)
    for r in range(2):
        qs, ks, vs = (t[..., 4 * r * m:4 * (r + 1) * m, :].contiguous()
                      for t, m in ((q, 2), (kp, 1), (vp, 1)))
        got = pa.paged_attention(qs, ks, vs, table, lens)
        want = pa.paged_decode_ref(qs.float(), ks.float(), vs.float(),
                                   table, lens)
        torch.cuda.synchronize()
        torch.testing.assert_close(got[live].float(), want[live], rtol=0,
                                   atol=TOL[dtype])
        assert torch.equal(got, full[:, 8 * r:8 * (r + 1)])
    q, kp, vp, table, positions = _dev(prefill_inputs(
        page=16, rep=2, d=128, c=77, hkv=8, seed=6), cuda, dtype)
    full = ops.paged_prefill(q, kp, vp, table, positions, impl="pallas")
    for r in range(2):
        qs, ks, vs = (t[..., 4 * r * m:4 * (r + 1) * m, :].contiguous()
                      for t, m in ((q, 2), (kp, 1), (vp, 1)))
        got = ops.paged_prefill(qs, ks, vs, table, positions,
                                impl="pallas")
        want = ops.paged_prefill(qs.float(), ks.float(), vs.float(), table,
                                 positions, impl="ref")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=TOL[dtype])
        assert torch.equal(got, full[:, :, 8 * r:8 * (r + 1)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernels_at_scouts_1x2_rank_heads(cuda, dtype):
    """K3 and K4 at the heads one rank of llama4-scout's 1x2 serve plan
    launches them with (Hq 20, Hkv 4 of 40 / 8: five q heads a KV head,
    D 128, page 16), against the twins; each rank's half of the heads
    gives, bit for bit, those heads' rows of the one-device launch."""
    q, kp, vp, table, lens = _dev(decode_inputs(
        page=16, rep=5, d=128, hkv=8, seed=7), cuda, dtype)
    live = lens <= table.shape[1] * 16
    full = pa.paged_attention(q, kp, vp, table, lens)
    for r in range(2):
        qs, ks, vs = (t[..., 4 * r * m:4 * (r + 1) * m, :].contiguous()
                      for t, m in ((q, 5), (kp, 1), (vp, 1)))
        pa.reset_launch_counts()
        got = pa.paged_attention(qs, ks, vs, table, lens)
        want = pa.paged_decode_ref(qs.float(), ks.float(), vs.float(),
                                   table, lens)
        torch.cuda.synchronize()
        assert pa.LAUNCHES["paged_decode"] == 1
        torch.testing.assert_close(got[live].float(), want[live], rtol=0,
                                   atol=TOL[dtype])
        assert torch.equal(got, full[:, 20 * r:20 * (r + 1)])
    q, kp, vp, table, positions = _dev(prefill_inputs(
        page=16, rep=5, d=128, c=77, hkv=8, seed=8), cuda, dtype)
    full = ops.paged_prefill(q, kp, vp, table, positions, impl="pallas")
    for r in range(2):
        qs, ks, vs = (t[..., 4 * r * m:4 * (r + 1) * m, :].contiguous()
                      for t, m in ((q, 5), (kp, 1), (vp, 1)))
        got = ops.paged_prefill(qs, ks, vs, table, positions,
                                impl="pallas")
        want = ops.paged_prefill(qs.float(), ks.float(), vs.float(), table,
                                 positions, impl="ref")
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=TOL[dtype])
        assert torch.equal(got, full[:, :, 20 * r:20 * (r + 1)])


def _poison_tails(kp, vp, table, lengths, page):
    """NaN in every pool row past a slot's length on its last live page
    (the pages past it in the table are the NaN scratch page already)."""
    for slot, n in enumerate(lengths):
        if n % page:
            phys = table[slot, (n - 1) // page]
            kp[phys, n % page:] = vp[phys, n % page:] = np.nan


@pytest.mark.parametrize("page", [8, 64])
@pytest.mark.parametrize("rep", [2, 8])
@pytest.mark.parametrize("window,cap", [(None, None), (20, 50.0)])
def test_prefill_kernel_bf16_page_sizes_and_nan_tail(cuda, page, rep,
                                                     window, cap):
    """K4's bf16 route (the tensor-core core) at page sizes 8 and 64 (a
    64-key tile spans 8 pages or one), with NaN in the pool rows past each
    slot's length: the copy zero-fills those rows, so the outputs are
    finite and match the twin, which masks them by select."""
    q, kp, vp, table, positions = prefill_inputs(page=page, rep=rep, d=128,
                                                 c=77, seed=page + rep)
    lengths = positions[:, -1] + 1
    _poison_tails(kp, vp, table, lengths, page)
    assert any(n % page for n in lengths)        # some slot has a NaN tail
    q, kp, vp, table, positions = _dev((q, kp, vp, table, positions), cuda,
                                       torch.bfloat16)
    kind = "local" if window else "causal"
    pa.reset_launch_counts()
    got = ops.paged_prefill(q, kp, vp, table, positions, kind=kind,
                            window=window, softcap=cap, impl="pallas")
    want = ops.paged_prefill(q.float(), kp.float(), vp.float(), table,
                             positions, kind=kind, window=window,
                             softcap=cap, impl="ref")
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == 1
    assert torch.isfinite(got.float()).all() and got.float().abs().max() > 0
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=TOL[torch.bfloat16])


def test_kernels_are_deterministic(cuda):
    """Repeated launches on the same inputs give bit-identical outputs: a
    shared-memory race would usually show as run-to-run differences."""
    for lengths in ("ragged", "long"):       # "long": all 8 splits busy
        q, kp, vp, table, lens = _dev(
            decode_inputs(page=16, rep=2, d=128, lengths=lengths), cuda,
            torch.bfloat16)
        first = pa.paged_attention(q, kp, vp, table, lens)
        for _ in range(50):
            assert torch.equal(pa.paged_attention(q, kp, vp, table, lens)
                               .view(torch.int16), first.view(torch.int16))
    q, kp, vp, table, positions = _dev(
        prefill_inputs(page=16, rep=2, d=128, c=77), cuda, torch.bfloat16)
    first = ops.paged_prefill(q, kp, vp, table, positions, impl="pallas")
    for _ in range(50):
        again = ops.paged_prefill(q, kp, vp, table, positions, impl="pallas")
        assert torch.equal(again.view(torch.int16), first.view(torch.int16))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    q, kp, vp, table, lengths = _dev(
        decode_inputs(page=16, rep=2, d=128), cuda, torch.float32)
    with pytest.raises(TypeError):
        pa.paged_attention(q.half(), kp, vp, table, lengths)
    # every head dim 1 ... 256 is taken; one past it is refused
    wide = [torch.cat([t, t, t[..., :1]], -1).contiguous()
            for t in (q, kp, vp)]
    with pytest.raises(ValueError, match="head_dim .* 1 to 256"):
        pa.paged_attention(*wide, table, lengths)
    with pytest.raises(ValueError, match="Hq/Hkv <= 32"):
        pa.paged_attention(torch.cat([q] * 17, 1).contiguous(), kp, vp,
                           table, lengths)
    with pytest.raises(ValueError, match="on"):
        pa.paged_attention(q, kp.cpu(), vp, table, lengths)


def test_engine_pallas_matches_ref_greedy(cuda):
    """The smoke model served through the kernels and through the twins
    on the card: same greedy tokens; launches = layers x steps."""
    cfg = smoke("qwen3-1.7b")
    params = init_params(cfg, 0, device=cuda)
    greedy = dict(temperature=1.0, top_k=1, top_p=1.0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 33, 12, 40)]
    out = {}
    for impl in ("pallas", "ref"):
        serve = ServeConfig(num_slots=3, page_size=16, prefill_chunk=16,
                            sync_every=4, max_total_tokens=64,
                            paged_attn_impl=impl)
        eng = build_engine(cfg, params, serve, rl=RLConfig(**greedy),
                           vocab_limit=cfg.vocab_size)
        pa.reset_launch_counts()
        res = eng.generate([Request(rid=i, prompt=p, params=SamplingParams(
            max_new_tokens=12, **greedy)) for i, p in enumerate(prompts)])
        st = eng.stats()
        if impl == "pallas":
            assert pa.LAUNCHES["paged_decode"] == \
                cfg.num_layers * st["decode_steps"]
            assert pa.LAUNCHES["paged_prefill"] == \
                cfg.num_layers * st["prefill_chunks"]
        else:
            assert pa.LAUNCHES == {"paged_decode": 0, "paged_prefill": 0}
        out[impl] = res
    for a, b in zip(out["pallas"], out["ref"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(a.logps, b.logps, atol=1e-4, rtol=0)


def test_dead_slot_writes_nowhere_on_card(cuda):
    cfg = dataclasses.replace(smoke("qwen3-1.7b"), paged_attn_impl="pallas")
    params = init_params(cfg, 0, device=cuda)
    from repro_torch.models import decode_step
    from repro_torch.sampling.paged_cache import init_paged_pool
    pool = init_paged_pool(cfg, 8, 16, device=cuda)
    for layer in pool.values():
        for leaf in layer["self"].values():
            leaf.normal_()
            leaf[:, 0] = float("nan")
    before = [leaf.clone() for layer in pool.values()
              for leaf in layer["self"].values()]
    table = torch.tensor([[1, 2], [0, 0]], dtype=torch.int32, device=cuda)
    decode_step(cfg, params, pool, torch.tensor([5, 6], device=cuda),
                torch.tensor([32, 32], device=cuda), page_table=table)
    after = [leaf for layer in pool.values() for leaf in layer["self"].values()]
    for a, b in zip(before, after):              # all but scratch page 0
        assert torch.equal(a[:, 1:].view(torch.int32),
                           b[:, 1:].view(torch.int32))


# --------------------------------------------------------------------------
# K1 / K2: fused token log-prob forward and backward

TOL_LP = 1e-4
RTOL_DLOGITS = {torch.float32: 1e-5, torch.bfloat16: 2 ** -7 + 1e-5}


def _logprob_case(dev, t, v, dtype, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (3.0 * torch.randn((t, v), generator=gen, device=dev)).to(dtype)
    tgt = torch.randint(0, v, (t,), generator=gen, device=dev)
    tgt[0], tgt[-1] = -1, v + 5                  # dirty ids, clamped
    g = torch.randn((2, t), generator=gen, device=dev)
    return x, tgt, g[0], g[1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t,v", [(64, 1001), (77, 77), (33, 152064),
                                 (5, 4), (3, 1), (33, 128256), (40, 51968)])
def test_logprob_kernels_match_twin(cuda, t, v, dtype):
    x, tgt, g_lp, g_ent = _logprob_case(cuda, t, v, dtype, seed=t + v)
    tgt32 = fl.clamp_target_ids(tgt, v)
    fl.reset_launch_counts()
    got = fl.logprob_fwd(x, tgt32)
    want = fl._chunked_fwd_pass(x, tgt32, 16)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL_LP)
    lse, mu = want[2], want[2] - want[1]
    d = fl.logprob_bwd(x, tgt32, lse, mu, g_lp, g_ent)
    d_want = fl._chunked_bwd_pass(x, tgt32, lse, mu, g_lp, g_ent, 16)
    torch.cuda.synchronize()
    assert fl.LAUNCHES == {"logprob_fwd": 1, "logprob_bwd": 1}
    assert d.dtype == dtype
    assert fl.dlogits_error_ratio(d, d_want, x, tgt32, lse, mu, g_lp, g_ent,
                                  rtol=RTOL_DLOGITS[dtype]) <= 1.0


def test_logprob_fwd_past_int32_offsets(cuda):
    """T * V > 2^31: row offsets need 64 bits. bf16 logits (4.3 GB); rows
    near the end are compared against the twin."""
    t, v = 14200, 152064
    assert t * v > 2 ** 31
    x, tgt, _, _ = _logprob_case(cuda, t, v, torch.bfloat16, seed=3)
    tgt32 = fl.clamp_target_ids(tgt, v)
    lp, ent, lse = fl.logprob_fwd(x, tgt32)
    rows = torch.cat([torch.arange(0, 64), torch.arange(t - 256, t)]).to(
        cuda)
    want = fl._chunked_fwd_pass(x[rows], tgt32[rows], 64)
    for a, b in zip((lp[rows], ent[rows], lse[rows]), want):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL_LP)
    assert torch.isfinite(lse).all()


def test_logprob_kernels_are_deterministic(cuda):
    x, tgt, g_lp, g_ent = _logprob_case(cuda, 64, 152064, torch.float32)
    tgt32 = fl.clamp_target_ids(tgt, x.shape[1])
    first = fl.logprob_fwd(x, tgt32)
    d0 = fl.logprob_bwd(x, tgt32, first[2], first[2] - first[1], g_lp, g_ent)
    for _ in range(20):
        again = fl.logprob_fwd(x, tgt32)
        for a, b in zip(again, first):
            assert torch.equal(a, b)
        assert torch.equal(fl.logprob_bwd(x, tgt32, first[2],
                                          first[2] - first[1], g_lp, g_ent),
                           d0)


def test_logprob_wrappers_refuse(cuda):
    x, tgt, g_lp, g_ent = _logprob_case(cuda, 8, 64, torch.float32)
    tgt32 = fl.clamp_target_ids(tgt, 64)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fused_token_logprob(x.cpu(), tgt.cpu(), impl="pallas")
    with pytest.raises(ValueError, match="T, V"):
        fl.logprob_fwd(x[None], tgt32)
    with pytest.raises(ValueError, match="contiguous"):
        fl.logprob_fwd(x.t(), torch.zeros(64, dtype=torch.int32,
                                          device=cuda))
    with pytest.raises(TypeError):
        fl.logprob_fwd(x.half(), tgt32)
    with pytest.raises(ValueError, match="int32"):
        fl.logprob_fwd(x, tgt)                  # int64, not clamped
    with pytest.raises(ValueError, match="on"):
        fl.logprob_fwd(x, tgt32.cpu())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_through_fused_matches_twin(cuda, dtype):
    """Autograd through ``ops.fused_token_logprob`` on (2, 37, 1001)
    logits: the values match the twin's, and the gradient is exactly K2
    on K1's lse and mu with the cotangents autograd hands over, which in
    turn matches the twin's backward rule within the element-wise bound,
    for random cotangents and for the log-prob alone (a zero g_ent)."""
    x, tgt, g_lp, g_ent = _logprob_case(cuda, 2 * 37, 1001, dtype, seed=9)
    tgt32 = fl.clamp_target_ids(tgt, 1001)
    _, ent_k, lse_k = fl.logprob_fwd(x, tgt32)
    mu_k = lse_k - ent_k
    zero = torch.zeros_like(g_ent)
    for ge in (g_ent, zero):
        xi = x.reshape(2, 37, 1001).clone().requires_grad_()
        lp, ent = ops.fused_token_logprob(xi, tgt.reshape(2, 37))
        want = ops.fused_token_logprob(xi.detach(), tgt.reshape(2, 37),
                                       impl="chunked")
        for a, b in zip((lp, ent), want):
            torch.testing.assert_close(a, b, rtol=0, atol=TOL_LP)
        if ge is zero:                  # autograd makes the zero g_ent
            (dx,) = torch.autograd.grad((lp * g_lp.reshape(2, 37)).sum(), xi)
        else:
            (dx,) = torch.autograd.grad((lp, ent), xi,
                                        (g_lp.reshape(2, 37),
                                         ge.reshape(2, 37)))
        args = (x, tgt32, lse_k, mu_k, g_lp, ge)
        direct = fl.logprob_bwd(*args)
        assert torch.equal(dx.reshape(74, 1001), direct)
        d_twin = fl._chunked_bwd_pass(*args, 16)
        assert fl.dlogits_error_ratio(direct, d_twin, *args,
                                      rtol=RTOL_DLOGITS[dtype]) <= 1.0


def test_tiny_train_step_fused_matches_chunked_on_card(cuda):
    """One GEPO step of the smoke model on the card, logprob_impl "fused"
    (K1/K2) against "chunked" (the twin): same metrics and params within
    float32 summation-order tolerance; K1 launches once and K2 once per
    microbatch."""
    from repro_torch.config import ModelConfig
    cfg = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=48,
                      num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=300,
                      dtype="float32", attn_impl="chunked", attn_chunk=8,
                      remat=True, rope_theta=1e4)
    rng = np.random.default_rng(0)
    b, s = 8, 20
    batch = {"tokens": torch.from_numpy(rng.integers(0, 300, (b, s))),
             "mask": torch.ones((b, s - 1)),
             "sampler_lp": -torch.rand((b, s - 1)),
             "rewards": torch.from_numpy((rng.random(b) > 0.5).astype(
                 np.float32))}
    batch = {k: v.to(cuda) for k, v in batch.items()}
    rl = RLConfig(loss_type="gepo", group_size=4, beta_kl=0.005)
    out = {}
    for impl in ("fused", "chunked"):
        tc = TrainConfig(learning_rate=1e-3, grad_accum=2, total_steps=10,
                         logprob_impl=impl)
        state = init_state(cfg, tc, init_params(cfg, 0, device=cuda))
        fl.reset_launch_counts()
        new, m = train_step(cfg, rl, tc, state, batch)
        torch.cuda.synchronize()
        out[impl] = (new, m, dict(fl.LAUNCHES))
    assert out["fused"][2] == {"logprob_fwd": 2, "logprob_bwd": 2}
    assert out["chunked"][2] == {"logprob_fwd": 0, "logprob_bwd": 0}
    for k, v in out["chunked"][1].items():
        torch.testing.assert_close(out["fused"][1][k], v, rtol=1e-4,
                                   atol=1e-5, msg=k)
    for a, b in zip(tree_leaves(out["fused"][0].params),
                    tree_leaves(out["chunked"][0].params)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# K5: dense flash attention forward

TOL_FLASH = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _flash_inputs(dev, dtype, *, b=2, s=160, hkv=2, rep=2, d=128, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
            for h in (hkv * rep, hkv, hkv)]


def _flash_check(q, k, v, **kw):
    fa.reset_launch_counts()
    got = fa.flash_attention(q, k, v, **kw)
    want = fa.flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert fa.LAUNCHES["flash_attention"] == 1
    assert got.dtype == q.dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want, rtol=0,
                               atol=TOL_FLASH[q.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [64, 128, 256])
@pytest.mark.parametrize("rep", [1, 2])
def test_flash_kernel_matches_twin(cuda, dtype, d, rep):
    q, k, v = _flash_inputs(cuda, dtype, rep=rep, d=d, seed=d + rep)
    _flash_check(q, k, v, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("s", [37, 160, 1023])
@pytest.mark.parametrize("mask", ["causal", "window", "softcap", "bidir"])
def test_flash_kernel_masks_and_ragged_lengths(cuda, s, mask, dtype):
    """Every mask at ragged lengths (partial last q and kv tiles), through
    both bodies (float32 on the CUDA cores, bfloat16 on the tensor cores);
    the window (50) cuts tiles of 64 keys mid-tile."""
    kw = {"causal": dict(causal=True),
          "window": dict(causal=True, window=50),
          "softcap": dict(causal=True, softcap=30.0),
          "bidir": dict(causal=False)}[mask]
    q, k, v = _flash_inputs(cuda, dtype, s=s, seed=s)
    _flash_check(q, k, v, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sk", [1500, 1601])
@pytest.mark.parametrize("sq", [1, 77])
@pytest.mark.parametrize("rep,d", [(4, 128), (1, 64)])
def test_flash_kernel_non_causal_at_unequal_lengths(cuda, dtype, sq, sk, rep,
                                                    d):
    """Cross-attention's shapes: non-causal, one decode row or a prompt
    (Sq 1, 77) against a memory of Sk rows (1601, the VLM's patches; 1500,
    Whisper's frames), at the VLM's group (rep 4, D 128) and Whisper's
    (rep 1, D 64). The last memory row has k 0 and v 1000, so it carries
    ~1000 / (Sk e^0.5) ~ 0.4 of every output: the twin over Sk - 1 keys
    (a kernel that drops the last row) is off by more than ten bars."""
    hkv = 2
    q, k, v = _flash_inputs(cuda, dtype, b=3, s=sk, hkv=hkv, rep=rep, d=d,
                            seed=sq + sk + d)
    q = q[:, :sq].contiguous()
    k[:, -1], v[:, -1] = 0.0, 1000.0
    _flash_check(q, k, v, causal=False)
    f32 = [t.float() for t in (q, k, v)]
    drop = fa.flash_attention_ref(f32[0], f32[1][:, :-1], f32[2][:, :-1],
                                  causal=False)
    full = fa.flash_attention_ref(*f32, causal=False)
    assert float((drop - full).abs().max()) > 10 * TOL_FLASH[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,d", [(6, 2, 64), (16, 2, 128),
                                      (80, 1, 256)])
def test_flash_kernel_gqa_packing(cuda, dtype, hq, hkv, d):
    """GQA group sizes that do not fill the bf16 route's packed rows evenly
    (rep 3: 42 tokens x 3 heads of 128 rows), fill them with 16 tokens (rep
    8), or exceed them (rep 80 at D 256: blocks of 64 and 16 heads of 64
    rows per kv head); sliding window and softcap on, ragged S."""
    gen = torch.Generator(device=cuda).manual_seed(hq)
    q, k, v = (torch.randn((2, 131, h, d), generator=gen, device=cuda)
               .to(dtype) for h in (hq, hkv, hkv))
    _flash_check(q, k, v, causal=True, window=70, softcap=30.0)


# the bf16 bodies on the tensor cores and the float32 bodies that must
# stay on the CUDA cores, by the names of their kernels in the library,
# with their instantiations: K5 and K4 at D 64, 128, 256 and padded at the
# 16 multiples of 16 (bf16), their float32 bodies (the float32 core of
# csrc/attention_f32.cuh) padded at the 8 multiples of 32; K6 at P slice
# 16, 32, 64 x N 16, 32, 64, 128, exact and padded: the bf16 body, and the
# float32 route's steps A and C (step B, the state pass, is one kernel)
TC_KERNELS = {"flash_attention_tc_kernel": 19, "paged_prefill_tc_kernel": 19}
F32_KERNELS = {"flash_attention_kernel": 11, "paged_prefill_kernel": 11}
SSD_TC_KERNELS = {"ssd_scan_tc_kernel": 24}
SSD_F32_KERNELS = {"ssd_state_kernel": 24, "ssd_pass_kernel": 1,
                   "ssd_chunk_scan_kernel": 24}


def _check_tensor_cores(tc, f32, f32_spills=False):
    """Every instantiation of the ``tc`` kernels has HMMA (or HGMMA)
    instructions in its SASS and spills nothing (the ptxas -v report of
    the build); the ``f32`` kernels have none, and with ``f32_spills``
    spill nothing either; each name has its count of instantiations."""
    built = build.build()
    sass = build.sass_functions(built.path)
    report = build.ptxas_report(built.log)
    for kern, count in {**tc, **f32}.items():
        names = [n for n in sass if kern in n]
        assert len(names) == count, (kern, names)
        for n in names:
            mma = "HMMA" in sass[n] or "HGMMA" in sass[n]
            assert mma == (kern in tc), n
            if kern in tc or f32_spills:
                assert report[n]["spill_stores"] == 0, (n, report[n])
                assert report[n]["spill_loads"] == 0, (n, report[n])


def test_bf16_attention_kernels_use_tensor_cores(cuda):
    """Every bf16 instantiation of K5 and K4 (D 64, 128, 256 and the padded
    widths) runs its products on the tensor cores without spilling; their
    float32 bodies do not use them."""
    _check_tensor_cores(TC_KERNELS, F32_KERNELS)


def test_bf16_ssd_kernel_uses_tensor_cores(cuda):
    """Every bf16 instantiation of K6 runs its products on the tensor
    cores without spilling; its float32 route's three kernels do not use
    them and spill nothing."""
    _check_tensor_cores(SSD_TC_KERNELS, SSD_F32_KERNELS, f32_spills=True)


def test_flash_kernel_is_deterministic(cuda):
    q, k, v = _flash_inputs(cuda, torch.bfloat16, b=1, s=1023, hkv=2,
                            rep=2, d=256)
    kw = dict(causal=True, window=300, softcap=50.0)
    first = fa.flash_attention(q, k, v, **kw)
    for _ in range(50):
        again = fa.flash_attention(q, k, v, **kw)
        assert torch.equal(again.view(torch.int16), first.view(torch.int16))


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _flash_inputs(cuda, torch.float32, d=128)
    fa.reset_launch_counts()
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), k, v)
    # every head dim 1 ... 256 is taken; one past it is refused
    with pytest.raises(ValueError, match="head_dim be 1 to 256"):
        fa.flash_attention(*(torch.cat([t, t, t[..., :1]], -1).contiguous()
                             for t in (q, k, v)))
    with pytest.raises(ValueError, match="on"):
        fa.flash_attention(q, k.cpu(), v)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q.cpu(), k.cpu(), v.cpu())
    with pytest.raises(ValueError, match="Hq % Hkv"):
        fa.flash_attention(q[:, :, :3].contiguous(), k, v)
    assert fa.LAUNCHES["flash_attention"] == 0
    qg = q.clone().requires_grad_()
    out = ops.flash_attention(qg, k, v)      # the kernel, recorded
    assert fa.LAUNCHES["flash_attention"] == 1
    with pytest.raises(RuntimeError, match="forward-only"):
        out.sum().backward()


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "gemma2-9b"])
def test_static_engine_pallas_matches_chunked_on_card(cuda, arch):
    """The smoke model (float32) through the static engine with its
    prefill on K5 and on the plain chunked attention: same greedy tokens,
    logps within 1e-4; K5 launches once per layer for the prefill."""
    greedy = dict(temperature=1.0, top_k=1, top_p=1.0)
    prompts = np.random.default_rng(0).integers(
        3, smoke(arch).vocab_size, (3, 100)).astype(np.int32)
    out = {}
    for impl in ("pallas", "chunked"):
        cfg = smoke(arch, attn_impl=impl)
        params = init_params(cfg, 0, device=cuda)
        fa.reset_launch_counts()
        res = StaticEngine(cfg, params, rl=RLConfig(**greedy)).generate(
            [Request(rid=i, prompt=p, params=SamplingParams(
                max_new_tokens=12, **greedy)) for i, p in enumerate(prompts)])
        assert fa.LAUNCHES["flash_attention"] == \
            (cfg.num_layers if impl == "pallas" else 0)
        out[impl] = res
    for a, b in zip(out["pallas"], out["chunked"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(a.logps, b.logps, atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# K6: the Mamba2 SSD chunk scan


def _ssd_inputs(dev, dtype, b, s, h, p, g, n, seed=0):
    """x, b, c ~ N(0, 1) in ``dtype``; dt in [0.01, 0.1] and a in [-0.1,
    -0.01] in float32: slow decay, so the carried state matters."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((b, s, h, p), generator=gen, device=dev).to(dtype)
    dt = 0.01 + 0.09 * torch.rand((b, s, h), generator=gen, device=dev)
    a = -(0.01 + 0.09 * torch.rand((h,), generator=gen, device=dev))
    bm, cm = (torch.randn((b, s, g, n), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    return x, dt, a, bm, cm


def _ssd_twin(x, dt, a, bm, cm, chunk):
    return ss.ssd_scan_ref(x.float(), dt, a, bm.float(), cm.float(),
                           chunk=chunk)


# (B, S, H, P, G, N, chunk): one chunk (S = chunk), many chunks with two
# groups, chunks shorter than a 64-row tile, a ragged tile (80 rows), P 128
# (split across blocks), P and N 16
SSD_CASES = [(2, 256, 4, 64, 1, 128, 256), (2, 512, 4, 64, 2, 128, 128),
             (1, 96, 4, 32, 2, 32, 32), (2, 160, 8, 16, 1, 16, 80),
             (1, 384, 2, 128, 1, 64, 192)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_kernel_matches_twin(cuda, dtype, case):
    b, s, h, p, g, n, chunk = case
    args = _ssd_inputs(cuda, dtype, b, s, h, p, g, n, seed=s + p)
    ss.reset_launch_counts()
    got = ss.ssd_scan(*args, chunk=chunk)
    want = _ssd_twin(*args, chunk)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == 1
    assert got.dtype == dtype and got.shape == args[0].shape
    assert ss.error_ratio(got, want) <= 1.0


def test_ssd_kernel_sees_a_dropped_inter_chunk_term(cuda):
    """The twin run chunk by chunk (each from a zero state) is what a
    kernel that drops the carried state would return: the check must
    reject it by far."""
    args = _ssd_inputs(cuda, torch.float32, 2, 512, 4, 64, 1, 128)
    got = ss.ssd_scan(*args, chunk=128)
    want = _ssd_twin(*args, 128)
    cut = torch.cat([_ssd_twin(*(t[:, c0:c0 + 128] if t.dim() > 1 else t
                                 for t in args), 128)
                     for c0 in range(0, 512, 128)], 1)
    assert ss.error_ratio(got, want) <= 1.0
    assert ss.error_ratio(cut, want) > 100.0


def test_ssd_kernel_p_splits_are_bit_identical(cuda):
    """64 heads: a batch of 16 runs one block per head (1024 blocks), its
    first row alone two blocks per head, each on 32 of the 64 P rows, and
    its first row's first 16 heads four blocks per head, each on 16 rows;
    all give the same bits for those rows."""
    args = _ssd_inputs(cuda, torch.bfloat16, 16, 512, 64, 64, 1, 128)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ss.p_splits(16 * 64, 64, sms) == 1
    assert ss.p_splits(64, 64, sms) == 2
    assert ss.p_splits(16, 64, sms) == 4
    whole = ss.ssd_scan(*args, chunk=128)
    first = ss.ssd_scan(*(t[:1] if t.dim() > 1 else t for t in args),
                        chunk=128)
    assert torch.equal(first.view(torch.int16), whole[:1].view(torch.int16))
    x, dt, a, bm, cm = (t[:1] if t.dim() > 1 else t for t in args)
    heads = ss.ssd_scan(x[:, :, :16].contiguous(),
                        dt[:, :, :16].contiguous(), a[:16], bm, cm,
                        chunk=128)
    assert torch.equal(heads.view(torch.int16),
                       whole[:1, :, :16].view(torch.int16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_kernel_at_jambas_1x2_rank_heads(cuda, dtype):
    """K6 at the heads one rank of jamba-1.5-large's 1x2 serve plan scans
    (128 of 256 heads, P 64, one group, N 128, chunk 256; B 1, S 1024)
    against its twin; each half of the heads gives, bit for bit, those
    heads' rows of the one-device launch over all 256."""
    x, dt, a, bm, cm = _ssd_inputs(cuda, dtype, 1, 1024, 256, 64, 1, 128,
                                   seed=9)
    whole = ss.ssd_scan(x, dt, a, bm, cm, chunk=256)
    for r in range(2):
        h = slice(128 * r, 128 * (r + 1))
        args = (x[:, :, h].contiguous(), dt[:, :, h].contiguous(), a[h],
                bm, cm)
        ss.reset_launch_counts()
        got = ss.ssd_scan(*args, chunk=256)
        want = _ssd_twin(*args, 256)
        torch.cuda.synchronize()
        assert ss.LAUNCHES["ssd_scan"] == 1
        assert ss.error_ratio(got, want) <= 1.0
        assert torch.equal(got, whole[:, :, h])


def test_ssd_kernel_is_deterministic_at_the_long_shape(cuda):
    """mamba2-1.3b's layer at B 1, S 8192 (64 heads, P split across
    blocks): 20 repeats bit for bit."""
    args = _ssd_inputs(cuda, torch.bfloat16, 1, 8192, 64, 64, 1, 128)
    first = ss.ssd_scan(*args, chunk=256)
    for _ in range(20):
        again = ss.ssd_scan(*args, chunk=256)
        assert torch.equal(again.view(torch.int16), first.view(torch.int16))


def test_ssd_f32_rows_and_heads_alone_are_bit_identical(cuda):
    """The float32 route at mamba2's widths (B 16, S 512, H 64, P 64, N
    128, 4 chunks): the first batch row alone and its first 16 heads alone
    give the whole call's bits for those rows (a head's y depends only on
    its own data and the shapes)."""
    args = _ssd_inputs(cuda, torch.float32, 16, 512, 64, 64, 1, 128, seed=7)
    whole = ss.ssd_scan(*args, chunk=128)
    x, dt, a, bm, cm = (t[:1] if t.dim() > 1 else t for t in args)
    first = ss.ssd_scan(x, dt, a, bm, cm, chunk=128)
    heads = ss.ssd_scan(x[:, :, :16].contiguous(),
                        dt[:, :, :16].contiguous(), a[:16], bm, cm,
                        chunk=128)
    assert torch.equal(first, whole[:1])
    assert torch.equal(heads, whole[:1, :, :16])
    assert ss.error_ratio(whole, _ssd_twin(*args, 128)) <= 1.0


def test_ssd_f32_is_deterministic_at_the_long_shape(cuda):
    """mamba2-1.3b's layer at B 1, S 8192 in float32 (32 chunks through
    the state pass): 20 repeats bit for bit."""
    args = _ssd_inputs(cuda, torch.float32, 1, 8192, 64, 64, 1, 128)
    first = ss.ssd_scan(*args, chunk=256)
    for _ in range(20):
        assert torch.equal(ss.ssd_scan(*args, chunk=256), first)


def test_ssd_f32_32_chunks_against_the_twin(cuda):
    """32 chunks of 64 rows (slow decay: the state carried through 31
    passes is a large part of y) against the twin, and the twin without
    the carried state rejected by far."""
    args = _ssd_inputs(cuda, torch.float32, 2, 2048, 8, 64, 1, 128, seed=3)
    ss.reset_launch_counts()
    got = ss.ssd_scan(*args, chunk=64)
    want = _ssd_twin(*args, 64)
    assert ss.LAUNCHES["ssd_scan"] == 1 and ss.F32_LAUNCHES["ssd_scan"] == 1
    cut = torch.cat([_ssd_twin(*(t[:, c0:c0 + 64] if t.dim() > 1 else t
                                 for t in args), 64)
                     for c0 in range(0, 2048, 64)], 1)
    assert ss.error_ratio(got, want) <= 1.0
    assert ss.error_ratio(cut, want) > 100.0


def test_ssd_f32_back_to_back_calls_of_other_shapes(cuda):
    """Calls of other shapes in turn reuse the allocator's blocks for the
    float32 scratch: a call's result does not depend on what an earlier
    call left there (a wider call first, then a narrower one; each
    repeated after the other, bit for bit)."""
    big = _ssd_inputs(cuda, torch.float32, 4, 1024, 16, 64, 2, 128, seed=1)
    small = _ssd_inputs(cuda, torch.float32, 2, 256, 8, 32, 1, 48, seed=2)
    y_big = ss.ssd_scan(*big, chunk=128)
    y_small = ss.ssd_scan(*small, chunk=64)
    again_big = ss.ssd_scan(*big, chunk=128)
    again_small = ss.ssd_scan(*small, chunk=64)
    assert ss.error_ratio(y_big, _ssd_twin(*big, 128)) <= 1.0
    assert ss.error_ratio(y_small, _ssd_twin(*small, 64)) <= 1.0
    assert torch.equal(again_big, y_big)
    assert torch.equal(again_small, y_small)


@pytest.mark.parametrize("shape", [
    (16, 1024, 64, 1, 64, 128, 256), (8, 1024, 16, 1, 32, 48, 256),
    (1, 8192, 64, 1, 64, 128, 256), (4, 768, 128, 1, 64, 128, 256),
    (1, 384, 2, 1, 128, 64, 384), (2, 128, 4, 2, 127, 1, 64),
    (3, 96, 6, 3, 24, 100, 32)])
def test_ssd_f32_plan_matches_the_c_entry(cuda, shape):
    """``ssd_scan.f32_plan`` (b, s, h, g, p, n, lc), which sizes the
    wrapper's scratch, against the C source's own plan for the same shapes
    (``ssd_f32_plan``: the grids and the scratch layout its launches
    use): P slices, units a step-C block, step A's blocks, step B's grid
    (0, 0 with one chunk), step C's blocks, the scratch's bytes."""
    out = (ctypes.c_longlong * 7)()
    assert build.load().ssd_f32_plan(*shape, out) == 0
    got = ss.f32_plan(*shape)
    assert list(out) == [got.nsplit, got.units, got.grid_a,
                         *(got.grid_b or (0, 0)), got.grid_c,
                         got.scratch_bytes]


def test_ssd_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, dt, a, bm, cm = _ssd_inputs(cuda, torch.float32, 1, 64, 4, 32, 2, 32)
    ss.reset_launch_counts()
    with pytest.raises(TypeError):
        ss.ssd_scan(x.half(), dt, a, bm.half(), cm.half())
    with pytest.raises(ValueError, match="S %"):
        ss.ssd_scan(x, dt, a, bm, cm, chunk=48)
    # every P and N 1 ... 128 is taken; one past it is refused
    with pytest.raises(ValueError, match="P and N in 1 ... 128"):
        ss.ssd_scan(torch.cat([x] * 5, -1)[..., :129].contiguous(), dt, a,
                    bm, cm)
    with pytest.raises(ValueError, match="P and N in 1 ... 128"):
        ss.ssd_scan(x, dt, a, *(torch.cat([t] * 5, -1)[..., :129]
                                .contiguous() for t in (bm, cm)))
    with pytest.raises(ValueError, match="H % G"):
        ss.ssd_scan(x[:, :, :3].contiguous(), dt[:, :, :3].contiguous(),
                    a[:3], bm, cm)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_scan(*(t.cpu() for t in (x, dt, a, bm, cm)))
    assert ss.LAUNCHES["ssd_scan"] == 0
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.ssd_scan(x.clone().requires_grad_(), dt, a, bm, cm)


def test_mamba2_recompute_pallas_matches_chunked_on_card(cuda):
    """The mamba2-1.3b smoke model (float32): ``token_logps`` through K6
    and through the chunked SSD within 1e-4 nats; K6 launches once per
    layer."""
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        3, 512, (3, 101))).to(cuda)
    out = {}
    for impl in ("pallas", "chunked"):
        cfg = smoke("mamba2-1.3b", ssd_impl=impl)
        params = init_params(cfg, 0, device=cuda)
        ss.reset_launch_counts()
        out[impl] = token_logps(cfg, params, toks)
        assert ss.LAUNCHES["ssd_scan"] == \
            (cfg.num_layers if impl == "pallas" else 0)
    torch.testing.assert_close(out["pallas"], out["chunked"], rtol=0,
                               atol=1e-4)


# --------------------------------------------------------------------------
# the HeteroRL loop on the card


def test_hetero_loop_on_card_smoke(cuda):
    """The loop on the bf16 smoke model: the samplers serve through K3/K4
    and recompute through K1, the learner steps through K1/K2; no sampler
    tensor aliases a learner tensor, and a fresh subscriber's sync of the
    newest version is bit-identical to the learner's params."""
    from repro_torch.config import HeteroConfig
    from repro_torch.data import ArithmeticTask, Tokenizer
    from repro_torch.hetero import HeteroRuntime
    from repro_torch.transport import ChunkSubscriber
    cfg = smoke("qwen3-1.7b", dtype="bfloat16")
    rl = RLConfig(loss_type="gepo", group_size=4, max_new_tokens=6,
                  temperature=1.0, top_k=0, top_p=1.0, engine="continuous")
    tc = TrainConfig(learning_rate=1e-3, total_steps=10)
    state = init_state(cfg, tc, init_params(cfg, 0, device=cuda))
    task = ArithmeticTask(max_operand=20, ops="+", prompt_width=6, seed=0)
    rt = HeteroRuntime(cfg, rl, tc, HeteroConfig(num_samplers=2, seed=0),
                       task, Tokenizer(), state, prompts_per_batch=2,
                       device=cuda)
    for mod in (fl, pa):
        mod.reset_launch_counts()
    hist = rt.run(3)
    torch.cuda.synchronize()
    batches = sum(s.batches_generated for s in rt.samplers)
    assert fl.LAUNCHES == {"logprob_fwd": batches + 3, "logprob_bwd": 3}
    assert pa.LAUNCHES["paged_decode"] > 0 and \
        pa.LAUNCHES["paged_prefill"] > 0
    assert np.isfinite(hist.get("loss")).all()
    learner = {t.untyped_storage().data_ptr()
               for t in tree_leaves(rt.learner.state)}
    for s in rt.samplers:
        assert s.params["embed"].device.type == "cuda"
        assert not learner & {t.untyped_storage().data_ptr()
                              for t in tree_leaves(s.params)}
    v, host, _ = ChunkSubscriber(rt.store).sync(rt.learner.state.params)
    assert v == 3
    for h, p in zip(tree_leaves(host), tree_leaves(rt.learner.state.params)):
        assert h.dtype == p.dtype == torch.bfloat16
        assert torch.equal(h, p.detach().cpu())


# --------------------------------------------------------------------------
# speculative decoding: K4 at the verify windows, the layer-folded K3/K4
# launches, and the kernel library shared by threads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [2, 3, 5])
def test_prefill_kernel_at_verify_widths(cuda, dtype, c):
    """K4 over the spec engine's verify windows (2 ... spec_k + 1 rows a
    slot) at qwen3's head shape, against the twin."""
    q, kp, vp, table, positions = _dev(
        prefill_inputs(page=16, rep=2, d=128, c=c, hkv=8, seed=c),
        cuda, dtype)
    pa.reset_launch_counts()
    got = ops.paged_prefill(q, kp, vp, table, positions, impl="pallas")
    want = ops.paged_prefill(q.float(), kp.float(), vp.float(), table,
                             positions, impl="ref")
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == 1
    torch.testing.assert_close(got.float(), want, rtol=0, atol=TOL[dtype])


def _qwen3_layer_pools(dev, dtype, lyr=28, pages=1025, seed=0):
    """qwen3-1.7b's pools as the engine holds them (28 layers, 1025 pages
    of 16 tokens, Hkv 8, D 128) and 8 slots' tables over them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (lyr, pages, 16, 8, 128)
    kp = torch.randn(shape, generator=g, device=dev).to(dtype)
    vp = torch.randn(shape, generator=g, device=dev).to(dtype)
    lengths = torch.tensor([1, 17, 300, 511, 512, 1000, 2000, 2047],
                           device=dev)
    table = torch.randperm(pages - 1, generator=g, device=dev)[:8 * 128]
    return kp, vp, (table + 1).reshape(8, 128).int(), lengths


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layer_folded_launches_are_bit_identical(cuda, dtype):
    """paged_decode_layers / paged_prefill_layers: ONE launch over all 28
    layers' pools (page indices up to 28 x 1025) gives the bits of 28
    per-layer launches."""
    kp, vp, table, lengths = _qwen3_layer_pools(cuda, dtype)
    lyr = kp.shape[0]
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((lyr, 8, 1, 16, 128), generator=g,
                    device=cuda).to(dtype)
    pa.reset_launch_counts()
    folded = ops.paged_decode_layers(q, kp, vp, table, lengths,
                                     impl="pallas")
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == 1
    for li in range(lyr):
        one = ops.paged_decode(q[li], kp[li], vp[li], table, lengths,
                               impl="pallas")
        assert torch.equal(folded[li], one), li
    c = 5
    qp = torch.randn((lyr, 8, c, 16, 128), generator=g,
                     device=cuda).to(dtype)
    positions = (lengths - c).clamp(min=0)[:, None] + torch.arange(
        c, device=cuda)
    pa.reset_launch_counts()
    folded = ops.paged_prefill_layers(qp, kp, vp, table, positions,
                                      impl="pallas")
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == 1
    for li in range(lyr):
        one = ops.paged_prefill(qp[li], kp[li], vp[li], table, positions,
                                impl="pallas")
        assert torch.equal(folded[li], one), li


def test_threads_share_a_cold_library(cuda, monkeypatch):
    """Two threads whose first launches come together: the library is
    built (or found) once, and every launch is counted."""
    import threading
    builds, real = [], build.build

    def counted():
        builds.append(1)
        return real()

    monkeypatch.setattr(build, "build", counted)
    monkeypatch.setattr(build, "_LIB", None)
    q, kp, vp, table, lengths = _dev(
        decode_inputs(page=16, rep=2, d=128, seed=3), cuda, torch.bfloat16)
    qp, kpp, vpp, tp, pos = _dev(
        prefill_inputs(page=16, rep=2, d=128, c=5, seed=4), cuda,
        torch.bfloat16)
    n, barrier, errors = 200, threading.Barrier(2), []

    def work(fn):
        try:
            barrier.wait()
            for _ in range(n):
                fn()
        except BaseException as e:       # surfaced below
            errors.append(e)

    pa.reset_launch_counts()
    threads = [threading.Thread(target=work, args=(lambda: ops.paged_decode(
        q[:, None], kp, vp, table, lengths, impl="pallas"),)),
        threading.Thread(target=work, args=(lambda: ops.paged_prefill(
            qp, kpp, vpp, tp, pos, impl="pallas"),))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    torch.cuda.synchronize()
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(builds) == 1
    assert pa.LAUNCHES == {"paged_decode": n, "paged_prefill": n}


def test_spec_engine_on_card(cuda):
    """The spec engine on the float32 smoke model: every verify round's
    folded rescore equals the forward's attention exactly, and the launch
    counts are what the rounds imply (K4 L per verify round + 1 per
    rescore + L per prefill chunk; K3 L per fallback decode step)."""
    cfg = smoke("qwen3-1.7b")
    params = init_params(cfg, 0, device=cuda)
    rl = RLConfig(max_new_tokens=24, engine="continuous", temperature=1.0,
                  top_k=1, top_p=1.0)
    eng = build_engine(cfg, params, ServeConfig(
        num_slots=4, page_size=16, prefill_chunk=32, sync_every=4,
        max_total_tokens=96, spec_k=4, paged_attn_impl="pallas"), rl=rl,
        vocab_limit=cfg.vocab_size)
    rng = np.random.default_rng(0)
    prompts = [np.tile(rng.integers(3, 40, size=int(rng.integers(2, 6))),
                       12)[:int(rng.integers(20, 60))].astype(np.int32)
               for _ in range(6)]
    pa.reset_launch_counts()
    res = eng.generate([Request(rid=i, prompt=p,
                                params=SamplingParams.from_rl(rl))
                        for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    st = eng.stats()
    lyr = cfg.num_layers
    assert st["spec_rounds"] > 0 and st["accepted_tokens_total"] > 0
    assert st["spec_rescore_max_diff"] == 0.0
    assert pa.LAUNCHES == {
        "paged_prefill": (lyr + 1) * st["spec_rounds"]
        + lyr * st["prefill_chunks"],
        "paged_decode": lyr * eng.sync_every * st["spec_fallback_chunks"]}
    assert all(r.finish_reason in ("eos", "length") for r in res)
    eng.prefix_cache.clear()
    assert eng.free_pages == eng.num_pages - 1


# --------------------------------------------------------------------------
# threefry draws, the "gather" path, ring decode (plain torch on the card)


def test_threefry_bits_on_card_equal_the_cpu(cuda):
    """Keys, bits and uniforms are integer work plus one exact float
    subtraction: bit for bit the CPU's. The Gumbel noise takes two float32
    logs, each within 1 ulp of exact on either device: within 4 ulps of
    max(|g|, 1) (2 for each log; tests/test_torch_prng.py holds the CPU to
    jax's at that bar); the tokens are equal."""
    from repro_torch.sampling import prng
    from repro_torch.sampling.sample import sample_token_rows
    v = 152064
    for rows in (8, 40):
        keys = {}
        for dev in (cuda, torch.device("cpu")):
            rids = torch.arange(rows, device=dev) * 7 + 3
            keys[dev.type] = prng.fold_in(prng.fold_in(
                prng.PRNGKey(5, dev), rids), rids % 5)
        kd, kc = keys["cuda"], keys["cpu"]
        assert torch.equal(kd.cpu(), kc)
        assert torch.equal(prng.random_bits(kd, (v,)).cpu(),
                           prng.random_bits(kc, (v,)))
        ud = prng.uniform(kd, (v,), minval=prng.TINY_F32).cpu()
        uc = prng.uniform(kc, (v,), minval=prng.TINY_F32)
        assert torch.equal(ud.view(torch.int32), uc.view(torch.int32))
        gd, gc = prng.gumbel(kd, (v,)).cpu(), prng.gumbel(kc, (v,))
        mag = gc.abs().clamp_min(1.0)
        ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
        assert float(((gd - gc).abs() / ulp).max()) <= 4
        lg = torch.randn((rows, v), generator=torch.Generator().manual_seed(  # noqa: RA002 — seeded
            rows)) * 4
        for kw in (dict(temperature=0.6, top_k=20, top_p=0.95), {}):
            assert torch.equal(
                sample_token_rows(kd, lg.to(cuda), **kw).cpu(),
                sample_token_rows(kc, lg, **kw))


def test_token_draw_makes_no_host_sync(cuda):
    """The engines' draw on the card never waits for it: under
    ``set_sync_debug_mode("error")`` a synchronizing op raises."""
    from repro_torch.sampling import prng
    from repro_torch.sampling.sample import sample_token_rows
    keys = prng.fold_in(prng.PRNGKey(5, cuda), torch.arange(8, device=cuda))
    logits = torch.randn((8, 152064), device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sample_token_rows(keys, logits, temperature=0.6, top_k=20,
                          top_p=0.95)
        prng.categorical(keys, logits)
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_matches_twin_at_kernel_shapes(cuda, dtype):
    """"gather" (the dense view, plain torch) against the twin at the K3
    and K4 case shapes (live slots; a finite scratch page, which the dense
    view reads), and no kernel launch."""
    q, kp, vp, table, lens = decode_inputs(page=16, rep=2, d=128, seed=3)
    kp[0], vp[0] = kp[1], vp[1]
    q, kp, vp, table, lens = _dev((q, kp, vp, table, lens), cuda, dtype)
    pa.reset_launch_counts()
    for kind, window, cap in (("causal", None, None), ("local", 9, 30.0)):
        got = ops.paged_decode(q[:, None], kp, vp, table, lens, kind=kind,
                               window=window, softcap=cap, impl="gather")
        want = ops.paged_decode(q[:, None].float(), kp.float(), vp.float(),
                                table, lens, kind=kind, window=window,
                                softcap=cap, impl="ref")
        live = (lens <= table.shape[1] * 16) & (lens > 0)
        torch.testing.assert_close(got[live].float(), want[live], rtol=0,
                                   atol=TOL[dtype])
    q, kp, vp, table, positions = prefill_inputs(page=16, rep=2, d=128,
                                                 c=77, seed=4)
    kp[0], vp[0] = kp[1], vp[1]
    q, kp, vp, table, positions = _dev((q, kp, vp, table, positions), cuda,
                                       dtype)
    for kind, window, cap in (("causal", None, None), ("local", 20, 50.0)):
        got = ops.paged_prefill(q, kp, vp, table, positions, kind=kind,
                                window=window, softcap=cap, impl="gather")
        want = ops.paged_prefill(q.float(), kp.float(), vp.float(), table,
                                 positions, kind=kind, window=window,
                                 softcap=cap, impl="ref")
        torch.testing.assert_close(got.float(), want, rtol=0,
                                   atol=TOL[dtype])
    torch.cuda.synchronize()
    assert pa.LAUNCHES == {"paged_decode": 0, "paged_prefill": 0}


def test_ring_decode_step_on_card(cuda):
    """A ring-KV decode step (gemma2's smoke model, float32, prompt past
    the window) on the card equals the full-cache step's logits within
    1e-4, and the ring cache holds window rows."""
    from repro_torch.models import decode_step, forward, init_cache
    base = smoke("gemma2-9b")
    params = init_params(base, 0, device=cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        3, base.vocab_size, (2, 80))).to(cuda)
    out = {}
    for ring in (False, True):
        cfg = dataclasses.replace(base, local_ring_kv=ring)
        cache = init_cache(cfg, params, 2, 84)
        forward(cfg, params, toks, cache=cache)
        steps = []
        tok = toks[:, -1]
        for t in range(4):
            lg, _ = decode_step(cfg, params, cache, tok, 80 + t)
            steps.append(lg)
            tok = lg.argmax(-1)
        out[ring] = torch.stack(steps)
        rows = {cache[f"layer_{i}"]["self"]["k"].shape[2]
                for i, k in enumerate(cfg.block_pattern) if k == "local"}
        assert rows == {cfg.sliding_window if ring else 84}
    torch.testing.assert_close(out[True], out[False], rtol=0, atol=1e-4)


# --------------------------------------------------------------------------
# the GQA groups and vocabularies of the dense and MoE families (head_dim
# 128, page 16): llama4-scout rep 5 (Hkv 8), qwen2-7b rep 7 (Hkv 4),
# qwen1.5-32b rep 1 at Hkv 40. At rep 5 and 7 K3 runs its 8-row path with
# idle rows and K4 packs 6 and 4 tokens per block of 32 rows (30 and 28
# live); Hkv 40 gives K3 a grid of (8, 40, B)

FAMILY_GQA = [(8, 5), (4, 7), (40, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,rep", FAMILY_GQA)
@pytest.mark.parametrize("window,cap", [(None, None), (9, 30.0)])
@pytest.mark.parametrize("lengths", ("ragged", "long"))
def test_decode_kernel_at_family_gqa(cuda, dtype, hkv, rep, window, cap,
                                     lengths):
    q, kp, vp, table, lens = _dev(
        decode_inputs(page=16, rep=rep, d=128, hkv=hkv, seed=hkv + rep,
                      lengths=lengths), cuda, dtype)
    pa.reset_launch_counts()
    got = pa.paged_attention(q, kp, vp, table, lens, window=window,
                             softcap=cap)
    want = pa.paged_decode_ref(q.float(), kp.float(), vp.float(), table,
                               lens, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == 1
    live = lens <= table.shape[1] * 16
    torch.testing.assert_close(got[live].float(), want[live], rtol=0,
                               atol=TOL[dtype])
    assert not got[~live].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,rep", FAMILY_GQA)
@pytest.mark.parametrize("c", [1, 77, 512])
@pytest.mark.parametrize("window,cap", [(None, None), (20, 50.0)])
def test_prefill_kernel_at_family_gqa(cuda, dtype, hkv, rep, c, window,
                                      cap):
    q, kp, vp, table, positions = prefill_inputs(
        page=16, rep=rep, d=128, c=c, hkv=hkv, npages=64, seed=c + rep)
    lengths = positions[:, -1] + 1
    _poison_tails(kp, vp, table, lengths, 16)
    q, kp, vp, table, positions = _dev((q, kp, vp, table, positions), cuda,
                                       dtype)
    kind = "local" if window else "causal"
    pa.reset_launch_counts()
    got = ops.paged_prefill(q, kp, vp, table, positions, kind=kind,
                            window=window, softcap=cap, impl="pallas")
    want = ops.paged_prefill(q.float(), kp.float(), vp.float(), table,
                             positions, kind=kind, window=window,
                             softcap=cap, impl="ref")
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == 1
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(got.float(), want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hkv,rep", [(8, 5), (4, 7)])
@pytest.mark.parametrize("s", [160, 1023])
def test_flash_kernel_at_family_gqa(cuda, dtype, hkv, rep, s):
    """K5's ``hr`` / ``ng`` split at rep 5 and 7, D 128, ragged S."""
    q, k, v = _flash_inputs(cuda, dtype, b=1, s=s, hkv=hkv, rep=rep, d=128,
                            seed=s + rep)
    _flash_check(q, k, v, causal=True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [202240, 50432])
def test_logprob_kernels_at_family_vocabularies(cuda, v, dtype):
    """K1/K2 at the padded vocabularies of llama4 (202048 -> 202240) and
    mamba2-1.3b (50280 -> 50432)."""
    x, tgt, g_lp, g_ent = _logprob_case(cuda, 33, v, dtype, seed=v)
    tgt32 = fl.clamp_target_ids(tgt, v)
    fl.reset_launch_counts()
    got = fl.logprob_fwd(x, tgt32)
    want = fl._chunked_fwd_pass(x, tgt32, 16)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL_LP)
    lse, mu = want[2], want[2] - want[1]
    d = fl.logprob_bwd(x, tgt32, lse, mu, g_lp, g_ent)
    d_want = fl._chunked_bwd_pass(x, tgt32, lse, mu, g_lp, g_ent, 16)
    torch.cuda.synchronize()
    assert fl.LAUNCHES == {"logprob_fwd": 1, "logprob_bwd": 1}
    assert fl.dlogits_error_ratio(d, d_want, x, tgt32, lse, mu, g_lp, g_ent,
                                  rtol=RTOL_DLOGITS[dtype]) <= 1.0


# --------------------------------------------------------------------------
# the MoE FFN on the card (plain torch: the JAX package has no MoE kernel)


@pytest.mark.parametrize("t,k", [(8, 1), (512, 1), (512, 2)])
def test_moe_ffn_on_card_matches_cpu(cuda, t, k):
    """``moe_ffn`` in float32 (matmuls in full float32, TF32 off) on the
    card and on the CPU from the same inputs: the same expert ids, the
    same stable order and ranks, the same drops (t 8: a decode step of 8
    slots at the minimum capacity 4; t 512: a prefill chunk), y within
    1e-5 of the CPU's, and no read back to the host on the card."""
    from repro_torch.config import ModelConfig
    from repro_torch.models import moe
    cfg = ModelConfig(name="moe-card", family="moe", num_layers=2,
                      d_model=256, num_heads=4, num_kv_heads=2, d_ff=512,
                      vocab_size=512, block_pattern=("attn",),
                      ffn_pattern=("moe",), num_experts=16,
                      experts_per_token=k, shared_expert=True,
                      dtype="float32")
    rng = np.random.default_rng(t + k)
    # inputs off-centre, so some experts overflow; at t 8 expert 3 takes
    # all 8 tokens (4 dropped)
    x = (rng.standard_normal((1, t, 256)) + 0.5).astype(np.float32)
    router = rng.standard_normal((256, 16)) * 0.3
    router[:, 3] += 0.3 * (t == 8)
    w = {"router": router,
         "w_gate": rng.standard_normal((16, 256, 512)) * 0.05,
         "w_up": rng.standard_normal((16, 256, 512)) * 0.05,
         "w_down": rng.standard_normal((16, 512, 256)) * 0.05,
         "shared": {n: rng.standard_normal(s) * 0.05 for n, s in (
             ("w_gate", (256, 512)), ("w_up", (256, 512)),
             ("w_down", (512, 256)))}}

    def on(dev):
        def conv(a):
            if isinstance(a, dict):
                return {n: conv(b) for n, b in a.items()}
            return torch.from_numpy(a.astype(np.float32)).to(dev)
        return conv(w), torch.from_numpy(x).to(dev)

    assert not torch.backends.cuda.matmul.allow_tf32
    out = {}
    for dev in ("cpu", cuda):
        p, xt = on(dev)
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            _, _, _, ids = moe.route(cfg, p["router"], xt[0])
            routing = moe.dispatch(cfg, ids)
            y, aux = moe.moe_ffn(cfg, p, xt)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        out[str(dev)] = (ids.cpu(), [r.cpu() if torch.is_tensor(r) else r
                                     for r in routing], y.cpu(),
                         {n: float(a) for n, a in aux.items()})
    (ic, rc, yc, ac), (ig, rg, yg, ag) = out["cpu"], out[str(cuda)]
    assert torch.equal(ic, ig)
    for a, b in zip(rc, rg):                 # cap, order, ids, rank, keep..
        assert (a == b) if isinstance(a, int) else torch.equal(a, b)
    assert not rc[4].all()                   # some entry is dropped
    torch.testing.assert_close(yg, yc, rtol=0, atol=1e-5)
    for n in ac:
        assert abs(ag[n] - ac[n]) <= 1e-5 * max(1.0, abs(ac[n])), n


def test_moe_engine_pallas_matches_ref_greedy_on_card(cuda):
    """The llama4-scout smoke model (float32, top-1 over 4 experts and a
    shared expert) served through K3/K4 and through the twins on the card:
    float32 routing does not flip between the two, so the greedy tokens
    are the same and the logps within 1e-4; launches = layers x steps."""
    cfg = smoke("llama4-scout-17b-a16e")
    params = init_params(cfg, 0, device=cuda)
    greedy = dict(temperature=1.0, top_k=1, top_p=1.0)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, n).astype(np.int32)
               for n in (5, 19, 33, 12, 40)]
    out = {}
    for impl in ("pallas", "ref"):
        serve = ServeConfig(num_slots=3, page_size=16, prefill_chunk=16,
                            sync_every=4, max_total_tokens=64,
                            paged_attn_impl=impl)
        eng = build_engine(cfg, params, serve, rl=RLConfig(**greedy),
                           vocab_limit=cfg.vocab_size)
        pa.reset_launch_counts()
        out[impl] = eng.generate([Request(
            rid=i, prompt=p, params=SamplingParams(max_new_tokens=12,
                                                   **greedy))
            for i, p in enumerate(prompts)])
        st = eng.stats()
        want = ({"paged_decode": cfg.num_layers * st["decode_steps"],
                 "paged_prefill": cfg.num_layers * st["prefill_chunks"]}
                if impl == "pallas" else
                {"paged_decode": 0, "paged_prefill": 0})
        assert pa.LAUNCHES == want
    for a, b in zip(out["pallas"], out["ref"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(a.logps, b.logps, atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# Every head dim 1 ... 256 (K3, K4, K5) and every P, N 1 ... 128 (K6): the
# padded instantiations against the twins at the bars above. The widths
# straddle each padded width (31, 33; 127, 129), hit rows that are not
# 16-byte aligned in bf16 (D 12, 20, 100) or in float32 (D 1, 31, 33, 127),
# and include the repo's small models (bench-lm D 24, serve-bench and
# spec-lm D 32, the tests' TINYs D 16 and 12) and the reference's kernel
# tests (D 32, SSD N 8).

WIDTHS = (1, 12, 16, 20, 24, 31, 32, 33, 48, 80, 96, 100, 127, 129, 200,
          255)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rep,window,cap", [(1, None, None), (4, 9, 30.0)])
def test_decode_kernel_at_every_width(cuda, dtype, d, rep, window, cap):
    q, kp, vp, table, lens = _dev(
        decode_inputs(page=8, rep=rep, d=d, seed=d), cuda, dtype)
    pa.reset_launch_counts()
    got = pa.paged_attention(q, kp, vp, table, lens, window=window,
                             softcap=cap)
    want = pa.paged_decode_ref(q.float(), kp.float(), vp.float(), table,
                               lens, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == 1
    live = lens <= table.shape[1] * 8
    torch.testing.assert_close(got[live].float(), want[live], rtol=0,
                               atol=TOL[dtype])
    assert not got[~live].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rep,window,cap", [(2, None, None), (8, 20, 50.0)])
def test_prefill_kernel_at_every_width(cuda, dtype, d, rep, window, cap):
    q, kp, vp, table, positions = _dev(
        prefill_inputs(page=16, rep=rep, d=d, c=77, seed=d), cuda, dtype)
    kind = "local" if window else "causal"
    pa.reset_launch_counts()
    got = ops.paged_prefill(q, kp, vp, table, positions, kind=kind,
                            window=window, softcap=cap, impl="pallas")
    want = ops.paged_prefill(q.float(), kp.float(), vp.float(), table,
                             positions, kind=kind, window=window,
                             softcap=cap, impl="ref")
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == 1
    torch.testing.assert_close(got.float(), want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rep,mask", [(1, "causal"), (3, "window+softcap"),
                                      (2, "bidir")])
def test_flash_kernel_at_every_width(cuda, dtype, d, rep, mask):
    kw = {"causal": dict(causal=True),
          "window+softcap": dict(causal=True, window=50, softcap=30.0),
          "bidir": dict(causal=False)}[mask]
    q, k, v = _flash_inputs(cuda, dtype, s=160, rep=rep, d=d, seed=d)
    _flash_check(q, k, v, **kw)


# --------------------------------------------------------------------------
# The float32 tile core (csrc/attention_f32.cuh) behind K4's and K5's
# float32 bodies, at the bars above (TOL, TOL_FLASH): each key split (1, 2,
# 4, 8 blocks a tile) either side of the plan's thresholds, GQA groups that
# do not fill a tile's rows (rep 5: 60 of 64), a ragged last tile, pages of
# 1, 16 and 64 rows with NaN past each slot's length, every padded width
# (K5 unsplit here, split in the width tests above; K4 always split),
# equal bits on two calls. Each call launches the float32 body once
# (F32_LAUNCHES).


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _f32_k5(dev, *, b, s, hkv, rep, d, seed, sq=None, **kw):
    q, k, v = _flash_inputs(dev, torch.float32, b=b, s=s, hkv=hkv, rep=rep,
                            d=d, seed=seed)
    if sq is not None:
        q = q[:, :sq].contiguous()
    _flash_check(q, k, v, **kw)
    assert fa.F32_LAUNCHES["flash_attention"] == 1
    return fa.f32_plan(q.shape[1], k.shape[1], b, hkv * rep, hkv, d,
                       _sms(dev))


def _f32_k4(dev, *, c, rep=2, d=128, hkv=2, page=16, npages=12,
                 seed=0, window=None, cap=None, poison=False):
    q, kp, vp, table, positions = prefill_inputs(
        page=page, rep=rep, d=d, c=c, hkv=hkv, npages=npages, seed=seed)
    if poison:
        _poison_tails(kp, vp, table, positions[:, -1] + 1, page)
    q, kp, vp, table, positions = _dev((q, kp, vp, table, positions), dev,
                                       torch.float32)
    kind = "local" if window else "causal"
    pa.reset_launch_counts()
    got = ops.paged_prefill(q, kp, vp, table, positions, kind=kind,
                            window=window, softcap=cap, impl="pallas")
    want = ops.paged_prefill(q, kp, vp, table, positions, kind=kind,
                             window=window, softcap=cap, impl="ref")
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_prefill"] == 1
    assert pa.F32_LAUNCHES["paged_prefill"] == 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=TOL[torch.float32])
    return pa.k4_f32_plan(c, q.shape[0], hkv * rep, hkv, d)


# (kernel, tokens, Hkv, D, the split the plan takes on 132 SMs): K5 at B 1,
# rep 2 either side of a wave (1025 / 1024 rows at Hkv 4), either side of
# the key-tile floor (512 / 448), at 4 and 8 blocks (S 800 at Hkv 2, S 1024
# at Hkv 1, D 128); K4 at B 3, rep 2, its one split at every size
F32_SPLIT_CASES = [("flash", 1025, 4, 64, 1), ("flash", 1024, 4, 64, 2),
                   ("flash", 512, 4, 64, 2), ("flash", 448, 4, 64, 1),
                   ("flash", 800, 2, 128, 4), ("flash", 1024, 1, 128, 8),
                   ("prefill", 704, 2, 64, 2), ("prefill", 320, 2, 64, 2),
                   ("prefill", 5, 2, 64, 2)]


@pytest.mark.parametrize("kernel,tokens,hkv,d,splits", F32_SPLIT_CASES)
def test_f32_core_at_each_split(cuda, kernel, tokens, hkv, d, splits):
    if kernel == "flash":
        plan = _f32_k5(cuda, b=1, s=tokens, hkv=hkv, rep=2, d=d,
                       seed=tokens, causal=True)
    else:
        plan = _f32_k4(cuda, c=tokens, d=d, hkv=hkv, npages=48, seed=tokens)
    assert _sms(cuda) != 132 or plan[0] == splits, plan


@pytest.mark.parametrize("rep", [2, 5, 8])
@pytest.mark.parametrize("tokens", [131, 800])
@pytest.mark.parametrize("kernel", ["flash", "prefill"])
def test_f32_core_gqa_groups_across_tile_edges(cuda, kernel, rep, tokens):
    """rep 5 fills 60 of 64 rows (12 tokens), rep 8 all 64, rep 2 all 64;
    a tile's last 4 rows at rep 5 are dead. Window and softcap on; K4
    splits every tile's keys over 2 blocks, K5 those of rep 2 at 800
    tokens over 4."""
    if kernel == "flash":
        _f32_k5(cuda, b=1, s=tokens, hkv=2, rep=rep, d=128, seed=rep,
                   causal=True, window=70, softcap=30.0)
    else:
        _f32_k4(cuda, c=tokens, rep=rep, npages=64, seed=rep,
                     window=70, cap=30.0)


def test_f32_core_ragged_tile_and_one_query_row(cuda):
    """K4 at C 77 (a ragged last tile, keys split in 8), K5 non-causal at
    Sq 1 x Sk 1601 (4 live rows of a tile against 51 key tiles, split in
    8)."""
    _f32_k4(cuda, c=77, seed=77)
    _f32_k5(cuda, b=3, s=1601, sq=1, hkv=2, rep=4, d=128, seed=1601,
               causal=False)


@pytest.mark.parametrize("page", [1, 16, 64])
def test_f32_core_page_sizes_and_nan_tail(cuda, page):
    """K4's float32 body with pages of 1, 16 and 64 rows (a key tile spans
    64, 4 or a part of one page), NaN in the pool rows past each slot's
    length: the copy zero-fills them, the outputs are finite."""
    _f32_k4(cuda, c=77, page=page, npages=-(-(2 * 77 + 2 * page) //
                                                 page), seed=page,
                 poison=True)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("kernel", ["flash", "prefill"])
def test_f32_core_every_width_at_a_full_grid(cuda, kernel, d):
    if kernel == "flash":
        plan = _f32_k5(cuda, b=4, s=512, hkv=8, rep=2, d=d, seed=d,
                       causal=True, window=300, softcap=30.0)
    else:
        plan = _f32_k4(cuda, c=256, d=d, hkv=8, npages=20, seed=d,
                       window=100, cap=30.0)
    assert plan[0] == (1 if kernel == "flash" else 2)
    assert plan[2] == (d if d in (64, 128, 256) else -(-d // 32) * 32)


def test_f32_core_is_deterministic(cuda):
    q, k, v = _flash_inputs(cuda, torch.float32, b=2, s=1023, hkv=2, rep=5,
                            d=128)
    kw = dict(causal=True, window=300, softcap=50.0)
    first = fa.flash_attention(q, k, v, **kw)
    assert torch.equal(fa.flash_attention(q, k, v, **kw).view(torch.int32),
                       first.view(torch.int32))
    q, kp, vp, table, positions = _dev(
        prefill_inputs(page=16, rep=2, d=128, c=512, npages=48), cuda,
        torch.float32)
    first = ops.paged_prefill(q, kp, vp, table, positions, impl="pallas")
    again = ops.paged_prefill(q, kp, vp, table, positions, impl="pallas")
    assert torch.equal(again.view(torch.int32), first.view(torch.int32))


def test_padded_widths_write_only_their_columns(cuda):
    """Outputs of a padded width land in their own (B, ..., D) rows: a
    view of a wider buffer beside them keeps its poison."""
    q, kp, vp, table, lens = _dev(
        decode_inputs(page=8, rep=2, d=20, seed=3), cuda, torch.bfloat16)
    buf = torch.full((2,) + tuple(q.shape), float("nan"), device=cuda,
                     dtype=q.dtype)
    out = pa.paged_attention(q, kp, vp, table, lens)
    buf[0] = out
    assert torch.isnan(buf[1]).all()
    live = lens <= table.shape[1] * 8
    assert torch.isfinite(out[live].float()).all()


# (B, S, H, P, G, N, chunk): the reference's sweep (tests/test_kernels.py,
# chunk 32) and its bf16 shape, P 24 x N 48, P and N not multiples of 4
# or 8, P 100 (two slices of 50) and 127, N 1 and 128 beside P 128
SSD_PADDED = [(1, 64, 2, 16, 1, 8, 32), (2, 128, 4, 32, 2, 16, 32),
              (1, 256, 8, 64, 1, 32, 32), (2, 192, 4, 24, 2, 48, 64),
              (1, 96, 3, 13, 1, 21, 48), (2, 128, 2, 100, 2, 7, 64),
              (1, 64, 2, 127, 1, 1, 64), (1, 128, 2, 128, 1, 100, 128),
              (1, 160, 2, 5, 1, 128, 80)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", SSD_PADDED)
def test_ssd_kernel_at_padded_sizes(cuda, dtype, case):
    b, s, h, p, g, n, chunk = case
    args = _ssd_inputs(cuda, dtype, b, s, h, p, g, n, seed=p + n)
    ss.reset_launch_counts()
    got = ss.ssd_scan(*args, chunk=chunk)
    want = _ssd_twin(*args, chunk)
    torch.cuda.synchronize()
    assert ss.LAUNCHES["ssd_scan"] == 1
    assert got.dtype == dtype and got.shape == args[0].shape
    assert ss.error_ratio(got, want) <= 1.0


def test_ssd_padded_slices_are_bit_identical(cuda):
    """P 100 over 8 heads: a batch of 16 runs two slices of 50 rows a head,
    its first row alone four of 25; both give the same bits."""
    args = _ssd_inputs(cuda, torch.bfloat16, 16, 128, 8, 100, 1, 24, seed=5)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert ss.p_splits(16 * 8, 100, sms) == 2
    assert ss.p_splits(8, 100, sms) == 4
    whole = ss.ssd_scan(*args, chunk=64)
    first = ss.ssd_scan(*(t[:1] if t.dim() > 1 else t for t in args),
                        chunk=64)
    assert torch.equal(first.view(torch.int16), whole[:1].view(torch.int16))
