"""The kernels' widened shape range, on the CPU: every head dim 1 ... 256
for the attention kernels K3, K4 and K5, every P and N 1 ... 128 for the
SSD kernel K6, and the dispatch's route labels.

- The wrappers' checks are functions of shapes and dtypes
  (``check_shapes``), so they run here although each wrapper raises on a
  CPU tensor: they take the repo's small models' widths (D 12, 16, 20,
  24, 32, 80, 96; SSD N 8, P 24 x N 48) and refuse past the limits, with
  the limits in the message. The kernels themselves run only on a card
  (``tests/test_torch_kernels_cuda.py``, every width against the twins).
- The twins, which the kernels are held to on the card, against the JAX
  package's Pallas kernels in interpret mode at D 24 (bench-lm) and D 12,
  and at K6's P 24, N 48: the same numpy inputs, the bars of the existing
  twin tests (paged 1e-5 and flash 2e-5 in float32, flash 2e-2 in
  bfloat16; SSD 2e-4).
- A CPU engine under the default paged impl records its paged dispatches
  on the route it takes, "twin", and emits the bits of impl "ref".
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import paged_attention as jpa
from repro_torch.analysis import sentinel
from repro_torch.analysis.sentinel import RecompileSentinel
from repro_torch.config import ATTN, MLP, ModelConfig, RLConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.models import init_params
from repro_torch.sampling import ContinuousEngine
from repro_torch.sampling.prng import PRNGKey
from repro_torch.serving.api import Request, SamplingParams

F32, BF16 = torch.float32, torch.bfloat16
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": F32, "bfloat16": BF16}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    yield


# --------------------------------------------------------------------------
# the wrappers' checks

SMALL_WIDTHS = (12, 16, 20, 24, 32, 80, 96)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", SMALL_WIDTHS + (1, 256))
def test_paged_kernels_take_every_head_dim(d, dtype):
    code = tpa.check_shapes((8, 1, 8, d), (33, 16, 2, d), (33, 16, 2, d),
                            dtype, dtype, dtype)
    assert code == {F32: 0, BF16: 1}[dtype]


@pytest.mark.parametrize("shapes,err,match", [
    (((8, 4, 257), (9, 16, 2, 257)), ValueError, "be 1 to 256"),
    (((8, 4, 0), (9, 16, 2, 0)), ValueError, "be 1 to 256"),
    (((8, 4, 24), (9, 16, 2, 32)), ValueError, "match the pools"),
    (((8, 66, 24), (9, 16, 2, 24)), ValueError, "Hq/Hkv <= 32"),
    (((8, 5, 24), (9, 16, 2, 24)), ValueError, "Hq % Hkv"),
    (((8, 4, 24), (9, 65, 2, 24)), ValueError, r"\[1, 64\]"),
])
def test_paged_kernels_refuse_past_their_limits(shapes, err, match):
    q, pool = shapes
    with pytest.raises(err, match=match):
        tpa.check_shapes(q, pool, pool, F32, F32, F32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tpa.check_shapes((8, 4, 24), (9, 16, 2, 24), (9, 16, 2, 24),
                         torch.float16, torch.float16, torch.float16)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("d", SMALL_WIDTHS + (1, 256))
def test_flash_kernel_takes_every_head_dim(d, dtype):
    assert fa.check_shapes((2, 160, 4, d), (2, 160, 2, d), (2, 160, 2, d),
                           dtype, dtype, dtype) == {F32: 0, BF16: 1}[dtype]


@pytest.mark.parametrize("q,k,match", [
    ((2, 9, 4, 257), (2, 9, 2, 257), "be 1 to 256"),
    ((2, 9, 4, 24), (2, 9, 2, 12), "head_dim must match"),
    ((2, 9, 3, 24), (2, 9, 2, 24), "Hq % Hkv"),
    ((16384, 9, 4, 24), (16384, 9, 2, 24), "exceeds the grid"),
])
def test_flash_kernel_refuses_past_its_limits(q, k, match):
    with pytest.raises(ValueError, match=match):
        fa.check_shapes(q, k, k, BF16, BF16, BF16)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("p,n", [(16, 8), (24, 48), (1, 1), (13, 21),
                                 (100, 7), (128, 128), (64, 128)])
def test_ssd_kernel_takes_every_p_and_n(p, n, dtype):
    lc = ss.check_shapes((2, 128, 4, p), (2, 128, 4), (4,), (2, 128, 2, n),
                         (2, 128, 2, n), dtype, dtype, dtype, chunk=32)
    assert lc == 32


@pytest.mark.parametrize("p,n", [(129, 16), (16, 129), (0, 16), (16, 0)])
def test_ssd_kernel_refuses_past_its_limits(p, n):
    with pytest.raises(ValueError, match=r"P and N in 1 \.\.\. 128"):
        ss.check_shapes((2, 128, 4, p), (2, 128, 4), (4,), (2, 128, 2, n),
                        (2, 128, 2, n), F32, F32, F32, chunk=32)


@pytest.mark.parametrize("blocks,p,want", [
    (1024, 64, 1), (64, 64, 2), (16, 64, 4), (1024, 128, 2), (2, 16, 1),
    (128, 100, 2), (8, 100, 4), (2, 127, 8), (2, 24, 1), (2, 33, 2)])
def test_p_splits_hold_every_slice_within_the_block(blocks, p, want):
    """The P slices of a head: at most 64 rows a block, split while the
    grid still fits one wave of 132 SMs; a slice holds ceil(P / n) rows
    and none is empty. Powers of two split as before."""
    n = ss.p_splits(blocks, p, 132)
    assert n == want
    rows = -(-p // n)
    assert rows <= ss.ROWS_MAX and (n - 1) * rows < p


# (tokens, keys, B, Hq, Hkv, D) -> K5's (splits, grid, padded width): the
# timed rows (the static prefill; D 32), bench-lm's static prefill (D 24,
# a grid of 128 whose 2 key tiles stay unsplit), the VLM's cross decode
# and prefill, Whisper's encoder, a grid either side of one wave (1025 /
# 1024), either side of the key-tile floor (512 / 448), splits of 4 and 8,
# rep 80 past a tile (two head groups of 64 and 16), and the widths
F32_PLANS = [
    ((832, 832, 16, 16, 8, 128), (1, (26, 128), 128)),
    ((832, 832, 16, 8, 4, 32), (1, (26, 64), 32)),
    ((128, 128, 16, 4, 2, 24), (1, (4, 32), 32)),
    ((1, 1601, 8, 32, 8, 128), (4, (4, 64), 128)),
    ((832, 1601, 8, 32, 8, 128), (1, (52, 64), 128)),
    ((1500, 1500, 8, 12, 12, 64), (1, (24, 96), 64)),
    ((1025, 1025, 1, 8, 4, 64), (1, (33, 4), 64)),
    ((1024, 1024, 1, 8, 4, 64), (2, (64, 4), 64)),
    ((512, 512, 1, 8, 4, 64), (2, (32, 4), 64)),
    ((448, 448, 1, 8, 4, 64), (1, (14, 4), 64)),
    ((800, 800, 1, 4, 2, 128), (4, (100, 2), 128)),
    ((1024, 1024, 1, 2, 1, 128), (8, (256, 1), 128)),
    ((131, 131, 2, 80, 1, 256), (1, (131, 4), 256)),
    ((3, 3, 1, 80, 1, 256), (1, (3, 2), 256)),
    ((9, 9, 2, 4, 2, 1), (1, (1, 4), 32)),
    ((9, 9, 2, 4, 2, 33), (1, (1, 4), 64)),
    ((9, 9, 2, 4, 2, 129), (1, (1, 4), 160)),
    ((9, 9, 2, 4, 2, 200), (1, (1, 4), 224)),
    ((9, 9, 2, 4, 2, 255), (1, (1, 4), 256)),
]


@pytest.mark.parametrize("args,want", F32_PLANS)
def test_f32_plan_splits_keys_only_under_a_wave(args, want):
    """K5's float32 launch as the kernel computes it from the split:
    64-row tiles of min(rep, 64) heads; where they leave the grid under
    one wave, the fewest of 2, 4, 8 blocks a tile that fill it while each
    keeps 4 key tiles; D padded to a multiple of 32 except 64, 128,
    256."""
    tokens, keys, b, hq, hkv, d = args
    splits, grid, width = fa.f32_plan(tokens, keys, b, hq, hkv, d, 132)
    assert (splits, grid, width) == want
    hr = min(hq // hkv, fa.F32_ROWS)
    tiles = grid[0] // splits
    assert (64 // hr) * (tiles - 1) < tokens <= (64 // hr) * tiles
    key_tiles = -(-keys // (64 if width <= 64 else 32))
    assert splits == 1 or (grid[0] * grid[1] // 2 < 132
                           and key_tiles >= 4 * splits)
    assert (splits == 8 or grid[0] * grid[1] >= 132
            or key_tiles < 8 * splits)


@pytest.mark.parametrize("b,hkv", [(1, 8), (8, 8), (224, 8), (1, 4),
                                   (3, 2), (1, 40)])
def test_k4_f32_split_is_one_for_every_batch_and_head_count(b, hkv):
    """K4's float32 body splits each tile's keys over K4_F32_SPLITS blocks
    whatever the slots and kv heads, so a launch folded over 28 layers (B
    8 -> 224) or at a rank's 4 of 8 kv heads splits as the per-layer or
    whole launch does; its grid is the tiles' times the split."""
    splits, grid, width = tpa.k4_f32_plan(512, b, 2 * hkv, hkv, 24)
    assert splits == tpa.K4_F32_SPLITS == 2
    assert grid == (16 * 2, b * hkv) and width == 32


@pytest.mark.parametrize("b,hq,hkv,dtype,ok", [
    (65535, 2, 1, F32, True), (65536, 2, 1, F32, False),
    (32767, 80, 1, F32, True), (32768, 80, 1, F32, False),
    (16384, 4, 2, F32, True), (16383, 4, 2, BF16, True),
    (16384, 4, 2, BF16, False)])
def test_flash_grid_rows_limit_by_body(b, hq, hkv, dtype, ok):
    """K5's grid rows: B * Hkv * ceil(rep / 64) for the float32 core (rep
    80 takes two head groups), B * Hq for the bf16 body; the last shape
    each takes and the first it refuses."""
    shapes = ((b, 9, hq, 24), (b, 9, hkv, 24), (b, 9, hkv, 24))
    if ok:
        assert fa.check_shapes(*shapes, dtype, dtype, dtype) == \
            {F32: 0, BF16: 1}[dtype]
    else:
        with pytest.raises(ValueError, match="exceeds the grid's 65535"):
            fa.check_shapes(*shapes, dtype, dtype, dtype)


@pytest.mark.parametrize("q,dtype,ok", [
    ((65535, 1, 4, 24), F32, True), ((65536, 1, 4, 24), F32, False),
    ((65536, 1, 4, 24), BF16, True), ((65536, 4, 24), F32, True)])
def test_paged_prefill_f32_grid_rows_limit(q, dtype, ok):
    """K4's float32 grid has B * Hkv rows (rep <= 32 fits a tile): the
    last prefill batch it takes and the first it refuses at Hkv 1; the
    bf16 body and K3 (a 3-d q) are not held to it."""
    pool = (9, 16, 1, 24)
    if ok:
        tpa.check_shapes(q, pool, pool, dtype, dtype, dtype)
    else:
        with pytest.raises(ValueError, match="exceeds the float32 grid's"):
            tpa.check_shapes(q, pool, pool, dtype, dtype, dtype)


# --------------------------------------------------------------------------
# the twins against the JAX package's Pallas kernels in interpret mode


def _paged_inputs(d, *, b=4, c=None, rep=2, hkv=2, page=8, npages=3,
                  seed=0):
    rng = np.random.default_rng(seed + d)
    pool = 1 + b * npages
    shape = (b, hkv * rep, d) if c is None else (b, c, hkv * rep, d)
    q = rng.standard_normal(shape, dtype=np.float32)
    kp = rng.standard_normal((pool, page, hkv, d), dtype=np.float32)
    vp = rng.standard_normal((pool, page, hkv, d), dtype=np.float32)
    table = np.arange(1, pool, dtype=np.int32).reshape(b, npages)
    return q, kp, vp, table


@pytest.mark.parametrize("d", [24, 12])
def test_paged_decode_twin_matches_pallas_at_small_head_dims(d):
    q, kp, vp, table = _paged_inputs(d)
    lengths = np.array([1, 9, 17, 24], np.int32)
    args = (q, kp, vp, table, lengths)
    for window, cap in ((None, None), (6, 20.0)):
        want = jpa.paged_attention(*map(jnp.asarray, args), window=window,
                                   softcap=cap, interpret=True)
        got = tpa.paged_decode_ref(*map(torch.from_numpy, args),
                                   window=window, softcap=cap)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("d", [24, 12])
def test_paged_prefill_twin_matches_pallas_at_small_head_dims(d):
    q, kp, vp, table = _paged_inputs(d, b=2, c=8, npages=3, seed=1)
    table = table[:, :3]
    starts = np.array([0, 5], np.int32)
    lengths = starts + 8
    args = (q, kp, vp, table, lengths, starts)
    want = jpa.paged_prefill(*map(jnp.asarray, args), block_q=8,
                             interpret=True)
    got = tpa.paged_prefill_ref(*map(torch.from_numpy, args))
    want = np.asarray(want)  # noqa: RA003 — the check reads the reference
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("d", [24, 12])
def test_flash_twin_matches_pallas_at_small_head_dims(d, dtype, tol):
    rng = np.random.default_rng(d)
    arrs = [rng.standard_normal((2, 128, h, d)).astype(np.float32)
            for h in (4, 2, 2)]
    for kw in (dict(causal=True), dict(causal=True, window=48,
                                       softcap=30.0)):
        want = np.asarray(jops.flash_attention(
            *(jnp.asarray(a, JDT[dtype]) for a in arrs), interpret=True,
            **kw), np.float32)
        got = fa.flash_attention_ref(
            *(torch.from_numpy(a).to(TDT[dtype]) for a in arrs), **kw)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                   atol=tol)


def test_ssd_twin_matches_pallas_at_p24_n48():
    rng = np.random.default_rng(24)
    b, s, h, p, g, n = 2, 128, 4, 24, 2, 48
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.1, (b, s, h)).astype(np.float32)
    a = -rng.uniform(0.01, 0.1, h).astype(np.float32)
    bb, cc = (rng.standard_normal((b, s, g, n)).astype(np.float32)
              for _ in range(2))
    want = np.asarray(jops.ssd_scan(*map(jnp.asarray, (x, dt, a, bb, cc)),
                                    chunk=32, interpret=True))
    got = ss.ssd_scan_ref(*map(torch.from_numpy, (x, dt, a, bb, cc)),
                          chunk=32)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# the dispatch's route on a CPU tensor

TINY = ModelConfig(name="tiny", family="dense", num_layers=2, d_model=48,
                   num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=32,
                   block_pattern=(ATTN,), ffn_pattern=(MLP,),
                   dtype="float32", attn_impl="naive", remat=False,
                   rope_theta=1e4)


def _serve(impl):
    cfg = ModelConfig(**{**TINY.__dict__, "paged_attn_impl": impl})
    eng = ContinuousEngine(
        cfg, init_params(cfg, 0, device="cpu"),
        rl=RLConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=5),
        max_total_tokens=24, num_slots=2, page_size=4, prefill_chunk=4,
        sync_every=4, vocab_limit=32, key=PRNGKey(1))
    reqs = [Request(rid=i, prompt=np.arange(3, 3 + n, dtype=np.int32),
                    params=SamplingParams(temperature=1.0, top_k=0,
                                          top_p=1.0, max_new_tokens=5))
            for i, n in enumerate((3, 9, 6))]
    sentinel._seen.clear()
    with RecompileSentinel() as s:
        res = eng.generate(reqs)
    return res, s.events


@pytest.mark.parametrize("impl", [None, "auto", "ref"])
@pytest.mark.parametrize("kernel", ["paged_decode", "paged_prefill"])
def test_a_cpu_paged_dispatch_records_the_twin_route(kernel, impl):
    q, kp, vp, table = _paged_inputs(24, c=None if kernel == "paged_decode"
                                     else 5)
    t = [torch.from_numpy(x) for x in (q, kp, vp, table)]
    sentinel._seen.clear()
    with RecompileSentinel() as s:
        if kernel == "paged_decode":
            got = tops.paged_decode(t[0][:, None], *t[1:],
                                    torch.tensor([1, 9, 17, 24]), impl=impl)
            want = tpa.paged_decode_ref(t[0], *t[1:],
                                        torch.tensor([1, 9, 17, 24]))[:, None]
        else:
            pos = torch.arange(5)[None] + torch.tensor([[0], [3], [7], [9]])
            got = tops.paged_prefill(*t, pos, impl=impl)
            want = tpa.paged_prefill_ref(*t, pos[:, -1] + 1, pos[:, 0])
    assert [e[:2] for e in s.events] == [(kernel, "twin")]
    assert torch.equal(got, want)


def test_a_cpu_engine_records_only_the_twin_route():
    """The engine under its default paged impl ("auto")."""
    res, events = _serve("auto")
    paged = [e for e in events if e[0] in ("paged_decode", "paged_prefill")]
    assert {e[0] for e in paged} == {"paged_decode", "paged_prefill"}
    assert {e[1] for e in paged} == {"twin"}
    ref, ref_events = _serve("ref")
    assert [e[2:] for e in ref_events] == [e[2:] for e in events]
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.logps, b.logps)
