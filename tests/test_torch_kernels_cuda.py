"""The port's CUDA kernels against their plain PyTorch twins, on a card.

Imports torch and numpy only, so it runs on a machine with the card and
no jax:  PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
Without a card every test skips (the kernels have no CPU mode).

Tolerances: the twin runs in float32 on the same inputs; 1e-5 abs for
float32 inputs (summation order only), 2e-2 abs for bfloat16 (one rounding
of the output to bf16).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.config import RLConfig, ServeConfig
from repro_torch.configs import smoke
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import init_params
from repro_torch.sampling import build_engine
from repro_torch.serving.api import Request, SamplingParams

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


def decode_inputs(*, page, rep, d, hkv=2, npages=6, seed=0):
    """Lengths 0, 1, page, ragged, full and a dead slot (width*page + 1);
    unused table entries point at the NaN scratch page."""
    rng = np.random.default_rng(seed)
    lengths = np.array([0, 1, page, page + 3, 3 * page - 1, npages * page,
                        npages * page + 1], np.int32)
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
def test_decode_kernel_matches_twin(cuda, dtype, d, page, rep, window, cap):
    q, kp, vp, table, lengths = _dev(
        decode_inputs(page=page, rep=rep, d=d, seed=d + page), cuda, dtype)
    pa.reset_launch_counts()
    got = pa.paged_attention(q, kp, vp, table, lengths, window=window,
                             softcap=cap)
    want = pa.paged_decode_ref(q.float(), kp.float(), vp.float(), table,
                               lengths, window=window, softcap=cap)
    torch.cuda.synchronize()
    assert pa.LAUNCHES["paged_decode"] == 1
    live = slice(0, q.shape[0] - 1)          # the twin's dead row is junk
    torch.testing.assert_close(got[live].float(), want[live], rtol=0,
                               atol=TOL[dtype])
    assert not got[-1].any()                 # the kernel's dead row: zeros


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


def test_kernels_are_deterministic(cuda):
    """Repeated launches on the same inputs give bit-identical outputs: a
    shared-memory race would usually show as run-to-run differences."""
    q, kp, vp, table, lengths = _dev(
        decode_inputs(page=16, rep=2, d=128), cuda, torch.bfloat16)
    first = pa.paged_attention(q, kp, vp, table, lengths)
    for _ in range(50):
        assert torch.equal(pa.paged_attention(q, kp, vp, table, lengths)
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
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_attention(q[..., :96].contiguous(), kp[..., :96].contiguous(),
                           vp[..., :96].contiguous(), table, lengths)
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
