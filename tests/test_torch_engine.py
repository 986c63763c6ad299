"""The port's continuous engine and sampling against the JAX package.

Under a greedy profile (temperature 1, top_k 1, top_p 1) the same
requests through both engines give identical tokens; logps (full-model
log-softmax, float32) agree to 1e-4. Draws are the JAX package's threefry
draws (``sampling.prng``; ``tests/test_torch_prng.py`` and
``tests/test_torch_stochastic.py`` hold the stochastic tokens to the
reference's); here they are also held to their contract: per-request
determinism whatever the slot, finite noise at the uniform's extremes,
support inside the filtered set, and the filtered distribution.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import RLConfig as JRLConfig
from repro.config import ServeConfig as JServeConfig
from repro.models import init_params as jinit_params
from repro.sampling import build_engine as jbuild_engine
from repro.sampling import filter_logits as jfilter_logits
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.config import RLConfig, ServeConfig
from repro_torch.models import init_params, params_from_numpy
from repro_torch.sampling import (ContinuousEngine, StaticEngine,
                                  build_engine, filter_logits)
from repro_torch.sampling import prng
from repro_torch.sampling.sample import mask_vocab, sample_token_rows
from repro_torch.serving.api import Request, SamplingParams

ROOT = Path(__file__).resolve().parents[1]
GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0)


def _prompts(vocab):
    """Mixed lengths, more requests than slots, and shared prefixes (one
    ending mid-page, so admission copies the partial tail page)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(3, vocab, 9).astype(np.int32)
    out = [np.concatenate([shared, rng.integers(3, vocab, 4)])]
    out += [rng.integers(3, vocab, n) for n in (5, 3, 14)]
    out += [np.concatenate([shared, rng.integers(3, vocab, n)])
            for n in (2, 6)]
    out += [rng.integers(3, vocab, 11)]
    return [p.astype(np.int32) for p in out]


def _serve(**over):
    kw = dict(num_slots=3, page_size=4, prefill_chunk=8, sync_every=4,
              max_total_tokens=24)
    kw.update(over)
    return kw


@pytest.mark.parametrize("sync_every", [4, 3])
def test_greedy_engine_matches_jax(sync_every):
    jcfg = jconfigs.smoke("qwen3-1.7b")
    tcfg = tconfigs.smoke("qwen3-1.7b")
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    prompts = _prompts(jcfg.vocab_size)
    max_new = 8
    jeng = jbuild_engine(jcfg, jp, JServeConfig(
        paged_attn_impl="ref", **_serve(sync_every=sync_every)),
        rl=JRLConfig(**GREEDY), vocab_limit=jcfg.vocab_size,
        key=jax.random.PRNGKey(0))
    jres = jeng.generate([JRequest(rid=i, prompt=p, params=JSamplingParams(
        max_new_tokens=max_new, **GREEDY)) for i, p in enumerate(prompts)])
    teng = build_engine(tcfg, tp, ServeConfig(**_serve(
        sync_every=sync_every)), rl=RLConfig(**GREEDY),
        vocab_limit=tcfg.vocab_size)
    tres = teng.generate([Request(rid=i, prompt=p, params=SamplingParams(
        max_new_tokens=max_new, **GREEDY)) for i, p in enumerate(prompts)])
    assert teng.cfg.paged_attn_impl == "auto"       # twin on the CPU
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.logps, a.logps, atol=1e-4, rtol=0)
        assert (b.finish_reason, b.prefix_hit_tokens) == \
            (a.finish_reason, a.prefix_hit_tokens)
    assert sum(r.prefix_hit_tokens for r in tres) > 0
    js, ts = jeng.stats(), teng.stats()
    for k in ("prefill_chunks", "prefill_tokens", "decode_steps",
              "cow_copies", "prefix_hits"):
        assert ts[k] == js[k], k
    assert ts["cow_copies"] > 0
    # the pool balances after drain: only the prefix cache holds pages
    teng.prefix_cache.clear()
    assert teng.free_pages == teng.num_pages - 1
    assert teng.sched.allocator.in_use == 0


def test_filter_logits_matches_jax_with_ties():
    rng = np.random.default_rng(1)
    lg = rng.standard_normal((4, 64)).astype(np.float32)
    lg[0, :6] = 3.0          # 6-way tie at the top: top_k=3 keeps all six
    lg[1, 10:13] = lg[1].max() - 0.5
    for kw in (dict(top_k=3), dict(top_k=5, top_p=0.8),
               dict(temperature=0.6, top_k=20, top_p=0.95),
               dict(top_p=0.5), dict(temperature=0.3)):
        want = np.asarray(jfilter_logits(jnp.asarray(lg), **kw))
        got = filter_logits(torch.from_numpy(lg), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    kept = filter_logits(torch.from_numpy(lg), top_k=3)[0] > -1e29
    assert int(kept.sum()) == 6


def _row_keys(seed, rids, gens):
    """Draw ``gens[r]`` of request ``rids[r]`` under ``PRNGKey(seed)``,
    the engines' keying."""
    return prng.fold_in(prng.fold_in(prng.PRNGKey(seed), rids), gens)


def test_draws_keyed_per_request_not_per_slot():
    rng = np.random.default_rng(2)
    lg = torch.from_numpy(rng.standard_normal((5, 300)).astype(np.float32))
    rids = torch.tensor([7, 3, 11, 0, 5])
    gens = torch.tensor([0, 4, 2, 9, 1])
    perm = torch.tensor([3, 0, 4, 1, 2])
    kw = dict(temperature=0.6, top_k=20, top_p=0.95)
    a = sample_token_rows(_row_keys(9, rids, gens), lg, **kw)
    b = sample_token_rows(_row_keys(9, rids[perm], gens[perm]), lg[perm],
                          **kw)
    assert torch.equal(a[perm], b)
    c = sample_token_rows(_row_keys(9, rids, gens), lg, **kw)
    assert torch.equal(a, c)
    noise = prng.gumbel(_row_keys(9, rids, gens), (300,))
    assert not torch.equal(noise, prng.gumbel(_row_keys(10, rids, gens),
                                              (300,)))
    assert not torch.equal(noise[0], noise[1])
    # a slot's noise is its own row: the batch around it changes nothing
    assert torch.equal(noise[perm], prng.gumbel(
        _row_keys(9, rids[perm], gens[perm]), (300,)))


def test_noise_is_finite_at_every_hash_value():
    """The uniforms behind the Gumbel noise stay inside [tiny, 1) at the
    extremes of the random bits (0 and 0xFFFFFFFF): a noise of +inf
    would win a draw through the top-k and vocab masks."""
    bits = torch.tensor([0, 1, 0x1FF, 0x200, 0xFFFFFE00, 0xFFFFFFFF],
                        dtype=torch.int64)
    orig = prng.random_bits
    try:
        prng.random_bits = lambda key, shape: bits
        u = prng.uniform(prng.PRNGKey(0), (6,), minval=prng.TINY_F32)
        g = prng.gumbel(prng.PRNGKey(0), (6,))
    finally:
        prng.random_bits = orig
    assert float(u[0]) == prng.TINY_F32 and float(u[-1]) == 1 - 2 ** -23
    assert bool(((u > 0) & (u < 1)).all())
    assert bool(torch.isfinite(g).all())
    # greedy over a masked vocab of 2^18 ids: every draw is the row's
    # argmax (an infinite noise would pick a masked id)
    rng = np.random.default_rng(4)
    lg = torch.from_numpy(rng.standard_normal((64, 1 << 18)).astype(
        np.float32))
    keys = _row_keys(0, torch.arange(64), torch.zeros(64, dtype=torch.long))
    tok = sample_token_rows(keys, mask_vocab(lg, 18), top_k=1)
    assert torch.equal(tok, lg[:, :18].argmax(-1))
    assert bool(torch.isfinite(prng.gumbel(keys, (1 << 18,))).all())


def test_draws_follow_the_filtered_distribution():
    rng = np.random.default_rng(3)
    v, n = 40, 20000
    logits = torch.from_numpy(rng.standard_normal(v).astype(np.float32))
    kw = dict(temperature=0.7, top_k=8, top_p=0.9)
    rows = logits.expand(n, v)
    tok = sample_token_rows(_row_keys(4, torch.arange(n),
                                      torch.zeros(n, dtype=torch.long)),
                            rows, **kw)
    filt = filter_logits(logits[None], **kw)[0]
    allowed = filt > -1e29
    assert bool(allowed[tok].all())               # only the filtered set
    p = torch.softmax(filt, -1).numpy()
    freq = np.bincount(tok.numpy(), minlength=v) / n
    # 5 standard errors of a binomial proportion at n draws
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / n) + 1e-9)


def test_engine_contracts():
    tcfg = tconfigs.smoke("qwen3-1.7b")
    tp = init_params(tcfg, 0, device="cpu")
    spec = build_engine(tcfg, tp, ServeConfig(spec_k=2))
    assert isinstance(spec, ContinuousEngine) and spec.spec_k == 2
    with pytest.raises(ValueError, match="continuous"):
        ServeConfig(engine="static", spec_k=4)
    assert isinstance(build_engine(tcfg, tp, ServeConfig(engine="static")),
                      StaticEngine)
    eng = build_engine(tcfg, tp, ServeConfig(**_serve()),
                       rl=RLConfig(**GREEDY))
    with pytest.raises(ValueError, match="profile"):
        eng.submit(Request(rid=0, prompt=np.arange(3, 6)))
    with pytest.raises(ValueError, match="max_total_tokens"):
        eng.submit(Request(rid=1, prompt=np.arange(3, 30),
                           params=SamplingParams(**GREEDY)))


def test_serve_cli_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device",
         "cpu", "--smoke", "--batch", "3", "--slots", "2", "--prompt-len",
         "12", "--max-new", "4", "--page-size", "4", "--prefill-chunk", "8",
         "--rounds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "total 12 tokens" in out.stdout, out.stdout
    assert "device=cpu impl=auto" in out.stdout
