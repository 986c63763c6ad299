"""Sampled tokens of the PyTorch port against the JAX package, token for
token: the threefry draws (``repro_torch.sampling.prng``) keyed as the
reference keys them, through every engine and the sampler node; the
``"gather"`` paged path and the ring-buffered local KV cache against the
reference's.

Configs: ``tests/test_serving.py``'s ``TINY`` (float32) and the smoke
variant of ``gemma2-9b`` (float32, local window 64, softcaps), prompts past
its window. The JAX params are carried across with ``params_from_numpy``;
the reference engines are built without a plan (``paged_attn_impl="ref"``
or ``"gather"``). Tokens are held exactly; logps within 1e-5 (float32, the
two frameworks' sums in another order); the ring cache's rows within
1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import ATTN as JATTN
from repro.config import MLP as JMLP
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.config import ServeConfig as JServeConfig
from repro.data import pipeline as jpipeline
from repro.data import tasks as jtasks
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.sampling import build_engine as jbuild_engine
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import PolicyStore
from repro_torch.config import ATTN, MLP, HeteroConfig, ModelConfig, \
    RLConfig, ServeConfig
from repro_torch.data import ArithmeticTask, PromptPipeline, Tokenizer
from repro_torch.hetero import SamplerNode
from repro_torch.models import (decode_step, forward, init_cache,
                                params_from_numpy)
from repro_torch.sampling import build_engine
from repro_torch.sampling.prng import as_key
from repro_torch.serving.api import Request, SamplingParams

SHAPE = dict(name="tiny-serve", family="dense", num_layers=2, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=32,
             dtype="float32", attn_impl="naive", remat=False,
             rope_theta=1e4)
PROFILES = [dict(temperature=1.0, top_k=0, top_p=1.0),
            dict(temperature=0.8, top_k=8, top_p=0.9)]
TOL_LP = 1e-5


@pytest.fixture(scope="module")
def tiny():
    jcfg = JModelConfig(block_pattern=(JATTN,), ffn_pattern=(JMLP,),
                        **SHAPE)
    tcfg = ModelConfig(block_pattern=(ATTN,), ffn_pattern=(MLP,), **SHAPE)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def gemma():
    jcfg = jconfigs.smoke("gemma2-9b")
    tcfg = tconfigs.smoke("gemma2-9b")
    jp = jinit_params(jcfg, jax.random.PRNGKey(1))
    return jcfg, jp, tcfg, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_ring_fns(jcfg, b, max_len):
    """The reference's jitted dense-cache prefill and decode step for one
    config, built once."""
    @jax.jit
    def prefill(p, t):
        cache = jinit_cache(jcfg, p, b, max_len)
        return jforward(jcfg, p, t, cache=cache)[:2]

    step = jax.jit(lambda p, c, t, pos: jdecode_step(jcfg, p, c, t, pos))
    return prefill, step


def _prompts(vocab, lens, seed=0, shared=0):
    rng = np.random.default_rng(seed)
    head = rng.integers(4, vocab, shared)
    return [np.concatenate([head, rng.integers(4, vocab, n)]).astype(
        np.int32) for n in lens]


def _both(jcfg, jp, tcfg, tp, serve, rl_kw, prompts, max_new, *, key=3,
          rid0=7, vocab_limit=20):
    """The same requests through the reference's engine and the port's,
    built from one ServeConfig and keyed by ``PRNGKey(key)``."""
    jkey = jax.random.PRNGKey(key)
    jeng = jbuild_engine(jcfg, jp, JServeConfig(**serve), rl=JRLConfig(
        max_new_tokens=max_new, engine=serve["engine"], **rl_kw),
        vocab_limit=vocab_limit, key=jkey)
    teng = build_engine(tcfg, tp, ServeConfig(**serve), rl=RLConfig(
        max_new_tokens=max_new, engine=serve["engine"], **rl_kw),
        vocab_limit=vocab_limit, key=as_key(np.asarray(jkey)))
    jres = jeng.generate([JRequest(rid=rid0 + 3 * i, prompt=p,
                                   params=JSamplingParams(
                                       max_new_tokens=max_new, **rl_kw))
                          for i, p in enumerate(prompts)])
    tres = teng.generate([Request(rid=rid0 + 3 * i, prompt=p,
                                  params=SamplingParams(
                                      max_new_tokens=max_new, **rl_kw))
                          for i, p in enumerate(prompts)])
    return jeng, jres, teng, tres


def _same(jres, tres):
    for a, b in zip(jres, tres):
        assert a.rid == b.rid
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.logps, a.logps, rtol=0, atol=TOL_LP)
        assert a.finish_reason == b.finish_reason
    assert sum(len(r.tokens) for r in tres) > 0


@pytest.mark.parametrize("profile", PROFILES)
def test_static_engine_sampled_tokens_match_jax(tiny, profile):
    jcfg, jp, tcfg, tp = tiny
    prompts = _prompts(30, [9] * 4, seed=1)
    _, jres, _, tres = _both(jcfg, jp, tcfg, tp, dict(engine="static"),
                             profile, prompts, 10)
    _same(jres, tres)


@pytest.mark.parametrize("profile", PROFILES)
def test_continuous_engine_sampled_tokens_match_jax(tiny, profile):
    """Ragged prompts, shared prefixes, more requests than slots, chunked
    prefill: the draws follow the request, never the slot."""
    jcfg, jp, tcfg, tp = tiny
    prompts = _prompts(30, [3, 7, 2, 9, 5, 4], seed=2, shared=6)
    serve = dict(engine="continuous", num_slots=2, page_size=4,
                 sync_every=4, prefill_chunk=4, max_total_tokens=28,
                 paged_attn_impl="ref")
    jeng, jres, teng, tres = _both(jcfg, jp, tcfg, tp, serve, profile,
                                   prompts, 12)
    _same(jres, tres)
    for a, b in zip(jres, tres):
        assert a.prefix_hit_tokens == b.prefix_hit_tokens
    assert sum(r.prefix_hit_tokens for r in tres) > 0


@pytest.mark.parametrize("profile", PROFILES)
def test_spec_engine_sampled_tokens_match_jax(tiny, profile):
    """Speculative decoding replays the draws with the same keys: tokens
    and draft / accept counts equal the reference's."""
    jcfg, jp, tcfg, tp = tiny
    rng = np.random.default_rng(3)
    prompts = [np.tile(rng.integers(4, 10, 3), 4)[:n].astype(np.int32)
               for n in (7, 11, 9, 12)]
    serve = dict(engine="continuous", num_slots=3, page_size=4,
                 sync_every=4, max_total_tokens=28, spec_k=3,
                 paged_attn_impl="ref")
    jeng, jres, teng, tres = _both(jcfg, jp, tcfg, tp, serve, profile,
                                   prompts, 12, vocab_limit=12)
    _same(jres, tres)
    js, ts = jeng.stats(), teng.stats()
    for k in ("drafted_tokens_total", "accepted_tokens_total",
              "spec_rounds", "spec_fallback_chunks"):
        assert ts[k] == js[k], k
    assert ts["spec_rounds"] > 0


def test_sampler_node_batches_match_jax(tiny):
    """Two batches of a sampled ``SamplerNode`` (temperature 1): the node
    splits ``PRNGKey(seed)`` once per batch as the reference does, so each
    batch's tokens are the reference engine's under that batch's key."""
    jcfg, jp, tcfg, tp = tiny
    rl_kw = dict(loss_type="gepo", group_size=4, max_new_tokens=5,
                 engine="continuous", temperature=1.0, top_k=0, top_p=1.0)
    tok = Tokenizer()
    task = ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=3)
    node = SamplerNode(0, tcfg, RLConfig(**rl_kw),
                       PromptPipeline(task, tok, 3, 4), task, tok, tp,
                       PolicyStore(), HeteroConfig(), seed=5, device="cpu")
    got = [node.generate_batch(1.0), node.generate_batch(2.0)]
    jtok = jtasks.Tokenizer()
    jpipe = jpipeline.PromptPipeline(jtasks.ArithmeticTask(
        max_operand=9, ops="+", prompt_width=5, seed=3), jtok, 3, 4)
    jrl = JRLConfig(**rl_kw)
    jkey = jax.random.PRNGKey(5)
    for batch in got:
        req = jpipe.next_batch()
        b, tp_ = req.prompts.shape
        jeng = jbuild_engine(jcfg, jp, JServeConfig(
            engine="continuous", max_total_tokens=tp_ + 5, num_slots=8,
            paged_attn_impl="ref"), rl=jrl, vocab_limit=jtok.vocab_size)
        jkey, k = jax.random.split(jkey)
        sp = JSamplingParams.from_rl(jrl)
        res = jeng.generate([JRequest(rid=r, prompt=req.prompts[r],
                                      params=sp) for r in range(b)], key=k)
        for r, jr in enumerate(res):
            n = jr.gen_count
            np.testing.assert_array_equal(batch.tokens[r, tp_:tp_ + n],
                                          jr.tokens)
    assert not np.array_equal(got[0].tokens, got[1].tokens)


@pytest.mark.parametrize("profile", PROFILES)
def test_gather_engine_matches_jax_gather(gemma, profile):
    """The continuous engine with ``paged_attn_impl="gather"`` on both
    sides (the reference's default), gemma2's smoke model with prompts
    past its window of 64: the same sampled tokens."""
    jcfg, jp, tcfg, tp = gemma
    tcfg = dataclasses.replace(tcfg, paged_attn_impl="gather")
    jcfg = dataclasses.replace(jcfg, paged_attn_impl="gather")
    prompts = _prompts(tcfg.vocab_size, [70, 90, 66], seed=4)
    serve = dict(engine="continuous", num_slots=2, page_size=8,
                 sync_every=4, prefill_chunk=32, max_total_tokens=104)
    _, jres, teng, tres = _both(jcfg, jp, tcfg, tp, serve, profile,
                                prompts, 8, vocab_limit=tcfg.vocab_size)
    assert teng.cfg.paged_attn_impl == "gather"
    _same(jres, tres)


def test_ring_cache_and_decode_match_jax(gemma):
    """``local_ring_kv``: the prefill's ring (``fill_ring``, the prompt of
    80 wraps the window of 64) and each decode step's logits and ring rows
    equal the reference's."""
    jcfg, jp, tcfg, tp = gemma
    jcfg = dataclasses.replace(jcfg, local_ring_kv=True)
    tcfg = dataclasses.replace(tcfg, local_ring_kv=True)
    b, s, steps = 2, 80, 4
    toks = np.random.default_rng(5).integers(3, tcfg.vocab_size,
                                             (b, s)).astype(np.int32)
    jprefill, jstep = _jax_ring_fns(jcfg, b, s + steps)
    jl, jc = jprefill(jp, jnp.asarray(toks))
    cache = init_cache(tcfg, tp, b, s + steps)
    tl, _, _ = forward(tcfg, tp, torch.from_numpy(toks), cache=cache)
    # the test compares on the host: each np.asarray is a deliberate sync
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),  # noqa: RA003
                               rtol=0, atol=1e-4)

    def rows_match():
        for i, kind in enumerate(tcfg.block_pattern):
            for n in ("k", "v"):
                got = cache[f"layer_{i}"]["self"][n].numpy()
                want = np.asarray(  # noqa: RA003
                    jc[f"layer_{i}"]["self"][n])
                assert got.shape == want.shape
                if kind == "local":
                    assert got.shape[2] == tcfg.sliding_window
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)

    rows_match()
    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)  # noqa: RA003
    for t in range(steps):
        jlg, jc = jstep(jp, jc, jnp.asarray(tok), jnp.int32(s + t))
        tlg, _ = decode_step(tcfg, tp, cache, torch.from_numpy(tok), s + t)
        want = np.asarray(jlg)  # noqa: RA003
        np.testing.assert_allclose(tlg.numpy(), want, rtol=0, atol=1e-4)
        tok = want.argmax(-1).astype(np.int32)
    rows_match()


@pytest.mark.parametrize("profile", PROFILES)
def test_ring_static_engine_matches_jax(gemma, profile):
    """The static engine over a ring cache (prompts past the window),
    sampled: the reference's tokens."""
    jcfg, jp, tcfg, tp = gemma
    jcfg = dataclasses.replace(jcfg, local_ring_kv=True)
    tcfg = dataclasses.replace(tcfg, local_ring_kv=True)
    prompts = _prompts(tcfg.vocab_size, [75] * 2, seed=6)
    _, jres, _, tres = _both(jcfg, jp, tcfg, tp, dict(engine="static"),
                             profile, prompts, 6,
                             vocab_limit=tcfg.vocab_size)
    _same(jres, tres)


def test_continuous_engine_refuses_a_ring_config(gemma):
    _, _, tcfg, tp = gemma
    ring = dataclasses.replace(tcfg, local_ring_kv=True)
    with pytest.warns(UserWarning, match="serving static"):
        eng = build_engine(ring, tp, ServeConfig(engine="continuous"))
    assert type(eng).__name__ == "StaticEngine"
