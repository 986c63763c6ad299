"""The port's dense KV cache, static engine and recompute under
``attn_impl="pallas"`` against the JAX package.

Smoke configs of qwen3-1.7b and gemma2-9b (local window 64, softcaps,
tied head) with ``attn_impl="pallas"``: the JAX package runs its Pallas
flash kernel in interpret mode, the port the kernel's twin on the CPU.
Prompts are longer than the window. The JAX params are carried across
with ``params_from_numpy``.

The JAX forward with ``attn_impl="pallas"`` runs under ``jax.jit``: called
eagerly it raises (``_standard_positions`` misses the scan's tracer under
jax 0.9.0; ROADMAP queue 3). Tolerances: logits and engine logps 1e-4,
recomputed logps 1e-5 (float32 throughout; the twin and the Pallas kernel
sum in another order). Against the JAX engine the profile here is greedy
(top_k 1; ``tests/test_torch_stochastic.py`` holds sampled tokens to the
reference's); against the port's own continuous engine, temperature 1.0.
"""
import dataclasses
import functools
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
from repro.models import decode_step as jdecode_step
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.sampling.engine import StaticEngine as JStaticEngine
from repro.sampling.engine import token_logps as jtoken_logps
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.config import RLConfig, ServeConfig
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import (decode_step, forward, init_cache,
                                params_from_numpy)
from repro_torch.sampling import (StaticEngine, build_engine, generate,
                                  token_logps)
from repro_torch.sampling.prng import PRNGKey
from repro_torch.serving.api import Request, SamplingParams

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-1.7b", "gemma2-9b"]
GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0)
PROMPT = 80                      # past the smoke window of 64


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(jax cfg, jax params, port cfg, port params) of one smoke arch."""
    name = request.param
    jcfg = jconfigs.smoke(name, attn_impl="pallas")
    tcfg = tconfigs.smoke(name, attn_impl="pallas")
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jp, tcfg, tp


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg, b, max_len):
    """The reference's jitted dense-cache prefill, decode step and
    ``token_logps`` for one config, built once."""
    @jax.jit
    def prefill(p, toks):
        cache = jinit_cache(jcfg, p, b, max_len)
        logits, cache, _ = jforward(jcfg, p, toks, cache=cache)
        return logits, cache

    step = jax.jit(lambda p, c, tok, pos: jdecode_step(jcfg, p, c, tok, pos))
    logps = jax.jit(lambda p, t: jtoken_logps(jcfg, p, t))
    return prefill, step, logps


def _prompts(vocab, b, n=PROMPT, seed=0):
    return np.random.default_rng(seed).integers(3, vocab, (b, n)
                                                ).astype(np.int32)


def test_gemma2_is_registered_with_a_tied_head(model):
    jcfg, jp, tcfg, tp = model
    assert ("lm_head" in tp) == (not tcfg.tie_embeddings)
    full = tconfigs.get_config(tcfg.name[:-len("-smoke")])
    ref = jconfigs.get_config(full.name)
    for f in dataclasses.fields(full):
        # the port's own default and its own knob
        if f.name not in ("paged_attn_impl", "ssd_impl"):
            assert getattr(full, f.name) == getattr(ref, f.name), f.name


def test_dense_cache_forward_and_decode_match_jax(model):
    jcfg, jp, tcfg, tp = model
    b, steps = 2, 3
    prompts = _prompts(tcfg.vocab_size, b)
    jprefill, jstep, _ = _jax_fns(jcfg, b, PROMPT + steps)
    jlogits, jcache = jprefill(jp, jnp.asarray(prompts))
    cache = init_cache(tcfg, tp, b, PROMPT + steps)
    assert cache["layer_0"]["self"]["k"].shape == \
        jcache["layer_0"]["self"]["k"].shape
    fa.reset_launch_counts()
    logits, out, _ = forward(tcfg, tp, torch.from_numpy(prompts), cache=cache)
    assert out is cache
    # the test compares on the host: each np.asarray is a deliberate sync
    want = np.asarray(jlogits)  # noqa: RA003
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-4, atol=1e-4)
    for i in range(tcfg.period):
        for n in ("k", "v"):
            np.testing.assert_allclose(
                cache[f"layer_{i}"]["self"][n].numpy(),
                np.asarray(jcache[f"layer_{i}"]["self"][n]),  # noqa: RA003
                rtol=1e-4, atol=1e-4)
    tok = np.argmax(want[:, -1], -1).astype(np.int32)
    for t in range(steps):
        pos = PROMPT + t
        jl, jcache = jstep(jp, jcache, jnp.asarray(tok), jnp.int32(pos))
        tl, _ = decode_step(tcfg, tp, cache, torch.from_numpy(tok), pos)
        want = np.asarray(jl)  # noqa: RA003
        np.testing.assert_allclose(tl.numpy(), want, rtol=1e-4, atol=1e-4)
        tok = np.argmax(want, -1).astype(np.int32)
    assert fa.LAUNCHES["flash_attention"] == 0        # the twin, on the CPU


@pytest.mark.parametrize("vocab_limit", [None, 3])
def test_static_engine_matches_jax_greedy(model, vocab_limit):
    """Tokens equal, logps within 1e-4, per-request budgets trimmed. A
    vocab limit of 3 leaves PAD, BOS and EOS, so rows finish at EOS and
    decode PAD afterwards."""
    jcfg, jp, tcfg, tp = model
    prompts = _prompts(tcfg.vocab_size, 3, seed=1)
    budgets = (8, 5, 8)
    jeng = JStaticEngine(jcfg, jp, rl=JRLConfig(**GREEDY),
                         vocab_limit=vocab_limit)
    jres = jeng.generate([JRequest(rid=i, prompt=p, params=JSamplingParams(
        max_new_tokens=n, **GREEDY)) for i, (p, n) in
        enumerate(zip(prompts, budgets))])
    teng = StaticEngine(tcfg, tp, rl=RLConfig(**GREEDY),
                        vocab_limit=vocab_limit)
    tres = teng.generate([Request(rid=i, prompt=p, params=SamplingParams(
        max_new_tokens=n, **GREEDY)) for i, (p, n) in
        enumerate(zip(prompts, budgets))])
    for a, b, n in zip(jres, tres, budgets):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.logps, a.logps, rtol=0, atol=1e-4)
        assert (b.rid, b.finish_reason, b.prompt_len) == \
            (a.rid, a.finish_reason, a.prompt_len)
        assert b.gen_count <= n
    if vocab_limit == 3:
        assert any(r.finish_reason == "eos" for r in tres)


def test_token_logps_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    toks = _prompts(tcfg.vocab_size, 2, n=PROMPT + 9, seed=2)
    want = _jax_fns(jcfg, 2, PROMPT + 9)[2](jp, jnp.asarray(toks))
    got = token_logps(tcfg, tp, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_static_matches_continuous_at_temperature_one(model):
    """Both port engines key draw t of request rid the same way: the same
    requests and seed give the same tokens through either."""
    _, _, tcfg, tp = model
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0)
    sp = SamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                        max_new_tokens=10)
    prompts = _prompts(tcfg.vocab_size, 4, seed=3)
    reqs = [Request(rid=7 + 3 * i, prompt=p, params=sp)
            for i, p in enumerate(prompts)]
    out = {}
    for kind in ("static", "continuous"):
        eng = build_engine(tcfg, tp, ServeConfig(
            engine=kind, num_slots=2, page_size=8, prefill_chunk=32,
            sync_every=4, max_total_tokens=PROMPT + 10, seed=5), rl=rl,
            vocab_limit=tcfg.vocab_size)
        assert isinstance(eng, StaticEngine) == (kind == "static")
        out[kind] = eng.generate(reqs)
    for a, b in zip(out["static"], out["continuous"]):
        assert a.rid == b.rid
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_allclose(a.logps, b.logps, rtol=0, atol=1e-4)


def test_legacy_generate_shim():
    tcfg = tconfigs.smoke("qwen3-1.7b", attn_impl="pallas")
    from repro_torch.models import init_params
    tp = init_params(tcfg, 0, device="cpu")
    rl = RLConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=6)
    prompts = _prompts(tcfg.vocab_size, 3, n=20, seed=4)
    roll = generate(tcfg, rl, tp, prompts, key=PRNGKey(9))
    assert roll["tokens"].shape == (3, 26) and roll["prompt_len"] == 20
    assert torch.equal(roll["tokens"][:, :20], torch.from_numpy(prompts))
    res = StaticEngine(tcfg, tp, rl=rl, key=PRNGKey(9)).generate(
        [Request(rid=i, prompt=p, params=SamplingParams.from_rl(rl))
         for i, p in enumerate(prompts)])
    for i, r in enumerate(res):
        n = r.gen_count
        np.testing.assert_array_equal(roll["completions"][i, :n].numpy(),
                                      r.tokens)
        np.testing.assert_allclose(roll["sampler_lp"][i, :n].numpy(),
                                   r.logps, rtol=0, atol=1e-6)
        assert float(roll["comp_mask"][i].sum()) == n
    cont = generate(tcfg, rl, tp, prompts, key=PRNGKey(9),
                    engine="continuous",
                    num_slots=2)
    assert torch.equal(cont["tokens"], roll["tokens"])
    with pytest.raises(TypeError, match="continuous-engine kwargs"):
        generate(tcfg, rl, tp, prompts, engine="static", num_slots=2)
    with pytest.raises(ValueError, match="unknown engine"):
        generate(tcfg, rl, tp, prompts, engine="beam")


def test_static_engine_rejects_ragged_and_mismatched():
    tcfg = tconfigs.smoke("qwen3-1.7b", attn_impl="pallas")
    from repro_torch.models import init_params
    tp = init_params(tcfg, 0, device="cpu")
    eng = StaticEngine(tcfg, tp, rl=RLConfig(**GREEDY))
    sp = SamplingParams(max_new_tokens=4, **GREEDY)
    with pytest.raises(ValueError, match="rectangular batch"):
        eng.generate([Request(rid=0, prompt=np.arange(3, 9), params=sp),
                      Request(rid=1, prompt=np.arange(3, 12), params=sp)])
    with pytest.raises(ValueError, match="sampling profile"):
        eng.generate([Request(rid=0, prompt=np.arange(3, 9), params=sp),
                      Request(rid=1, prompt=np.arange(3, 9),
                              params=SamplingParams(max_new_tokens=4))])
    # a ring config's local layers cache min(max_len, window) rows
    ring = dataclasses.replace(tconfigs.smoke("gemma2-9b"),
                               local_ring_kv=True)
    rp = init_params(ring, 0, device="cpu")
    for max_len, rows in ((8, 8), (200, ring.sliding_window)):
        rc = init_cache(ring, rp, 1, max_len)
        for i, kind in enumerate(ring.block_pattern):
            want = rows if kind == "local" else max_len
            assert rc[f"layer_{i}"]["self"]["k"].shape[2] == want
    with pytest.raises(ValueError, match="one position"):
        decode_step(tcfg, tp, init_cache(tcfg, tp, 2, 8),
                    torch.tensor([1, 2]), torch.tensor([3, 4]))


def test_serve_cli_static_pallas_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--arch", "gemma2-9b", "--engine", "static",
         "--attn-impl", "pallas", "--batch", "3", "--prompt-len", "70",
         "--max-new", "4", "--rounds", "1"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "engine=static attn=pallas" in out.stdout, out.stdout
    assert "total 12 tokens" in out.stdout, out.stdout
