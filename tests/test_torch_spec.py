"""Speculative decoding in the PyTorch port against the JAX package.

The port's n-gram drafter, acceptance rule and spec engine are held to
``repro.sampling.spec`` and the reference's spec engine on the ``TINY``
and ``GQA_LOCAL`` configs of ``tests/test_spec.py`` (float32, the same
weights carried across), under a greedy profile, which neither package's
noise source touches: the same tokens, logps within 1e-5, the same
draft/accept counts. Against the port's own non-speculative engine the
tokens are identical for greedy and for stochastic profiles (exact
replay of the per-request draws). The layer-folding ``paged_*_layers``
and the forward's ``record_queries`` tapes are held to the reference's
(under ``jax.jit``, its twins) and to L separate calls, bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ATTN as JATTN
from repro.config import LOCAL as JLOCAL
from repro.config import MLP as JMLP
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.config import ServeConfig as JServeConfig
from repro.kernels import ops as jops
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.sampling import build_engine as jbuild_engine
from repro.sampling import spec as jspec
from repro.sampling.paged_cache import init_paged_pool as jinit_pool
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch.config import ATTN, LOCAL, MLP, ModelConfig, RLConfig, \
    ServeConfig
from repro_torch.data.tasks import EOS, PAD
from repro_torch.kernels import ops as tops
from repro_torch.models import forward, params_from_numpy
from repro_torch.sampling import build_engine, init_paged_pool
from repro_torch.sampling import spec as tspec
from repro_torch.sampling.prng import as_key
from repro_torch.serving.api import Request, SamplingParams

SHAPES = {
    "tiny": dict(name="tiny", family="dense", num_layers=2, d_model=64,
                 num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=32,
                 dtype="float32", attn_impl="naive", remat=False,
                 rope_theta=1e4),
    "gqa-local": dict(name="gqa-local", family="dense", num_layers=4,
                      d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
                      vocab_size=32, sliding_window=8, dtype="float32",
                      attn_impl="naive", remat=False, rope_theta=1e4),
}
PATTERNS = {"tiny": (ATTN,), "gqa-local": (ATTN, LOCAL)}
JPATTERNS = {"tiny": (JATTN,), "gqa-local": (JATTN, JLOCAL)}
GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0)


def _cfgs(name):
    jcfg = JModelConfig(block_pattern=JPATTERNS[name], ffn_pattern=(JMLP,),
                        **SHAPES[name])
    tcfg = ModelConfig(block_pattern=PATTERNS[name], ffn_pattern=(MLP,),
                       **SHAPES[name])
    return jcfg, tcfg


def _params(jcfg, seed):
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _prompts(rng, n=6, width=7, vocab=30):
    return [rng.integers(4, vocab, size=width).astype(np.int32)
            for _ in range(n)]


def _serve(prompts, max_new, **kw):
    return dict(engine="continuous", num_slots=3, page_size=4, sync_every=4,
                max_total_tokens=max(len(p) for p in prompts) + max_new,
                seed=0, **kw)


def _run(cfg, params, rl, prompts, *, spec_k, prefix_cache=True,
         spec_rescore=True, spec=True):
    """The port's engine, as ``tests/test_spec.py::_run`` builds the
    reference's."""
    eng = build_engine(cfg, params, ServeConfig(**_serve(
        prompts, rl.max_new_tokens, prefix_cache=prefix_cache,
        spec_k=spec_k, spec_rescore=spec_rescore)), rl=rl,
        vocab_limit=cfg.vocab_size)
    sp = dataclasses.replace(SamplingParams.from_rl(rl), spec=spec)
    return eng, eng.generate([Request(rid=i, prompt=p, params=sp)
                              for i, p in enumerate(prompts)])


def _jrun(cfg, params, rl, prompts, *, spec_k):
    eng = jbuild_engine(cfg, params, JServeConfig(**_serve(
        prompts, rl.max_new_tokens, spec_k=spec_k)), rl=rl,
        vocab_limit=cfg.vocab_size, key=jax.random.PRNGKey(0))
    sp = JSamplingParams.from_rl(rl)
    return eng, eng.generate([JRequest(rid=i, prompt=p, params=sp)
                              for i, p in enumerate(prompts)])


# --------------------------------------------------------------------------
# the drafter and the acceptance rule


@pytest.mark.parametrize("max_ngram,min_ngram", [(3, 1), (1, 1), (4, 2)])
def test_ngram_drafter_matches_jax(max_ngram, min_ngram):
    rng = np.random.default_rng(max_ngram * 10 + min_ngram)
    jd = jspec.NGramDrafter(max_ngram=max_ngram, min_ngram=min_ngram)
    td = tspec.NGramDrafter(max_ngram=max_ngram, min_ngram=min_ngram)
    proposed = 0
    for trial in range(200):
        n = int(rng.integers(0, 40))
        vocab = int(rng.integers(2, 9))        # small vocab: many matches
        h = rng.integers(0, vocab, size=n).astype(np.int32)
        if trial % 5 == 0 and n:               # a loop to chain through
            h = np.tile(h[:int(rng.integers(1, 4))], 6)
        k = int(rng.integers(0, 7))
        want, got = jd.propose(h, k), td.propose(h, k)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        proposed += got.size
    assert proposed > 100
    with pytest.raises(ValueError):
        tspec.NGramDrafter(max_ngram=2, min_ngram=3)


def _accept_case(seed, b=5, w=5, v=16):
    """Greedy logits with drafts that match the argmax for a random
    prefix; row 1 emits EOS mid-window, row 2 runs into its budget, row 3
    is inactive, row 4 drafted nothing."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, w, v)).astype(np.float32)
    logits[1, 1, EOS] = 10.0
    am = logits.argmax(-1)
    window = np.full((b, w), PAD, np.int32)
    window[:, 0] = rng.integers(3, v, size=b)
    draft_len = np.full((b,), w - 1, np.int32)
    draft_len[4] = 0
    for r in range(b):
        d = am[r, :w - 1].copy()
        cut = int(rng.integers(0, w))          # first mismatch (or none)
        if cut < w - 1:
            d[cut] = (d[cut] + 1) % v
        window[r, 1:1 + draft_len[r]] = d[:draft_len[r]]
    gen_base = np.array([-1, 3, 6, 0, 2], np.int32)
    max_new = np.array([20, 20, 9, 20, 20], np.int32)
    active = np.array([True, True, True, False, True])
    return logits, window, draft_len, active, gen_base, max_new


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_accept_drafts_matches_jax(seed):
    logits, window, dl, active, gen_base, max_new = _accept_case(seed)
    b = logits.shape[0]
    keys = jnp.repeat(jax.random.PRNGKey(0)[None], b, axis=0)
    want = jspec.accept_drafts(
        jnp.asarray(logits), jnp.asarray(window), jnp.asarray(dl),
        jnp.asarray(active), keys, jnp.asarray(gen_base),
        jnp.asarray(max_new), vocab_limit=logits.shape[-1], **GREEDY)
    t = [torch.from_numpy(x) for x in (logits, window, dl, active,
                                        gen_base, max_new)]
    got = tspec.accept_drafts(t[0], t[1], t[2], t[3],
                              as_key(np.asarray(keys)), t[4], t[5],
                              vocab_limit=logits.shape[-1], **GREEDY)
    for name, g, w_ in zip(("toks", "lps", "n_emit", "n_acc"), got, want):
        if name == "lps":
            np.testing.assert_allclose(g.numpy(), np.asarray(w_), atol=1e-6,
                                       rtol=0)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w_),
                                          err_msg=name)
    n_emit = got[2].numpy()
    assert n_emit[3] == 0                      # inactive
    assert n_emit[2] <= 2                      # budget: draws 7 and 8 only
    assert (got[0].numpy()[1, :n_emit[1]] == EOS).sum() <= 1


# --------------------------------------------------------------------------
# the spec engine against the reference's, and against the port's own


@pytest.mark.parametrize("name", ["tiny", "gqa-local"])
def test_greedy_spec_engine_matches_jax(name):
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg, 0)
    prompts = _prompts(np.random.default_rng(0))
    jeng, jres = _jrun(jcfg, jp, JRLConfig(max_new_tokens=12,
                                           engine="continuous", **GREEDY),
                       prompts, spec_k=4)
    teng, tres = _run(tcfg, tp, RLConfig(max_new_tokens=12,
                                         engine="continuous", **GREEDY),
                      prompts, spec_k=4)
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.logps, a.logps, atol=1e-5, rtol=0)
        assert a.finish_reason == b.finish_reason
    js, ts = jeng.stats(), teng.stats()
    keys = ("drafted_tokens_total", "accepted_tokens_total", "spec_rounds",
            "spec_fallback_chunks", "decode_steps", "draft_hits")
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["accepted_tokens_total"] > 0 and ts["spec_rounds"] > 0
    assert ts["spec_rescore_max_diff"] == 0.0


@pytest.mark.parametrize("name,profile", [
    ("tiny", GREEDY), ("gqa-local", GREEDY),
    ("tiny", dict(temperature=0.8, top_k=8, top_p=0.9)),
    ("gqa-local", dict(temperature=1.0, top_k=0, top_p=1.0))])
def test_spec_engine_emits_the_non_spec_tokens(name, profile):
    """Exact replay: greedy and sampled runs emit the non-speculative
    engine's tokens; logps are the target model's either way."""
    _, tcfg = _cfgs(name)
    _, tp = _params(_cfgs(name)[0], 1)
    rl = RLConfig(max_new_tokens=10, engine="continuous", **profile)
    # a narrow alphabet: the drafter finds n-grams in every history
    prompts = _prompts(np.random.default_rng(1), vocab=10)
    _, r0 = _run(tcfg, tp, rl, prompts, spec_k=0)
    eng, r3 = _run(tcfg, tp, rl, prompts, spec_k=3)
    for a, b in zip(r0, r3):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.logps, a.logps, rtol=2e-5, atol=1e-6)
        assert a.finish_reason == b.finish_reason
    assert eng.stats()["spec_rounds"] > 0


def test_per_request_opt_out():
    """SamplingParams.spec=False rides through the spec engine with no
    drafts (every round takes the fallback chunk) and emits the
    non-speculative tokens."""
    _, tcfg = _cfgs("tiny")
    _, tp = _params(_cfgs("tiny")[0], 2)
    rl = RLConfig(max_new_tokens=8, engine="continuous", **GREEDY)
    prompts = _prompts(np.random.default_rng(2), n=4)
    _, r0 = _run(tcfg, tp, rl, prompts, spec_k=0)
    eng, r4 = _run(tcfg, tp, rl, prompts, spec_k=4, spec=False)
    for a, b in zip(r0, r4):
        np.testing.assert_array_equal(b.tokens, a.tokens)
    st = eng.stats()
    assert st["drafted_tokens_total"] == 0 and st["spec_rounds"] == 0
    assert st["spec_fallback_chunks"] > 0


def test_logps_are_target_model_end_to_end():
    """The teacher-forced recompute of the emitted sequences reproduces
    the spec engine's logps: never the drafter's."""
    from repro_torch.sampling import rollout_from_results, token_logps
    _, tcfg = _cfgs("tiny")
    _, tp = _params(_cfgs("tiny")[0], 2)
    rl = RLConfig(max_new_tokens=10, engine="continuous", **GREEDY)
    width = 7
    prompts = _prompts(np.random.default_rng(2), n=4, width=width)
    eng, res = _run(tcfg, tp, rl, prompts, spec_k=4)
    assert eng.stats()["accepted_tokens_total"] > 0
    roll = rollout_from_results(np.stack(prompts), res, rl.max_new_tokens,
                                device="cpu")
    lp = token_logps(tcfg, tp, roll["tokens"])[:, width - 1:]
    mask = roll["comp_mask"]
    torch.testing.assert_close(roll["sampler_lp"] * mask, lp * mask,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("prefix_cache", [False, True])
def test_pool_balanced_after_spec_run(prefix_cache):
    """Rejected drafts rewind by position only, no allocator traffic: a
    finished spec run returns every page (but the cache's)."""
    _, tcfg = _cfgs("tiny")
    _, tp = _params(_cfgs("tiny")[0], 4)
    rl = RLConfig(max_new_tokens=12, engine="continuous", **GREEDY)
    rng = np.random.default_rng(4)
    shared = rng.integers(4, 30, size=5).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(4, 30, size=3).astype(
        np.int32)]) for _ in range(4)] + _prompts(rng, n=4, width=8)
    eng, res = _run(tcfg, tp, rl, prompts, spec_k=4,
                    prefix_cache=prefix_cache)
    assert len(res) == 8
    assert all(r.finish_reason in ("eos", "length") for r in res)
    held = 0
    if prefix_cache:
        held = len({pg for ent in eng.prefix_cache._entries.values()
                    for pg in ent.pages})
        assert eng.stats()["prefix_hits"] > 0
    assert eng.free_pages + held == eng.num_pages - 1   # all but scratch


@pytest.mark.parametrize("name", ["tiny", "gqa-local"])
def test_rescore_is_one_folded_launch_per_kind(name, monkeypatch):
    """Each verify round replays every layer's attention through one
    ``paged_prefill_layers`` call per mask kind, all of that kind's
    layers folded in, and agrees with the forward bit for bit."""
    _, tcfg = _cfgs(name)
    _, tp = _params(_cfgs(name)[0], 6)
    calls = []
    real = tspec.paged_prefill_layers

    def counted(q, kp, vp, *a, **kw):
        calls.append((int(q.shape[0]), int(kp.shape[0]), kw["kind"]))
        return real(q, kp, vp, *a, **kw)

    monkeypatch.setattr(tspec, "paged_prefill_layers", counted)
    rl = RLConfig(max_new_tokens=10, engine="continuous", **GREEDY)
    eng, _ = _run(tcfg, tp, rl, _prompts(np.random.default_rng(6)),
                  spec_k=4)
    st = eng.stats()
    kinds = len(set(tcfg.block_pattern))
    assert st["spec_rounds"] > 0 and len(calls) == kinds * st["spec_rounds"]
    per_kind = tcfg.num_layers // kinds
    assert all(n == per_kind and p == per_kind for n, p, _ in calls)
    assert {k for _, _, k in calls} == (
        {"causal", "local"} if kinds == 2 else {"causal"})
    assert st["spec_rescore_max_diff"] == 0.0

    calls.clear()
    eng, _ = _run(tcfg, tp, rl, _prompts(np.random.default_rng(7), n=3),
                  spec_k=4, spec_rescore=False)
    assert eng.stats()["spec_rounds"] > 0 and not calls


def test_stacked_pools_are_views_for_one_kind():
    _, tcfg = _cfgs("tiny")
    pool = init_paged_pool(tcfg, 9, 4, device="cpu")
    kp, vp = tspec.stacked_pools(tcfg, pool)
    assert kp.data_ptr() == pool["layer_0"]["self"]["kp"].data_ptr()
    assert kp.shape == (tcfg.num_layers, 9, 4, 2, 16)
    jcfg, tcfg = _cfgs("gqa-local")
    rng = np.random.default_rng(0)
    jpool = jinit_pool(jcfg, 9, 4)
    jpool = jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), jpool)
    tpool = params_from_numpy(jax.tree_util.tree_map(np.asarray, jpool),
                              device="cpu")
    for g, w in zip(tspec.stacked_pools(tcfg, tpool),
                    jspec.stacked_pools(jcfg, jpool)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_width_buckets_and_serve_config():
    for k in range(12):
        assert tspec.verify_width_buckets(k) == jspec.verify_width_buckets(k)
    assert tspec.verify_width_buckets(4) == 3          # widths {2, 4, 5}
    with pytest.raises(ValueError, match="continuous"):
        ServeConfig(engine="static", spec_k=4)
    with pytest.raises(ValueError):
        ServeConfig(engine="continuous", spec_k=-1)
    with pytest.raises(ValueError):
        ServeConfig(engine="continuous", spec_k=2, spec_ngram_min=0)
    with pytest.raises(ValueError):
        ServeConfig(spec_k=2, spec_ngram_min=4, spec_ngram_max=3)
    sc = ServeConfig(spec_k=4, spec_ngram_max=2, spec_rescore=False)
    jsc = JServeConfig(spec_k=4, spec_ngram_max=2, spec_rescore=False)
    assert (sc.spec_k, sc.spec_ngram_max, sc.spec_ngram_min,
            sc.spec_rescore) == (jsc.spec_k, jsc.spec_ngram_max,
                                 jsc.spec_ngram_min, jsc.spec_rescore)


# --------------------------------------------------------------------------
# the layer-folded kernels and the forward's tapes


def _layer_pools(rng, lyr, pages, page, hkv, d):
    kp = rng.standard_normal((lyr, pages, page, hkv, d)).astype(np.float32)
    vp = rng.standard_normal((lyr, pages, page, hkv, d)).astype(np.float32)
    kp[:, 0] = np.nan                           # the scratch page
    vp[:, 0] = np.nan
    return kp, vp


@pytest.mark.parametrize("kind,window,cap", [("causal", None, None),
                                             ("local", 5, 30.0)])
def test_k3_layer_fold(kind, window, cap):
    rng = np.random.default_rng(11)
    lyr, b, npg, page, hkv, d = 3, 4, 3, 4, 2, 16
    kp, vp = _layer_pools(rng, lyr, 1 + b * npg, page, hkv, d)
    q = rng.standard_normal((lyr, b, 1, 2 * hkv, d)).astype(np.float32)
    table = (1 + np.arange(b * npg, dtype=np.int32)).reshape(b, npg)
    lengths = np.array([1, 5, 9, 12], np.int32)
    kw = dict(kind=kind, window=window, softcap=cap)
    t = [torch.from_numpy(x) for x in (q, kp, vp, table, lengths)]
    got = tops.paged_decode_layers(*t, **kw)
    for li in range(lyr):
        one = tops.paged_decode(t[0][li], t[1][li], t[2][li], t[3], t[4],
                                **kw)
        assert torch.equal(got[li], one)
    want = jops.paged_decode_layers(*map(jnp.asarray, (q, kp, vp, table,
                                                       lengths)),
                                    impl="ref", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("kind,window,cap", [("causal", None, None),
                                             ("local", 6, 25.0)])
def test_k4_layer_fold(kind, window, cap):
    rng = np.random.default_rng(12)
    lyr, b, c, npg, page, hkv, d = 4, 3, 5, 4, 4, 2, 16
    kp, vp = _layer_pools(rng, lyr, 1 + b * npg, page, hkv, d)
    q = rng.standard_normal((lyr, b, c, 2 * hkv, d)).astype(np.float32)
    table = (1 + np.arange(b * npg, dtype=np.int32)).reshape(b, npg)
    positions = np.array([0, 4, 11], np.int32)[:, None] + np.arange(c)
    kw = dict(kind=kind, window=window, softcap=cap)
    t = [torch.from_numpy(x) for x in (q, kp, vp, table, positions)]
    got = tops.paged_prefill_layers(*t, **kw)
    for li in range(lyr):
        one = tops.paged_prefill(t[0][li], t[1][li], t[2][li], t[3], t[4],
                                 **kw)
        assert torch.equal(got[li], one)
    want = jops.paged_prefill_layers(*map(jnp.asarray, (q, kp, vp, table,
                                                        positions)),
                                     impl="ref", **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_fold_is_a_view_of_the_pools():
    q = torch.zeros((3, 2, 1, 4, 16))
    kp = torch.zeros((3, 7, 4, 2, 16))
    qf, kpf, _, tablef = tops._fold_layers(q, kp, kp.clone(),
                                           torch.ones((2, 3), dtype=torch.long))
    assert kpf.data_ptr() == kp.data_ptr() and kpf.shape == (21, 4, 2, 16)
    assert tablef.tolist() == [[1] * 3, [1] * 3, [8] * 3, [8] * 3,
                               [15] * 3, [15] * 3]


@pytest.mark.parametrize("name", ["tiny", "gqa-local"])
def test_record_queries_tapes_match_jax(name):
    """``forward(record_queries=True)`` over page pools returns the
    reference's q/o tapes (L, B, S, Hq, D), block-major; the dense path
    refuses."""
    jcfg, tcfg = _cfgs(name)
    jp, tp = _params(jcfg, 9)
    rng = np.random.default_rng(9)
    b, s, page, npg = 2, 5, 4, 3
    tokens = rng.integers(3, 30, size=(b, s)).astype(np.int32)
    positions = np.array([[2], [6]], np.int32) + np.arange(s)
    table = (1 + np.arange(b * npg, dtype=np.int32)).reshape(b, npg)
    jpool = jinit_pool(jcfg, 1 + b * npg, page)
    fwd = jax.jit(lambda p, pool, tk, pos, tb: jforward(
        jcfg, p, tk, positions=pos, cache=pool, page_table=tb,
        record_queries=True))
    jl, _, jaux = fwd(jp, jpool, jnp.asarray(tokens), jnp.asarray(positions),
                      jnp.asarray(table))
    tpool = init_paged_pool(tcfg, 1 + b * npg, page, device="cpu")
    tl, _, taux = forward(tcfg, tp, torch.from_numpy(tokens).long(),
                          positions=torch.from_numpy(positions).long(),
                          cache=tpool, page_table=torch.from_numpy(table),
                          record_queries=True)
    assert taux["q_tape"].shape == (tcfg.num_layers, b, s, 4, 16)
    for k in ("q_tape", "o_tape"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   atol=1e-5, rtol=0, err_msg=k)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-4, rtol=0)
    diff = tspec.fused_rescore_diff(tcfg, tpool, taux["q_tape"],
                                    taux["o_tape"], torch.from_numpy(table),
                                    torch.from_numpy(positions).long())
    assert float(diff) == 0.0
    with pytest.raises(ValueError, match="record_queries"):
        forward(tcfg, tp, torch.from_numpy(tokens).long(),
                record_queries=True)


def test_serve_cli_runs_spec_on_cpu():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--smoke", "--spec-k", "4", "--batch", "3", "--slots", "2",
         "--prompt-len", "12", "--max-new", "12", "--page-size", "4",
         "--rounds", "1", "--top-k", "1"],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "spec_k=4 accept_rate" in out.stdout, out.stdout
    assert "total 36 tokens" in out.stdout, out.stdout


def test_greedy_spec_engine_matches_jax_through_moe(monkeypatch):
    """MoE through spec rounds: llama4-scout's smoke (4 experts, top-1,
    a shared expert) on the repeating-pattern workload of ``chip_smoke.py``
    phase 9 (a), greedy over a 12-token alphabet and cut to six prompts of
    9-22 tokens, so drafts are accepted. Three slots for six requests
    leave slots idle in the later rounds, and spec_k 4 makes a verify
    window of 5 tokens, wider than the 4-token page. Every verify window
    reaches the MoE with the reference's token count (all slots, padded
    windows), so capacity drops match. The JAX package's MoE runs through
    ``tests/_jax_moe_ref.py`` (its kept-only scatter)."""
    from _jax_moe_ref import patch_jax_moe
    from repro import configs as jconfigs
    from repro_torch import configs as tconfigs
    patch_jax_moe(monkeypatch)
    name, vocab = "llama4-scout-17b-a16e", 12
    jcfg = jconfigs.smoke(name, paged_attn_impl="ref")
    tcfg = tconfigs.smoke(name, paged_attn_impl="ref")
    jp, tp = _params(jcfg, 2)
    rng = np.random.default_rng(9)
    prompts = []
    for _ in range(6):
        pat = rng.integers(3, vocab, int(rng.integers(3, 6)))
        n = int(rng.integers(9, 23))
        prompts.append(np.tile(pat, -(-n // len(pat)))[:n].astype(np.int32))
    serve = _serve(prompts, 12, spec_k=4)
    jrl = JRLConfig(max_new_tokens=12, engine="continuous", **GREEDY)
    jeng = jbuild_engine(jcfg, jp, JServeConfig(**serve), rl=jrl,
                         vocab_limit=vocab, key=jax.random.PRNGKey(0))
    jres = jeng.generate([JRequest(rid=i, prompt=p,
                                   params=JSamplingParams.from_rl(jrl))
                          for i, p in enumerate(prompts)])
    rl = RLConfig(max_new_tokens=12, engine="continuous", **GREEDY)
    teng = build_engine(tcfg, tp, ServeConfig(**serve), rl=rl,
                        vocab_limit=vocab)
    tres = teng.generate([Request(rid=i, prompt=p,
                                  params=SamplingParams.from_rl(rl))
                          for i, p in enumerate(prompts)])
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.logps, a.logps, atol=1e-4, rtol=0)
        assert a.finish_reason == b.finish_reason
    js, ts = jeng.stats(), teng.stats()
    keys = ("drafted_tokens_total", "accepted_tokens_total", "spec_rounds",
            "spec_fallback_chunks", "decode_steps", "draft_hits")
    assert {k: ts[k] for k in keys} == {k: js[k] for k in keys}
    assert ts["accepted_tokens_total"] > 0 and ts["spec_rounds"] > 0
