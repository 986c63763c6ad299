"""The reference's last public names on the port, each against the JAX
package where it returns a value: ``ModelConfig.has_attention``,
``ContinuousEngine.evictable_pages``, ``SamplingParams.rl``, the one-row
draw ``sample_token``, ``launch/serve.py::parse_serve_config``, and the
serve launcher's ``--obs`` / ``--trace-out``, which write the engine's
spans as Perfetto JSON through ``repro_torch.obs.export_chrome_trace``.

Inputs are made with numpy and handed to both packages. The draw's
log-probs are float32 log-softmaxes of the same logits (1e-6 abs); every
other value is compared exactly.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.config import RLConfig as JRLConfig
from repro.config import ServeConfig as JServeConfig
from repro.launch import serve as jserve
from repro.models import init_params as jinit_params
from repro.sampling import build_engine as jbuild_engine
from repro.sampling import sample_token as jsample_token
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch import obs
from repro_torch.config import RLConfig, ServeConfig
from repro_torch.launch import serve as tserve
from repro_torch.models import params_from_numpy
from repro_torch.sampling import build_engine, sample_token
from repro_torch.sampling.prng import PRNGKey
from repro_torch.serving.api import Request, SamplingParams


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)
    yield


@pytest.mark.parametrize("name", sorted(jconfigs.ALL))
def test_has_attention_matches_the_reference(name):
    for get in ("get_config", "smoke"):
        want = getattr(jconfigs, get)(name).has_attention
        assert getattr(tconfigs, get)(name).has_attention == want
    assert tconfigs.get_config("mamba2-1.3b").has_attention is False


GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0)


def _prompts(vocab):
    """Shared prefixes (one ending mid-page) among more requests than
    slots, so the prefix cache holds pages after the drain."""
    rng = np.random.default_rng(0)
    shared = rng.integers(3, vocab, 9).astype(np.int32)
    out = [np.concatenate([shared, rng.integers(3, vocab, 4)])]
    out += [rng.integers(3, vocab, n) for n in (5, 14)]
    out += [np.concatenate([shared, rng.integers(3, vocab, n)])
            for n in (2, 6)]
    return [p.astype(np.int32) for p in out]


@pytest.mark.parametrize("prefix_cache", [True, False])
def test_evictable_pages_matches_the_reference(prefix_cache):
    jcfg, tcfg = jconfigs.smoke("qwen3-1.7b"), tconfigs.smoke("qwen3-1.7b")
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    kw = dict(num_slots=3, page_size=4, prefill_chunk=8, sync_every=4,
              max_total_tokens=24, prefix_cache=prefix_cache)
    prompts = _prompts(jcfg.vocab_size)
    jeng = jbuild_engine(jcfg, jp, JServeConfig(paged_attn_impl="ref", **kw),
                         rl=JRLConfig(**GREEDY), vocab_limit=jcfg.vocab_size,
                         key=jax.random.PRNGKey(0))
    teng = build_engine(tcfg, tp, ServeConfig(**kw), rl=RLConfig(**GREEDY),
                        vocab_limit=tcfg.vocab_size)
    assert teng.evictable_pages == jeng.evictable_pages == 0
    jeng.generate([JRequest(rid=i, prompt=p, params=JSamplingParams(
        max_new_tokens=6, **GREEDY)) for i, p in enumerate(prompts)])
    teng.generate([Request(rid=i, prompt=p, params=SamplingParams(
        max_new_tokens=6, **GREEDY)) for i, p in enumerate(prompts)])
    assert teng.evictable_pages == jeng.evictable_pages
    assert (teng.evictable_pages > 0) == prefix_cache
    if prefix_cache:
        # a flush returns at least the evictable pages to the free list
        # (a page two entries hold counts for neither)
        free = teng.free_pages
        teng.prefix_cache.clear()
        assert teng.free_pages >= free + jeng.evictable_pages
        assert teng.evictable_pages == 0


@pytest.mark.parametrize("base", [None, "custom"])
def test_sampling_params_rl_matches_the_reference(base):
    kw = dict(temperature=0.7, top_k=5, top_p=0.9, max_new_tokens=11)
    over = dict(loss_type="gspo", group_size=4, beta_kl=0.01)
    want = JSamplingParams(**kw).rl(None if base is None
                                    else JRLConfig(**over))
    got = SamplingParams(**kw).rl(None if base is None else RLConfig(**over))
    want = dataclasses.asdict(want)
    got = dataclasses.asdict(got)
    assert {k: got[k] for k in want} == want
    assert set(got) == set(want)


@pytest.mark.parametrize("kw", [dict(), dict(temperature=0.6, top_k=20,
                                              top_p=0.95),
                                dict(top_k=3), dict(top_p=0.5)])
@pytest.mark.parametrize("seed", [0, 7])
def test_sample_token_matches_the_reference(kw, seed):
    rng = np.random.default_rng(seed)
    lg = (3 * rng.standard_normal((5, 300))).astype(np.float32)
    jtok, jlp_f, jlp_m = jsample_token(jax.random.PRNGKey(seed),
                                       jnp.asarray(lg), **kw)
    tok, lp_f, lp_m = sample_token(PRNGKey(seed), torch.from_numpy(lg), **kw)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_allclose(lp_f.numpy(), np.asarray(jlp_f), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(lp_m.numpy(), np.asarray(jlp_m), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("argv", [
    [],
    ["--engine", "static", "--slots", "2", "--prompt-len", "40"],
    ["--engine", "continuous", "--slots", "4", "--page-size", "8",
     "--prefill-chunk", "32", "--sync-every", "3", "--num-pages", "40",
     "--no-prefix-cache", "--mesh", "1x2", "--paged-attn-impl", "ref",
     "--spec-k", "4", "--spec-ngram", "2", "--no-spec-rescore",
     "--host", "0.0.0.0", "--port", "9000", "--max-queue", "7",
     "--deadline-s", "2.5", "--seed", "3", "--max-total-tokens", "99"]])
def test_parse_serve_config_matches_the_reference(argv):
    """The same flags collapse into the same ServeConfig; the reference's
    prompt width plays the port's ``--prompt-len``."""
    args = tserve.parse_args(argv)
    args.prompt_width = args.prompt_len
    want = dataclasses.asdict(jserve.parse_serve_config(args))
    got = dataclasses.asdict(tserve.parse_serve_config(args))
    assert got == want
    assert isinstance(tserve.parse_serve_config(args), ServeConfig)


def test_serve_trace_out_writes_the_engines_spans(tmp_path, capsys):
    out = tmp_path / "trace.json"
    try:
        tserve.main(["--device", "cpu", "--smoke", "--batch", "2",
                     "--max-new", "3", "--rounds", "1", "--prompt-len", "9",
                     "--trace-out", str(out)])
    finally:
        obs.configure(False, clear=True)
    assert f"trace events -> {out}" in capsys.readouterr().out
    trace = json.loads(out.read_text())
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    names = {e.get("name") for e in events}
    assert {"prefill", "decode"} <= names
    assert not obs.enabled()
