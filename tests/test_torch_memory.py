"""The modality-memory families against the JAX package: the VLM
Llama-3.2-11B-Vision (a CROSS layer every fifth layer over stub patch
embeddings) and the encoder-decoder Whisper-small (an encoder over stub
frame embeddings, a decoder that cross-attends to its output in every
layer).

Each model runs at its smoke size in float32 (VLM: 5 layers, a memory of
16 rows; Whisper: 2 decoder and 2 encoder layers over 32 frames) with the
JAX package's weights carried across by ``params_from_numpy`` and inputs
made with numpy from a seed. The JAX forward under
``attn_impl="pallas"`` runs under ``jax.jit`` (eager it raises, ROADMAP
queue 3); its Pallas flash kernel runs in interpret mode, the port's
cross-attention the twin of K5.

The memory is N(0, 1): at the launcher's 0.02 N(0, 1) the VLM memory
moves the smoke logits by ~2e-4, which a 1e-4 check would not see; at
N(0, 1) it moves them by ~9e-3. ``test_memory_is_not_ignored`` shows the
memory moving the logits by more than 100 times the tolerance, and that
the port with the memory zeroed fails the check.

Tolerances (float32, sums in another order through a few layers; the
differences measured here are ~1e-6): logits, encoder outputs and cached
memory projections 1e-5 absolute (logits reach ~1.5); engine logps and
recomputed logps 1e-4 absolute, tokens equal; the learner's loss and
metrics 1e-4 relative and 1e-6 absolute; each gradient leaf 1e-4
relative and 1e-4 of the leaf's largest entry absolute (the encoder's
gradients are ~1e-7 at this size, under any fixed floor); params after
one AdamW step 1e-4 relative and 1e-5 absolute, as in
``tests/test_torch_families.py``. The JAX learner is held through
``rl_loss_fn`` and ``train_step`` called directly.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import training as jtraining
from repro.config import RLConfig as JRLConfig
from repro.config import ServeConfig as JServeConfig
from repro.config import TrainConfig as JTrainConfig
from repro.models import decode_step as jdecode_step
from repro.models import encode as jencode
from repro.models import forward as jforward
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models.params import param_templates as jtemplates
from repro.sampling import build_engine as jbuild_engine
from repro.sampling.engine import token_logps as jtoken_logps
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch import training as ttraining
from repro_torch.config import RLConfig, ServeConfig, TrainConfig
from repro_torch.models import (decode_step, encode, forward, init_cache,
                                param_templates, params_from_numpy)
from repro_torch.models import attention as tattention
from repro_torch.optim import tree_leaves
from repro_torch.sampling import (ContinuousEngine, StaticEngine,
                                  build_engine, generate, token_logps)
from repro_torch.serving.api import Request, SamplingParams

VLM, WHISPER = "llama-3.2-vision-11b", "whisper-small"
NAMES = (VLM, WHISPER)
GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0)
RTOL, ATOL = 0.0, 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _smokes(name, **over):
    return jconfigs.smoke(name, **over), tconfigs.smoke(name, **over)


def _params(jcfg, seed=0):
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_fns(jcfg):
    """The reference's jitted ``encode`` and ``forward(memory=)`` for one
    config, built once (eager ``attn_impl="pallas"`` raises there)."""
    enc = jax.jit(lambda p, f: jencode(jcfg, p, f))
    fwd = jax.jit(lambda p, t, m: jforward(jcfg, p, t, memory=m))
    return enc, fwd


def _stub(cfg, b, seed=1, scale=1.0):
    """The numpy stub of a model's modality input: frames (b,
    encoder_seq, d) for Whisper, patch embeddings (b, memory_seq, d) for
    the VLM, scale x N(0, 1)."""
    rows = cfg.encoder_seq if cfg.is_encdec else cfg.memory_seq
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((b, rows, cfg.d_model))).astype(
        np.float32)


def _memories(jcfg, jp, tcfg, tp, b, seed=1, scale=1.0):
    """(JAX memory, port memory) of one batch: the encoder's output over
    the same frames for Whisper (each package its own encoder), the
    patch embeddings themselves for the VLM."""
    x = _stub(tcfg, b, seed, scale)
    if tcfg.is_encdec:
        with torch.no_grad():
            return _jax_fns(jcfg)[0](jp, jnp.asarray(x)), encode(
                tcfg, tp, torch.from_numpy(x))
    return jnp.asarray(x), torch.from_numpy(x)


def _tokens(vocab, b, s, seed=2):
    return np.random.default_rng(seed).integers(3, vocab, (b, s)).astype(
        np.int32)


def _leaves_np(tree):
    if isinstance(tree, dict):
        return [a for k in sorted(tree) for a in _leaves_np(tree[k])]
    if isinstance(tree, torch.Tensor):
        return [tree.detach().numpy()]
    return [np.asarray(tree)]


def _assert_trees(got, want, rtol=1e-4, atol=1e-6):
    g, w = _leaves_np(got), _leaves_np(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _close_metrics(got, want, rtol=1e-4, atol=1e-6):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


# --------------------------------------------------------------------------
# parameters


@pytest.mark.parametrize("name", NAMES)
def test_param_templates_and_weights_match_jax(name):
    jcfg, tcfg = _smokes(name)

    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda t: (t.shape, t.init, t.scale), tree,
            is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "init"))
    assert shapes(param_templates(tcfg)) == shapes(jtemplates(jcfg))
    jp, tp = _params(jcfg)
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(tree_leaves(tp))
    for (path, a), b in zip(flat_j, tree_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), str(path))
    layer = tp["blocks"]["layer_0"]
    if name == WHISPER:
        assert {"cross_norm", "cross"} <= set(layer)
        assert "bq" not in layer["cross"]
        assert set(tp["encoder"]) == {"blocks", "final_norm"}
        assert tp["encoder"]["blocks"]["attn"]["wq"].shape[0] == \
            tcfg.encoder_layers
    else:
        cross = tp["blocks"][f"layer_{tcfg.period - 1}"]
        assert "cross" not in cross and "wq" in cross["attn"]


@pytest.mark.parametrize("name", NAMES)
def test_param_count_is_the_templates_count(name):
    """The port's count is every parameter the templates hold, at full
    size and at smoke size (the JAX count leaves out the final norm and,
    for Whisper, the decoder's cross-attention and the encoder's final
    norm; ``test_torch_families.py::test_config_matches_jax`` pins the
    difference)."""
    for cfg in (tconfigs.get_config(name), tconfigs.smoke(name)):
        n = sum(int(np.prod(t.shape)) for t in _template_leaves(
            param_templates(cfg)))
        assert cfg.param_count() == n


def _template_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _template_leaves(v)
    else:
        yield tree


# --------------------------------------------------------------------------
# encoder, forward, cache


@pytest.mark.parametrize("impl", ["naive", "chunked", "pallas"])
def test_encode_matches_jax(impl):
    """Whisper's encoder over 32 frames. "chunked" at a chunk of 12 runs
    the flash-style bidirectional attention over padded q and key blocks
    (32 is no multiple of 12); "pallas" the twin of K5, bidir."""
    over = dict(attn_impl=impl, attn_chunk=12)
    jcfg, tcfg = _smokes(WHISPER, **over)
    jp, tp = _params(jcfg)
    x = _stub(tcfg, 2)
    want = _jax_fns(jcfg)[0](jp, jnp.asarray(x))
    with torch.no_grad():
        got = encode(tcfg, tp, torch.from_numpy(x))
    assert got.shape == (2, tcfg.encoder_seq, tcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("impl", ["naive", "pallas"])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax(name, impl):
    jcfg, tcfg = _smokes(name, attn_impl=impl)
    jp, tp = _params(jcfg)
    jm, tm = _memories(jcfg, jp, tcfg, tp, 2)
    toks = _tokens(tcfg.vocab_size, 2, 20)
    jl, _, _ = _jax_fns(jcfg)[1](jp, jnp.asarray(toks), jm)
    with torch.no_grad():
        tl, _, aux = forward(tcfg, tp, torch.from_numpy(toks).long(),
                             memory=tm)
    assert aux == {}
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_memory_is_not_ignored(name):
    """The control: the memory moves the logits by more than 100 times
    the check's tolerance, so a port that ignored it (here: the memory
    zeroed) fails the check ``test_forward_matches_jax`` makes."""
    jcfg, tcfg = _smokes(name)
    jp, tp = _params(jcfg)
    jm, tm = _memories(jcfg, jp, tcfg, tp, 2)
    toks = _tokens(tcfg.vocab_size, 2, 20)
    want = np.asarray(jforward(jcfg, jp, jnp.asarray(toks), memory=jm)[0])
    with torch.no_grad():
        zero = forward(tcfg, tp, torch.from_numpy(toks).long(),
                       memory=torch.zeros_like(tm))[0].numpy()
    assert np.abs(zero - want).max() > 100 * ATOL
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(zero, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", NAMES)
def test_cache_prefill_and_decode_match_jax(name):
    """``init_cache(memory=)`` projects k_mem / v_mem once per cross
    layer as the reference does; the prefill over that cache and three
    greedy decode steps, which read the projections from the cache and
    get no memory, match the reference's logits."""
    jcfg, tcfg = _smokes(name)
    jp, tp = _params(jcfg)
    b, s, steps = 2, 12, 3
    jm, tm = _memories(jcfg, jp, tcfg, tp, b)
    toks = _tokens(tcfg.vocab_size, b, s)
    jcache = jinit_cache(jcfg, jp, b, s + steps, memory=jm)
    with torch.no_grad():
        cache = init_cache(tcfg, tp, b, s + steps, memory=tm)
    for i, kind in enumerate(tcfg.block_pattern):
        if "mem" in jcache[f"layer_{i}"]:
            for n in ("k_mem", "v_mem"):
                np.testing.assert_allclose(
                    cache[f"layer_{i}"]["mem"][n].numpy(),
                    np.asarray(jcache[f"layer_{i}"]["mem"][n]), rtol=RTOL,
                    atol=ATOL)
        else:
            assert "mem" not in cache[f"layer_{i}"]
    jl, jcache, _ = jforward(jcfg, jp, jnp.asarray(toks), cache=jcache,
                             memory=jm)
    with torch.no_grad():
        tl, _, _ = forward(tcfg, tp, torch.from_numpy(toks).long(),
                           cache=cache, memory=tm)
    want = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), want, rtol=RTOL, atol=ATOL)
    tok = np.argmax(want[:, -1], -1).astype(np.int32)
    for t in range(steps):
        jl, jcache = jdecode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                  jnp.int32(s + t))
        with torch.no_grad():
            tl, _ = decode_step(tcfg, tp, cache, torch.from_numpy(tok), s + t)
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, rtol=RTOL, atol=ATOL)
        tok = np.argmax(want, -1).astype(np.int32)


def test_init_cache_refuses_a_missing_or_mismatched_memory():
    tcfg = tconfigs.smoke(VLM)
    _, tp = _params(jconfigs.smoke(VLM))
    with pytest.raises(ValueError, match="memory="):
        init_cache(tcfg, tp, 2, 8)
    with pytest.raises(ValueError, match="memory batch"):
        init_cache(tcfg, tp, 2, 8, memory=torch.zeros(3, 16, tcfg.d_model))
    with pytest.raises(ValueError, match="memory="):
        forward(tcfg, tp, torch.zeros((2, 4), dtype=torch.long))


# --------------------------------------------------------------------------
# routes: cross-attention reaches the flash kernel's entry point


@pytest.mark.parametrize("name", NAMES)
def test_cross_path_routes_to_the_flash_kernel(name, monkeypatch):
    """Under ``attn_impl="pallas"`` every cross-attention takes the K5
    entry point, non-causal at Sq != Sk, without checking its zero
    positions (no host sync) and without the naive or chunked path: one
    call per cross layer in a decode step (Sq 1 against the memory's M
    rows, from the cache), and in the prefill also one per causal
    self-attention layer (and, for Whisper, the encoder's bidirectional
    layers)."""
    jcfg, tcfg = _smokes(name, attn_impl="pallas")
    _, tp = _params(jcfg)
    calls = []
    real = tattention.flash_attention

    def counted(q, k, v, *, causal, window, softcap):
        calls.append((q.shape[1], k.shape[1], causal))
        return real(q, k, v, causal=causal, window=window, softcap=softcap)

    def no_fallback(*a, **k):
        raise AssertionError("cross-attention left the K5 route")

    def no_sync(pos):
        raise AssertionError("positions checked on the host")
    monkeypatch.setattr(tattention, "flash_attention", counted)
    monkeypatch.setattr(tattention, "naive_attention", no_fallback)
    monkeypatch.setattr(tattention, "chunked_attention", no_fallback)
    monkeypatch.setattr(tattention, "standard_positions", no_sync)
    b, s = 2, 9
    with torch.no_grad():
        if tcfg.is_encdec:
            memory = encode(tcfg, tp, torch.from_numpy(_stub(tcfg, b)))
            enc = tcfg.encoder_layers
            assert calls == [(tcfg.encoder_seq, tcfg.encoder_seq, False)] \
                * enc
            calls.clear()
        else:
            memory = torch.from_numpy(_stub(tcfg, b))
        m = memory.shape[1]
        cache = init_cache(tcfg, tp, b, s + 1, memory=memory)
        toks = torch.from_numpy(_tokens(tcfg.vocab_size, b, s)).long()
        forward(tcfg, tp, toks, cache=cache, memory=memory)
        n_cross = tcfg.num_layers if tcfg.is_encdec else tcfg.num_blocks
        n_self = tcfg.num_layers - (0 if tcfg.is_encdec else n_cross)
        assert sorted(calls) == sorted([(s, s, True)] * n_self
                                       + [(s, m, False)] * n_cross)
        calls.clear()
        decode_step(tcfg, tp, cache, toks[:, 0], s)
    assert calls == [(1, m, False)] * n_cross


# --------------------------------------------------------------------------
# engines and the recompute


def _requests(cls_req, cls_sp, prompts, max_new):
    return [cls_req(rid=i, prompt=p, params=cls_sp(max_new_tokens=max_new,
                                                   **GREEDY))
            for i, p in enumerate(prompts)]


@pytest.mark.parametrize("name", NAMES)
def test_static_engine_matches_jax_greedy(name):
    """``build_engine(engine="static", memory=)`` against the reference's
    engine with the same memory: tokens equal, logps within 1e-4."""
    jcfg, tcfg = _smokes(name)
    jp, tp = _params(jcfg)
    b = 3
    jm, tm = _memories(jcfg, jp, tcfg, tp, b)
    prompts = list(_tokens(tcfg.vocab_size, b, 10))
    jeng = jbuild_engine(jcfg, jp, JServeConfig(engine="static"),
                         rl=JRLConfig(**GREEDY), memory=jm,
                         vocab_limit=jcfg.vocab_size,
                         key=jax.random.PRNGKey(0))
    jres = jeng.generate(_requests(JRequest, JSamplingParams, prompts, 6))
    teng = build_engine(tcfg, tp, ServeConfig(engine="static"),
                        rl=RLConfig(**GREEDY), memory=tm,
                        vocab_limit=tcfg.vocab_size)
    assert isinstance(teng, StaticEngine)
    tres = teng.generate(_requests(Request, SamplingParams, prompts, 6))
    for a, r in zip(jres, tres):
        np.testing.assert_array_equal(r.tokens, a.tokens)
        np.testing.assert_allclose(r.logps, a.logps, atol=1e-4, rtol=0)
        assert r.finish_reason == a.finish_reason


@pytest.mark.parametrize("name", NAMES)
def test_continuous_engine_warns_and_serves_static(name):
    """A memory or encoder-decoder model serves static, as in the JAX
    package: ``build_engine`` and the legacy ``generate`` warn under
    ``engine="continuous"`` and the static path serves the same tokens;
    ``ContinuousEngine`` refuses the model."""
    jcfg, tcfg = _smokes(name)
    jp, tp = _params(jcfg)
    b = 2
    _, tm = _memories(jcfg, jp, tcfg, tp, b)
    prompts = _tokens(tcfg.vocab_size, b, 7)
    rl = RLConfig(**GREEDY, max_new_tokens=4)
    with pytest.warns(UserWarning, match="serving static"):
        eng = build_engine(tcfg, tp, ServeConfig(engine="continuous"),
                           rl=rl, memory=tm)
    assert isinstance(eng, StaticEngine)
    with pytest.warns(UserWarning, match="falling back to static"):
        got = generate(tcfg, rl, tp, prompts, memory=tm, engine="continuous")
    want = generate(tcfg, rl, tp, prompts, memory=tm, engine="static")
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  want["tokens"].numpy())
    res = eng.generate(_requests(Request, SamplingParams, list(prompts), 4))
    for i, r in enumerate(res):
        n = int(want["comp_mask"][i].sum())
        np.testing.assert_array_equal(r.tokens,
                                      want["completions"][i, :n].numpy())
    with pytest.raises(ValueError, match="continuous engine"):
        ContinuousEngine(tcfg, tp, rl=rl, max_total_tokens=32)


@pytest.mark.parametrize("name", NAMES)
def test_token_logps_matches_jax(name):
    jcfg, tcfg = _smokes(name)
    jp, tp = _params(jcfg)
    jm, tm = _memories(jcfg, jp, tcfg, tp, 3)
    toks = _tokens(tcfg.vocab_size, 3, 17)
    want = jtoken_logps(jcfg, jp, jnp.asarray(toks), memory=jm)
    got = token_logps(tcfg, tp, torch.from_numpy(toks).long(), memory=tm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


# --------------------------------------------------------------------------
# the learner: frames / image_embeds ride in the batch


def _batch(tcfg, seed, b=8, s=16):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s - 1), np.float32)
    mask[:, :4] = 0.0                          # prompt targets
    for i in range(b):
        mask[i, s - 1 - (i % 3):] = 0.0        # ragged tails
    out = {"tokens": rng.integers(0, tcfg.vocab_size, (b, s)).astype(
               np.int32),
           "mask": mask,
           "sampler_lp": -np.abs(rng.standard_normal((b, s - 1))).astype(
               np.float32) - 5.0,
           "rewards": (rng.random(b) > 0.5).astype(np.float32)}
    out["frames" if tcfg.is_encdec else "image_embeds"] = _stub(tcfg, b,
                                                                seed + 1)
    return out


@pytest.mark.parametrize("name", NAMES)
def test_rl_loss_fn_grads_and_train_step_match_jax(name):
    """GEPO through ``rl_loss_fn`` with the modality stub in the batch
    (Whisper: ``frames`` through the encoder, whose weights get
    gradients; VLM: ``image_embeds``), then one ``train_step`` at
    ``grad_accum`` 2, which cuts the stub with the batch."""
    jcfg, tcfg = _smokes(name)
    jp, tp = _params(jcfg)
    kw = dict(loss_type="gepo", group_size=4, beta_kl=0.005)
    jrl, trl = JRLConfig(**kw), RLConfig(**kw)
    batch = _batch(tcfg, 3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtraining.rl_loss_fn(jcfg, jrl, p, jb), has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = ttraining.rl_loss_fn(tcfg, trl, tp, tb)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4,
                               atol=1e-6)
    _close_metrics({k: v.detach() for k, v in tm.items()}, jm)
    flat_j = jax.tree_util.tree_flatten_with_path(jg)[0]
    assert len(flat_j) == len(tg)
    for (path, b), a in zip(flat_j, tg):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4,
                                   atol=1e-4 * np.abs(b).max(),
                                   err_msg=str(path))
    # the memory reaches the gradients: the cross-attention's keys (and,
    # for Whisper, the encoder's queries) get a gradient, which would be
    # exactly zero with the memory cut off
    names = [jax.tree_util.keystr(p) for p, _ in flat_j]
    wk = "['cross']['wk']" if tcfg.is_encdec else \
        f"['layer_{tcfg.period - 1}']['attn']['wk']"
    hit = [i for i, n in enumerate(names) if n.endswith(wk)]
    if tcfg.is_encdec:
        hit += [i for i, n in enumerate(names)
                if n.startswith("['encoder']") and n.endswith("['wq']")]
    assert len(hit) == (2 if tcfg.is_encdec else 1)
    for i in hit:
        assert float(tg[i].abs().max()) > 0, names[i]
    for p in leaves:
        p.requires_grad_(False)

    tc_kw = dict(learning_rate=1e-3, grad_accum=2, total_steps=10, eps=1e-6)
    jtc, ttc = JTrainConfig(**tc_kw), TrainConfig(**tc_kw)
    jnew, jm = jtraining.train_step(jcfg, jrl, jtc,
                                    jtraining.init_state(jcfg, jtc, jp), jb)
    tnew, tm = ttraining.train_step(tcfg, trl, ttc,
                                    ttraining.init_state(tcfg, ttc, tp), tb)
    _close_metrics(tm, jm)
    assert int(tnew.step) == int(jnew.step) == 1
    _assert_trees(tnew.params, jnew.params, rtol=1e-4, atol=1e-5)
    _assert_trees(tnew.opt.m, jnew.opt.m, rtol=1e-4, atol=1e-9)


def test_explicit_memory_takes_precedence():
    """``rl_loss_fn(memory=)`` wins over ``image_embeds`` in the batch,
    as in the JAX package; with the batch's own embeddings passed as the
    memory, the loss is the one the batch gives alone."""
    jcfg, tcfg = _smokes(VLM)
    _, tp = _params(jcfg)
    rl = RLConfig(loss_type="gepo", group_size=4)
    tb = {k: torch.from_numpy(v) for k, v in _batch(tcfg, 5).items()}
    with torch.no_grad():
        alone, _ = ttraining.rl_loss_fn(tcfg, rl, tp, tb)
        same, _ = ttraining.rl_loss_fn(tcfg, rl, tp, tb,
                                       memory=tb["image_embeds"])
        other, _ = ttraining.rl_loss_fn(
            tcfg, rl, tp, tb, memory=torch.zeros_like(tb["image_embeds"]))
    assert float(same) == float(alone)
    assert float(other) != float(alone)


def test_chunked_bidir_attention_at_unequal_lengths():
    """The learner's flash-style attention, bidirectional with Sq != Sk
    and neither a multiple of the chunk (the padded key block is masked):
    forward and gradients equal the naive attention's within float32
    summation order (1e-5)."""
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .requires_grad_(True)
               for s in ((2, 23, 4, 16), (2, 37, 2, 16), (2, 37, 2, 16)))
    pq = torch.zeros((2, 23), dtype=torch.long)
    pk = torch.zeros((2, 37), dtype=torch.long)
    out = {}
    for name, fn in (("naive", tattention.naive_attention),
                     ("chunked", tattention.chunked_attention)):
        kw = dict(q_chunk=8, kv_chunk=16) if name == "chunked" else {}
        o = fn(q, k, v, pos_q=pq, pos_k=pk, kind="bidir", **kw)
        g = torch.autograd.grad((o * o).sum(), (q, k, v))
        out[name] = (o.detach(), g)
    (on, gn), (oc, gc) = out["naive"], out["chunked"]
    torch.testing.assert_close(oc, on, rtol=0, atol=1e-5)
    for a, b in zip(gc, gn):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_full_configs_keep_their_widths():
    """The card runs these at full width: the memory and encoder shapes
    the phase's kernels see."""
    vlm, wh = tconfigs.get_config(VLM), tconfigs.get_config(WHISPER)
    assert (vlm.memory_seq, vlm.num_heads // vlm.num_kv_heads,
            vlm.head_dim, vlm.padded_vocab) == (1601, 4, 128, 128256)
    assert vlm.block_pattern.count("cross") == 1 and vlm.num_blocks == 8
    assert (wh.encoder_seq, wh.encoder_layers, wh.num_heads,
            wh.num_kv_heads, wh.head_dim, wh.padded_vocab) == \
        (1500, 12, 12, 12, 64, 51968)
    assert dataclasses.replace(vlm, num_layers=5).param_count() < \
        vlm.param_count()
