"""The hybrid Jamba-1.5-Large against the JAX package on the CPU: one
attention layer to seven Mamba2 layers, a MoE FFN (top-2 of 16 experts)
on every other layer and an MLP on the rest.

The registry's full-size entry is the JAX config field for field
(``tests/test_torch_families.py::test_config_matches_jax``); no
full-width model fits one card (one 8-layer period is ~45B parameters),
so its card run holds pieces at full width (``chip_smoke.py`` phase 13)
and the model is held here at its smoke size (one period of 8 layers,
d_model 256, 4 experts top-2, SSM state 32, float32), with the JAX
package's weights carried across by ``params_from_numpy`` and inputs made
with numpy from a seed. The JAX MoE layers run through
``_jax_moe_ref.moe_ffn_kept`` (the reference with its dispatch writing
only the kept entries; ROADMAP queue 3).

Tolerances (float32): logits and the MoE aux sums 1e-4 relative and
1e-5 absolute; engine and recomputed logps 1e-4 absolute, tokens equal;
the learner's loss and metrics 1e-4 relative and 1e-6 absolute,
gradients 1e-4 relative and 1e-6 absolute, params after one AdamW step
1e-4 relative and 1e-5 absolute, as in ``tests/test_torch_families.py``.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _jax_moe_ref import patch_jax_moe
from repro import configs as jconfigs
from repro import training as jtraining
from repro.config import RLConfig as JRLConfig
from repro.config import ServeConfig as JServeConfig
from repro.config import TrainConfig as JTrainConfig
from repro.models import decode_step as jdecode_step
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
from repro_torch.config import MAMBA, MOE, RLConfig, ServeConfig, TrainConfig
from repro_torch.models import (decode_step, forward, init_cache,
                                param_templates, params_from_numpy)
from repro_torch.optim import tree_leaves
from repro_torch.sampling import (ContinuousEngine, StaticEngine,
                                  build_engine, token_logps)
from repro_torch.serving.api import Request, SamplingParams

JAMBA = "jamba-1.5-large-398b"
GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0)


@pytest.fixture(scope="module", autouse=True)
def _kept_only_jax_moe():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_moe(mp)
        yield


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params) of jamba's smoke."""
    jcfg, tcfg = jconfigs.smoke(JAMBA), tconfigs.smoke(JAMBA)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    return jcfg, jp, tcfg, tp


def _tokens(vocab, b, s, seed=1):
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


def test_smoke_keeps_the_hybrid_layout(model):
    _, _, tcfg, _ = model
    full = tconfigs.get_config(JAMBA)
    assert tcfg.block_pattern == full.block_pattern
    assert tcfg.block_pattern.count(MAMBA) == 7 and tcfg.num_layers == 8
    assert [tcfg.ffn_kind(i) for i in range(2)] == [MOE, "mlp"]
    assert (full.num_experts, full.experts_per_token, full.ssm_state,
            full.ssm_heads, full.d_model) == (16, 2, 128, 256, 8192)


def test_param_templates_and_weights_match_jax(model):
    jcfg, jp, tcfg, tp = model

    def shapes(tree):
        return jax.tree_util.tree_map(
            lambda t: (t.shape, t.init, t.scale), tree,
            is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "init"))
    assert shapes(param_templates(tcfg)) == shapes(jtemplates(jcfg))
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat_j) == len(tree_leaves(tp))
    for (path, a), b in zip(flat_j, tree_leaves(tp)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), str(path))


@pytest.mark.parametrize("ssd_impl", ["chunked", "pallas"])
def test_forward_matches_jax(model, ssd_impl):
    """Logits and the MoE aux sums; ``ssd_impl="pallas"`` runs the port's
    Mamba2 layers through K6's twin (the JAX package always runs its
    chunked SSD)."""
    jcfg, jp, tcfg, tp = model
    tcfg = tconfigs.smoke(JAMBA, ssd_impl=ssd_impl)
    toks = _tokens(jcfg.vocab_size, 2, 40)
    jl, _, jaux = jforward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, _, taux = forward(tcfg, tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    assert set(taux) == set(jaux) == {"moe_load_balance", "moe_z_loss",
                                      "moe_drop_frac"}
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)


def test_dense_cache_prefill_and_decode_match_jax(model):
    """The attention layer's KV cache and the Mamba2 layers' conv window
    and SSM state, filled by a prefill and carried by 3 greedy decode
    steps (through the MoE at 2 rows a step)."""
    jcfg, jp, tcfg, tp = model
    b, s, steps = 2, 13, 3
    toks = _tokens(jcfg.vocab_size, b, s)
    jcache = jinit_cache(jcfg, jp, b, s + steps)
    jl, jcache, _ = jforward(jcfg, jp, jnp.asarray(toks), cache=jcache)
    cache = init_cache(tcfg, tp, b, s + steps)
    with torch.no_grad():
        tl, _, _ = forward(tcfg, tp, torch.from_numpy(toks).long(),
                           cache=cache)
    want = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), want, rtol=1e-4, atol=1e-5)
    tok = np.argmax(want[:, -1], -1).astype(np.int32)
    for t in range(steps):
        jl, jcache = jdecode_step(jcfg, jp, jcache, jnp.asarray(tok),
                                  jnp.int32(s + t))
        with torch.no_grad():
            tl, _ = decode_step(tcfg, tp, cache, torch.from_numpy(tok), s + t)
        want = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), want, rtol=1e-4, atol=1e-5)
        tok = np.argmax(want, -1).astype(np.int32)


def test_static_engine_matches_jax_greedy(model):
    """``build_engine(engine="continuous")`` warns and serves static (the
    paged cache holds no Mamba2 layer), as the reference's does: tokens
    equal, logps within 1e-4."""
    jcfg, jp, tcfg, tp = model
    prompts = list(_tokens(jcfg.vocab_size, 3, 11))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jeng = jbuild_engine(jcfg, jp, JServeConfig(engine="continuous"),
                             rl=JRLConfig(**GREEDY),
                             vocab_limit=jcfg.vocab_size,
                             key=jax.random.PRNGKey(0))
    jres = jeng.generate([JRequest(rid=i, prompt=p, params=JSamplingParams(
        max_new_tokens=6, **GREEDY)) for i, p in enumerate(prompts)])
    with pytest.warns(UserWarning, match="serving static"):
        teng = build_engine(tcfg, tp, ServeConfig(engine="continuous"),
                            rl=RLConfig(**GREEDY),
                            vocab_limit=tcfg.vocab_size)
    assert isinstance(teng, StaticEngine)
    tres = teng.generate([Request(rid=i, prompt=p, params=SamplingParams(
        max_new_tokens=6, **GREEDY)) for i, p in enumerate(prompts)])
    for a, r in zip(jres, tres):
        np.testing.assert_array_equal(r.tokens, a.tokens)
        np.testing.assert_allclose(r.logps, a.logps, atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="continuous engine"):
        ContinuousEngine(tcfg, tp, rl=RLConfig(**GREEDY),
                         max_total_tokens=32)


def test_token_logps_matches_jax(model):
    jcfg, jp, tcfg, tp = model
    toks = _tokens(jcfg.vocab_size, 3, 30)
    want = jtoken_logps(jcfg, jp, jnp.asarray(toks))
    got = token_logps(tcfg, tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)


def _batch(seed, vocab, b=8, s=20):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s - 1), np.float32)
    mask[:, :5] = 0.0                          # prompt targets
    for i in range(b):
        mask[i, s - 1 - (i % 3):] = 0.0        # ragged tails
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "mask": mask,
            "sampler_lp": -np.abs(rng.standard_normal((b, s - 1))).astype(
                np.float32) - 5.0,
            "rewards": (rng.random(b) > 0.5).astype(np.float32)}


def test_rl_loss_fn_grads_and_train_step_match_jax(model):
    jcfg, jp, tcfg, tp = model
    kw = dict(loss_type="gepo", group_size=4, beta_kl=0.005)
    jrl, trl = JRLConfig(**kw), RLConfig(**kw)
    batch = _batch(3, jcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtraining.rl_loss_fn(jcfg, jrl, p, jb), has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = ttraining.rl_loss_fn(tcfg, trl, tp, tb)
    tg = torch.autograd.grad(tl, leaves)
    for p in leaves:
        p.requires_grad_(False)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4,
                               atol=1e-6)
    _close_metrics({k: v.detach() for k, v in tm.items()}, jm)
    assert {"moe_load_balance", "moe_z_loss", "moe_drop_frac"} <= set(tm)
    for a, b in zip(tg, _leaves_np(jg)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)

    # eps 1e-6: see test_torch_families.py (Mamba2's in_proj gradients
    # of ~1e-10 swing an eps-1e-8 AdamW step with their last bits)
    tc_kw = dict(learning_rate=1e-3, grad_accum=2, total_steps=10, eps=1e-6)
    jtc, ttc = JTrainConfig(**tc_kw), TrainConfig(**tc_kw)
    own = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                            device="cpu")
    jnew, jm = jtraining.train_step(jcfg, jrl, jtc,
                                    jtraining.init_state(jcfg, jtc, jp), jb)
    tnew, tm = ttraining.train_step(tcfg, trl, ttc,
                                    ttraining.init_state(tcfg, ttc, own), tb)
    _close_metrics(tm, jm)
    assert int(tnew.step) == int(jnew.step) == 1
    _assert_trees(tnew.params, jnew.params, rtol=1e-4, atol=1e-5)
    _assert_trees(tnew.opt.m, jnew.opt.m, rtol=1e-4, atol=1e-9)
