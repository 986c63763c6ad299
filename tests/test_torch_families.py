"""The decoder-only families of this slice against the JAX package: the
MoE Llama-4 Scout and Maverick, the dense InternLM2-1.8B, Qwen2-7B and
Qwen1.5-32B, and the Mamba2-1.3B learner step.

Every config is the registry's full-size entry, field for field the JAX
package's, and every model runs at its smoke size in float32 with the JAX
package's weights carried across by ``params_from_numpy`` and inputs made
with numpy from a seed. The JAX MoE layers run through
``_jax_moe_ref.moe_ffn_kept``, the reference with its dispatch scatter
writing only the kept entries: random routers overflow the last expert
in most of these forwards, where the reference zeroes one kept row more
than it drops (ROADMAP queue 3, pinned in ``tests/test_torch_moe.py``).

Tolerances (float32): logits and the MoE aux sums 1e-4 relative and
1e-5 absolute (matmul and softmax summation order through a few layers);
engine logps 1e-4 absolute, tokens equal; the learner's loss and metrics
1e-4 relative and 1e-6 absolute, gradients 1e-4 relative and 1e-6
absolute, params after one AdamW step rtol 1e-4, atol 1e-5 (the
reference's own grad-accumulation tolerance) and its first moments rtol
1e-4, atol 1e-9, as in ``tests/test_torch_training.py``. The JAX learner
is held through ``rl_loss_fn`` and ``train_step`` called directly, never
``jit_*`` (ROADMAP queue 3).
"""
import dataclasses

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
from repro.models import init_params as jinit_params
from repro.models.params import param_templates as jtemplates
from repro.sampling import build_engine as jbuild_engine
from repro.sampling.paged_cache import init_paged_pool as jinit_paged_pool
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch import training as ttraining
from repro_torch.config import RLConfig, ServeConfig, TrainConfig
from repro_torch.models import (decode_step, forward, param_templates,
                                params_from_numpy)
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.optim import tree_leaves
from repro_torch.sampling import (ContinuousEngine, build_engine,
                                  init_paged_pool)
from repro_torch.serving.api import Request, SamplingParams

SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
DENSE = ("internlm2-1.8b", "qwen2-7b", "qwen1.5-32b")
FAMILIES = (SCOUT, MAVERICK) + DENSE
MAMBA2 = "mamba2-1.3b"
GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0)
PORT_ONLY = ("paged_attn_impl", "ssd_impl")     # the port's default / knob


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


def _smokes(name, **over):
    return jconfigs.smoke(name, **over), tconfigs.smoke(name, **over)


def _params(jcfg, seed=0):
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


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
# registry and parameters


# the hybrid and modality-memory families: registered field for field,
# and counted (their parity is in test_torch_jamba.py and
# test_torch_memory.py)
LATER = ("jamba-1.5-large-398b", "llama-3.2-vision-11b", "whisper-small")


@pytest.mark.parametrize("name", FAMILIES + LATER)
def test_config_matches_jax(name):
    full, ref = tconfigs.get_config(name), jconfigs.get_config(name)
    for f in dataclasses.fields(full):
        if f.name not in PORT_ONLY:
            assert getattr(full, f.name) == getattr(ref, f.name), f.name
    # the port also counts the final norm and the QKV biases; in an
    # encoder-decoder model the decoder's cross-attention and its norm in
    # every layer and the encoder's final norm
    d = full.d_model
    bias = full.num_layers * (full.num_heads + 2 * full.num_kv_heads) \
        * full.head_dim if full.qkv_bias else 0
    cross = full.num_layers * (2 * d * (full.num_heads
                                        + full.num_kv_heads)
                               * full.head_dim + d) + d \
        if full.is_encdec else 0
    assert full.param_count() == ref.param_count() + d + bias + cross


def test_registry_sizes():
    """The sizes the card phases are cut from (billions of params)."""
    got = {n: round(tconfigs.get_config(n).param_count() / 1e9, 2)
           for n in FAMILIES}
    assert got == {SCOUT: 107.77, MAVERICK: 397.69, "internlm2-1.8b": 1.89,
                   "qwen2-7b": 7.62, "qwen1.5-32b": 35.2}
    scout = tconfigs.get_config(SCOUT)
    assert scout.padded_vocab == 202240 and scout.moe_ep is None


@pytest.mark.parametrize("name", FAMILIES)
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
    if name in (SCOUT, MAVERICK):
        moe = tp["blocks"]["layer_0"]["moe"]
        e, d, f = tcfg.num_experts, tcfg.d_model, tcfg.d_ff
        assert moe["w_gate"].shape == (tcfg.num_blocks, e, d, f)
        assert moe["w_down"].shape == (tcfg.num_blocks, e, f, d)
        assert "shared" in moe and moe["router"].shape[-1] == e


# --------------------------------------------------------------------------
# forward


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_jax(name):
    jcfg, tcfg = _smokes(name)
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab_size,
                                             (2, 24)).astype(np.int32)
    jl, _, jaux = jforward(jcfg, jp, jnp.asarray(toks))
    with torch.no_grad():
        tl, _, taux = forward(tcfg, tp, torch.from_numpy(toks).long())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-5)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    if name in (SCOUT, MAVERICK):
        assert set(taux) == {"moe_load_balance", "moe_z_loss",
                             "moe_drop_frac"}
        assert float(taux["moe_drop_frac"]) > 0        # drops are exercised


# --------------------------------------------------------------------------
# the continuous engine: token counts per forward as the reference's


def _prompts(vocab):
    rng = np.random.default_rng(0)
    shared = rng.integers(3, vocab, 9).astype(np.int32)
    out = [np.concatenate([shared, rng.integers(3, vocab, 4)])]
    out += [rng.integers(3, vocab, n) for n in (5, 3, 14, 11)]
    out += [np.concatenate([shared, rng.integers(3, vocab, 6)])]
    return [p.astype(np.int32) for p in out]


def test_continuous_engine_greedy_matches_jax_on_scout():
    """Decode steps over every slot (dead ones as PAD), prefill chunks of
    8 tokens: the MoE's capacity sees the reference's token counts, so
    drops, tokens and logps match."""
    jcfg, tcfg = _smokes(SCOUT)
    jp, tp = _params(jcfg)
    prompts = _prompts(jcfg.vocab_size)
    serve = dict(num_slots=3, page_size=4, prefill_chunk=8, sync_every=4,
                 max_total_tokens=28)
    jeng = jbuild_engine(jcfg, jp, JServeConfig(paged_attn_impl="ref",
                                                **serve),
                         rl=JRLConfig(**GREEDY), vocab_limit=jcfg.vocab_size,
                         key=jax.random.PRNGKey(0))
    jres = jeng.generate([JRequest(rid=i, prompt=p, params=JSamplingParams(
        max_new_tokens=10, **GREEDY)) for i, p in enumerate(prompts)])
    teng = build_engine(tcfg, tp, ServeConfig(**serve),
                        rl=RLConfig(**GREEDY), vocab_limit=tcfg.vocab_size)
    assert isinstance(teng, ContinuousEngine)
    tres = teng.generate([Request(rid=i, prompt=p, params=SamplingParams(
        max_new_tokens=10, **GREEDY)) for i, p in enumerate(prompts)])
    for a, b in zip(jres, tres):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        np.testing.assert_allclose(b.logps, a.logps, atol=1e-4, rtol=0)
        assert (b.finish_reason, b.prefix_hit_tokens) == \
            (a.finish_reason, a.prefix_hit_tokens)
    js, ts = jeng.stats(), teng.stats()
    for k in ("prefill_chunks", "prefill_tokens", "decode_steps",
              "prefix_hits"):
        assert ts[k] == js[k], k
    teng.prefix_cache.clear()
    assert teng.free_pages == teng.num_pages - 1


def test_dead_decode_slots_do_not_reach_live_tokens():
    """A decode step over 32 slots, every other one dead (PAD at the
    position past its table) with stale pages of junk, E 4, cap 10: the
    dead rows share the MoE's capacity with the live ones. The port zeroes
    a dead row's attention output (K3 returns zeros there; the twin and
    "gather" read its stale pages), so the live rows' logits do not move
    when the junk does. The JAX package's live rows move with it (a known
    reference fault, ROADMAP queue 3): a live token's drops depend on
    what its backend leaves in the dead rows."""
    jcfg, tcfg = _smokes(SCOUT, paged_attn_impl="ref")
    jp, tp = _params(jcfg)
    b, width, page = 32, 4, 4
    rng = np.random.default_rng(0)
    table = (1 + np.arange(b * width)).reshape(b, width).astype(np.int32)
    dead = np.arange(b) % 2 == 1
    pos = np.where(dead, width * page,
                   rng.integers(1, width * page, b)).astype(np.int32)
    tok = rng.integers(3, jcfg.vocab_size, b).astype(np.int32)
    shape = (tcfg.num_blocks, 1 + b * width, page, tcfg.num_kv_heads,
             tcfg.head_dim)
    base = rng.standard_normal(shape).astype(np.float32)
    dead_pages = table[dead].reshape(-1)
    drops, port, ref = [], [], []
    real = tmodel.moe_ffn

    def observed(cfg, p, x):
        y, aux = real(cfg, p, x)
        drops.append(float(aux["moe_drop_frac"]))
        return y, aux
    for _ in range(2):
        pool = base.copy()
        pool[:, dead_pages] = 10 * rng.standard_normal(
            pool[:, dead_pages].shape)
        tpool = init_paged_pool(tcfg, 1 + b * width, page, device="cpu")
        for leaf in tpool["layer_0"]["self"].values():
            leaf.copy_(torch.from_numpy(pool))
        with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
            mp.setattr(tmodel, "moe_ffn", observed)
            logits, _ = decode_step(tcfg, tp, tpool, torch.from_numpy(tok),
                                    torch.from_numpy(pos),
                                    page_table=torch.from_numpy(table))
        port.append(logits.numpy()[~dead])
        jpool = jax.tree_util.tree_map(
            lambda _: jnp.asarray(pool),
            jinit_paged_pool(jcfg, 1 + b * width, page))
        jl, _ = jdecode_step(jcfg, jp, jpool, jnp.asarray(tok),
                             jnp.asarray(pos), page_table=jnp.asarray(table))
        ref.append(np.asarray(jl)[~dead])
    assert max(drops) > 0                        # the capacity is shared
    np.testing.assert_array_equal(port[0], port[1])
    assert np.abs(ref[0] - ref[1]).max() > 1e-3  # the reference's fault


# --------------------------------------------------------------------------
# the learner: rl_loss_fn gradients and train_step


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


LEARNERS = {
    "scout": (SCOUT, {}),
    "mamba2": (MAMBA2, {}),
    # remat on, and the SSD's head slices (each under its own checkpoint)
    "mamba2-sliced": (MAMBA2, dict(remat=True)),
}


@pytest.mark.parametrize("case", sorted(LEARNERS))
def test_rl_loss_fn_grads_and_train_step_match_jax(case, monkeypatch):
    name, over = LEARNERS[case]
    jcfg, tcfg = _smokes(name, **over)
    if case == "mamba2-sliced":
        # microbatch 4 x 19 tokens, chunk 16: 4 x 2 x 16 x 16 elements per
        # head; a budget of 4 heads cuts the 16 heads in 4 slices
        monkeypatch.setattr(tssm, "HEAD_SLICE_BUDGET", 4 * 2 * 16 * 16 * 4)
        assert tssm._head_slice(tcfg, 4, 19) == 4
    jp, tp = _params(jcfg)
    kw = dict(loss_type="gepo", group_size=4, beta_kl=0.005)
    jrl, trl = JRLConfig(**kw), RLConfig(**kw)
    batch = _batch(3, jcfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}

    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtraining.rl_loss_fn(jcfg, jrl, p, jb),
        has_aux=True)(jp)
    leaves = tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    tl, tm = ttraining.rl_loss_fn(tcfg, trl, tp, tb)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-4,
                               atol=1e-6)
    _close_metrics({k: v.detach() for k, v in tm.items()}, jm)
    if name == SCOUT:
        assert {"moe_load_balance", "moe_z_loss", "moe_drop_frac"} <= set(tm)
    for a, b in zip(tg, _leaves_np(jg)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)
    for p in leaves:
        p.requires_grad_(False)

    # AdamW's first step moves p by lr g / (|g| + eps): where |g| is near
    # eps = 1e-8 that swings with the last bits of g (Mamba2's in_proj
    # has gradients of 1e-10 whose float32 sums differ by 1e-10, moving
    # the step by 1.5e-5 at eps 1e-8); at eps 1e-6 the step is as well
    # conditioned as the gradients held above
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


def test_mamba2_learner_refuses_the_forward_only_kernel():
    """K6 has no backward, as the TPU kernel has none: a learner step on
    ``ssd_impl="pallas"`` raises instead of training on the chunked SSD."""
    jcfg = jconfigs.smoke(MAMBA2)
    tcfg = tconfigs.smoke(MAMBA2, ssd_impl="pallas")
    _, tp = _params(jcfg)
    tb = {k: torch.from_numpy(v)
          for k, v in _batch(4, tcfg.vocab_size).items()}
    tc = TrainConfig(learning_rate=1e-3, total_steps=10)
    with pytest.raises(RuntimeError, match="forward-only"):
        ttraining.train_step(tcfg, RLConfig(loss_type="gepo", group_size=4),
                             tc, ttraining.init_state(tcfg, tc, tp), tb)
