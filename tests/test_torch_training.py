"""The learner side of the PyTorch port against the JAX package.

Losses, advantages, importance weights, optimizers and schedules, dense
attention (forward and the flash backward), the dense model forward with
remat on and off, ``rl_loss_fn`` value and gradients, ``train_step`` at
``grad_accum`` 1 and 2, and the sampler-side helpers (``sft_loss_fn``,
``token_logps``, ``rollout_from_results``, greedy ``generate_continuous``).
Both packages get the same float32 inputs made from a numpy seed, and the
same weights (the JAX package's ``init_params`` carried across with
``params_from_numpy``). The JAX learner is held through ``train_step``,
``rl_loss_fn`` and ``forward`` called directly, never the ``jit_*``
wrappers (ROADMAP queue 3).

Tolerances (float32): elementwise loss math 1e-5 abs and 1e-5 relative;
model logits and gradients 1e-4 relative plus 1e-6 abs (matmul and
softmax summation order); params after one step rtol 1e-4, atol 1e-5, the
tolerance of the reference's own grad-accumulation test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import optim as joptim
from repro import training as jtraining
from repro.config import ATTN as JATTN
from repro.config import LOCAL as JLOCAL
from repro.config import MLP as JMLP
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.config import TrainConfig as JTrainConfig
from repro.core import diagnostics as jdiag
from repro.models import attention as jattn
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.sampling.continuous import generate_continuous as jgenerate
from repro.sampling.continuous import rollout_from_results as jrollout
from repro.sampling.engine import token_logps as jtoken_logps
from repro.serving.api import GenerationResult as JGenerationResult
from repro_torch import core as tcore
from repro_torch import optim as toptim
from repro_torch import training as ttraining
from repro_torch.config import ModelConfig, RLConfig, TrainConfig
from repro_torch.core import diagnostics as tdiag
from repro_torch.models import attention as tattn
from repro_torch.models import forward, params_from_numpy
from repro_torch.parallel import plan_from_flag
from repro_torch.sampling import (generate_continuous, rollout_from_results,
                                  token_logps)
from repro_torch.sampling.prng import PRNGKey
from repro_torch.serving.api import GenerationResult

LOSS_TYPES = ("grpo", "dr_grpo", "bnpo", "gspo", "gepo", "tis", "cispo",
              "topr")
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=48,
            num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=32,
            dtype="float32", attn_impl="naive", remat=False, rope_theta=1e4)


def _cfgs(**over):
    kw = dict(TINY, **over)
    pattern = kw.pop("pattern", ("attn",))
    jmap = {"attn": JATTN, "local": JLOCAL}
    return (JModelConfig(block_pattern=tuple(jmap[k] for k in pattern),
                         ffn_pattern=(JMLP,), **kw),
            ModelConfig(block_pattern=pattern, ffn_pattern=("mlp",), **kw))


def _params(jcfg, seed=0):
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                                 device="cpu")


def _leaves_np(tree):
    """Leaves in sorted-key order from a JAX or a torch tree."""
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


def _batch(seed, b=8, s=10, vocab=32, ragged=True):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s - 1), np.float32)
    if ragged:                             # prompt targets and ragged tails
        mask[:, :3] = 0.0
        for i in range(b):
            mask[i, s - 1 - (i % 3):] = 0.0
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "mask": mask,
            "sampler_lp": -np.abs(rng.standard_normal((b, s - 1))).astype(
                np.float32),
            "rewards": (rng.random(b) > 0.5).astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close_metrics(got, want, keys=None, rtol=1e-5, atol=1e-5):
    keys = keys or want.keys()
    assert set(got) == set(want)
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)


# --------------------------------------------------------------------------
# core: advantages, importance weights, losses


@pytest.mark.parametrize("kind,normalize", [("grpo", True), ("grpo", False),
                                            ("gepo", True),
                                            ("dr_grpo", True),
                                            ("bnpo", True)])
def test_group_advantages_match_jax(kind, normalize):
    rng = np.random.default_rng(1)
    r = np.concatenate([(rng.random(8) > 0.5), rng.random(8),
                        np.ones(4)]).astype(np.float32)   # one flat group
    got = tcore.group_advantages(torch.from_numpy(r), 4, kind=kind,
                                 normalize=normalize)
    want = jcore.group_advantages(jnp.asarray(r), 4, kind=kind,
                                  normalize=normalize)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("smooth", [0.0, 0.3])
def test_group_expectation_denominator_matches_jax(smooth):
    rng = np.random.default_rng(2)
    q = (-3 * rng.random(8)).astype(np.float32)
    p = (-3 * rng.random(8)).astype(np.float32)
    got = tcore.group_expectation_log_denominator(
        torch.from_numpy(q), 4, smooth=smooth,
        learner_seq_lp=torch.from_numpy(p))
    want = jcore.group_expectation_log_denominator(
        jnp.asarray(q), 4, smooth=smooth, learner_seq_lp=jnp.asarray(p))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def _loss_inputs(seed, b=8, t=7):
    rng = np.random.default_rng(seed)
    lp = -np.abs(rng.standard_normal((b, t))).astype(np.float32)
    slp = (lp + 0.3 * rng.standard_normal((b, t))).astype(np.float32)
    mask = (rng.random((b, t)) > 0.2).astype(np.float32)
    adv = rng.standard_normal(b).astype(np.float32)
    ent = np.abs(rng.standard_normal((b, t))).astype(np.float32)
    return lp, slp, mask, adv, ent


@pytest.mark.parametrize("with_entropy", [False, True])
@pytest.mark.parametrize("loss_type", LOSS_TYPES)
def test_policy_loss_and_grad_match_jax(loss_type, with_entropy):
    lp, slp, mask, adv, ent = _loss_inputs(LOSS_TYPES.index(loss_type))
    kw = dict(loss_type=loss_type, group_size=4, entropy_bonus=0.01,
              gepo_smooth=0.1 if loss_type == "gepo" else 0.0)
    jrl, trl = JRLConfig(**kw), RLConfig(**kw)
    e = ent if with_entropy else None

    def jloss(x):
        return jcore.policy_loss(jrl, x, jnp.asarray(slp), jnp.asarray(mask),
                                 jnp.asarray(adv),
                                 entropy=None if e is None else jnp.asarray(e))
    (jl, jm), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(lp))
    x = torch.from_numpy(lp).requires_grad_()
    tl, tm = tcore.policy_loss(trl, x, torch.from_numpy(slp),
                               torch.from_numpy(mask), torch.from_numpy(adv),
                               entropy=None if e is None
                               else torch.from_numpy(e))
    (tg,) = torch.autograd.grad(tl, x)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    _close_metrics(tm, jm)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def test_kl_and_importance_weights_match_jax():
    lp, slp, mask, _, _ = _loss_inputs(5)
    np.testing.assert_allclose(
        float(tcore.kl_k3(torch.from_numpy(lp), torch.from_numpy(slp),
                          torch.from_numpy(mask))),
        float(jcore.kl_k3(jnp.asarray(lp), jnp.asarray(slp),
                          jnp.asarray(mask))), rtol=1e-6)
    for lt in LOSS_TYPES:
        got, lvl = tcore.importance_weights(
            lt, torch.from_numpy(lp), torch.from_numpy(slp),
            torch.from_numpy(mask), group_size=4)
        want, jlvl = jcore.importance_weights(
            lt, jnp.asarray(lp), jnp.asarray(slp), jnp.asarray(mask),
            group_size=4)
        assert lvl == jlvl
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


def test_diagnostics_copy_matches_jax():
    th, jh = tdiag.MetricsHistory(), jdiag.MetricsHistory()
    for i in range(5):
        for h in (th, jh):
            h.append(i, {"kl": 0.1 * i, "iw_var": (i - 2) ** 2})
    assert th.summary(["kl", "iw_var"]) == jh.summary(["kl", "iw_var"])
    assert tdiag.correlation_matrix(th, ["kl", "iw_var"]) == \
        jdiag.correlation_matrix(jh, ["kl", "iw_var"])
    assert tdiag.best_last_gap([0.1, 0.5, 0.3]) == \
        jdiag.best_last_gap([0.1, 0.5, 0.3])


# --------------------------------------------------------------------------
# optimizers and schedules


def _opt_tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((4, 3)).astype(np.float32),
            "stack": rng.standard_normal((2, 3, 5)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizers_match_jax(opt):
    tc_kw = dict(learning_rate=1e-2, weight_decay=0.01, total_steps=100,
                 warmup_frac=0.0)
    jtc, ttc = JTrainConfig(**tc_kw), TrainConfig(**tc_kw)
    p0 = _opt_tree(0)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jinit, jupd = ((joptim.adamw_init, joptim.adamw_update) if opt == "adamw"
                   else (joptim.adafactor_init, joptim.adafactor_update))
    tinit, tupd = ((toptim.adamw_init, toptim.adamw_update) if opt == "adamw"
                   else (toptim.adafactor_init, toptim.adafactor_update))
    js, ts = jinit(jp), tinit(tp)
    for step in range(3):
        g = _opt_tree(10 + step)
        jp, js = jupd(jtc, {k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                      jnp.float32(1e-2))
        tp, ts = tupd(ttc, {k: torch.from_numpy(v) for k, v in g.items()},
                      ts, tp, torch.tensor(1e-2))
    _assert_trees(tp, jp, rtol=1e-5, atol=1e-6)
    assert int(ts.step) == int(js.step) == 3


def test_clip_and_schedules_match_jax():
    g = _opt_tree(3)
    for max_norm in (0.5, 100.0):
        tg, tn = toptim.clip_by_global_norm(
            {k: torch.from_numpy(v.copy()) for k, v in g.items()}, max_norm)
        jg, jn = joptim.clip_by_global_norm(
            {k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees(tg, jg, rtol=1e-6, atol=1e-7)
    kw = dict(learning_rate=3e-4, warmup_frac=0.1, total_steps=50)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    for s in (0, 1, 4, 5, 6, 30, 49, 60):
        for tf, jf in ((toptim.warmup_schedule, joptim.warmup_schedule),
                       (toptim.cosine_schedule, joptim.cosine_schedule)):
            np.testing.assert_allclose(float(tf(ttc, torch.tensor(s))),
                                       float(jf(jtc, s)), rtol=1e-6)
    # the mesh is checked when a plan is built: no process group here
    assert TrainConfig(mesh="2x2").mesh == "2x2"
    with pytest.raises(RuntimeError, match="torchrun"):
        plan_from_flag("2x2", "train")


# --------------------------------------------------------------------------
# attention


def _qkv(seed, b=2, sq=20, hq=4, hkv=2, d=8):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, sq, hkv, d)).astype(np.float32)
    do = rng.standard_normal((b, sq, hq, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("kind,window,cap", [("causal", 4096, None),
                                             ("local", 5, None),
                                             ("causal", 4096, 2.0),
                                             ("bidir", 4096, None)])
@pytest.mark.parametrize("chunk", [8, 32])
def test_chunked_attention_fwd_bwd_match_jax(kind, window, cap, chunk):
    """S = 20 over chunk 8: three blocks with a padded tail (PAD_POS keys);
    chunk 32: one padded-free block."""
    q, k, v, do = _qkv(chunk)
    pos = np.broadcast_to(np.arange(q.shape[1]), q.shape[:2]).copy()
    kw = dict(kind=kind, window=window, softcap=cap, q_chunk=chunk,
              kv_chunk=chunk)
    jo, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention(
        a, b, c, pos_q=jnp.asarray(pos), pos_k=jnp.asarray(pos), **kw),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tp = torch.from_numpy(pos)
    to = tattn.chunked_attention(tq, tk, tv, pos_q=tp, pos_k=tp, **kw)
    tgrads = torch.autograd.grad(to, (tq, tk, tv), torch.from_numpy(do))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tgrads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    naive = tattn.naive_attention(tq, tk, tv, pos_q=tp, pos_k=tp, kind=kind,
                                  window=window, softcap=cap)
    np.testing.assert_allclose(naive.detach().numpy(), np.asarray(jo),
                               rtol=1e-5, atol=1e-5)


def test_attention_dispatch():
    q, k, v, _ = _qkv(0, sq=6)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    pos = torch.arange(6).expand(2, 6)
    # "pallas" on CPU tensors: the twin of the flash kernel K5
    c = tattn.attention(*t, pos_q=pos, pos_k=pos, impl="pallas")
    with pytest.raises(ValueError, match="unknown"):
        tattn.attention(*t, pos_q=pos, pos_k=pos, impl="flash")
    a = tattn.attention(*t, pos_q=pos, pos_k=pos, impl="chunked", chunk=4)
    b = tattn.attention(*t, pos_q=pos, pos_k=pos, impl="naive")
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c, b, rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the dense model forward


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("over", [dict(), dict(attn_impl="chunked",
                                               attn_chunk=8),
                                  dict(pattern=("attn", "local"),
                                       sliding_window=4, attn_softcap=5.0,
                                       final_softcap=30.0, num_layers=4)])
def test_dense_forward_and_grad_match_jax(over, remat):
    jcfg, tcfg = _cfgs(remat=remat, **over)
    jp, tp = _params(jcfg)
    toks = np.random.default_rng(4).integers(0, 32, (2, 20))
    jl, _, _ = jforward(jcfg, jp, jnp.asarray(toks))
    for leaf in toptim.tree_leaves(tp):
        leaf.requires_grad_(True)
    tl, cache, aux = forward(tcfg, tp, torch.from_numpy(toks))
    assert cache is None and aux == {}
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-5)
    w = np.random.default_rng(5).standard_normal(jl.shape).astype(np.float32)
    jg = jax.grad(lambda p: (jforward(jcfg, p, jnp.asarray(toks))[0]
                             * w).sum())(jp)
    tg = torch.autograd.grad((tl * torch.from_numpy(w)).sum(),
                             toptim.tree_leaves(tp))
    for a, b in zip(tg, _leaves_np(jg)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# the learner step


@pytest.mark.parametrize("loss_type", ["gepo", "grpo", "cispo"])
@pytest.mark.parametrize("impl", ["fused", "chunked", "naive"])
def test_rl_loss_fn_value_and_grads_match_jax(impl, loss_type):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    kw = dict(loss_type=loss_type, group_size=4, beta_kl=0.005)
    jrl, trl = JRLConfig(**kw), RLConfig(**kw)
    batch = _batch(6)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jtraining.rl_loss_fn(jcfg, jrl, p, _j(batch),
                                       logprob_impl=impl),
        has_aux=True)(jp)
    leaves = toptim.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl, tm = ttraining.rl_loss_fn(tcfg, trl, tp, _t(batch),
                                  logprob_impl=impl)
    tg = torch.autograd.grad(tl, leaves)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5,
                               atol=1e-6)
    _close_metrics(tm, jm)
    for a, b in zip(tg, _leaves_np(jg)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("variant", ["tiny", "chunked_attn"])
def test_train_step_matches_jax(accum, variant):
    """Gradients and metrics first, then params after one AdamW step at
    the reference's own accumulation tolerance (rtol 1e-4, atol 1e-5)."""
    over = dict(attn_impl="chunked", attn_chunk=8) if variant != "tiny" \
        else {}
    jcfg, tcfg = _cfgs(**over)
    jp, tp = _params(jcfg)
    kw = dict(loss_type="gepo", group_size=4, beta_kl=0.005)
    jrl, trl = JRLConfig(**kw), RLConfig(**kw)
    tc_kw = dict(learning_rate=1e-3, grad_accum=accum, total_steps=10)
    jtc, ttc = JTrainConfig(**tc_kw), TrainConfig(**tc_kw)
    batch = _batch(7, s=20 if variant != "tiny" else 10)
    jstate = jtraining.init_state(jcfg, jtc, jp)
    jnew, jm = jtraining.train_step(jcfg, jrl, jtc, jstate, _j(batch))
    tstate = ttraining.init_state(tcfg, ttc, tp)
    tnew, tm = ttraining.train_step(tcfg, trl, ttc, tstate, _t(batch))
    assert set(tm) == set(jm)
    for k, v in tm.items():
        assert v.dim() == 0 and v.device == torch.device("cpu"), k
    _close_metrics(tm, jm, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(float(tm["iw_max"]), float(jm["iw_max"]),
                               rtol=1e-5)
    assert int(tnew.step) == int(jnew.step) == 1
    _assert_trees(tnew.params, jnew.params, rtol=1e-4, atol=1e-5)
    _assert_trees(tnew.opt.m, jnew.opt.m, rtol=1e-4, atol=1e-8)


def test_train_step_adafactor_and_second_step_match_jax():
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    kw = dict(loss_type="gspo", group_size=4)
    jrl, trl = JRLConfig(**kw), RLConfig(**kw)
    jtc = JTrainConfig(learning_rate=1e-3, total_steps=10, grad_clip=0.1)
    ttc = TrainConfig(learning_rate=1e-3, total_steps=10, grad_clip=0.1)
    js = jtraining.init_state(jcfg, jtc, jp, optimizer="adafactor")
    ts = ttraining.init_state(tcfg, ttc, tp, optimizer="adafactor")
    for seed in (8, 9):
        batch = _batch(seed)
        js, jm = jtraining.train_step(jcfg, jrl, jtc, js, _j(batch),
                                      optimizer="adafactor")
        ts, tm = ttraining.train_step(tcfg, trl, ttc, ts, _t(batch),
                                      optimizer="adafactor")
        _close_metrics(tm, jm, rtol=1e-4, atol=1e-6)
    _assert_trees(ts.params, js.params, rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# the sampler side


@pytest.mark.parametrize("impl", ["fused", "naive"])
def test_sft_loss_and_token_logps_match_jax(impl):
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    rng = np.random.default_rng(12)
    toks = rng.integers(3, 32, (4, 12)).astype(np.int32)
    mask = (rng.random((4, 11)) > 0.3).astype(np.float32)
    jl, jg = jax.value_and_grad(lambda p: jtraining.sft_loss_fn(
        jcfg, p, jnp.asarray(toks), jnp.asarray(mask),
        logprob_impl=impl))(jp)
    leaves = toptim.tree_leaves(tp)
    for leaf in leaves:
        leaf.requires_grad_(True)
    tl = ttraining.sft_loss_fn(tcfg, tp, torch.from_numpy(toks),
                               torch.from_numpy(mask), logprob_impl=impl)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    for a, b in zip(torch.autograd.grad(tl, leaves), _leaves_np(jg)):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-4, atol=1e-6)
    got = token_logps(tcfg, tp, torch.from_numpy(toks), logprob_impl=impl)
    want = jtoken_logps(jcfg, jp, jnp.asarray(toks), logprob_impl=impl)
    assert not got.requires_grad and got.shape == (4, 11)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_rollout_from_results_matches_jax():
    rng = np.random.default_rng(13)
    prompts = rng.integers(3, 32, (3, 5)).astype(np.int32)
    lens = (4, 0, 6)                       # the second request expired
    res, jres = [], []
    for i, n in enumerate(lens):
        kw = dict(rid=i, tokens=rng.integers(3, 32, n).astype(np.int32),
                  logps=-rng.random(n).astype(np.float32),
                  finish_reason="length" if n else "expired", prompt_len=5)
        res.append(GenerationResult(**kw))
        jres.append(JGenerationResult(**kw))
    got = rollout_from_results(prompts, res, 6, device="cpu")
    want = jrollout(prompts, jres, 6)
    assert got["prompt_len"] == want["prompt_len"] == 5
    for k in ("tokens", "completions", "sampler_lp", "comp_mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def test_generate_continuous_greedy_matches_jax():
    """Greedy decoding is independent of either package's noise source:
    same tokens, and sampler logps within 1e-4; then the App. B.1
    recompute assembles the batch the way hetero/nodes.py does."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    greedy = dict(temperature=1.0, top_k=1, top_p=1.0, max_new_tokens=6)
    prompts = np.random.default_rng(14).integers(3, 32, (4, 7)).astype(
        np.int32)
    kw = dict(num_slots=2, page_size=4, prefill_chunk=4, sync_every=3)
    want = jgenerate(jcfg, JRLConfig(**greedy), jp, jnp.asarray(prompts),
                     jax.random.PRNGKey(0), prompt_lens=[7, 5, 7, 3], **kw)
    got = generate_continuous(tcfg, RLConfig(**greedy), tp, prompts,
                              key=PRNGKey(0), prompt_lens=[7, 5, 7, 3], **kw)
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["comp_mask"].numpy(),
                                  np.asarray(want["comp_mask"]))
    np.testing.assert_allclose(got["sampler_lp"].numpy(),
                               np.asarray(want["sampler_lp"]), atol=1e-4)
    assert got["stats"]["decode_steps"] > 0
    lp = token_logps(tcfg, tp, got["tokens"])
    comp = lp[:, prompts.shape[1] - 1:]
    live = got["comp_mask"] > 0
    # full prompts: the recompute agrees with the engine's own logps
    rows = torch.tensor([0, 2])
    torch.testing.assert_close(comp[rows][live[rows]],
                               got["sampler_lp"][rows][live[rows]],
                               rtol=0, atol=1e-4)


def test_rl_loss_fn_refuses_modality_memory():
    """The modality stubs ride in the batch, as in the JAX package (the
    families that use them are held in ``tests/test_torch_memory.py``). A
    model without cross-attention or an encoder (``TINY``) refuses
    ``frames``, which need an encoder (the reference asserts
    ``cfg.is_encdec``), and leaves ``image_embeds`` unread: its loss and
    metrics are the reference's on the same batch, and the loss is the
    one the batch gives without them."""
    jcfg, tcfg = _cfgs()
    jp, tp = _params(jcfg)
    rl = RLConfig(group_size=4)
    batch = _batch(1)
    frames = dict(batch, frames=np.zeros((8, 4, 48), np.float32))
    with pytest.raises(ValueError, match="no encoder"):
        ttraining.rl_loss_fn(tcfg, rl, tp, _t(frames))
    with pytest.raises(AssertionError):
        jtraining.rl_loss_fn(jcfg, JRLConfig(group_size=4), jp, _j(frames))
    embeds = dict(batch, image_embeds=np.random.default_rng(2).standard_normal(
        (8, 5, 48)).astype(np.float32))
    jl, jm = jtraining.rl_loss_fn(jcfg, JRLConfig(group_size=4), jp,
                                  _j(embeds))
    with torch.no_grad():
        tl, tm = ttraining.rl_loss_fn(tcfg, rl, tp, _t(embeds))
        plain, _ = ttraining.rl_loss_fn(tcfg, rl, tp, _t(batch))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
    _close_metrics(tm, jm)
    assert float(tl) == float(plain)
