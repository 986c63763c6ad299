"""The HeteroRL loop of the PyTorch port, piece by piece: the SFT step,
the learner and sampler nodes and the train launcher, on the CPU (the
runtime and the loop's contract are in ``test_torch_hetero_loop.py``).

The reference cannot run its loop end to end under jax 0.9.0 (every
``ExecutionPlan`` path fails), so each piece is held against the JAX
package's entry points that still run without a plan, on the same
float32 inputs made from numpy seeds and the same weights
(``params_from_numpy``):

- the SFT step against ``jax.value_and_grad(sft_loss_fn)``, then the
  reference's clip, warm-up and ``adamw_update`` called directly;
- ``LearnerNode.train_on`` against ``repro.training.train_step``;
- a greedy ``SamplerNode`` batch against the reference's continuous
  engine (``paged_attn_impl="ref"``, built without a plan), its
  ``score_rollouts`` and ``token_logps``.

Tolerances are those of ``test_torch_training.py``'s ``train_step``
parity: metrics and losses rtol 1e-4 + 1e-6 abs, params after the update
rtol 1e-4 + 1e-5 abs; the sampler's recomputed log-probs 1e-5.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro import training as jtraining
from repro.config import ATTN as JATTN
from repro.config import MLP as JMLP
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.config import ServeConfig as JServeConfig
from repro.config import TrainConfig as JTrainConfig
from repro.data import pipeline as jpipeline
from repro.data import tasks as jtasks
from repro.models import init_params as jinit_params
from repro.sampling import build_engine as jbuild_engine
from repro.sampling import rollout_from_results as jrollout
from repro.sampling import token_logps as jtoken_logps
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import training as ttraining
from repro_torch.checkpoint import PolicyStore
from repro_torch.config import (HeteroConfig, ModelConfig, RLConfig,
                                ServeConfig, TrainConfig)
from repro_torch.data import ArithmeticTask, PromptPipeline, Tokenizer
from repro_torch.data.tasks import EOS
from repro_torch.hetero import LearnerNode, RolloutBatch, SamplerNode
from repro_torch.launch import train as tlaunch
from repro_torch.models import init_params, params_from_numpy
from repro_torch.optim import tree_leaves
from repro_torch.parallel import local_plan
from repro_torch.transport import ChunkSubscriber, publish_params

ROOT = Path(__file__).resolve().parents[1]
SHAPE = dict(name="tiny", family="dense", num_layers=2, d_model=48,
             num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=32,
             dtype="float32", attn_impl="naive", remat=False,
             rope_theta=1e4)
# tests/test_hetero.py's TINY and RL
TINY = ModelConfig(block_pattern=("attn",), ffn_pattern=("mlp",), **SHAPE)
RL = RLConfig(loss_type="gepo", group_size=4, max_new_tokens=4,
              beta_kl=0.005, temperature=1.0, top_k=0, top_p=1.0)
GREEDY = dict(temperature=1.0, top_k=1, top_p=1.0)


def _jparams(seed=0):
    jcfg = JModelConfig(block_pattern=(JATTN,), ffn_pattern=(JMLP,),
                        **SHAPE)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, jp, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _assert_trees(got, want, rtol=1e-4, atol=1e-5):
    g = [t.detach().numpy() for t in tree_leaves(got)]
    w = [np.asarray(a) for a in jax.tree_util.tree_leaves(want)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)}


# --------------------------------------------------------------------------
# the SFT step


def _sft_rows(task, tok, batch):
    """The rows and masks ``repro/launch/train.py::sft_warmstart`` builds."""
    width = task.prompt_width + 8
    rows, masks = [], []
    for p in task.sample_batch(batch):
        ids = tok.encode(p.prompt) + tok.encode(p.answer) + [EOS]
        m = ([0.0] * (len(tok.encode(p.prompt)) - 1)
             + [1.0] * (len(tok.encode(p.answer)) + 1))
        ids += [0] * (width - len(ids))
        m += [0.0] * (width - 1 - len(m))
        rows.append(ids[:width])
        masks.append(m[:width - 1])
    return (jnp.asarray(rows, jnp.int32), jnp.asarray(masks, jnp.float32))


@pytest.mark.parametrize("impl", ["fused", "naive"])
def test_sft_warmstart_matches_jax_steps(impl):
    jcfg, jp, tp = _jparams()
    # the train_step parity's learning rate: AdamW's first steps scale
    # each gradient element to about +-lr, so an element whose gradient
    # sits near eps turns a float32 summation-order difference into up to
    # lr of param difference
    kw = dict(learning_rate=1e-3, total_steps=10, logprob_impl=impl)
    jtc, ttc = JTrainConfig(**kw), TrainConfig(**kw)
    jstate = jtraining.init_state(jcfg, jtc, jp)
    jtask = jtasks.ArithmeticTask(max_operand=9, ops="+", prompt_width=5,
                                  seed=4)
    losses = []
    for _ in range(2):
        toks, mask = _sft_rows(jtask, jtasks.Tokenizer(), 8)
        loss, grads = jax.value_and_grad(lambda p: jtraining.sft_loss_fn(
            jcfg, p, toks, mask, logprob_impl=impl))(jstate.params)
        grads, _ = joptim.clip_by_global_norm(grads, jtc.grad_clip)
        lr = joptim.warmup_schedule(jtc, jstate.step)
        params, opt = joptim.adamw_update(jtc, grads, jstate.opt,
                                          jstate.params, lr)
        jstate = jtraining.TrainState(params, opt, jstate.step + 1)
        losses.append(float(loss))
    tstate = ttraining.init_state(TINY, ttc, tp)
    ttask = ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=4)
    tstate, tloss = tlaunch.sft_warmstart(TINY, ttc, ttask, Tokenizer(),
                                          tstate, steps=1, batch=8)
    np.testing.assert_allclose(tloss, losses[0], rtol=1e-4, atol=1e-6)
    tstate, tloss = tlaunch.sft_warmstart(TINY, ttc, ttask, Tokenizer(),
                                          tstate, steps=1, batch=8)
    np.testing.assert_allclose(tloss, losses[1], rtol=1e-4, atol=1e-6)
    assert int(tstate.step) == int(jstate.step) == 2
    _assert_trees(tstate.params, jstate.params)
    _assert_trees(tstate.opt.m, jstate.opt.m, atol=1e-8)


# --------------------------------------------------------------------------
# the learner node


def _batch(seed, b=8, s=10, vocab=32):
    rng = np.random.default_rng(seed)
    mask = np.ones((b, s - 1), np.float32)
    mask[:, :3] = 0.0
    for i in range(b):
        mask[i, s - 1 - (i % 3):] = 0.0
    return {"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
            "mask": mask,
            "sampler_lp": -np.abs(rng.standard_normal((b, s - 1))).astype(
                np.float32),
            "rewards": (rng.random(b) > 0.5).astype(np.float32)}


@pytest.mark.parametrize("accum", [1, 2])
def test_learner_node_matches_jax_train_step(accum):
    """One ``train_on`` against the reference ``train_step``; the node
    trains a clone (the caller's state is bit-identical afterwards) and
    publishes versions 0 and 1; a sampler built from the learner's params
    shares no storage with them."""
    jcfg, jp, tp = _jparams(1)
    kw = dict(loss_type="gepo", group_size=4, beta_kl=0.005)
    tc_kw = dict(learning_rate=1e-3, grad_accum=accum, total_steps=10)
    jtc, ttc = JTrainConfig(**tc_kw), TrainConfig(**tc_kw)
    batch = _batch(7)
    jnew, jm = jtraining.train_step(
        jcfg, JRLConfig(**kw), jtc, jtraining.init_state(jcfg, jtc, jp),
        {k: jnp.asarray(v) for k, v in batch.items()})
    caller = ttraining.init_state(TINY, ttc, tp)
    before = [t.clone() for t in tree_leaves(caller)]
    store = PolicyStore()
    learner = LearnerNode(TINY, RLConfig(**kw), ttc, HeteroConfig(), caller,
                          store, device="cpu")
    assert not _storages(learner.state) & _storages(caller)
    learner.receive(0.0, RolloutBatch(version=0, created_s=0.0,
                                      sampler_id=0, **batch))
    out = learner.train_on(learner.pop_eligible(0.0))
    assert set(out) == set(jm) | {"staleness", "buffer_len"}
    for k, v in jm.items():
        np.testing.assert_allclose(out[k], float(v), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert out["staleness"] == 0.0 and learner.step == 1
    _assert_trees(learner.state.params, jnew.params)
    for a, b in zip(tree_leaves(caller), before):
        assert torch.equal(a, b)
    assert store.latest_version() == 1
    sampler = SamplerNode(0, TINY, RL, None, None, Tokenizer(),
                          learner.state.params, store, HeteroConfig(),
                          seed=0, device="cpu")
    assert not _storages(sampler.params) & _storages(learner.state)
    _, host, _ = ChunkSubscriber(store).sync(learner.state.params)
    for a, b in zip(tree_leaves(host), tree_leaves(learner.state.params)):
        assert torch.equal(a, b)


# --------------------------------------------------------------------------
# the sampler node


def test_sampler_node_greedy_batch_matches_jax():
    jcfg, jp, tp = _jparams(2)
    rl_kw = dict(loss_type="gepo", group_size=4, max_new_tokens=4,
                 engine="continuous", **GREEDY)
    trl, jrl = RLConfig(**rl_kw), JRLConfig(**rl_kw)
    tok, jtok = Tokenizer(), jtasks.Tokenizer()
    task = ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=3)
    node = SamplerNode(0, TINY, trl, PromptPipeline(task, tok, 3, 4), task,
                       tok, tp, PolicyStore(), HeteroConfig(), seed=5,
                       device="cpu")
    got = node.generate_batch(2.5)
    jtask = jtasks.ArithmeticTask(max_operand=9, ops="+", prompt_width=5,
                                  seed=3)
    req = jpipeline.PromptPipeline(jtask, jtok, 3, 4).next_batch()
    b, tp_ = req.prompts.shape
    jeng = jbuild_engine(jcfg, jp, JServeConfig(
        engine="continuous", max_total_tokens=tp_ + 4, num_slots=8,
        paged_attn_impl="ref"), rl=jrl, vocab_limit=jtok.vocab_size,
        key=jax.random.PRNGKey(0))
    sp = JSamplingParams.from_rl(jrl)
    res = jeng.generate([JRequest(rid=r, prompt=req.prompts[r], params=sp)
                         for r in range(b)])
    roll = jrollout(req.prompts, res, 4)
    rewards = jpipeline.score_rollouts(jtask, jtok, req.problems,
                                       np.asarray(roll["completions"]), 4)
    lp = np.asarray(jtoken_logps(jcfg, jp, roll["tokens"],
                                 logprob_impl="fused"))[:, tp_ - 1:]
    zeros = np.zeros((b, tp_ - 1), np.float32)
    np.testing.assert_array_equal(got.tokens, np.asarray(roll["tokens"]))
    np.testing.assert_array_equal(got.mask, np.concatenate(
        [zeros, np.asarray(roll["comp_mask"])], 1))
    np.testing.assert_array_equal(got.rewards, rewards)
    np.testing.assert_allclose(got.sampler_lp, np.concatenate([zeros, lp], 1),
                               rtol=0, atol=1e-5)
    assert (got.version, got.created_s, got.sampler_id) == (0, 2.5, 0)
    assert node.engine_stats["decode_steps"] > 0
    assert node.warmup_tokens == int(got.mask.sum()) > 0


class _FixedPipeline(PromptPipeline):
    """The same request every batch."""

    def next_batch(self):
        if not hasattr(self, "_req"):
            self._req = super().next_batch()
        return self._req


def test_sampler_batches_draw_afresh_and_replay_from_the_seed():
    tok = Tokenizer()
    params = init_params(TINY, 0, device="cpu")

    def node(seed):
        task = ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=0)
        return SamplerNode(0, TINY, RL, _FixedPipeline(task, tok, 2, 4),
                           task, tok, params, PolicyStore(), HeteroConfig(),
                           seed=seed, device="cpu")

    a = node(3)
    first, second = a.generate_batch(0.0), a.generate_batch(1.0)
    assert np.array_equal(first.tokens[:, :5], second.tokens[:, :5])
    assert not np.array_equal(first.tokens, second.tokens)
    b = node(3)
    np.testing.assert_array_equal(b.generate_batch(0.0).tokens, first.tokens)
    np.testing.assert_array_equal(b.generate_batch(1.0).tokens, second.tokens)
    assert a.gen_seconds > 0.0 and a.tokens_generated > 0
    assert a.tokens_per_s == a.tokens_generated / a.gen_seconds


@pytest.mark.parametrize("recompute", [False, True])
def test_synced_sampler_serves_the_new_weights(recompute):
    """A node that generated under the old weights, then synced, serves
    what a fresh node built from the new weights serves: the engine's
    prefix cache (keyed on tokens only) must not hand it KV computed
    under the old weights. Without the recompute the batch's log-probs
    are the engine's own, so stale KV would show in them too."""
    tok = Tokenizer()
    rl = RLConfig(loss_type="gepo", group_size=4, max_new_tokens=4,
                  engine="continuous", recompute_sampler_logps=recompute,
                  **GREEDY)
    old = init_params(TINY, 0, device="cpu")
    new = init_params(TINY, 1, device="cpu")

    def node(params, store):
        task = ArithmeticTask(max_operand=9, ops="+", prompt_width=20,
                              seed=0)
        return SamplerNode(0, TINY, rl, _FixedPipeline(task, tok, 2, 4),
                           task, tok, params, store, HeteroConfig(), seed=3,
                           device="cpu")

    store = PolicyStore()
    publish_params(store, 0, local_plan(), TINY, old)
    synced = node(old, store)
    synced.generate_batch(0.0)
    assert synced._gen_engine.prefix_cache.stats["inserts"] > 0
    publish_params(store, 1, local_plan(), TINY, new)
    assert synced.sync() > 0 and synced.version == 1
    got = synced.generate_batch(1.0)
    want = node(new, PolicyStore()).generate_batch(1.0)
    assert got.version == 1
    np.testing.assert_array_equal(got.tokens, want.tokens)
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_allclose(got.sampler_lp, want.sampler_lp, rtol=0,
                               atol=1e-6)


def test_sampler_paged_attn_impl_threads_into_cfg():
    def node(hcfg):
        return SamplerNode(0, TINY, RL, None, None, Tokenizer(),
                           init_params(TINY, 0, device="cpu"),
                           PolicyStore(), hcfg, seed=0, device="cpu")

    assert node(HeteroConfig()).cfg.paged_attn_impl == "auto"
    assert node(HeteroConfig(paged_attn_impl="ref")).cfg.paged_attn_impl \
        == "ref"


def test_nodes_default_to_cuda_and_refuse_what_is_not_ported(tmp_path):
    """A node defaults to the card; a sampler mesh needs its ranks; on a
    live serve plan (here a one-rank gloo group's 1x1 mesh, every
    collective live; the 1x2 cases run in
    tests/test_torch_serve_plan.py) the static engine serves the
    one-device tokens, on the ``serve`` and the ``long`` plan, and so do
    the continuous engine on the ``long`` plan and a MoE config on the
    ``serve`` plan, which raised before they were ported."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        SamplerNode(0, TINY, RL, None, None, Tokenizer(),
                    init_params(TINY, 0, device="cpu"), PolicyStore(),
                    HeteroConfig(), seed=0)
    assert HeteroConfig(sampler_mesh="1x2").sampler_mesh == "1x2"
    with pytest.raises(ValueError, match="DxM"):
        HeteroConfig(sampler_mesh="two")
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 2"):
        SamplerNode(0, TINY, RL, None, None, Tokenizer(),
                    init_params(TINY, 0, device="cpu"), PolicyStore(),
                    HeteroConfig(sampler_mesh="1x2"), seed=0, device="cpu")
    assert HeteroConfig(spec_k=2).spec_k == 2
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        tlaunch.main(["--device", "cpu", "--mesh", "2x2"])
    import datetime

    import torch.distributed as dist
    from repro_torch.configs import smoke
    from repro_torch.parallel import ExecutionPlan, make_debug_mesh
    from repro_torch.sampling import build_engine, generate
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_debug_mesh(1, 1, device="cpu")
        serve = ExecutionPlan(mesh, "serve")
        params = init_params(TINY, 0, device="cpu")
        prompts = np.full((2, 4), 5)
        want = generate(TINY, RL, params, prompts, engine="static")
        for plan in (serve, ExecutionPlan(mesh, "long")):
            eng = build_engine(TINY, params, ServeConfig(engine="static"),
                               rl=RL, plan=plan)
            assert eng.shard is not None
            got = generate(TINY, RL, params, prompts, engine="static",
                           plan=plan)
            assert torch.equal(got["tokens"], want["tokens"])
        kw = dict(engine="continuous", num_slots=2, page_size=4,
                  prefill_chunk=3, sync_every=2)
        want = generate(TINY, RL, params, prompts, **kw)
        long = ExecutionPlan(mesh, "long")
        assert build_engine(TINY, params, ServeConfig(),
                            plan=long).shard is not None
        got = generate(TINY, RL, params, prompts, plan=long, **kw)
        assert torch.equal(got["tokens"], want["tokens"])
        scout = smoke("llama4-scout-17b-a16e")
        sp = init_params(scout, 0, device="cpu")
        assert build_engine(scout, sp, ServeConfig(),
                            plan=serve).shard.experts == (0, 4)
        want = generate(scout, RL, sp, prompts, **kw)
        got = generate(scout, RL, sp, prompts, plan=serve, **kw)
        assert torch.equal(got["tokens"], want["tokens"])
    finally:
        dist.destroy_process_group()


def test_train_launcher_runs_hetero_on_the_cpu(tmp_path):
    out = tmp_path / "summary.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--mode", "hetero", "--steps", "2", "--sft-steps", "2",
         "--num-samplers", "2", "--out", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    assert "[train] SFT warm start done" in proc.stdout
    summary = json.loads(out.read_text())
    assert summary["mode"] == "hetero" and summary["steps"] == 2
    assert '"staleness_mean"' in proc.stdout
    assert np.isfinite(summary["kl_mean"])
