"""The threaded HeteroRL runtime of the PyTorch port, on the CPU.

``ThreadedHeteroRuntime`` runs the learner and the sampler nodes as OS
threads on wall-clock delays. The reference's own test
(``tests/test_hetero.py::TestThreadedRuntime``) fails under jax 0.9.0
(every ``ExecutionPlan`` path does), so the port is held to that test's
thresholds on the same ``TINY`` model: the learner takes every step,
staleness stays within the window, the loss is finite. Also held: spec
samplers (the accept-rate gauge and the drafted counter set), the
sampler node's bounded retry of a sync that lost the publisher's prune
race, and the loop skipping a sync round that still fails.

Torch runs one thread in this module, as in ``test_torch_hetero_loop.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch import training as ttraining
from repro_torch.checkpoint import PolicyStore
from repro_torch.config import HeteroConfig, ModelConfig, RLConfig, TrainConfig
from repro_torch.data import ArithmeticTask, PromptPipeline, Tokenizer
from repro_torch.hetero import SamplerNode, ThreadedHeteroRuntime
from repro_torch.models import init_params
from repro_torch.optim import tree_leaves
from repro_torch.parallel import local_plan
from repro_torch.transport import publish_params

SHAPE = dict(name="tiny", family="dense", num_layers=2, d_model=48,
             num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=32,
             dtype="float32", attn_impl="naive", remat=False,
             rope_theta=1e4)
# tests/test_hetero.py's TINY, RL and TC
TINY = ModelConfig(**SHAPE)
RL = RLConfig(loss_type="gepo", group_size=4, max_new_tokens=4,
              beta_kl=0.005, temperature=1.0, top_k=0, top_p=1.0)
TC = TrainConfig(learning_rate=1e-3, total_steps=50)
# spec samplers serve through the continuous engine; 12 new tokens leave
# rounds after the first chunk, where the drafter has a history to match
RL_SPEC = dataclasses.replace(RL, engine="continuous", max_new_tokens=12)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _runtime(rl=RL, time_scale=5e-3, **h):
    kw = dict(num_samplers=2, max_delay_steps=16, delay_median_s=120.0,
              seed=7)
    kw.update(h)
    task = ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=7)
    state = ttraining.init_state(TINY, TC, init_params(TINY, 7,
                                                       device="cpu"))
    return ThreadedHeteroRuntime(TINY, rl, TC, HeteroConfig(**kw), task,
                                 Tokenizer(), state, prompts_per_batch=4,
                                 time_scale=time_scale, device="cpu")


def _check_contract(rt, hist, steps):
    """tests/test_hetero.py::TestThreadedRuntime's thresholds, and no
    sampler thread alive after the run."""
    assert rt.learner.step == steps
    assert hist.get("staleness").max() <= 16
    assert np.isfinite(hist.get("loss")).all()
    assert not any(t.is_alive() for t in rt.threads)
    assert not rt.errors


def test_real_async_trains_and_bounds_staleness():
    rt = _runtime()
    hist = rt.run(6)
    _check_contract(rt, hist, 6)
    assert sum(s.batches_generated for s in rt.samplers) >= 6


@pytest.fixture
def _obs_on():
    obs.configure(True, clear=True)
    yield
    obs.configure(False, clear=True)


def test_spec_samplers_train_and_report_drafts(_obs_on):
    rt = _runtime(rl=RL_SPEC, spec_k=2)
    hist = rt.run(6)
    _check_contract(rt, hist, 6)
    snap = obs.metrics.snapshot()
    drafted = 0
    for s in rt.samplers:
        st = s.engine_stats
        assert st["spec_rounds"] + st["spec_fallback_chunks"] > 0
        lab = f'{{sampler="{s.sid}"}}'
        assert snap[f"sampler_accept_rate{lab}"] == st["accept_rate"]
        assert snap[f"sampler_drafted_tokens_total{lab}"] == \
            st["drafted_tokens_total"]
        drafted += st["drafted_tokens_total"]
    assert drafted > 0
    assert snap["engine_spec_rounds_total"] > 0


def _node_and_store():
    """A sampler at version 0 and a store holding version 1."""
    tok = Tokenizer()
    task = ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=0)
    store = PolicyStore()
    publish_params(store, 0, local_plan(), TINY,
                   init_params(TINY, 0, device="cpu"))
    node = SamplerNode(0, TINY, RL, PromptPipeline(task, tok, 2, 4), task,
                       tok, init_params(TINY, 0, device="cpu"), store,
                       HeteroConfig(), seed=0, device="cpu")
    new = init_params(TINY, 1, device="cpu")
    publish_params(store, 1, local_plan(), TINY, new)
    return node, new


def test_sync_retries_a_pruned_manifest(monkeypatch):
    node, new = _node_and_store()
    real, calls = node.subscriber.sync, []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise KeyError("chunk pruned by the publisher")
        return real(*a, **kw)

    monkeypatch.setattr(node.subscriber, "sync", flaky)
    assert node.sync() > 0
    assert len(calls) == 2 and node.version == 1 and node.syncs == 1
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(node.params),
                                                 tree_leaves(new)))


def test_sync_raises_after_three_attempts(monkeypatch):
    node, _ = _node_and_store()
    calls = []

    def pruned(*a, **kw):
        calls.append(1)
        raise KeyError("chunk pruned by the publisher")

    monkeypatch.setattr(node.subscriber, "sync", pruned)
    with pytest.raises(KeyError):
        node.sync()
    assert len(calls) == 3 and node.version == 0 and node.syncs == 0


def test_threaded_loop_skips_a_failed_sync_round(monkeypatch):
    def pruned(self):
        raise KeyError("chunk pruned by the publisher")

    monkeypatch.setattr(SamplerNode, "sync", pruned)
    # 1 simulated second = 0.1 ms: every batch is past its sync time
    rt = _runtime(time_scale=1e-4)
    hist = rt.run(3)
    _check_contract(rt, hist, 3)
    assert rt.skipped_syncs > 0
    assert all(s.version == 0 for s in rt.samplers)
