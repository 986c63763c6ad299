"""The HeteroRL loop of the PyTorch port as a whole, on the CPU: the
event-sim runtime and the online control held to the thresholds of
``tests/test_hetero.py::TestRuntime`` and ``tests/test_system.py`` (the
reference cannot run its own loop under jax 0.9.0: every
``ExecutionPlan`` path fails), on the same ``TINY`` models.

Torch runs one thread in this module: its models are tiny, and under the
suite's parallel workers a pool of threads per process only contends.
"""
import numpy as np
import pytest
import torch

from repro_torch import training as ttraining
from repro_torch.config import HeteroConfig, ModelConfig, RLConfig, TrainConfig
from repro_torch.data import ArithmeticTask, Tokenizer
from repro_torch.hetero import HeteroRuntime, run_online
from repro_torch.launch import train as tlaunch
from repro_torch.models import init_params
from repro_torch.optim import tree_leaves
from repro_torch.transport import ChunkSubscriber

SHAPE = dict(name="tiny", family="dense", num_layers=2, d_model=48,
             num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=32,
             dtype="float32", attn_impl="naive", remat=False,
             rope_theta=1e4)
# tests/test_hetero.py's TINY, RL and TC
TINY = ModelConfig(**SHAPE)
RL = RLConfig(loss_type="gepo", group_size=4, max_new_tokens=4,
              beta_kl=0.005, temperature=1.0, top_k=0, top_p=1.0)
TC = TrainConfig(learning_rate=1e-3, total_steps=50)
# tests/test_system.py's TINY
TINY64 = ModelConfig(**dict(SHAPE, d_model=64, d_ff=128))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _storages(tree):
    return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)}


# --------------------------------------------------------------------------
# the runtime (tests/test_hetero.py::TestRuntime)


def _runtime(seed=0, **h):
    kw = dict(num_samplers=2, max_delay_steps=8, delay_median_s=120.0,
              seed=seed)
    kw.update(h)
    task = ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=seed)
    state = ttraining.init_state(TINY, TC, init_params(TINY, seed,
                                                       device="cpu"))
    return HeteroRuntime(TINY, RL, TC, HeteroConfig(**kw), task, Tokenizer(),
                         state, prompts_per_batch=4, learner_step_s=28.125,
                         device="cpu")


def test_runtime_deterministic_given_seed():
    h1 = _runtime(seed=3).run(8)
    h2 = _runtime(seed=3).run(8)
    np.testing.assert_array_equal(h1.get("staleness"), h2.get("staleness"))
    np.testing.assert_allclose(h1.get("loss"), h2.get("loss"), rtol=1e-6)


def test_runtime_staleness_bounded_by_window():
    rt = _runtime(seed=4, max_delay_steps=8)
    hist = rt.run(12)
    assert hist.get("staleness").max() <= 8
    assert rt.transport.messages_sent > 0


def test_online_is_zero_staleness():
    task = ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=0)
    state = ttraining.init_state(TINY, TC, init_params(TINY, 0,
                                                       device="cpu"))
    hist, _, learner = run_online(TINY, RL, TC, task, Tokenizer(), state,
                                  num_steps=5, prompts_per_batch=4,
                                  device="cpu")
    assert hist.get("staleness").max() == 0.0
    assert learner.step == 5


def test_hetero_staleness_grows_with_delay():
    slow = _runtime(seed=5, delay_median_s=1500.0).run(12)
    fast = _runtime(seed=5, delay_median_s=60.0).run(12)
    assert slow.get("staleness").mean() > fast.get("staleness").mean()


def test_samplers_hold_the_version_they_are_stamped_with():
    """A sampler's weights are the published version it says it holds —
    not the learner's newest (which an alias would give) — and the
    transport telemetry adds up."""
    rt = _runtime(seed=6, delay_median_s=120.0)
    rt.run(10)
    versions = {s.version for s in rt.samplers}
    assert max(versions) > 0 and min(versions) < rt.learner.step
    for s in rt.samplers:
        assert not _storages(s.params) & _storages(rt.learner.state)
        _, held, _ = ChunkSubscriber(rt.store).sync(s.params,
                                                    version=s.version)
        for a, b in zip(tree_leaves(held), tree_leaves(s.params)):
            assert torch.equal(a, b)
    rows = rt.sync_telemetry()
    assert [r["sampler"] for r in rows] == [0.0, 1.0, -1.0]
    assert rows[-1]["syncs"] == 10.0
    assert sum(r["syncs"] for r in rows[:-1]) == sum(s.syncs
                                                    for s in rt.samplers)
    assert all(r["bytes_on_wire"] > 0 for r in rows)


# --------------------------------------------------------------------------
# the loop's contract (tests/test_system.py's thresholds)


@pytest.fixture(scope="module")
def warm_state():
    task = ArithmeticTask(max_operand=9, ops="+", prompt_width=5, seed=0)
    tok = Tokenizer()
    tc = TrainConfig(learning_rate=1e-2, total_steps=250)
    state = ttraining.init_state(TINY64, tc, init_params(TINY64, 0,
                                                         device="cpu"))
    state, loss = tlaunch.sft_warmstart(TINY64, tc, task, tok, state,
                                        steps=250, batch=64)
    return state, task, tok, loss


def _fresh(state):
    return state._replace(step=torch.zeros_like(state.step))


def test_sft_warmstart_reaches_the_loss_bar(warm_state):
    assert warm_state[3] < 2.0


def test_online_rl_runs_and_logs_diagnostics(warm_state):
    state, task, tok, _ = warm_state
    rl = RLConfig(loss_type="gepo", group_size=4, beta_kl=0.0,
                  max_new_tokens=5, temperature=1.0, top_k=0, top_p=1.0)
    tc = TrainConfig(learning_rate=1e-3, total_steps=12)
    hist, evals, learner = run_online(
        TINY64, rl, tc, task, tok, _fresh(state), num_steps=12,
        prompts_per_batch=4,
        eval_fn=tlaunch.make_eval_fn(TINY64, rl, task, tok, n_prompts=8),
        eval_every=6, device="cpu")
    assert learner.step == 12
    for key in ("iw_var", "kl", "est_error", "reward_mean", "grad_norm"):
        vals = hist.get(key)
        assert len(vals) == 12 and np.isfinite(vals).all(), key
    assert len(evals) == 2
    assert hist.get("kl").max() < 0.3
    assert abs(hist.get("iw_mean") - 1.0).max() < 0.5


def test_hetero_rl_staleness_and_stability_metrics(warm_state):
    state, task, tok, _ = warm_state
    rl = RLConfig(loss_type="gepo", group_size=4, beta_kl=0.005,
                  max_new_tokens=5, temperature=1.0, top_k=0, top_p=1.0)
    tc = TrainConfig(learning_rate=1e-3, total_steps=10)
    hcfg = HeteroConfig(num_samplers=2, max_delay_steps=64,
                        delay_median_s=600.0, seed=1)
    rt = HeteroRuntime(TINY64, rl, tc, hcfg, task, tok, _fresh(state),
                       prompts_per_batch=4, device="cpu")
    hist = rt.run(10)
    assert rt.learner.step == 10
    stale = hist.get("staleness")
    assert 0 < stale.max() <= 64
    assert np.isfinite(hist.get("iw_var")).all()


def test_gepo_weights_stay_bounded_under_staleness(warm_state):
    state, task, tok, _ = warm_state
    rl = RLConfig(loss_type="gepo", group_size=4, beta_kl=0.005,
                  max_new_tokens=5, temperature=1.0, top_k=0, top_p=1.0)
    tc = TrainConfig(learning_rate=2e-3, total_steps=16)
    hcfg = HeteroConfig(num_samplers=2, max_delay_steps=64,
                        delay_median_s=1500.0, seed=2,
                        delay_distribution="weibull")
    rt = HeteroRuntime(TINY64, rl, tc, hcfg, task, tok, _fresh(state),
                       prompts_per_batch=4, device="cpu")
    hist = rt.run(16)
    assert float(hist.get("iw_max").max()) < 50.0
