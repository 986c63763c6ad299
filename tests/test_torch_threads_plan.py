"""``ThreadedHeteroRuntime`` on a live 1x2 sampler plan on the CPU: two
gloo rank processes (``tests/_torch_serve_ranks.py``'s "threads" case).

Sampler threads reach their collectives in wall-clock order, which
differs by rank, so rank 0 alone runs the threads and the learner loop,
broadcasting each collective section (a sampler's batch, its sync, the
learner's step) before it runs it under one runtime lock, and rank 1
replays that sequence. Held: both ranks return the same batches (tokens,
versions, sampler logps) in the same order and the same learner history
(staleness, loss, KL, IW variance: rank 0's order), the thresholds of the
reference's ``tests/test_hetero.py::TestThreadedRuntime`` on its ``TINY``
(every learner step taken, staleness within the 16-step window, finite
loss), and the run ends with rank 0's "stop", well inside the group's
60 s collective timeout.

The same holds with a live 2x1 learner plan (``train`` and ``train_fsdp``)
alone, whose rank 0 then orders the sections, and beside the 1x2 sampler
plan.
"""
from pathlib import Path

import jax
import numpy as np
import pytest

from _torch_parallel_ranks import run_job
from repro.config import ModelConfig as JModelConfig
from repro.models import init_params as jinit_params

SCRIPT = Path(__file__).resolve().parent / "_torch_serve_ranks.py"
# tests/test_hetero.py's TINY
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=48,
            num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=32,
            block_pattern=["attn"], ffn_pattern=["mlp"], dtype="float32",
            attn_impl="naive", remat=False, rope_theta=1e4,
            paged_attn_impl="ref")
STEPS = 6
# the threaded runtime on a live 2x1 learner plan, alone and beside the 1x2
# sampler plan
LEARNER_CASES = {
    "train_2x1": dict(learner=["train", [2, 1]], sampler=False),
    "fsdp_2x1": dict(learner=["train_fsdp", [2, 1]], sampler=False),
    "fsdp_2x1_samplers_1x2": dict(learner=["train_fsdp", [2, 1]]),
}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jcfg = JModelConfig(**dict(TINY, block_pattern=("attn",),
                               ffn_pattern=("mlp",)))
    params = jinit_params(jcfg, jax.random.PRNGKey(7))
    out = {"tiny/" + "/".join(p.key for p in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    spec = {"cases": [dict(name="threads", kind="threads", model="tiny",
                           steps=STEPS)]
            + [dict(name=name, kind="threads", model="tiny", steps=STEPS,
                    **kw) for name, kw in LEARNER_CASES.items()],
            "models": {"tiny": TINY}, "meshes": [[1, 2], [2, 1]]}
    return run_job(tmp_path_factory.mktemp("threads"), spec, out, world=2,
                   script=SCRIPT)


def test_both_ranks_return_rank_zeros_batches(ranks):
    lead, follow = ranks
    assert bool(lead["threads/leader"]) and not bool(follow["threads/leader"])
    assert len(lead["threads/batch_meta"]) >= STEPS
    for key in ("batch_meta", "batch_tokens", "batch_lp"):
        np.testing.assert_array_equal(lead[f"threads/{key}"],
                                      follow[f"threads/{key}"], err_msg=key)
    for key in ("staleness", "loss", "kl", "iw_var"):
        np.testing.assert_array_equal(lead[f"threads/{key}"],
                                      follow[f"threads/{key}"], err_msg=key)


def test_the_reference_thresholds_hold_and_the_run_ends(ranks):
    for out in ranks:
        assert int(out["threads/steps"]) == STEPS
        assert out["threads/staleness"].max() <= 16
        assert np.isfinite(out["threads/loss"]).all()
        assert float(out["threads/seconds"]) < 60.0


@pytest.mark.parametrize("case", sorted(LEARNER_CASES))
def test_a_live_learner_plan_keeps_both_ranks_in_step(ranks, case):
    lead, follow = ranks
    assert bool(lead[f"{case}/leader"])
    assert not bool(follow[f"{case}/leader"])
    assert len(lead[f"{case}/batch_meta"]) >= STEPS
    for key in ("batch_meta", "batch_tokens", "batch_lp", "staleness",
                "loss", "kl", "iw_var"):
        np.testing.assert_array_equal(lead[f"{case}/{key}"],
                                      follow[f"{case}/{key}"], err_msg=key)
    for out in ranks:
        assert int(out[f"{case}/steps"]) == STEPS
        assert out[f"{case}/staleness"].max() <= 16
        assert np.isfinite(out[f"{case}/loss"]).all()
        assert float(out[f"{case}/seconds"]) < 60.0
