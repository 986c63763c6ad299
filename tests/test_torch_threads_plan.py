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


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    jcfg = JModelConfig(**dict(TINY, block_pattern=("attn",),
                               ffn_pattern=("mlp",)))
    params = jinit_params(jcfg, jax.random.PRNGKey(7))
    out = {"tiny/" + "/".join(p.key for p in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}
    spec = {"cases": [dict(name="threads", kind="threads", model="tiny",
                           steps=STEPS)],
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
