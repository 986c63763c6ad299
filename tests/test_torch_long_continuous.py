"""The continuous engine on live ``long`` plans on the CPU: the port's
``ContinuousEngine`` on 1x2, 2x1 and 2x2 ``long`` plans of gloo rank
processes against the JAX package's unplanned ``generate_continuous``
and engine.

On a ``long`` plan the weights' heavy dims split over 'data' x 'model'
(``qkv``, ``kv``, ``ffn``, ``vocab``) while the page pools split their KV
heads over 'model' alone and are whole over 'data' (the reference's
fitted ``cache_specs``). So a rank's k/v columns are gathered and its
pools' heads kept, and where a rank's q heads do not lie in its pools'
KV-head groups (2x2 here: the rank at data 0, model 1 holds q head 1 but
pool head 1, whose group is q heads 2-3) every rank gathers q to every
head, attends its pools' groups, and gathers the outputs over 'model'.
The batch is not split on ``long``: every rank computes every slot.

Model: the reference's paged ``TINY`` (2 layers, Hq 4, Hkv 2, head_dim
16, V 32, float32, ``paged_attn_impl="ref"``). Traffic: 4 prompts of 9
tokens, 6 new, 2 slots, page 4, sync every 2, chunked prefill (chunks of
3), temperature 1.0, vocab limit 20, speculative rounds off and on
(spec_k 3 over repeating-pattern prompts). Every rank emits the
reference's tokens with log-probs within 1e-4, and holds the element
count of the fitted ``long`` shardings of every param leaf and pool.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parallel_ranks import run_job
from repro.config import ATTN as JATTN
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.models import init_params as jinit_params
from repro.sampling import generate_continuous as jgenerate_continuous
from repro.sampling.continuous import ContinuousEngine as JContinuousEngine
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch.config import ModelConfig
from repro_torch.parallel import ExecutionPlan, abstract_mesh, axes

SCRIPT = Path(__file__).resolve().parent / "_torch_serve_ranks.py"
TINY = dict(name="tiny-paged", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=32,
            block_pattern=["attn"], ffn_pattern=["mlp"], dtype="float32",
            attn_impl="naive", remat=False, rope_theta=1e4,
            paged_attn_impl="ref")
WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
PLANS = WORLDS[2] + WORLDS[4]
ENGINE = dict(max_new=6, vocab_limit=20, num_slots=2, page_size=4,
              sync_every=2, prefill_chunk=3)
# name -> (kind, prompts, key, spec_k)
TRAFFIC = {"generate": ("generate", "p9", 1, 0),
           "engine": ("engine", "p9", 2, 0),
           "spec": ("spec", "pattern", 3, 3)}
TOL_LP = 1e-4


def _tag(dims):
    return f"{dims[0]}x{dims[1]}"


def _prompts():
    rng = np.random.default_rng(29)
    pattern = np.array([[5, 6, 7] * 3, [9, 4] * 4 + [9],
                        [11, 12, 13, 14] * 2 + [11], [8] * 9])
    return {"p9": rng.integers(3, 32, (4, 9)), "pattern": pattern}


def _cases(world):
    return [dict(name=f"{_tag(d)}/{t}", mesh=list(d), mode="long", kind=kind,
                 model="tiny", prompts=prompts, key=key,
                 engine=dict(ENGINE, spec_k=spec_k))
            for d in WORLDS[world]
            for t, (kind, prompts, key, spec_k) in TRAFFIC.items()]


def _jcfg():
    kw = dict(TINY, block_pattern=(JATTN,), ffn_pattern=("mlp",))
    return JModelConfig(**kw)


@pytest.fixture(scope="module")
def jax_params():
    return jinit_params(_jcfg(), jax.random.PRNGKey(11))


def _job(tmp_path_factory, jax_params, world):
    out = {"tiny/" + "/".join(p.key for p in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               jax_params)[0]}
    spec = {"cases": _cases(world), "models": {"tiny": TINY},
            "meshes": [list(d) for d in WORLDS[world]]}
    return run_job(tmp_path_factory.mktemp(f"long{world}"), spec,
                   {**out, **_prompts()}, world=world, script=SCRIPT)


@pytest.fixture(scope="module")
def two(tmp_path_factory, jax_params):
    return _job(tmp_path_factory, jax_params, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory, jax_params):
    return _job(tmp_path_factory, jax_params, 4)


def _ranks(request, dims):
    return request.getfixturevalue("two" if np.prod(dims) == 2 else "four")


@pytest.fixture(scope="module")
def reference(jax_params):
    """The reference, unplanned: (tokens, logps, lengths) a traffic."""
    cfg = _jcfg()
    rl = JRLConfig(temperature=1.0, top_k=0, top_p=1.0,
                   max_new_tokens=ENGINE["max_new"])
    sp = JSamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                         max_new_tokens=ENGINE["max_new"])
    runs = {}
    for name, (kind, prompts, key, spec_k) in TRAFFIC.items():
        prompts = _prompts()[prompts]
        k = jax.random.PRNGKey(key)
        if kind == "generate":
            roll = jgenerate_continuous(
                cfg, rl, jax_params, jnp.asarray(prompts), k,
                max_new=ENGINE["max_new"], vocab_limit=ENGINE["vocab_limit"],
                num_slots=ENGINE["num_slots"], page_size=ENGINE["page_size"],
                prefill_chunk=ENGINE["prefill_chunk"],
                sync_every=ENGINE["sync_every"])
            mask = np.asarray(roll["comp_mask"]) > 0
            runs[name] = (np.asarray(roll["completions"])[mask],
                          np.asarray(roll["sampler_lp"])[mask], mask.sum(1))
            continue
        eng = JContinuousEngine(
            cfg, jax_params, rl=rl,
            max_total_tokens=prompts.shape[1] + ENGINE["max_new"],
            num_slots=ENGINE["num_slots"], page_size=ENGINE["page_size"],
            sync_every=ENGINE["sync_every"],
            prefill_chunk=ENGINE["prefill_chunk"],
            vocab_limit=ENGINE["vocab_limit"], prefix_cache=False,
            spec_k=spec_k, key=k)
        res = eng.generate([JRequest(rid=i, prompt=p, params=sp)
                            for i, p in enumerate(prompts)])
        runs[name] = (np.concatenate([r.tokens for r in res]),
                      np.concatenate([r.logps for r in res]),
                      np.array([r.gen_count for r in res]))
    return runs


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
@pytest.mark.parametrize("traffic", list(TRAFFIC))
def test_long_plan_matches_the_unplanned_reference(request, reference, dims,
                                                   traffic):
    tokens, logps, lengths = reference[traffic]
    name = f"{_tag(dims)}/{traffic}"
    for r, out in enumerate(_ranks(request, dims)):
        np.testing.assert_array_equal(out[f"{name}/lengths"], lengths,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{name}/tokens"], tokens,
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{name}/logps"], logps, rtol=0,
                                   atol=TOL_LP, err_msg=f"rank {r}")
    if traffic == "spec":
        for out in _ranks(request, dims):
            rounds, drafted, diff = out[f"{name}/spec"]
            assert rounds > 0 and drafted > 0
            assert diff == 0.0    # the folded K4 replay of the rank's heads


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
def test_each_rank_holds_the_fitted_long_shards(request, dims):
    """Per rank, every param leaf holds the element count of its fitted
    ``long`` sharding (the heavy dims over 'data' x 'model'), and each
    pool its KV heads over 'model', whole over 'data'."""
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in TINY.items()})
    plan = ExecutionPlan(abstract_mesh(dims), "long")

    def walk(sh, shapes, path=""):
        if isinstance(sh, dict):
            for k in sh:
                yield from walk(sh[k], shapes[k], f"{path}{k}/")
            return
        yield path[:-1], int(np.prod(sh.shard_shape(shapes)))
    want = dict(walk(plan.param_shardings(cfg), axes.param_shapes(cfg)))
    assert want["blocks/layer_0/attn/wq"] * int(np.prod(dims)) == \
        cfg.num_blocks * cfg.d_model * cfg.num_heads * cfg.head_dim
    pages = 1 + ENGINE["num_slots"] * -(-15 // ENGINE["page_size"])
    shape = (cfg.num_blocks, pages, ENGINE["page_size"], cfg.num_kv_heads,
             cfg.head_dim)
    pool = plan.cache_shardings(cfg, {"kp": shape})["kp"]
    assert pool.shard_shape(shape)[3] == cfg.num_kv_heads // dims[1]
    for out in _ranks(request, dims):
        name = f"{_tag(dims)}/engine"
        for path, n in want.items():
            numel, on_cpu = out[f"{name}/numel/params/{path}"]
            assert numel == n and on_cpu, path
        for leaf in ("kp", "vp"):
            numel, _ = out[f"{name}/numel/pool/layer_0/self/{leaf}"]
            assert numel == int(np.prod(pool.shard_shape(shape)))
