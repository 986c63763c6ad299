"""Plans whose cuts split a head, on four gloo ranks: the port's engines
against the JAX package's unplanned runs.

``fit_spec`` keeps an axis that divides a leaf's dim, so ``wq``'s Hq·hd
columns split over 'model' even where Hq does not (the production meshes'
'model' 16 against Qwen2-7B's 28 q heads), and a Mamba2 block's
``d_inner`` channels split where its heads do not. A rank whose ``wq``
columns cut inside a head gathers them to every head, attends the heads
its columns touch and keeps its columns of their outputs for its ``wo``
rows (``ServeShard.q_cols``); a Mamba2 rank scans its heads and keeps its
channels of them (``SsmSplit.inner``). Every leaf stays at its fitted
shard.

Models, float32: ``two`` (2 layers, 2 q heads of 32 columns and one KV
head: 64 ``wq`` columns over 'model' 4 cut each head in two), ``two_kv``
(the same with two KV heads: on a ``long`` 2x2 plan the q heads split
over 'data' x 'model' inside the heads, the pools' KV heads over 'model',
so the ranks also regroup), and ``ssm`` (the Mamba2 smoke with three SSM
heads of 64 channels: 192 channels split over 4, the heads not at all;
its embedding scaled as in ``tests/test_torch_family_plan.py``). Cases:
the continuous engine (``generate_continuous``) and the static engine on
``serve`` 1x4 and ``long`` 2x2. The reference is the JAX package's
unplanned ``generate_continuous`` / ``StaticEngine`` (its own plan runs
fail under jax 0.9.0, ROADMAP queue 3) on the same weights, prompts and
key: tokens exactly on every rank, log-probs within 1e-4. The ranks run
``_torch_serve_ranks.py`` through ``_torch_parallel_ranks.run_job``.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parallel_ranks import run_job
from repro import configs as jconfigs
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.models import init_params as jinit_params
from repro.sampling import generate_continuous as jgenerate_continuous
from repro.sampling.engine import StaticEngine as JStaticEngine
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.config import ModelConfig
from repro_torch.parallel import ExecutionPlan, abstract_mesh, axes
from repro_torch.parallel.mesh import AXES_2D, Mesh

SCRIPT = Path(__file__).resolve().parent / "_torch_serve_ranks.py"
TWO = dict(name="two-heads", family="dense", num_layers=2, d_model=64,
           num_heads=2, num_kv_heads=1, head_dim=32, d_ff=128,
           vocab_size=32, block_pattern=["attn"], ffn_pattern=["mlp"],
           dtype="float32", attn_impl="naive", remat=False, rope_theta=1e4,
           paged_attn_impl="ref")
MODELS = {"two": TWO,
          "two_kv": dict(TWO, name="two-heads-kv", num_kv_heads=2),
          "ssm": dataclasses.asdict(dataclasses.replace(
              tconfigs.smoke("mamba2-1.3b"), d_model=96, ssm_headdim=64))}
EMBED_SCALE = {"ssm": 0.05}
ENGINE = dict(max_new=6, vocab_limit=20, num_slots=2, page_size=4,
              prefill_chunk=3, sync_every=2, spec_k=0)
# name -> (kind, model, mode, mesh, key)
CASES = {"serve-1x4/continuous": ("generate", "two", "serve", (1, 4), 0),
         "serve-1x4/static": ("static", "two", "serve", (1, 4), 1),
         "long-2x2/continuous": ("generate", "two_kv", "long", (2, 2), 2),
         "long-2x2/static": ("static", "two_kv", "long", (2, 2), 3),
         "serve-1x4/ssm": ("static", "ssm", "serve", (1, 4), 4),
         "long-2x2/ssm": ("static", "ssm", "long", (2, 2), 5)}
TOL_LP = 1e-4


def _tcfg(model):
    return ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in MODELS[model].items()})


def _jcfg(model):
    if model == "ssm":
        return dataclasses.replace(jconfigs.smoke("mamba2-1.3b"),
                                   d_model=96, ssm_headdim=64)
    kw = dict(MODELS[model], block_pattern=("attn",), ffn_pattern=("mlp",))
    return JModelConfig(**kw)


def _prompts():
    return np.random.default_rng(26).integers(3, 32, (4, 9))


@pytest.fixture(scope="module")
def weights():
    out, jp = {}, {}
    for i, model in enumerate(MODELS):
        params = jinit_params(_jcfg(model), jax.random.PRNGKey(40 + i))
        if model in EMBED_SCALE:
            params["embed"] = params["embed"] * EMBED_SCALE[model]
        jp[model] = params
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{model}/" + "/".join(p.key for p in path)] = \
                np.asarray(leaf)
    return out, jp


@pytest.fixture(scope="module")
def four(tmp_path_factory, weights):
    out, _ = weights
    cases = [dict(name=name, kind=kind, model=model, mode=mode,
                  mesh=list(dims), prompts="p9", key=key, engine=ENGINE,
                  steps_before=0)
             for name, (kind, model, mode, dims, key) in CASES.items()]
    spec = {"cases": cases, "models": MODELS,
            "meshes": sorted({tuple(c[3]) for c in CASES.values()})}
    return run_job(tmp_path_factory.mktemp("cuts"), spec,
                   {**out, "p9": _prompts()}, world=4, script=SCRIPT)


def _jax_run(kind, model, key, jp):
    cfg, params = _jcfg(model), jp[model]
    prompts = _prompts()
    rl = JRLConfig(temperature=1.0, top_k=0, top_p=1.0,
                   max_new_tokens=ENGINE["max_new"])
    k = jax.random.PRNGKey(key)
    if kind == "generate":
        roll = jgenerate_continuous(
            cfg, rl, params, jnp.asarray(prompts), k,
            max_new=ENGINE["max_new"], vocab_limit=ENGINE["vocab_limit"],
            num_slots=ENGINE["num_slots"], page_size=ENGINE["page_size"],
            prefill_chunk=ENGINE["prefill_chunk"],
            sync_every=ENGINE["sync_every"])
        mask = np.asarray(roll["comp_mask"]) > 0
        return (np.asarray(roll["completions"])[mask],
                np.asarray(roll["sampler_lp"])[mask], mask.sum(1))
    sp = JSamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                         max_new_tokens=ENGINE["max_new"])
    res = JStaticEngine(cfg, params, rl=rl, vocab_limit=ENGINE["vocab_limit"],
                        key=k).generate([JRequest(rid=i, prompt=p, params=sp)
                                         for i, p in enumerate(prompts)])
    return (np.concatenate([r.tokens for r in res]),
            np.concatenate([r.logps for r in res]),
            np.array([r.gen_count for r in res]))


def test_the_cases_cut_inside_a_head():
    """Every case's plan cuts what it says: ``wq`` inside a head (the
    ``two`` models), SSM channels finer than their heads (``ssm``), on
    every rank; ``long`` 2x2 on ``two_kv`` also regroups."""
    for name, (_, model, mode, dims, _) in CASES.items():
        cfg = _tcfg(model)
        for r in range(int(np.prod(dims))):
            # rank r's view of a live mesh (no collective runs here)
            mesh = Mesh(dims, AXES_2D, rank=r, groups={AXES_2D: None})
            shard = ExecutionPlan(mesh, mode).serve_shard(cfg)
            if model == "ssm":
                (h0, hn), (i0, i_n) = shard.ssm.heads, shard.ssm.inner
                assert i_n < hn * cfg.ssm_headdim, name
                assert h0 * cfg.ssm_headdim <= i0 and \
                    i0 + i_n <= (h0 + hn) * cfg.ssm_headdim, name
            else:
                assert shard.q_cols is not None and shard.q_cols[1] == 16
                if name == "long-2x2/continuous":
                    assert shard.regroup


@pytest.mark.parametrize("name", list(CASES))
def test_a_cut_head_serves_the_unplanned_reference(four, weights, name):
    kind, model, mode, dims, key = CASES[name]
    tokens, logps, lengths = _jax_run(kind, model, key, weights[1])
    for r, out in enumerate(four):
        np.testing.assert_array_equal(out[f"{name}/lengths"], lengths,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{name}/tokens"], tokens,
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{name}/logps"], logps, rtol=0,
                                   atol=TOL_LP, err_msg=f"rank {r}")


@pytest.mark.parametrize("name", ["serve-1x4/static", "long-2x2/ssm"])
def test_each_rank_holds_its_fitted_shard(four, name):
    """The cuts move no byte: every param leaf a rank's engine holds has
    its fitted shard's element count."""
    _, model, mode, dims, _ = CASES[name]
    cfg = _tcfg(model)
    sh = ExecutionPlan(abstract_mesh(dims), mode).param_shardings(cfg)

    def walk(s, shapes, path=""):
        if isinstance(s, dict):
            for k in s:
                yield from walk(s[k], shapes[k], f"{path}{k}/")
        else:
            yield path[:-1], int(np.prod(s.shard_shape(shapes)))
    for path, numel in walk(sh, axes.param_shapes(cfg)):
        for out in four:
            got, on_cpu = out[f"{name}/numel/params/{path}"]
            assert got == numel and on_cpu, path
