"""Jamba (MoE and Mamba2 layers together) on live ``serve`` plans on the
CPU: the port's ``StaticEngine`` and ``token_logps`` with jamba's smoke on
1x2 and 2x1 plans of gloo rank processes against the JAX package's
unplanned runs.

Jamba's smoke is one period of 8 layers (attention + 7 Mamba2 layers,
MoE and dense MLP FFNs alternating; 4 experts, top-2, capacity factor
1.25), float32. An SSM model serves through the static engine (the JAX
package has no paged cache for it). On a plan each rank runs its
attention heads over its span of the dense cache, its Mamba2 heads on
the reference's contiguous cuts (``SsmSplit``), and its experts (over
'model') on its FFN columns (over 'data') at the global capacity, as
``tests/test_torch_moe_plan.py`` holds scout and maverick. The reference
runs its MoE through ``tests/_jax_moe_ref.py`` (the kept-only scatter).
Every rank emits the reference's tokens with log-probs within 1e-4,
``token_logps`` (the recompute through K6's twin, ``ssd_impl="pallas"``)
is within 1e-4 of the reference's, and the drop fraction of every MoE
forward equals one device's.
"""
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _jax_moe_ref import patch_jax_moe
from _torch_parallel_ranks import run_job
from repro import configs as jconfigs
from repro.config import RLConfig as JRLConfig
from repro.models import init_params as jinit_params
from repro.sampling.engine import StaticEngine as JStaticEngine
from repro.sampling.engine import token_logps as jtoken_logps
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs

SCRIPT = Path(__file__).resolve().parent / "_torch_static_ranks.py"
JAMBA = "jamba-1.5-large-398b"
MODELS = {"jamba": dataclasses.asdict(tconfigs.smoke(JAMBA,
                                                     ssd_impl="pallas"))}
PLANS = [(1, 2), (2, 1)]
NEW, VOCAB_LIMIT, KEY = 6, 500, 5
TOL_LP = 1e-4


def _tag(dims):
    return f"{dims[0]}x{dims[1]}"


def _inputs():
    rng = np.random.default_rng(27)
    return {"p12": rng.integers(3, 500, (4, 12)),
            "lp": rng.integers(3, 512, (4, 17))}


def _cases():
    cases = []
    for dims in PLANS:
        base = dict(mesh=list(dims), mode="serve", model="jamba")
        cases.append(dict(base, name=f"{_tag(dims)}/static", kind="static",
                          prompts="p12", key=KEY, max_new=NEW,
                          vocab_limit=VOCAB_LIMIT, drops=True))
        cases.append(dict(base, name=f"{_tag(dims)}/logps", kind="logps",
                          prompts="lp"))
    return cases


@pytest.fixture(scope="module", autouse=True)
def _kept_only_jax_moe():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_moe(mp)
        yield


@pytest.fixture(scope="module")
def jax_params():
    return jinit_params(jconfigs.smoke(JAMBA), jax.random.PRNGKey(50))


@pytest.fixture(scope="module")
def two(tmp_path_factory, jax_params):
    out = {f"jamba/" + "/".join(p.key for p in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(
               jax_params)[0]}
    spec = {"cases": _cases(), "models": MODELS,
            "meshes": [list(d) for d in PLANS]}
    return run_job(tmp_path_factory.mktemp("jamba"), spec,
                   {**out, **_inputs()}, world=2, script=SCRIPT)


@pytest.fixture(scope="module")
def reference(jax_params):
    cfg = jconfigs.smoke(JAMBA)
    rl = JRLConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=NEW)
    sp = JSamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                         max_new_tokens=NEW)
    eng = JStaticEngine(cfg, jax_params, rl=rl, vocab_limit=VOCAB_LIMIT,
                        key=jax.random.PRNGKey(KEY))
    res = eng.generate([JRequest(rid=i, prompt=p, params=sp)
                        for i, p in enumerate(_inputs()["p12"])])
    return {"static": (np.concatenate([r.tokens for r in res]),
                       np.concatenate([r.logps for r in res]),
                       np.array([r.gen_count for r in res])),
            "logps": np.asarray(jtoken_logps(
                cfg, jax_params, jnp.asarray(_inputs()["lp"])))}


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
def test_jamba_static_engine_serves_the_unplanned_reference(two, reference,
                                                            dims):
    tokens, logps, lengths = reference["static"]
    name = f"{_tag(dims)}/static"
    for r, out in enumerate(two):
        np.testing.assert_array_equal(out[f"{name}/lengths"], lengths,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{name}/tokens"], tokens,
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{name}/logps"], logps, rtol=0,
                                   atol=TOL_LP, err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{name}/drops"],
                                      out[f"{name}/drops_one"])
        assert len(out[f"{name}/drops"]) > 0


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
def test_jamba_recompute_on_a_plan_matches_the_reference(two, reference,
                                                         dims):
    for r, out in enumerate(two):
        np.testing.assert_allclose(out[f"{_tag(dims)}/logps/lp"],
                                   reference["logps"], rtol=0, atol=TOL_LP,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
def test_each_rank_holds_jambas_fitted_share(two, dims):
    """Per rank, every param leaf the static engine holds has the element
    count of its fitted serve sharding: the attention heads, the Mamba2
    channels and heads, the experts over 'model' and their FFN columns
    over 'data'."""
    from repro_torch.config import ModelConfig
    from repro_torch.parallel import ExecutionPlan, abstract_mesh, axes
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in MODELS["jamba"].items()})
    plan = ExecutionPlan(abstract_mesh(dims), "serve")

    def walk(sh, shapes, path=""):
        if isinstance(sh, dict):
            for k in sh:
                yield from walk(sh[k], shapes[k], f"{path}{k}/")
            return
        yield path[:-1], int(np.prod(sh.shard_shape(shapes)))
    want = dict(walk(plan.param_shardings(cfg), axes.param_shapes(cfg)))
    full = int(np.prod(axes.param_shapes(cfg)["blocks"]["layer_0"]["moe"][
        "w_gate"]))
    assert want["blocks/layer_0/moe/w_gate"] * 2 == full
    for out in two:
        for path, n in want.items():
            got = out[f"{_tag(dims)}/static/numel/params/{path}"]
            assert int(got) == n, path
