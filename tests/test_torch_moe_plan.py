"""The MoE family on live ``serve`` plans on the CPU: the port's
``ContinuousEngine`` and ``StaticEngine`` with scout's and maverick's
smokes on 1x2, 2x1 and 2x2 plans of gloo rank processes against the JAX
package's unplanned runs, and ``moe_ep="serve"`` against the reference's
``moe_ffn_ep``.

The reference's own plan runs fail under jax 0.9.0 (ROADMAP queue 3), and
its contract is that a plan's tokens equal the unplanned run's, so each
plan is held to the reference's unplanned ``generate_continuous`` and
``StaticEngine`` on the same weights (``params_from_numpy``), prompts and
key. The reference runs its MoE through ``tests/_jax_moe_ref.py`` (the
kept-only scatter: random routers overflow the last expert, the known
reference fault). Models, float32 smokes with ``paged_attn_impl="ref"``:
scout (every layer MoE, top-1 with a shared expert) and maverick (MoE and
dense MLP layers), each at its ``capacity_factor`` 1.25, and scout at
0.5, where the capacity drops tokens. On a serve plan a rank holds its
experts over 'model' and their FFN columns over 'data'; the layer gathers
the rows over 'data', dispatches every token at the global capacity and
sums the ranks' partial outputs, so the same tokens drop as on one
device: every rank emits the reference's tokens, logps within 1e-4, and
the drop fraction of every MoE forward equals one device's (and, for a
forward of a row split, the reference's). The control, each rank running
the next rank's experts, misses.

``moe_ep="serve"`` (``models/moe_ep.py``: the expert FFN columns gathered
over 'data' inside the layer, a per-shard capacity) is held at the
contract of ``tests/test_moe_ep.py`` (capacity factor 8, no drops, output
within 1e-4, top-1 and top-2 with a shared expert) to the reference's
``moe_ffn`` and to its ``moe_ffn_ep`` on 1x2 and 2x2 meshes of forced
host devices (in a subprocess), and scout's smoke at that capacity serves
the reference's unplanned tokens through it on 1x2.

Per rank, every param leaf holds the element count of the fitted serve
shardings, and the pools their KV heads over 'model'.

Speculative decoding on a plan: scout's smoke with ``spec_k`` 3 on the
2x1 and 2x2 serve plans, at capacity 1.25 and 0.5, over prompts of
repeated motifs (so drafts are proposed and verified), against one
device's spec engine on the same weights, prompts and key in the rank:
tokens equal, log-probs within 1e-4, the same drops in every MoE forward.
A verify round forwards each slot's window, so its tokens share the
capacity differently from a decode step's: one device's spec run, not
the non-speculative reference, is the run to match.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _jax_moe_ref import moe_ffn_kept, patch_jax_moe
from _torch_parallel_ranks import run_job
from repro import configs as jconfigs
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.models import forward as jforward
from repro.models import init_params as jinit_params
from repro.sampling import generate_continuous as jgenerate_continuous
from repro.sampling.engine import StaticEngine as JStaticEngine
from repro.sampling.engine import token_logps as jtoken_logps
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.config import ModelConfig
from repro_torch.parallel import ExecutionPlan, abstract_mesh

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
SERVE = HERE / "_torch_serve_ranks.py"
STATIC = HERE / "_torch_static_ranks.py"
SCOUT, MAVERICK = "llama4-scout-17b-a16e", "llama4-maverick-400b-a17b"
# model -> (arch, capacity factor)
ARCHS = {"scout": (SCOUT, 1.25), "maverick": (MAVERICK, 1.25),
         "scout_drop": (SCOUT, 0.5), "scout_ep": (SCOUT, 8.0)}
MODELS = {k: dataclasses.asdict(tconfigs.smoke(
    arch, capacity_factor=cf, paged_attn_impl="ref"))
    for k, (arch, cf) in ARCHS.items()}
# the layer cases of tests/test_moe_ep.py's contract
LAYER = dict(name="moe-ep", family="moe", num_layers=1, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
             block_pattern=["attn"], ffn_pattern=["moe"], num_experts=4,
             dtype="float32", attn_impl="naive", remat=False,
             capacity_factor=8.0)
LAYERS = {"k1": dict(LAYER, experts_per_token=1),
          "k2": dict(LAYER, experts_per_token=2, shared_expert=True)}
WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2)]}
PLANS = WORLDS[2] + WORLDS[4]
ENGINE = dict(max_new=6, vocab_limit=500, num_slots=2, page_size=4,
              sync_every=2, prefill_chunk=16)
TRAFFIC = ("scout", "maverick", "scout_drop")
TOL_LP = 1e-4
# speculative decoding on the plans that split the slots over 'data'
SPEC_PLANS = [(2, 1), (2, 2)]
SPEC_MODELS = ("scout", "scout_drop")


def _tag(dims):
    return f"{dims[0]}x{dims[1]}"


def _jcfg(model):
    if model in LAYERS:
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in LAYERS[model].items()}
        return JModelConfig(**kw)
    arch, cf = ARCHS[model]
    return jconfigs.smoke(arch, capacity_factor=cf, paged_attn_impl="ref")


def _inputs():
    rng = np.random.default_rng(31)
    motifs = np.random.default_rng(32)
    return {"p24": rng.integers(3, 500, (4, 24)),
            "fwd": rng.integers(3, 512, (4, 13)),
            "x": (0.5 * rng.standard_normal((4, 16, 64))).astype(
                np.float32),
            "pat": np.stack([np.tile(motifs.integers(3, 500, n), 24)[:24]
                             for n in (3, 4, 5, 6)])}


def _cases(world):
    serve, static = [], []
    for dims in WORLDS[world]:
        tag = _tag(dims)
        base = dict(mesh=list(dims), prompts="p24", key=3)
        for model in TRAFFIC:
            serve.append(dict(base, name=f"{tag}/{model}/continuous",
                              kind="engine", model=model, drops=True,
                              engine=dict(ENGINE)))
            static.append(dict(base, name=f"{tag}/{model}/static",
                               kind="static", model=model, mode="serve",
                               max_new=ENGINE["max_new"],
                               vocab_limit=ENGINE["vocab_limit"],
                               drops=True))
        if dims in SPEC_PLANS:
            for model in SPEC_MODELS:
                serve.append(dict(base, name=f"{tag}/{model}/spec",
                                  kind="spec", model=model, drops=True,
                                  prompts="pat",
                                  engine=dict(ENGINE, spec_k=3, max_new=8)))
        static.append(dict(name=f"{tag}/forward", kind="forward",
                           model="scout_drop", mode="serve",
                           mesh=list(dims), prompts="fwd"))
        for layer in LAYERS:
            static.append(dict(name=f"{tag}/{layer}/ep", kind="moe_layer",
                               model=layer, mode="serve", mesh=list(dims),
                               prompts="x", moe_ep=True))
        # every rank the whole batch, cut over ep_dp_axes in the layer
        static.append(dict(name=f"{tag}/scout_ep/logps", kind="logps",
                           model="scout_ep", mode="serve", mesh=list(dims),
                           prompts="fwd", moe_ep=True))
    if world == 2:
        serve.append(dict(name="1x2/control/continuous", mesh=[1, 2],
                          prompts="p24",
                          key=3, kind="control_experts", model="scout",
                          engine=dict(ENGINE)))
        static.append(dict(name="1x2/control/static", mesh=[1, 2],
                           prompts="p24",
                           key=3, kind="control_experts", model="scout",
                           mode="serve", max_new=ENGINE["max_new"],
                           vocab_limit=ENGINE["vocab_limit"]))
        static.append(dict(name="1x2/scout_ep/static", mesh=[1, 2],
                           prompts="p24", key=3, kind="static",
                           model="scout_ep", mode="serve", moe_ep=True,
                           max_new=ENGINE["max_new"],
                           vocab_limit=ENGINE["vocab_limit"]))
    return serve, static


@pytest.fixture(scope="module", autouse=True)
def _kept_only_jax_moe():
    with pytest.MonkeyPatch.context() as mp:
        patch_jax_moe(mp)
        yield


@pytest.fixture(scope="module")
def weights():
    out, jp = {}, {}
    # scout's three configs share its weights
    seeds = {"scout": 40, "scout_drop": 40, "scout_ep": 40, "maverick": 41,
             "k1": 42, "k2": 43}
    for model, seed in seeds.items():
        params = jinit_params(_jcfg(model), jax.random.PRNGKey(seed))
        jp[model] = params
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{model}/" + "/".join(p.key for p in path)] = \
                np.asarray(leaf)
    return out, jp


def _job(tmp_path_factory, weights, world):
    out, _ = weights
    serve, static = _cases(world)
    models = {**MODELS, **LAYERS}
    meshes = [list(d) for d in WORLDS[world]]
    inputs = {**out, **_inputs()}
    work = tmp_path_factory.mktemp(f"moe{world}")
    got = run_job(work, {"cases": serve, "models": models,
                         "meshes": meshes}, inputs, world=world,
                  script=SERVE)
    work = tmp_path_factory.mktemp(f"moe_static{world}")
    for r, more in enumerate(run_job(work, {"cases": static,
                                            "models": models,
                                            "meshes": meshes},
                                     inputs, world=world, script=STATIC)):
        got[r].update({k: v for k, v in more.items()})
    return got


@pytest.fixture(scope="module")
def two(tmp_path_factory, weights):
    return _job(tmp_path_factory, weights, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory, weights):
    return _job(tmp_path_factory, weights, 4)


def _ranks(request, dims):
    return request.getfixturevalue("two" if np.prod(dims) == 2 else "four")


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's unplanned runs: both engines per model, a forward
    with its router metrics, the MoE layer cases."""
    _, jp = weights
    inputs, runs = _inputs(), {}
    rl = JRLConfig(temperature=1.0, top_k=0, top_p=1.0,
                   max_new_tokens=ENGINE["max_new"])
    sp = JSamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                         max_new_tokens=ENGINE["max_new"])
    prompts = inputs["p24"]
    for model in TRAFFIC + ("scout_ep",):
        cfg, params = _jcfg(model), jp[model]
        eng = JStaticEngine(cfg, params, rl=rl,
                            vocab_limit=ENGINE["vocab_limit"],
                            key=jax.random.PRNGKey(3))
        res = eng.generate([JRequest(rid=i, prompt=p, params=sp)
                            for i, p in enumerate(prompts)])
        runs[f"{model}/static"] = (np.concatenate([r.tokens for r in res]),
                                   np.concatenate([r.logps for r in res]),
                                   np.array([r.gen_count for r in res]))
        if model == "scout_ep":
            continue
        roll = jgenerate_continuous(
            cfg, rl, params, jnp.asarray(prompts), jax.random.PRNGKey(3),
            max_new=ENGINE["max_new"], vocab_limit=ENGINE["vocab_limit"],
            num_slots=ENGINE["num_slots"], page_size=ENGINE["page_size"],
            prefill_chunk=ENGINE["prefill_chunk"],
            sync_every=ENGINE["sync_every"])
        mask = np.asarray(roll["comp_mask"]) > 0
        runs[f"{model}/continuous"] = (
            np.asarray(roll["completions"])[mask],
            np.asarray(roll["sampler_lp"])[mask], mask.sum(1))
    logits, _, aux = jforward(_jcfg("scout_drop"), jp["scout_drop"],
                              jnp.asarray(inputs["fwd"]))
    runs["scout_ep/logps"] = np.asarray(jtoken_logps(
        _jcfg("scout_ep"), jp["scout_ep"], jnp.asarray(inputs["fwd"])))
    runs["forward"] = (np.asarray(logits),
                       {k: float(v) for k, v in aux.items()})
    for layer in LAYERS:
        moe = jax.tree_util.tree_map(
            lambda a: a[0], jp[layer]["blocks"]["layer_0"]["moe"])
        y, _ = moe_ffn_kept(_jcfg(layer), moe, jnp.asarray(inputs["x"]))
        runs[f"{layer}/y"] = np.asarray(y)
    return runs


def _check(ranks, name, want, tol=TOL_LP):
    tokens, logps, lengths = want
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"{name}/lengths"], lengths,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{name}/tokens"], tokens,
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{name}/logps"], logps, rtol=0,
                                   atol=tol, err_msg=f"rank {r}")


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
@pytest.mark.parametrize("engine", ["continuous", "static"])
@pytest.mark.parametrize("model", TRAFFIC)
def test_moe_plan_matches_the_unplanned_reference(request, reference, dims,
                                                  engine, model):
    ranks = _ranks(request, dims)
    name = f"{_tag(dims)}/{model}/{engine}"
    _check(ranks, name, reference[f"{model}/{engine}"])
    for out in ranks:                     # the drops of every MoE forward
        np.testing.assert_array_equal(out[f"{name}/drops"],
                                      out[f"{name}/drops_one"])
        assert len(out[f"{name}/drops"]) > 0
    if model == "scout_drop":
        assert max(ranks[0][f"{name}/drops"]) > 0


@pytest.mark.parametrize("dims", SPEC_PLANS, ids=_tag)
@pytest.mark.parametrize("model", SPEC_MODELS)
def test_scout_spec_on_a_plan_matches_one_device(request, dims, model):
    name = f"{_tag(dims)}/{model}/spec"
    for r, out in enumerate(_ranks(request, dims)):
        np.testing.assert_array_equal(out[f"{name}/lengths"],
                                      out[f"{name}/lengths_one"])
        np.testing.assert_array_equal(out[f"{name}/tokens"],
                                      out[f"{name}/tokens_one"],
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{name}/logps"],
                                   out[f"{name}/logps_one"], rtol=0,
                                   atol=TOL_LP, err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{name}/drops"],
                                      out[f"{name}/drops_one"])
        rounds, drafted, rescore = out[f"{name}/spec"]
        assert rounds > 0 and drafted > 0 and rescore == 0.0
    if model == "scout_drop":
        assert max(_ranks(request, dims)[0][f"{name}/drops"]) > 0


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
def test_forward_of_a_row_split_drops_as_the_reference(request, reference,
                                                       dims):
    """Scout at capacity factor 0.5: each rank forwards its rows of a 4 x
    13 batch (split over 'data' where it has two ranks); the layer gathers
    them, so the drop fraction (summed over the two layers, within the
    float32 rounding of that sum; one drop moves it by 1/52) and the
    router metrics are the reference's whole batch's, and each rank's
    logits its rows of the reference's."""
    logits, aux = reference["forward"]
    assert aux["moe_drop_frac"] > 0
    for out in _ranks(request, dims):
        r0, rn = out[f"{_tag(dims)}/forward/rows"]
        np.testing.assert_allclose(out[f"{_tag(dims)}/forward/y"],
                                   logits[r0:r0 + rn], rtol=0, atol=1e-4)
        for k, want in aux.items():
            got = float(out[f"{_tag(dims)}/forward/metric/{k}"])
            if k == "moe_drop_frac":
                assert got == pytest.approx(want, abs=1e-6)
            else:
                assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("engine", ["continuous", "static"])
def test_the_next_ranks_experts_miss(two, reference, engine):
    """Each rank running the next rank's experts (its weights on the rows
    dispatched to another expert) misses the bar."""
    tokens, logps, _ = reference[f"scout/{engine}"]
    for out in two:
        got = out[f"1x2/control/{engine}/tokens"]
        missed = got.shape != tokens.shape or \
            not np.array_equal(got, tokens) or \
            np.abs(out[f"1x2/control/{engine}/logps"] - logps).max() > TOL_LP
        assert missed


JAX_EP = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax, numpy as np
    from repro.config import ModelConfig
    from repro.models.moe_ep import moe_ffn_ep
    from repro.runtime_context import mesh_context
    work = sys.argv[1]
    cases = json.load(open(os.path.join(work, "cases.json")))
    x = np.load(os.path.join(work, "x.npy"))
    out = {}
    for name, kw in cases.items():
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in kw.items()}
        cfg = dataclasses.replace(ModelConfig(**kw), moe_ep="serve",
                                  ep_dp_axes=("data",))
        moe = dict(np.load(os.path.join(work, name + ".npz")))
        tree = {}
        for k, v in moe.items():
            node = tree
            parts = k.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
        for dims in ((1, 2), (2, 2)):
            mesh = jax.make_mesh(dims, ("data", "model"))
            with mesh_context(mesh):
                y, _ = jax.jit(lambda p, x: moe_ffn_ep(cfg, p, x))(tree, x)
            out[name + "/" + "x".join(map(str, dims))] = np.asarray(y)
    np.savez(os.path.join(work, "jax.npz"), **out)
""")


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory, weights):
    """The reference's ``moe_ffn_ep`` (``moe_ep="serve"``) on 1x2 and 2x2
    meshes of forced host devices, in a subprocess."""
    out, _ = weights
    work = tmp_path_factory.mktemp("jax_ep")
    np.save(work / "x.npy", _inputs()["x"])
    (work / "cases.json").write_text(json.dumps(LAYERS))
    for layer in LAYERS:
        pre = f"{layer}/blocks/layer_0/moe/"
        np.savez(work / f"{layer}.npz",
                 **{k[len(pre):]: v[0] for k, v in out.items()
                    if k.startswith(pre)})
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_EP, str(work)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(work / "jax.npz"))


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
@pytest.mark.parametrize("layer", list(LAYERS))
def test_moe_ep_serve_matches_the_reference(request, reference, jax_ep,
                                            dims, layer):
    """``moe_ep="serve"`` on the rank's shards (experts over 'model', FFN
    columns over 'data', gathered in the layer): each rank's rows within
    1e-4 of the reference's ``moe_ffn`` and, where the reference's mesh
    runs it, of its ``moe_ffn_ep``; no drops, and the two model ranks of
    a row block agree."""
    want = reference[f"{layer}/y"]
    ep = jax_ep.get(f"{layer}/{_tag(dims)}")
    for out in _ranks(request, dims):
        r0, rn = out[f"{_tag(dims)}/{layer}/ep/rows"]
        got = out[f"{_tag(dims)}/{layer}/ep/y"]
        assert np.abs(got - want[r0:r0 + rn]).max() < 1e-4
        if ep is not None:
            assert np.abs(got - ep[r0:r0 + rn]).max() < 1e-4
        assert float(out[f"{_tag(dims)}/{layer}/ep/metric/"
                         "moe_drop_frac"]) == 0.0


def test_moe_ep_serve_engine_matches_the_unplanned_reference(two, reference):
    """Scout's smoke at capacity factor 8 with ``moe_ep="serve"`` through
    the static engine on 1x2: the reference's unplanned tokens."""
    _check(two, "1x2/scout_ep/static", reference["scout_ep/static"])


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
def test_moe_ep_serve_recompute_matches_the_reference(request, reference,
                                                      dims):
    """``token_logps(plan=)`` with ``moe_ep="serve"``: every rank forwards
    the whole batch, which the layer cuts over 'data' (the reference's
    ``shard_map`` rows) and gathers back; within 1e-4 of the reference's
    unplanned ``token_logps``."""
    for out in _ranks(request, dims):
        np.testing.assert_allclose(out[f"{_tag(dims)}/scout_ep/logps/lp"],
                                   reference["scout_ep/logps"], rtol=0,
                                   atol=TOL_LP)


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
@pytest.mark.parametrize("model", ["scout", "maverick"])
def test_each_rank_holds_its_fitted_share(request, dims, model):
    """Per rank, every param leaf (both engines) holds the element count
    of its fitted serve sharding: on 1x2 half of the experts (2 of 4) and
    of the heads, FFN and vocab; on 2x1 half of every expert's FFN
    columns; on 2x2 a quarter of the experts' weights. The pools hold
    their KV heads over 'model'."""
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in MODELS[model].items()})
    plan = ExecutionPlan(abstract_mesh(dims), "serve")
    ranks = _ranks(request, dims)

    def walk(sh, shapes, path=""):
        if isinstance(sh, dict):
            for k in sh:
                yield from walk(sh[k], shapes[k], f"{path}{k}/")
            return
        yield path[:-1], int(np.prod(sh.shard_shape(shapes)))
    from repro_torch.parallel import axes
    want = dict(walk(plan.param_shardings(cfg), axes.param_shapes(cfg)))
    moe = "blocks/layer_0/moe/w_gate"
    full = int(np.prod(axes.param_shapes(cfg)["blocks"]["layer_0"]["moe"][
        "w_gate"]))
    assert want[moe] * int(np.prod(dims)) == full
    for out in ranks:
        for engine in ("continuous", "static"):
            name = f"{_tag(dims)}/{model}/{engine}"
            for path, n in want.items():
                got = out[f"{name}/numel/params/{path}"]
                assert int(np.ravel(got)[0]) == n, (engine, path)
        pool = out[f"{_tag(dims)}/{model}/continuous/numel/pool/layer_0/"
                   "self/kp"]
        pages = 1 + ENGINE["num_slots"] * -(-30 // ENGINE["page_size"])
        kv = cfg.num_kv_heads // dims[1]
        assert int(pool[0]) == cfg.num_blocks * pages * \
            ENGINE["page_size"] * kv * cfg.head_dim


def _serve(cmd, mesh):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(cmd + ["-m", "repro_torch.launch.serve", "--device",
                                 "cpu", "--smoke", "--arch", SCOUT, "--mesh",
                                 mesh], capture_output=True, text=True,
                          env=env, timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    return [line.split(" | ")[-1] for line in proc.stdout.splitlines()
            if line.startswith("[serve] round")]


def test_serve_launcher_serves_scout_on_a_1x2_mesh_under_torchrun():
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.serve --device cpu --smoke --arch
    llama4-scout-17b-a16e --mesh 1x2``: rank 0's rounds print the 1x1
    run's tokens."""
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "2"]
    two = _serve(torchrun, "1x2")
    assert len(two) == 2 and two == _serve([sys.executable], "1x1")
