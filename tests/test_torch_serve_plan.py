"""Tensor-parallel serving on the CPU: the port's ``ContinuousEngine`` on
live ``serve`` plans of gloo rank processes against the JAX package.

The JAX package's own plan runs fail here (its explicit-mesh sharding
under jax 0.9.0, ROADMAP queue 3), and its contract is that a plan's
tokens equal the unplanned run's
(``tests/test_paged_attention.py::TestTensorParallel``). So each plan is
held to the reference's *unplanned* ``generate_continuous`` (or its
engine, for the shared-prefix and speculative cases) on the same weights
(``params_from_numpy``), prompts and key.

The ranks run as subprocesses (``_torch_parallel_ranks.run_job`` with
``_torch_serve_ranks.py``: a ``file://`` store, one torch thread a rank,
240 s): 1x2 and 2x1 on two ranks, 2x2 and 1x4 on four. At 1x4 the two KV
heads do not split over four ranks, so the pools hold every KV head and
each rank attends its one q head. Configs: the reference's paged
``TINY`` (2 layers, Hq 4, Hkv 2, V 32) and ``GQA_LOCAL`` (4 layers, a
sliding window of 6), and the smoke ``gemma2-9b`` (local and global
layers, both softcaps, tied and scaled embeddings: the vocab shard of
``embed`` serves the lookup and, transposed, the head), float32,
``paged_attn_impl="ref"``. Traffic: the
reference's (4 prompts of 5 and of 9 tokens, 6 new, 2 slots, page 4,
prefill chunk 3 for the 9-token prompts, sync every 2, temperature 1.0,
vocab limit 20), a shared-prefix pair whose second request is admitted
into the other slot (the other data rank) after the first one's prompt is
cached, and a spec_k=3 run on 1x2. Tokens are held exactly on every rank,
log-probs within 1e-4; each rank holds exactly 1/M of every leaf the
plan's fitted spec splits.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parallel_ranks import run_job
from repro import configs as jconfigs
from repro.config import ATTN as JATTN
from repro.config import LOCAL as JLOCAL
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.models import init_params as jinit_params
from repro.sampling import generate_continuous as jgenerate_continuous
from repro.sampling.continuous import ContinuousEngine as JContinuousEngine
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.config import ModelConfig
from repro_torch.parallel import ExecutionPlan, abstract_mesh, axes

ROOT = Path(__file__).resolve().parents[1]
SCRIPT = Path(__file__).resolve().parent / "_torch_serve_ranks.py"
TINY = dict(name="tiny-paged", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=32,
            block_pattern=["attn"], ffn_pattern=["mlp"], dtype="float32",
            attn_impl="naive", remat=False, rope_theta=1e4,
            paged_attn_impl="ref")
MODELS = {"tiny": TINY,
          "local": dict(TINY, name="tiny-paged-local", num_layers=4,
                        block_pattern=["attn", "local"], sliding_window=6),
          "gemma": dataclasses.asdict(dataclasses.replace(
              tconfigs.smoke("gemma2-9b"), paged_attn_impl="ref"))}
WORLDS = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
ENGINE = dict(max_new=6, vocab_limit=20, num_slots=2, page_size=4,
              sync_every=2)
# name -> (kind, model, prompts, key, prefill chunk, extra)
TRAFFIC = {
    "tiny-5": ("generate", "tiny", "p5", 0, None, {}),
    "tiny-9": ("generate", "tiny", "p9", 1, 3, {}),
    "local-9": ("generate", "local", "p9", 1, 3, {}),
    "gemma-9": ("generate", "gemma", "p9", 5, 3, {}),
    # key 4: the first request is still decoding when the second is
    # admitted (under key 2 it draws EOS first and frees slot 0)
    "prefix": ("prefix", "tiny", "shared", 4, 3, {"steps_before": 3}),
}
SPEC = ("spec", "tiny", "pattern", 3, 3, {"spec_k": 3})
TOL_LP = 1e-4


def _prompts():
    rng = np.random.default_rng(23)
    shared = rng.integers(3, 32, (2, 9))
    shared[1, :7] = shared[0, :7]            # 7 shared: a page + a CoW tail
    shared[1, 7] = 3 if shared[0, 7] != 3 else 4
    pattern = np.array([[5, 6, 7] * 3, [9, 4] * 4 + [9],
                        [11, 12, 13, 14] * 2 + [11], [8] * 9])
    return {"p5": rng.integers(3, 32, (4, 5)),
            "p9": rng.integers(3, 32, (4, 9)),
            "shared": shared, "pattern": pattern}


def _jcfg(model):
    if model == "gemma":
        return dataclasses.replace(jconfigs.smoke("gemma2-9b"),
                                   paged_attn_impl="ref")
    kw = dict(MODELS[model])
    kw["block_pattern"] = tuple(JLOCAL if k == "local" else JATTN
                                for k in kw["block_pattern"])
    kw["ffn_pattern"] = tuple(kw["ffn_pattern"])
    return JModelConfig(**kw)


def _case(name, dims, traffic):
    kind, model, prompts, key, chunk, extra = traffic
    return dict(name=name, mesh=list(dims), kind=kind, model=model,
                prompts=prompts, key=key,
                engine=dict(ENGINE, prefill_chunk=chunk,
                            spec_k=extra.get("spec_k", 0)),
                steps_before=extra.get("steps_before", 0))


def _cases(world):
    cases = [_case(f"{d[0]}x{d[1]}/{t}", d, TRAFFIC[t])
             for d in WORLDS[world] for t in TRAFFIC]
    if world == 2:
        cases.append(_case("1x2/spec", (1, 2), SPEC))
        cases.append(dict(name="node", kind="node", model="node"))
    return cases


@pytest.fixture(scope="module")
def weights():
    """Each model's JAX weights (numpy) and config; the node case's three
    versions of tests/test_torch_hetero.py's TINY."""
    out, jp = {}, {}
    for i, model in enumerate(MODELS):
        params = jinit_params(_jcfg(model), jax.random.PRNGKey(i))
        jp[model] = params
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            key = "/".join(p.key for p in path)
            out[f"{model}/{key}"] = np.asarray(leaf)
    node_cfg = dict(name="tiny", family="dense", num_layers=2, d_model=48,
                    num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=32,
                    block_pattern=("attn",), ffn_pattern=("mlp",),
                    dtype="float32", attn_impl="naive", remat=False,
                    rope_theta=1e4)
    for tag, seed in (("node", 5), ("node_v1", 6), ("node_v2", 7)):
        params = jinit_params(JModelConfig(**node_cfg), jax.random.PRNGKey(
            seed))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{tag}/" + "/".join(p.key for p in path)] = np.asarray(leaf)
    node_cfg = dict(node_cfg, block_pattern=["attn"], ffn_pattern=["mlp"])
    return out, jp, dict(MODELS, node=node_cfg)


def _job(tmp_path_factory, weights, world):
    out, _, models = weights
    prompts = _prompts()
    work = tmp_path_factory.mktemp(f"serve{world}")
    spec = {"cases": _cases(world), "models": models,
            "meshes": [list(d) for d in WORLDS[world]]}
    return run_job(work, spec, {**out, **prompts}, world=world,
                   script=SCRIPT)


@pytest.fixture(scope="module")
def two(tmp_path_factory, weights):
    return _job(tmp_path_factory, weights, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory, weights):
    return _job(tmp_path_factory, weights, 4)


def _jax_run(traffic, jp):
    """The reference, unplanned: (tokens, logps, lengths[, prefix hits])
    of one traffic."""
    kind, model, prompts, key, chunk, extra = traffic
    cfg, params = _jcfg(model), jp[model]
    prompts = _prompts()[prompts]
    rl = JRLConfig(temperature=1.0, top_k=0, top_p=1.0,
                   max_new_tokens=ENGINE["max_new"])
    k = jax.random.PRNGKey(key)
    if kind == "generate":
        roll = jgenerate_continuous(
            cfg, rl, params, jnp.asarray(prompts), k,
            max_new=ENGINE["max_new"], vocab_limit=ENGINE["vocab_limit"],
            num_slots=ENGINE["num_slots"], page_size=ENGINE["page_size"],
            prefill_chunk=chunk, sync_every=ENGINE["sync_every"])
        mask = np.asarray(roll["comp_mask"]) > 0
        return (np.asarray(roll["completions"])[mask],
                np.asarray(roll["sampler_lp"])[mask], mask.sum(1), None)
    eng = JContinuousEngine(
        cfg, params, rl=rl, max_total_tokens=prompts.shape[1]
        + ENGINE["max_new"], num_slots=ENGINE["num_slots"],
        page_size=ENGINE["page_size"], sync_every=ENGINE["sync_every"],
        prefill_chunk=chunk, vocab_limit=ENGINE["vocab_limit"],
        prefix_cache=kind == "prefix", spec_k=extra.get("spec_k", 0), key=k)
    sp = JSamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                         max_new_tokens=ENGINE["max_new"])
    reqs = [JRequest(rid=i, prompt=p, params=sp)
            for i, p in enumerate(prompts)]
    if kind == "spec":
        res = eng.generate(reqs)
    else:
        eng.submit(reqs[0])
        for _ in range(extra["steps_before"]):
            eng.step(now_s=0.0)
        eng.submit(reqs[1])
        while eng.has_work():
            eng.step(now_s=0.0)
        res = [eng.pop_result(0), eng.pop_result(1)]
    return (np.concatenate([r.tokens for r in res]),
            np.concatenate([r.logps for r in res]),
            np.array([r.gen_count for r in res]),
            np.array([r.prefix_hit_tokens for r in res])
            if kind == "prefix" else None)


@pytest.fixture(scope="module")
def reference(weights):
    _, jp, _ = weights
    runs = {name: _jax_run(t, jp) for name, t in TRAFFIC.items()}
    runs["spec"] = _jax_run(SPEC, jp)
    return runs


def _check(ranks, name, want):
    tokens, logps, lengths, hits = want
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"{name}/lengths"], lengths,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{name}/tokens"], tokens,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{name}/tokens"],
                                      ranks[0][f"{name}/tokens"])
        np.testing.assert_allclose(out[f"{name}/logps"], logps, rtol=0,
                                   atol=TOL_LP, err_msg=f"rank {r}")
        if hits is not None:
            np.testing.assert_array_equal(out[f"{name}/prefix_hits"], hits)


@pytest.mark.parametrize("dims", WORLDS[2] + WORLDS[4],
                         ids=lambda d: f"{d[0]}x{d[1]}")
@pytest.mark.parametrize("traffic", list(TRAFFIC))
def test_serve_plan_matches_the_unplanned_reference(request, reference,
                                                    dims, traffic):
    ranks = request.getfixturevalue("two" if np.prod(dims) == 2 else "four")
    name = f"{dims[0]}x{dims[1]}/{traffic}"
    _check(ranks, name, reference[traffic])
    if traffic == "prefix":
        # the second request shares 7 tokens (a full page and a
        # copy-on-write tail) and was admitted into slot 1: on a 2xM plan
        # the other data rank than the first request's slot 0
        assert reference["prefix"][3][1] == 7
        for out in ranks:
            assert int(out[f"{name}/second_slot"]) == 1


def test_spec_rounds_on_a_1x2_plan(two, reference):
    _check(two, "1x2/spec", reference["spec"])
    for out in two:
        rounds, drafted, diff = out["1x2/spec/spec"]
        assert rounds > 0 and drafted > 0
        assert diff == 0.0          # the folded K4 replay, per rank's heads


@pytest.mark.parametrize("dims", WORLDS[2] + WORLDS[4],
                         ids=lambda d: f"{d[0]}x{d[1]}")
def test_each_rank_holds_its_share_of_the_weights_and_pools(request, dims):
    """Per rank, a leaf the fitted serve spec splits holds exactly 1/M of
    its elements (the weights are replicated over 'data'), any other
    leaf all of them; at 1xM the heavy leaves split, and the pools split
    their KV heads where Hkv divides M."""
    ranks = request.getfixturevalue("two" if np.prod(dims) == 2 else "four")
    name = f"{dims[0]}x{dims[1]}/prefix"
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in TINY.items()})
    plan = ExecutionPlan(abstract_mesh(dims), "serve")
    m = dims[1]
    split = set()

    def walk(sh, shapes, path=""):
        if isinstance(sh, dict):
            for k in sh:
                walk(sh[k], shapes[k], f"{path}{k}/")
            return
        full = int(np.prod(shapes))
        div = m if sh.sharded_dims() else 1
        if div > 1:
            split.add(path[:-1])
        for out in ranks:
            numel, on_cpu = out[f"{name}/numel/params/{path[:-1]}"]
            assert numel * div == full and on_cpu, path
    walk(plan.param_shardings(cfg), axes.param_shapes(cfg))
    if m > 1:
        for leaf in ("embed", "blocks/layer_0/attn/wq",
                     "blocks/layer_0/attn/wo", "blocks/layer_0/mlp/w_gate",
                     "blocks/layer_0/mlp/w_up", "blocks/layer_0/mlp/w_down",
                     "lm_head"):
            assert leaf in split
    pool = 1 + 2 * -(-15 // 4)             # scratch + 2 slots x 4 pages
    full = cfg.num_blocks * pool * 4 * cfg.num_kv_heads * cfg.head_dim
    div = m if cfg.num_kv_heads % m == 0 else 1
    for out in ranks:
        for leaf in ("kp", "vp"):
            numel, on_cpu = out[f"{name}/numel/pool/layer_0/self/{leaf}"]
            assert numel * div == full and on_cpu


def test_sampler_node_syncs_its_cells_and_refits(two):
    """A SamplerNode on a 1x2 serve plan syncs a version published on a 2x1
    learner plan, fetching only the chunks its rank's shards overlap,
    serves the one-device node's batch, and ``sync(plan=)`` re-fits it
    onto the 2x1 serve plan with the next version."""
    for out in two:
        fetched, needed, total = out["node/fetched"]
        assert fetched == needed < total
        assert out["node/v1_equal"] and out["node/v2_equal"]
        assert out["node/refit"].all()
        for tag in ("batch", "refit"):
            got, want = out[f"node/{tag}_tokens"]
            np.testing.assert_array_equal(got, want)
            got, want = out[f"node/{tag}_lp"]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(two[0]["node/batch_tokens"],
                                  two[1]["node/batch_tokens"])


@pytest.mark.parametrize("what", ["static", "generate_static", "long",
                                  "moe", "threads", "long_static", "door",
                                  "node_static", "ssm", "memory",
                                  "head_split", "ssm_split"])
def test_what_a_1x2_plan_does_not_serve_raises(two, what):
    """On a live 1x2 plan, on every rank: what used to raise serves now
    (the continuous engine on a ``long`` plan and scout's smoke on the
    ``serve`` plan emit the one-device tokens; the threaded runtime takes
    its steps on the sampler plan), as do the cases ported before (the
    static engine through ``build_engine`` and the legacy ``generate``, on
    ``serve`` and on ``long``, the front door, a ``SamplerNode`` on the
    static engine, the SSM and memory families). What a 1x2 plan still
    does not serve raises ``NotImplementedError`` naming ROADMAP queue 1
    item 5: a q head cut over 'model', SSM heads that split apart from
    their channels."""
    for out in two:
        assert out[f"refuse/{what}"]


def _serve(cmd, mesh):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(cmd + ["-m", "repro_torch.launch.serve", "--device",
                                 "cpu", "--smoke", "--mesh", mesh],
                          capture_output=True, text=True, env=env,
                          timeout=240, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    return proc.stdout


def test_serve_launcher_on_a_1x2_mesh_under_torchrun():
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.serve --device cpu --smoke --mesh 1x2`` exits 0;
    rank 0 prints the plan and the 1x1 run's tokens."""
    torchrun = [sys.executable, "-m", "torch.distributed.run",
                "--standalone", "--nproc-per-node", "2"]
    two = _serve(torchrun, "1x2")
    one = _serve([sys.executable], "1x1")
    assert "[serve] ExecutionPlan(mode=serve, mesh=1dx2m, devices=2)" in two
    pick = re.compile(r"round (\d+): (\d+) tokens .* rid (\d+): (\[.*\])")
    rounds = [pick.search(line).groups() for line in two.splitlines()
              if line.startswith("[serve] round")]
    assert len(rounds) == 2
    assert rounds == [pick.search(line).groups() for line in
                      one.splitlines() if line.startswith("[serve] round")]
