"""The static engine on live ``serve`` and ``long`` plans on the CPU: the
port's context-parallel dense-cache decode against the JAX package.

The JAX package's own plan runs fail here (its explicit-mesh sharding
under jax 0.9.0, ROADMAP queue 3), and its contract is that a plan's
tokens equal the unplanned run's. So each plan is held to the reference's
*unplanned* ``StaticEngine`` (or ``token_logps``) on the same weights
(``params_from_numpy``), prompts and key.

The ranks run as subprocesses (``_torch_parallel_ranks.run_job`` with
``_torch_static_ranks.py``: a ``file://`` store, one torch thread a rank,
240 s): ``serve`` 1x2 and 2x1 and ``long`` 1x2 on two ranks, ``serve``
2x2 and 1x4 and ``long`` 2x2 on four. On ``serve`` the dense cache's
sequence splits over 'model' and its rows over 'data'; on ``long`` the
sequence over 'data' x 'model', every rank every row. A cache of 10 + 6
= 16 positions splits over 2 and 4 ranks; one of 9 + 6 = 15 splits over
none, and every rank takes the plain local decode. Models: the
reference's ``TINY`` dense config (2 layers, Hq 4, Hkv 2, head dim 16,
V 32; at 1x4 each rank holds one q head, and its k/v columns are cut
inside a head) and the smoke ``gemma2-9b`` with a sliding window of 8
(local and global layers, both softcaps, tied and scaled embeddings),
``local_ring_kv`` on (the ring's 8 slots split over the ranks) and off,
its prefill through K5's twin (``attn_impl="pallas"``) against the
reference's naive attention. Float32 throughout; 4 requests, 6 new
tokens, temperature 1.0 over a vocab limit. Every rank emits the
reference's tokens, log-probs within 1e-4; each rank's dense cache has
the shard shape of the plan's fitted ``cache_specs``; the ranks' partials
summed without their max rescale (the control) miss the bar.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parallel_ranks import run_job
from pathlib import Path
from repro import configs as jconfigs
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.models import init_params as jinit_params
from repro.sampling.engine import StaticEngine as JStaticEngine
from repro.sampling.engine import token_logps as jtoken_logps
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.config import ModelConfig
from repro_torch.parallel import ExecutionPlan, abstract_mesh, axes

SCRIPT = Path(__file__).resolve().parent / "_torch_static_ranks.py"
TINY = dict(name="tiny-static", family="dense", num_layers=2, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=32,
            block_pattern=["attn"], ffn_pattern=["mlp"], dtype="float32",
            attn_impl="naive", remat=False, rope_theta=1e4)
GEMMA = dict(sliding_window=8)
# TINY with its attention sharpened (wq, wk x 4: scores x 16; wo x 8), so
# that the ranks' running maxima differ and the merge's rescale shows in
# the log-probs: at init scale the scores are ~1e-2 and a merge that
# drops it stays within the bar
SHARP = {"wq": 4.0, "wk": 4.0, "wo": 8.0}
MODELS = {
    "tiny": TINY,
    "sharp": TINY,
    "gemma": dataclasses.asdict(tconfigs.smoke(
        "gemma2-9b", attn_impl="pallas", **GEMMA)),
    "gemma-ring": dataclasses.asdict(tconfigs.smoke(
        "gemma2-9b", attn_impl="pallas", local_ring_kv=True, **GEMMA)),
}
VOCAB_LIMIT = {"tiny": 20, "sharp": 20, "gemma": 500, "gemma-ring": 500}
SERVE = {2: [(1, 2), (2, 1)], 4: [(2, 2), (1, 4)]}
LONG = {2: [(1, 2)], 4: [(2, 2)]}
PLANS = [("serve", d) for w in (2, 4) for d in SERVE[w]] + \
    [("long", d) for w in (2, 4) for d in LONG[w]]
PLAN_IDS = [f"{m}-{d[0]}x{d[1]}" for m, d in PLANS]
NEW = 6
# name -> (model, prompts, key): 10 + 6 positions split over 2 and 4
# ranks, 9 + 6 over none
TRAFFIC = {
    "tiny-16": ("tiny", "p10", 0),
    "tiny-15": ("tiny", "p9", 1),
    "sharp-16": ("sharp", "p10", 5),
    "gemma-16": ("gemma", "p10", 2),
    "ring-16": ("gemma-ring", "p10", 3),
    "ring-15": ("gemma-ring", "p9", 4),
}
TOL_LP = 1e-4


def _prompts():
    rng = np.random.default_rng(24)
    return {"p10": rng.integers(3, 20, (4, 10)),
            "p9": rng.integers(3, 20, (4, 9)),
            "lp": rng.integers(3, 32, (3, 13))}


def _jcfg(model):
    if model not in ("tiny", "sharp"):
        return jconfigs.smoke("gemma2-9b", local_ring_kv=model.endswith(
            "ring"), **GEMMA)
    kw = dict(TINY, block_pattern=tuple(TINY["block_pattern"]),
              ffn_pattern=tuple(TINY["ffn_pattern"]))
    return JModelConfig(**kw)


def _tag(mode, dims):
    return f"{mode}/{dims[0]}x{dims[1]}"


def _cases(world):
    plans = [("serve", d) for d in SERVE[world]] + \
        [("long", d) for d in LONG[world]]
    cases = []
    for mode, dims in plans:
        base = dict(mesh=list(dims), mode=mode, max_new=NEW)
        for name, (model, prompts, key) in TRAFFIC.items():
            cases.append(dict(base, name=f"{_tag(mode, dims)}/{name}",
                              kind="static", model=model, prompts=prompts,
                              key=key, vocab_limit=VOCAB_LIMIT[model]))
        cases.append(dict(base, name=f"{_tag(mode, dims)}/control",
                          kind="control", model="sharp", prompts="p10",
                          key=5, vocab_limit=VOCAB_LIMIT["sharp"]))
        cases.append(dict(base, name=f"{_tag(mode, dims)}/logps",
                          kind="logps", model="tiny", prompts="lp"))
        cases.append(dict(base, name=f"{_tag(mode, dims)}/generate",
                          kind="generate", model="tiny", prompts="p9",
                          key=1, vocab_limit=VOCAB_LIMIT["tiny"]))
    return cases


@pytest.fixture(scope="module")
def weights():
    """Each model's JAX weights (numpy leaves by path, and the tree)."""
    out, jp = {}, {}
    for i, model in enumerate(MODELS):
        params = jinit_params(_jcfg(model), jax.random.PRNGKey(10 + i))
        if model == "sharp":
            attn = params["blocks"]["layer_0"]["attn"]
            for k, f in SHARP.items():
                attn[k] = attn[k] * f
        jp[model] = params
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{model}/" + "/".join(p.key for p in path)] = \
                np.asarray(leaf)
    return out, jp


def _job(tmp_path_factory, weights, world):
    out, _ = weights
    spec = {"cases": _cases(world), "models": MODELS,
            "meshes": [list(d) for d in SERVE[world] + LONG[world]]}
    return run_job(tmp_path_factory.mktemp(f"static{world}"), spec,
                   {**out, **_prompts()}, world=world, script=SCRIPT)


@pytest.fixture(scope="module")
def two(tmp_path_factory, weights):
    return _job(tmp_path_factory, weights, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory, weights):
    return _job(tmp_path_factory, weights, 4)


def _ranks(request, dims):
    return request.getfixturevalue("two" if np.prod(dims) == 2 else "four")


def _jax_run(jp, model, prompts, key):
    """The reference's unplanned static engine: (tokens, logps, lengths)
    of requests 0..3 (its legacy ``generate`` wraps its step in the
    explicit-mesh constraint that fails under jax 0.9.0)."""
    rl = JRLConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=NEW)
    sp = JSamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                         max_new_tokens=NEW)
    eng = JStaticEngine(_jcfg(model), jp[model], rl=rl,
                        vocab_limit=VOCAB_LIMIT[model],
                        key=jax.random.PRNGKey(key))
    res = eng.generate([JRequest(rid=i, prompt=p, params=sp)
                        for i, p in enumerate(_prompts()[prompts])])
    return (np.concatenate([r.tokens for r in res]),
            np.concatenate([r.logps for r in res]),
            np.array([r.gen_count for r in res]))


@pytest.fixture(scope="module")
def reference(weights):
    _, jp = weights
    runs = {name: _jax_run(jp, *t) for name, t in TRAFFIC.items()}
    runs["logps"] = np.asarray(jtoken_logps(
        _jcfg("tiny"), jp["tiny"], jnp.asarray(_prompts()["lp"])))
    return runs


def _held(out, name, want):
    tokens, logps, lengths = want
    return (np.array_equal(out[f"{name}/lengths"], lengths)
            and np.array_equal(out[f"{name}/tokens"], tokens)
            and np.abs(out[f"{name}/logps"] - logps).max() <= TOL_LP)


def _check(ranks, name, want):
    tokens, logps, lengths = want
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"{name}/lengths"], lengths,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{name}/tokens"], tokens,
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{name}/logps"], logps, rtol=0,
                                   atol=TOL_LP, err_msg=f"rank {r}")


@pytest.mark.parametrize("mode,dims", PLANS, ids=PLAN_IDS)
@pytest.mark.parametrize("traffic", list(TRAFFIC))
def test_static_plan_matches_the_unplanned_reference(request, reference,
                                                     mode, dims, traffic):
    ranks = _ranks(request, dims)
    _check(ranks, f"{_tag(mode, dims)}/{traffic}", reference[traffic])


@pytest.mark.parametrize("mode,dims", PLANS, ids=PLAN_IDS)
def test_legacy_generate_on_a_plan(request, reference, mode, dims):
    """``generate(engine="static", plan=)`` serves the reference's
    unplanned tokens on every rank."""
    _check(_ranks(request, dims), f"{_tag(mode, dims)}/generate",
           reference["tiny-15"])


@pytest.mark.parametrize("mode,dims", PLANS, ids=PLAN_IDS)
def test_token_logps_on_a_plan(request, reference, mode, dims):
    for r, out in enumerate(_ranks(request, dims)):
        np.testing.assert_allclose(out[f"{_tag(mode, dims)}/logps/lp"],
                                   reference["logps"], rtol=0, atol=TOL_LP,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("mode,dims", PLANS, ids=PLAN_IDS)
def test_unrescaled_combine_misses_the_bar(request, reference, mode, dims):
    """The control: where the 16-position cache splits over the ranks
    (every plan but 2x1 ``serve``, whose sequence axis has size 1), the
    ranks' partials weighted by their sums alone, without exp(m - max),
    miss the reference; where it does not split, nothing is merged and
    the run is the reference's."""
    ranks = _ranks(request, dims)
    name = f"{_tag(mode, dims)}/control"
    split = not (mode == "serve" and dims[1] == 1)
    for out in ranks:
        assert _held(out, name, reference["sharp-16"]) != split


@pytest.mark.parametrize("mode,dims", PLANS, ids=PLAN_IDS)
@pytest.mark.parametrize("traffic", ["tiny-16", "tiny-15", "ring-16"])
def test_each_rank_holds_its_fitted_share_of_the_cache(request, mode, dims,
                                                       traffic):
    """Every leaf of a rank's dense cache has the shard shape of the
    plan's fitted ``cache_specs`` (the sequence over 'model' or 'data' x
    'model', the rows over 'data' on ``serve``), and the shards tile the
    whole cache."""
    ranks = _ranks(request, dims)
    model, prompts, _ = TRAFFIC[traffic]
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in MODELS[model].items()})
    b, tp = _prompts()[prompts].shape
    plan = ExecutionPlan(abstract_mesh(dims), mode)
    name = f"{_tag(mode, dims)}/{traffic}"
    rows = {i: min(tp + NEW, cfg.sliding_window)
            if cfg.local_ring_kv and k == "local" else tp + NEW
            for i, k in enumerate(cfg.block_pattern)}
    shapes = {f"layer_{i}": {"self": {
        n: (cfg.num_blocks, b, rows[i], cfg.num_kv_heads, cfg.head_dim)
        for n in ("k", "v")}} for i in rows}
    sh = plan.cache_shardings(cfg, shapes)
    seen = 0
    for i in rows:
        for n in ("k", "v"):
            full = shapes[f"layer_{i}"]["self"][n]
            want = sh[f"layer_{i}"]["self"][n].shard_shape(full)
            for out in ranks:
                got = tuple(out[f"{name}/cache/layer_{i}/self/{n}"])
                assert got == want, (i, n, got, want)
            split = int(np.prod(full)) // int(np.prod(want))
            seen += split > 1
    if traffic != "tiny-15" and (mode, dims) != ("serve", (2, 1)):
        assert seen, "a 16-position cache splits on this plan"


# --------------------------------------------------------------------------
# the front door on a 1x2 mesh, under torchrun


def _door_reference(prompts, max_new):
    """The reference's unplanned continuous engine on the launcher's
    weights (the port's ``init_params(smoke("qwen3-1.7b"), 0)``), profile,
    budget and key: requests 0..n-1 (the door's rids in arrival order)."""
    import torch
    from repro.config import ServeConfig as JServeConfig
    from repro.data import Tokenizer as JTokenizer
    from repro.sampling import build_engine as jbuild_engine
    from repro_torch.models import init_params
    with torch.no_grad():
        tp = init_params(tconfigs.smoke("qwen3-1.7b"), 0, device="cpu")

    def to_jax(t):
        return {k: to_jax(v) for k, v in t.items()} if isinstance(t, dict) \
            else jnp.asarray(t.numpy())
    jcfg = jconfigs.smoke("qwen3-1.7b", paged_attn_impl="ref")
    rl = JRLConfig(temperature=0.6, top_k=20, top_p=0.95,
                   max_new_tokens=max_new, engine="continuous")
    eng = jbuild_engine(jcfg, to_jax(tp), JServeConfig(
        max_total_tokens=64 + 16, num_slots=8, page_size=16,
        sync_every=8), rl=rl, vocab_limit=JTokenizer().vocab_size,
        key=jax.random.PRNGKey(0))
    sp = JSamplingParams(temperature=0.6, top_k=20, top_p=0.95,
                         max_new_tokens=max_new)
    return eng.generate([JRequest(rid=i, prompt=np.asarray(p, np.int32),
                                  params=sp) for i, p in enumerate(prompts)])


def test_front_door_on_a_1x2_mesh_under_torchrun():
    """``torchrun --standalone --nproc-per-node 2 -m
    repro_torch.launch.serve --device cpu --smoke --mesh 1x2 --listen
    --port 0``: rank 0 serves HTTP and rank 1 follows its engine rounds.
    Requests posted one after another to rank 0 (rids 0, 1, ... in
    order) get the reference's unplanned continuous-engine tokens under
    the same key (log-probs within 1e-4); a SIGINT to torchrun ends every
    process."""
    import json
    import os
    import re
    import signal
    import subprocess
    import sys
    import time
    import urllib.request
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(root / "src"), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.serve",
         "--device", "cpu", "--smoke", "--mesh", "1x2", "--listen",
         "--port", "0"], cwd=root, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    rng = np.random.default_rng(26)
    prompts = [rng.integers(3, 30, n).tolist() for n in (5, 12, 9, 20)]
    max_new = 8
    lines, got = [], []
    try:
        deadline = time.monotonic() + 180
        port = None
        while port is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"listening on 127\.0\.0\.1:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "".join(lines[-40:])
        assert any("[serve] ExecutionPlan(mode=serve, mesh=1dx2m" in ln
                   for ln in lines)
        for p in prompts:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/generate", data=json.dumps(
                    {"tokens": p, "max_new_tokens": max_new}).encode())
            with urllib.request.urlopen(req, timeout=120) as resp:
                got.append(json.loads(resp.read()))
    finally:
        os.killpg(proc.pid, signal.SIGINT)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    want = _door_reference(prompts, max_new)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["tokens"], w.tokens)
        np.testing.assert_allclose(g["logps"], w.logps, rtol=0, atol=TOL_LP)
    assert len(got) == len(prompts)
