"""The SSM and memory families on live ``serve`` plans on the CPU: the
port's ``StaticEngine`` and ``token_logps`` on 1x2 and 2x2 plans of gloo
rank processes against the JAX package's unplanned runs.

As in ``tests/test_torch_static_plan.py`` (whose rank script,
``_torch_static_ranks.py``, runs these cases), the reference is the JAX
package's *unplanned* ``StaticEngine`` and ``token_logps`` on the same
weights, prompts, memory and key (its own plan runs fail under jax 0.9.0,
ROADMAP queue 3). Models, float32 smokes:

- ``mamba2-1.3b`` (2 Mamba2 layers, 16 SSM heads, fused fan-out 1104,
  576 conv channels; its embedding scaled by ``EMBED_SCALE``): each rank keeps the reference's contiguous cuts of
  ``in_proj``, the conv and the heads, gathers the projection and the
  conv's output, and scans its heads (the control: each rank scanning
  the next rank's heads misses); ``token_logps`` runs the scan
  through K6's twin (``ssd_impl="pallas"``) against the reference's
  chunked SSD;
- ``whisper-small`` (2 encoder and 2 decoder layers, Hq 4, Hkv 2): the
  plan's ``encode`` of the frames (bidirectional, on each rank's heads),
  then the static engine with the memory's rows split over 'model' where
  they divide it (32 frames) and whole where they do not (31);
- ``llama-3.2-vision-11b`` (4 self-attention layers and a CROSS layer):
  16 patch rows (split) and 17 (whole: every rank holds every row and
  runs K5's twin on its heads with no merge).

The memory models run their prefill and cross-attention through K5's twin
(``attn_impl="pallas"``) against the reference's naive attention. Every
rank emits the reference's tokens, log-probs within 1e-4, and holds the
plan's fitted share of the dense cache (conv channels and SSM heads; the
memory's rows).
"""
import dataclasses
import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_parallel_ranks import run_job
from repro import configs as jconfigs
from repro.config import RLConfig as JRLConfig
from repro.models import encode as jencode
from repro.models import init_params as jinit_params
from repro.sampling.engine import StaticEngine as JStaticEngine
from repro.sampling.engine import token_logps as jtoken_logps
from repro.serving.api import Request as JRequest
from repro.serving.api import SamplingParams as JSamplingParams
from repro_torch import configs as tconfigs
from repro_torch.config import ModelConfig
from repro_torch.parallel import ExecutionPlan, abstract_mesh

SCRIPT = Path(__file__).resolve().parent / "_torch_static_ranks.py"
ARCHS = {"mamba": ("mamba2-1.3b", dict(ssd_impl="pallas")),
         "whisper": ("whisper-small", dict(attn_impl="pallas")),
         "vlm": ("llama-3.2-vision-11b", dict(attn_impl="pallas"))}
MODELS = {k: dataclasses.asdict(tconfigs.smoke(name, **over))
          for k, (name, over) in ARCHS.items()}
PLANS = [(1, 2), (2, 2)]
NEW = 6
VOCAB_LIMIT = 500
# name -> (model, memory rows or None, key)
TRAFFIC = {"mamba": ("mamba", None, 0),
           "whisper-32": ("whisper", 32, 1), "whisper-31": ("whisper", 31, 2),
           "vlm-16": ("vlm", 16, 3), "vlm-17": ("vlm", 17, 4)}
TOL_LP = 1e-4
# the mamba2 smoke's tied N(0, 1) embedding makes it a copy machine: the
# residual carries the input token's row, whose logit ||e||^2 ~ d = 256
# outweighs everything the Mamba2 layers add, so every draw is the argmax
# at logp 0 whatever the scan computes. Its embedding is scaled down so the
# layers decide the logits.
EMBED_SCALE = 0.05


def _jcfg(model):
    return jconfigs.smoke(ARCHS[model][0])


def _inputs():
    rng = np.random.default_rng(25)
    out = {"p10": rng.integers(3, 500, (4, 10)),
           "lp": rng.integers(3, 512, (4, 13))}
    for name, (model, rows, _) in TRAFFIC.items():
        if rows is not None:
            scale = 1.0 if model == "whisper" else 0.02
            out[f"mem/{name}"] = (scale * rng.standard_normal(
                (4, rows, MODELS[model]["d_model"]))).astype(np.float32)
    return out


def _tag(dims):
    return f"{dims[0]}x{dims[1]}"


def _cases(world):
    cases = []
    for dims in PLANS:
        if int(np.prod(dims)) != world:
            continue
        base = dict(mesh=list(dims), mode="serve", max_new=NEW,
                    vocab_limit=VOCAB_LIMIT)
        for name, (model, rows, key) in TRAFFIC.items():
            mem = None if rows is None else f"mem/{name}"
            cases.append(dict(base, name=f"{_tag(dims)}/{name}",
                              kind="static", model=model, prompts="p10",
                              key=key, memory=mem))
            if name == "mamba":
                cases.append(dict(base, name=f"{_tag(dims)}/ssm_control",
                                  kind="ssm_control", model=model,
                                  prompts="p10", key=key, memory=None))
            if name in ("mamba", "whisper-32", "vlm-17"):
                cases.append(dict(base, name=f"{_tag(dims)}/{name}/logps",
                                  kind="logps", model=model, prompts="lp",
                                  memory=mem))
    return cases


@pytest.fixture(scope="module")
def weights():
    out, jp = {}, {}
    for i, model in enumerate(MODELS):
        params = jinit_params(_jcfg(model), jax.random.PRNGKey(20 + i))
        if model == "mamba":
            params["embed"] = params["embed"] * EMBED_SCALE
        jp[model] = params
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            out[f"{model}/" + "/".join(p.key for p in path)] = \
                np.asarray(leaf)
    return out, jp


def _job(tmp_path_factory, weights, world):
    out, _ = weights
    spec = {"cases": _cases(world), "models": MODELS,
            "meshes": [list(d) for d in PLANS if np.prod(d) == world]}
    return run_job(tmp_path_factory.mktemp(f"family{world}"), spec,
                   {**out, **_inputs()}, world=world, script=SCRIPT)


@pytest.fixture(scope="module")
def two(tmp_path_factory, weights):
    return _job(tmp_path_factory, weights, 2)


@pytest.fixture(scope="module")
def four(tmp_path_factory, weights):
    return _job(tmp_path_factory, weights, 4)


@functools.lru_cache(maxsize=None)
def _jax_encode(model):
    """The reference's jitted ``encode``, built once."""
    cfg = _jcfg(model)
    return jax.jit(lambda p, f: jencode(cfg, p, f))


def _jax_memory(jp, model, name):
    if name not in TRAFFIC or TRAFFIC[name][1] is None:
        return None
    x = jnp.asarray(_inputs()[f"mem/{name}"])
    if model == "whisper":
        return _jax_encode(model)(jp, x)
    return x


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's unplanned static engine and ``token_logps``."""
    _, jp = weights
    rl = JRLConfig(temperature=1.0, top_k=0, top_p=1.0, max_new_tokens=NEW)
    sp = JSamplingParams(temperature=1.0, top_k=0, top_p=1.0,
                         max_new_tokens=NEW)
    inputs, runs = _inputs(), {}
    for name, (model, _, key) in TRAFFIC.items():
        mem = _jax_memory(jp[model], model, name)
        eng = JStaticEngine(_jcfg(model), jp[model], rl=rl,
                            vocab_limit=VOCAB_LIMIT, memory=mem,
                            key=jax.random.PRNGKey(key))
        res = eng.generate([JRequest(rid=i, prompt=p, params=sp)
                            for i, p in enumerate(inputs["p10"])])
        runs[name] = (np.concatenate([r.tokens for r in res]),
                      np.concatenate([r.logps for r in res]),
                      np.array([r.gen_count for r in res]))
        runs[f"{name}/logps"] = np.asarray(jtoken_logps(
            _jcfg(model), jp[model], jnp.asarray(inputs["lp"]), memory=mem))
    return runs


def _ranks(request, dims):
    return request.getfixturevalue("two" if np.prod(dims) == 2 else "four")


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
@pytest.mark.parametrize("traffic", list(TRAFFIC))
def test_family_serves_the_unplanned_reference_on_a_plan(request, reference,
                                                         dims, traffic):
    tokens, logps, lengths = reference[traffic]
    name = f"{_tag(dims)}/{traffic}"
    for r, out in enumerate(_ranks(request, dims)):
        np.testing.assert_array_equal(out[f"{name}/lengths"], lengths,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[f"{name}/tokens"], tokens,
                                      err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{name}/logps"], logps, rtol=0,
                                   atol=TOL_LP, err_msg=f"rank {r}")


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
def test_mamba_split_control_misses_the_bar(request, reference, dims):
    """The control: each rank scanning the next rank's SSM heads (its own
    A, D, dt bias, state and norm) misses the reference on every rank."""
    tokens, logps, lengths = reference["mamba"]
    name = f"{_tag(dims)}/ssm_control"
    for out in _ranks(request, dims):
        held = (np.array_equal(out[f"{name}/lengths"], lengths)
                and np.array_equal(out[f"{name}/tokens"], tokens)
                and np.abs(out[f"{name}/logps"] - logps).max() <= TOL_LP)
        assert not held


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
@pytest.mark.parametrize("traffic", ["mamba", "whisper-32", "vlm-17"])
def test_family_token_logps_on_a_plan(request, reference, dims, traffic):
    """Teacher-forced log-probs of random tokens within 1e-4 of the
    reference's."""
    want = reference[f"{traffic}/logps"]
    for r, out in enumerate(_ranks(request, dims)):
        np.testing.assert_allclose(out[f"{_tag(dims)}/{traffic}/logps/lp"],
                                   want, rtol=0, atol=TOL_LP,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("dims", PLANS, ids=_tag)
@pytest.mark.parametrize("traffic", list(TRAFFIC))
def test_family_cache_is_the_fitted_share(request, dims, traffic):
    """Each leaf of a rank's dense cache (k/v, k_mem/v_mem, conv, ssm) has
    the shard shape of the plan's fitted ``cache_specs``."""
    model, rows, _ = TRAFFIC[traffic]
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in MODELS[model].items()})
    plan = ExecutionPlan(abstract_mesh(dims), "serve")
    b, length = 4, 10 + NEW
    shapes = {}
    for i, kind in enumerate(cfg.block_pattern):
        layer = {}
        if kind == "mamba":
            conv = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
            layer["ssm_c"] = {
                "conv": (cfg.num_blocks, b, cfg.ssm_conv - 1, conv),
                "ssm": (cfg.num_blocks, b, cfg.ssm_heads, cfg.ssm_headdim,
                        cfg.ssm_state)}
        elif kind != "cross":
            layer["self"] = {n: (cfg.num_blocks, b, length, cfg.num_kv_heads,
                                 cfg.head_dim) for n in ("k", "v")}
        if kind == "cross" or cfg.is_encdec:
            layer["mem"] = {n: (cfg.num_blocks, b, rows, cfg.num_kv_heads,
                                cfg.head_dim) for n in ("k_mem", "v_mem")}
        shapes[f"layer_{i}"] = layer
    sh = plan.cache_shardings(cfg, shapes)
    name = f"{_tag(dims)}/{traffic}"
    for out in _ranks(request, dims):
        for li, layer in shapes.items():
            for part, leaves in layer.items():
                for n, full in leaves.items():
                    want = sh[li][part][n].shard_shape(full)
                    got = tuple(out[f"{name}/cache/{li}/{part}/{n}"])
                    assert got == want, (li, part, n, got, want)
