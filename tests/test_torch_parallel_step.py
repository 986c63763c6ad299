"""The sharded learner step on 4 gloo ranks against the JAX package's
single-device step.

One job of 4 rank processes (``tests/_torch_parallel_ranks.py``, a gloo
group through a ``file://`` store under ``tmp_path``, one torch thread
each, the job under a 240 s timeout) runs ``make_sharded_train_step`` /
``make_sharded_sft_step`` on the 2x2 ``train`` and ``train_fsdp`` plans
and two pod meshes (2x2x1 ``train``, 2x1x2 ``train_fsdp``), with AdamW and
Adafactor at ``grad_accum`` 1 and 2, a tiny MoE at a capacity that drops
tokens, the expert-parallel MoE (``moe_ep="train"``) at a capacity that
drops none, and SFT. Each is held against the JAX package's
``train_step`` / SFT step on one device from the same numpy inputs (the
JAX weights carried across), at the bars of
``tests/test_parallel_parity.py``: params rtol 5e-4 / atol 1e-5, metrics
rtol 2e-3 / atol 1e-5. The JAX MoE runs through ``tests/_jax_moe_ref.py``
(the reference with a kept-only scatter, ROADMAP queue 3).

The expert-parallel case leaves ``moe_load_balance`` out: it is the mean
of the shards' own products (as in the JAX package's ``moe_ffn_ep``, whose
test allows 0.1), not the product of global means.

Controls: the wrong microbatch order (the batch sharded first and cut
into microbatches locally, fed as the permutation it amounts to) must
miss the bars. Every rank's stored shards have the shapes of the JAX
package's fitted specs on the same mesh, and every rank's publish of the
sharded params writes the manifest the abstract 2x2 plan writes for the
gathered params.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import AbstractMesh

from _jax_moe_ref import patch_jax_moe
from _torch_parallel_ranks import run_job
from repro import optim as joptim
from repro import training as jtraining
from repro.config import ModelConfig as JModelConfig
from repro.config import RLConfig as JRLConfig
from repro.config import TrainConfig as JTrainConfig
from repro.models import init_params as jinit_params
from repro.models.params import abstract_params as jabstract_params
from repro.parallel import axes as jaxes
from repro.parallel import local_plan as jlocal_plan
from repro.parallel import make_sharded_sft_step as jsft_step
from repro_torch.checkpoint import PolicyStore
from repro_torch.config import ModelConfig
from repro_torch.models import params_from_numpy
from repro_torch.parallel import ExecutionPlan, abstract_mesh
from repro_torch.transport import publish_params

WORLD = 4
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=48,
            num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=32,
            dtype="float32", attn_impl="naive", remat=False, rope_theta=1e4)
MOE = dict(name="moe-tiny", family="moe", num_layers=2, d_model=32,
           num_heads=4, num_kv_heads=2, d_ff=48, vocab_size=32,
           block_pattern=("attn",), ffn_pattern=("moe",), num_experts=4,
           experts_per_token=2, capacity_factor=0.5, dtype="float32",
           attn_impl="naive", remat=False, rope_theta=1e4)
MODELS = {"tiny": TINY, "moe": MOE, "moe_nodrop": dict(MOE,
                                                       capacity_factor=8.0)}
RL = dict(loss_type="gepo", group_size=4, beta_kl=0.005)


def _tc(accum):
    return dict(learning_rate=1e-3, grad_accum=accum, total_steps=10)


def _case(name, mesh=(2, 2), mode="train", model="tiny", opt="adamw",
          accum=2, **kw):
    return dict(name=name, mesh=list(mesh), mode=mode, model=model,
                optimizer=opt, tc=_tc(accum), batch=0, kind="rl", **kw)


CASES = [
    _case("train-adamw-a1", accum=1),
    _case("train-adamw-a2", publish=True),
    _case("train-adafactor-a2", opt="adafactor"),
    _case("fsdp-adamw-a2", mode="train_fsdp"),
    _case("fsdp-adafactor-a1", mode="train_fsdp", opt="adafactor",
          accum=1),
    _case("pod-train-adamw-a2", mesh=(2, 2, 1)),
    _case("pod-fsdp-adafactor-a2", mesh=(2, 1, 2), mode="train_fsdp",
          opt="adafactor"),
    _case("sft-train", accum=1, kind_sft=True),
    _case("moe-drops-a2", model="moe"),
    _case("moe-ep-nodrop-a1", model="moe_nodrop", accum=1, moe_ep="train"),
    # the batch sharded first and cut into microbatches on each rank:
    # rank r's microbatch i is rows 4r + 2i, 4r + 2i + 1, so the
    # microbatches are rows {0, 1, 4, 5} and {2, 3, 6, 7}
    _case("control-wrong-order", perm=[0, 1, 4, 5, 2, 3, 6, 7]),
]
for c in CASES:
    if c.pop("kind_sft", False):
        c.update(kind="sft", batch=1)
BY_NAME = {c["name"]: c for c in CASES}


def _flat(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flat(v, key + "/"))
        else:
            out[key] = np.asarray(v)
    return out


def _jparams(model):
    return jinit_params(JModelConfig(**MODELS[model]),
                        jax.random.PRNGKey(7))


def _batches():
    rng = np.random.default_rng(3)
    out = {}
    for b in (0, 1):
        out[b] = {
            "tokens": rng.integers(0, 32, (8, 10)).astype(np.int32),
            "mask": (np.ones((8, 9)) if b == 0 else
                     (rng.uniform(size=(8, 9)) > 0.3)).astype(np.float32),
            "sampler_lp": -np.abs(rng.standard_normal((8, 9))).astype(
                np.float32),
            "rewards": (rng.uniform(size=8) > 0.5).astype(np.float32)}
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    inputs = {}
    for model in MODELS:
        for k, v in _flat(_jparams(model)).items():
            inputs[f"{model}/{k}"] = v
    for b, batch in _batches().items():
        for k, v in batch.items():
            inputs[f"batch{b}/{k}"] = v
    return run_job(tmp_path_factory.mktemp("ranks"),
                   {"cases": CASES, "models": MODELS, "rl": RL}, inputs,
                   world=WORLD)


def _reference(case, monkeypatch):
    """The JAX package's one-device step on the case's inputs: (params,
    metrics) as flat numpy dicts."""
    model = case["model"]
    jcfg = JModelConfig(**MODELS[model])
    if model != "tiny":
        patch_jax_moe(monkeypatch)
    jtc = JTrainConfig(**case["tc"])
    batch = {k: jnp.asarray(v) for k, v in _batches()[case["batch"]].items()}
    params = _jparams(model)
    if case["kind"] == "sft":
        state = jtraining.init_state(jcfg, jtc, params)
        state, loss = jsft_step(jcfg, jtc, jlocal_plan("train"))(
            state, batch["tokens"], batch["mask"])
        return _flat(state.params), {"loss": float(loss)}
    opt = case["optimizer"]
    state = jtraining.init_state(jcfg, jtc, params, optimizer=opt)
    step = jax.jit(lambda s, b: jtraining.train_step(
        jcfg, JRLConfig(**RL), jtc, s, b, optimizer=opt))
    state, m = step(state, batch)
    return _flat(state.params), {k: float(v) for k, v in m.items()}


def _misses(case, got, monkeypatch):
    """The list of bars the case's result misses (params rtol 5e-4 /
    atol 1e-5, metrics rtol 2e-3 / atol 1e-5)."""
    name = case["name"]
    want_p, want_m = _reference(case, monkeypatch)
    miss = []
    for k, w in want_p.items():
        g = got[f"{name}/params/{k}"]
        if not np.allclose(g, w, rtol=5e-4, atol=1e-5):
            miss.append((k, float(np.max(np.abs(g - w)))))
    skip = {"moe_load_balance"} if case.get("moe_ep") else set()
    for k, w in want_m.items():
        if k in skip:
            continue
        g = float(got[f"{name}/metric/{k}"])
        if not np.isclose(g, w, rtol=2e-3, atol=1e-5):
            miss.append((k, g, w))
    return miss, want_m


@pytest.mark.parametrize("name", [c["name"] for c in CASES
                                  if not c["name"].startswith("control")])
def test_sharded_step_matches_jax_single_device(job, name, monkeypatch):
    case = BY_NAME[name]
    miss, want_m = _misses(case, job[0], monkeypatch)
    assert not miss, miss
    if name == "moe-drops-a2":
        assert want_m["moe_drop_frac"] > 0.05     # the capacity drops
    if name.startswith("moe-ep"):
        assert float(job[0][f"{name}/metric/moe_drop_frac"]) == 0.0


def test_wrong_microbatch_order_misses_the_bars(job, monkeypatch):
    case = dict(BY_NAME["control-wrong-order"])
    miss, _ = _misses(case, job[0], monkeypatch)
    assert len(miss) > 5, miss


@pytest.mark.parametrize("name", [c["name"] for c in CASES])
def test_stored_shards_have_the_fitted_shapes(job, name):
    case = BY_NAME[name]
    dims = tuple(case["mesh"])
    mesh = AbstractMesh(dims, ("data", "model") if len(dims) == 2
                        else ("pod", "data", "model"))
    jcfg = JModelConfig(**MODELS[case["model"]])
    opt = "adamw" if case["kind"] == "sft" else case["optimizer"]
    avals = jabstract_params(jcfg)
    pspecs = jaxes.param_specs(jcfg, case["mode"], mesh)
    init = joptim.adamw_init if opt == "adamw" else joptim.adafactor_init
    oavals = jax.eval_shape(init, avals)
    ospecs = jaxes.opt_specs(pspecs, opt)
    want = {}
    trees = [("params", pspecs, avals)] + [
        (f"opt.{f}", getattr(ospecs, f), getattr(oavals, f))
        for f in oavals._fields if f != "step"]
    for tag, specs, av in trees:
        flat_s = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
        )[0]
        flat_a = jax.tree_util.tree_leaves(av)
        for (path, s), a in zip(flat_s, flat_a, strict=True):
            fit = jaxes.fit_spec(mesh, s, a.shape)
            shape = []
            for dim, entry in zip(a.shape, list(fit) + [None] * (
                    len(a.shape) - len(fit))):
                axes = () if entry is None else (
                    entry if isinstance(entry, tuple) else (entry,))
                shape.append(dim // int(np.prod([mesh.shape[x]
                                                 for x in axes])))
            key = "/".join(str(p.key) for p in path)
            want[f"{name}/shard/{tag}/{key}"] = tuple(shape)
    for out in job:
        got = {k: tuple(int(x) for x in v) for k, v in out.items()
               if k.startswith(f"{name}/shard/") and "opt.step" not in k}
        assert got == want
    # some leaf is really split on every mesh used here
    assert any(np.prod(s) < np.prod(a.shape) for s, a in zip(
        [want[k] for k in sorted(want) if "/shard/params/" in k],
        [a for a in jax.tree_util.tree_leaves(avals)]))


def test_every_rank_publishes_the_abstract_plans_manifest(job):
    case = BY_NAME["train-adamw-a2"]
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in TINY.items()})
    params = {}
    for k, v in job[0].items():
        if k.startswith("train-adamw-a2/params/"):
            node = params
            parts = k.split("/")[2:]
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    store = PolicyStore()
    plan = ExecutionPlan(abstract_mesh(tuple(case["mesh"])), case["mode"])
    stats = publish_params(store, 0, plan, cfg,
                           params_from_numpy(params, device="cpu"))
    want = store.fetch(0)[1]
    assert stats.chunks > len(jax.tree_util.tree_leaves(params))
    for out in job:
        assert bytes(out["train-adamw-a2/manifest"]) == want
