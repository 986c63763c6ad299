"""The port's placement rules and plans against the JAX package's.

``repro_torch.parallel.axes`` (``param_specs``, ``opt_specs`` for AdamW
and Adafactor, ``batch_specs``, ``cache_specs`` for a dense cache and a
paged pool, ``act_sharding_for``, ``fit_spec``) must give the JAX
package's specs, entry for entry, for every registry config, the four
modes and the meshes 1x1, 2x2, 2x4 and 2x2x2. The JAX side runs on
``jax.sharding.AbstractMesh`` in this process (no devices); the port's
on ``abstract_mesh``. Specs are compared after one normalisation: a
one-axis tuple entry is the axis name. Exact equality, no tolerance.

Also the plan's own contract on the CPU without a process group: the
local plan launches nothing and places tensors, a mesh larger than the
group raises with the ``torchrun`` recipe, ``batch_shardings`` refuses
unknown keys, and an abstract plan's shard grid tiles every leaf. A live
mesh on a one-rank gloo group built without a device places on the card
whenever CUDA is available, and placement never moves a card tensor to
the host.
"""
import datetime

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.models import init_cache as jinit_cache
from repro.models import init_params as jinit_params
from repro.models.params import abstract_params as jabstract_params
from repro.parallel import axes as jaxes
from repro.sampling.paged_cache import init_paged_pool as jinit_paged_pool
from repro_torch import configs as tconfigs
from repro_torch.models import init_cache, init_params, params_from_numpy
from repro_torch.optim import tree_leaves
from repro_torch.parallel import (ExecutionPlan, abstract_mesh, local_plan,
                                  make_debug_mesh, mesh_from_flag,
                                  plan_from_flag)
from repro_torch.parallel.plan import placement_device
from repro_torch.parallel import axes as taxes
from repro_torch.sampling.paged_cache import init_paged_pool

MESHES = [(1, 1), (2, 2), (2, 4), (2, 2, 2)]
NAMES = sorted(tconfigs.ALL)


def _meshes(dims):
    names = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return AbstractMesh(dims, names), abstract_mesh(dims, names)


def _norm_entry(e):
    if isinstance(e, tuple):
        return e[0] if len(e) == 1 else tuple(e)
    return e


def _norm(spec):
    return tuple(_norm_entry(e) for e in spec)


def _flat_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): _norm(s) for path, s in flat}


def _flat_port(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_port(v, path + (k,)))
        return out
    return {"/".join(str(p) for p in path): _norm(tree)}


def test_registry_matches():
    assert NAMES == sorted(jconfigs.ALL)


@pytest.mark.parametrize("name", NAMES)
def test_param_opt_and_fitted_specs_match_jax(name):
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    shapes = _flat_jax(jax.tree_util.tree_map(
        lambda a: jax.sharding.PartitionSpec(*a.shape),
        jabstract_params(jcfg)))
    assert _flat_port(taxes.param_shapes(tcfg)) == shapes
    for dims in MESHES:
        jm, tm = _meshes(dims)
        for mode in taxes.MODES:
            jp = jaxes.param_specs(jcfg, mode, jm)
            tp = taxes.param_specs(tcfg, mode, tm)
            assert _flat_port(tp) == _flat_jax(jp), (dims, mode)
            jfit = {k: _norm(jaxes.fit_spec(jm, jax.sharding.PartitionSpec(
                *s), shapes[k])) for k, s in _flat_jax(jp).items()}
            tfit = {k: _norm(taxes.fit_spec(tm, taxes.P(*s), shapes[k]))
                    for k, s in _flat_port(tp).items()}
            assert tfit == jfit, (dims, mode)
            for opt in ("adamw", "adafactor"):
                jo = jaxes.opt_specs(jp, opt)
                to = taxes.opt_specs(tp, opt)
                assert type(jo).__name__ == type(to).__name__
                for field in jo._fields:
                    jv, tv = getattr(jo, field), getattr(to, field)
                    if isinstance(tv, dict):
                        assert _flat_port(tv) == _flat_jax(jv), \
                            (dims, mode, opt, field)
                    else:
                        assert _norm(tv) == _norm(jv)


@pytest.mark.parametrize("dims", MESHES, ids=lambda d: "x".join(map(str, d)))
def test_batch_act_and_fit_rules_match_jax(dims):
    jm, tm = _meshes(dims)
    for name in NAMES:
        jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
        jb, tb = jaxes.batch_specs(jcfg, jm), taxes.batch_specs(tcfg, tm)
        assert {k: _norm(v) for k, v in tb.items()} == \
            {k: _norm(v) for k, v in jb.items()}, name
    for mode in taxes.MODES:
        ja, ta = jaxes.act_sharding_for(mode, jm), \
            taxes.act_sharding_for(mode, tm)
        assert ta == ja, mode
    # fit_spec on shapes that do and do not divide, nested entries
    rng = np.random.default_rng(len(dims))
    axes_pool = [None, "data", "model", ("data", "model")]
    if len(dims) == 3:
        axes_pool += ["pod", ("pod", "data"), ("pod", "data", "model")]
    for _ in range(200):
        shape = tuple(int(x) for x in rng.integers(1, 13, size=3))
        spec = [axes_pool[i] for i in rng.integers(0, len(axes_pool), 3)]
        assert _norm(taxes.fit_spec(tm, taxes.P(*spec), shape)) == \
            _norm(jaxes.fit_spec(jm, jax.sharding.PartitionSpec(*spec),
                                 shape)), (spec, shape)


CACHE_ARCHS = ["qwen3-1.7b", "mamba2-1.3b", "whisper-small",
               "jamba-1.5-large-398b", "llama-3.2-vision-11b"]


@pytest.mark.parametrize("name", CACHE_ARCHS)
def test_cache_specs_match_jax(name):
    jcfg, tcfg = jconfigs.smoke(name), tconfigs.smoke(name)
    jp = jinit_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    memory = None
    if jcfg.is_encdec or jcfg.memory_seq:
        m = jcfg.encoder_seq if jcfg.is_encdec else jcfg.memory_seq
        memory = np.zeros((2, m, jcfg.d_model), np.float32)
    jc = jinit_cache(jcfg, jp, 2, 8, memory=None if memory is None
                     else jax.numpy.asarray(memory))
    tc = init_cache(tcfg, tp, 2, 8, memory=None if memory is None
                    else torch.from_numpy(memory))
    pools = None
    if all(k in ("attn", "local") for k in tcfg.block_pattern):
        pools = (jinit_paged_pool(jcfg, 5, 4),
                 init_paged_pool(tcfg, 5, 4, device="cpu"))
    for dims in MESHES:
        jm, tm = _meshes(dims)
        for mode in taxes.MODES:
            assert _flat_port(taxes.cache_specs(tcfg, tc, mode, tm)) == \
                _flat_jax(jaxes.cache_specs(jcfg, jc, mode, jm)), \
                (dims, mode)
            if pools is not None:
                assert _flat_port(taxes.cache_specs(tcfg, pools[1], mode,
                                                    tm)) == \
                    _flat_jax(jaxes.cache_specs(jcfg, pools[0], mode, jm))


def test_local_plan_needs_no_group_and_places_tensors():
    assert not torch.distributed.is_initialized()
    plan = plan_from_flag("1x1", "train", "cpu")
    assert plan is local_plan("train", "cpu") and not plan.mesh.live
    assert hash(plan) == hash(local_plan("train", "cpu"))
    cfg = tconfigs.smoke("qwen3-1.7b")
    p = init_params(cfg, 0, device="cpu")
    placed = plan.device_put_params(cfg, p, copy=True)
    for a, b in zip(tree_leaves(placed), tree_leaves(p)):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    full = plan.gather_params(cfg, placed)
    assert all(a is b for a, b in zip(tree_leaves(full),
                                      tree_leaves(placed)))
    assert not torch.distributed.is_initialized()


def test_mesh_larger_than_group_raises_with_the_recipe():
    with pytest.raises(RuntimeError, match="torchrun --nproc-per-node 4"):
        plan_from_flag("2x2", "train")
    with pytest.raises(RuntimeError, match="nproc-per-node 8"):
        mesh_from_flag("2x2x2")
    with pytest.raises(ValueError, match="DxM"):
        mesh_from_flag("2by2")
    with pytest.raises(ValueError, match="mode"):
        ExecutionPlan(abstract_mesh((2, 2)), "pipeline")


def test_gloo_mesh_without_a_device_never_places_on_the_host(
        tmp_path, monkeypatch):
    dist = torch.distributed
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = make_debug_mesh(1, 1)
        # no card here: the plan names no device and leaves stay put
        assert mesh.live and mesh.device is None
        plan = ExecutionPlan(mesh, "train")
        cfg = tconfigs.smoke("qwen3-1.7b")
        placed = plan.device_put_params(cfg, init_params(cfg, 0,
                                                         device="cpu"))
        assert all(t.device.type == "cpu" for t in tree_leaves(placed))
        # with a card, a gloo mesh built without a device places on it
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        assert make_debug_mesh(1, 1).device == torch.device("cuda", 0)
    finally:
        dist.destroy_process_group()
    card, host = torch.device("cuda", 0), torch.device("cpu")
    assert placement_device(None, card) == card
    assert placement_device(card, host) == card
    assert placement_device(host, host) == host
    with pytest.raises(RuntimeError, match="off the card"):
        placement_device(host, card)


def test_batch_shardings_and_shard_grid_on_an_abstract_plan():
    cfg = tconfigs.smoke("qwen3-1.7b")
    plan = ExecutionPlan(abstract_mesh((2, 2)), "train_fsdp")
    batch = {"tokens": torch.zeros(8, 10), "rewards": torch.zeros(8)}
    sh = plan.batch_shardings(cfg, batch)
    assert _norm(sh["tokens"].spec) == ("data", None)
    with pytest.raises(ValueError, match="frames"):
        plan.batch_shardings(cfg, {**batch, "frames": torch.zeros(8, 2, 2)})
    # every leaf's grid: the ranks' slices tile it, each cell held by
    # mesh size / cells ranks
    shapes = taxes.param_shapes(cfg)
    for shp, ns in zip(_leaves(shapes), _leaves(plan.param_shardings(cfg))):
        cover = np.zeros(shp, np.int32)
        for idx in ns.devices_indices_map(shp).values():
            cover[idx] += 1
        assert (cover == cover.flat[0]).all()
        cells = plan.num_devices // int(cover.flat[0])
        assert cells == int(np.prod([plan.mesh.axes_size(a)
                                     for _, a in ns.sharded_dims()]))


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


FIT_MESHES = [(1, 2), (2, 1), (2, 2), (1, 4)]


def _dense_cache_shapes(cfg, batch, length):
    """The leaf shapes of ``init_cache(cfg, ..., batch, length,
    memory=)`` at the config's full widths (a memory of its
    ``encoder_seq`` / ``memory_seq`` rows), without building it."""
    nb, kv = cfg.num_blocks, (cfg.num_kv_heads, cfg.head_dim)
    mem_rows = cfg.encoder_seq if cfg.is_encdec else cfg.memory_seq
    out = {}
    for i, kind in enumerate(cfg.block_pattern):
        layer = {}
        if kind == "mamba":
            conv = cfg.d_inner + 2 * cfg.ssm_ngroups * cfg.ssm_state
            layer["ssm_c"] = {
                "conv": (nb, batch, cfg.ssm_conv - 1, conv),
                "ssm": (nb, batch, cfg.ssm_heads, cfg.ssm_headdim,
                        cfg.ssm_state)}
        elif kind != "cross":
            rows = min(length, cfg.sliding_window) \
                if cfg.local_ring_kv and kind == "local" else length
            layer["self"] = {n: (nb, batch, rows) + kv for n in ("k", "v")}
        if kind == "cross" or cfg.is_encdec:
            layer["mem"] = {n: (nb, batch, mem_rows) + kv
                            for n in ("k_mem", "v_mem")}
        out[f"layer_{i}"] = layer
    return out


def _fit_all(fit, mesh, specs, shapes):
    return {path: _norm(fit(mesh, spec, shapes[path]))
            for path, spec in specs.items()}


def _raw_jax(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): s for path, s in flat}


def _raw_port(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_raw_port(v, path + (k,)))
        return out
    return {"/".join(str(p) for p in path): tree}


@pytest.mark.parametrize("name", NAMES)
def test_fitted_serve_and_long_specs_match_jax(name):
    """The fitted specs (``fit_spec`` of the mode's rules over each
    leaf's shape) of every param and every dense-cache leaf, at the
    config's full widths (a batch of 4 and a cache of 8192 + 64
    positions), equal the JAX package's on the ``serve`` and ``long``
    modes over 1x2, 2x1, 2x2 and 1x4: the shards a serving rank holds."""
    jcfg, tcfg = jconfigs.get_config(name), tconfigs.get_config(name)
    pshapes = _raw_port(taxes.param_shapes(tcfg))
    cshapes = _dense_cache_shapes(tcfg, 4, 8256)
    jcache = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s, jax.numpy.float32), cshapes,
        is_leaf=lambda x: isinstance(x, tuple))
    flat_c = _raw_port(cshapes)
    for dims in FIT_MESHES:
        jm, tm = _meshes(dims)
        for mode in ("serve", "long"):
            got = _fit_all(taxes.fit_spec, tm, _raw_port(
                taxes.param_specs(tcfg, mode, tm)), pshapes)
            want = _fit_all(jaxes.fit_spec, jm, _raw_jax(
                jaxes.param_specs(jcfg, mode, jm)), pshapes)
            assert got == want, (dims, mode)
            got = _fit_all(taxes.fit_spec, tm, _raw_port(
                taxes.cache_specs(tcfg, cshapes, mode, tm)), flat_c)
            want = _fit_all(jaxes.fit_spec, jm, _raw_jax(
                jaxes.cache_specs(jcfg, jcache, mode, jm)), flat_c)
            assert got == want, (dims, mode)
