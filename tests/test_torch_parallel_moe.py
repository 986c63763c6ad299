"""The expert-parallel MoE layer (``repro_torch.models.moe_ep``) on a 2x2
gloo mesh against the JAX package's ``moe_ffn_ep`` on a 2x2 mesh of
forced host devices.

The JAX side runs in a subprocess with
``--xla_force_host_platform_device_count=8``, as ``tests/test_moe_ep.py``
runs it; the port's on 4 rank processes (``tests/_torch_parallel_ranks.py``,
``file://`` store, 240 s timeout), each on its data shard's rows. Top-1
and top-2 routing, with a shared expert in one case, each at a capacity
that drops nothing (``capacity_factor`` 8) and at one that drops tokens
(0.5): the per-shard capacity ``max(int(t_loc k / E * cf), 4)`` and the
stable routed-first order decide the same drops on both sides. Output
rows within 1e-4 (the bar of ``tests/test_moe_ep.py``), the router
metrics (load balance, z-loss, drop fraction, averaged over 'model' and
'data' on both sides) within 1e-5 relative.

The same job runs ``models/moe.py`` under the plan (rows gathered over
the data axes, dispatched as one batch): at the dropping capacity its
rows equal the single-device dispatch of the whole batch, which drops
the same tokens.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parallel_ranks import run_job
from repro_torch.config import ModelConfig
from repro_torch.models import params_from_numpy
from repro_torch.models.moe import moe_ffn

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(name="moe-ep", family="moe", num_layers=1, d_model=64,
            num_heads=4, num_kv_heads=2, d_ff=128, vocab_size=256,
            block_pattern=("attn",), ffn_pattern=("moe",), num_experts=4,
            dtype="float32", attn_impl="naive", remat=False)
CASES = {f"k{k}-cf{cf}" + ("-shared" if shared else ""):
         dict(BASE, experts_per_token=k, capacity_factor=cf,
              shared_expert=shared)
         for k, shared in ((1, False), (2, True)) for cf in (8.0, 0.5)}

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses, json
    import jax, numpy as np
    from repro.config import ModelConfig
    from repro.models.moe_ep import moe_ffn_ep
    from repro.models.params import init_params
    from repro.runtime_context import mesh_context
    work = sys.argv[1]
    cases = json.load(open(os.path.join(work, "jax_cases.json")))
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    x = np.load(os.path.join(work, "x.npy"))
    out = {}
    for name, kw in cases.items():
        kw = {k: tuple(v) if isinstance(v, list) else v
              for k, v in kw.items()}
        cfg = ModelConfig(**kw)
        params = init_params(cfg, jax.random.PRNGKey(0))
        for k, v in jax.tree_util.tree_leaves_with_path(params):
            out[name + "/params/" + "/".join(str(p.key) for p in k)] = \\
                np.asarray(v)
        moe = jax.tree_util.tree_map(lambda a: a[0],
                                     params["blocks"]["layer_0"]["moe"])
        cfg_ep = dataclasses.replace(cfg, moe_ep="train",
                                     ep_dp_axes=("data",))
        with mesh_context(mesh):
            y, aux = jax.jit(lambda p, x: moe_ffn_ep(cfg_ep, p, x))(moe, x)
        out[name + "/y"] = np.asarray(y)
        for k, v in aux.items():
            out[name + "/metric/" + k] = np.asarray(v)
    np.savez(os.path.join(work, "jax.npz"), **out)
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("moe")
    x = (0.5 * np.random.default_rng(1).standard_normal((4, 16, 64))
         ).astype(np.float32)
    np.save(work / "x.npy", x)
    (work / "jax_cases.json").write_text(json.dumps(CASES))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT, str(work)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax_out = dict(np.load(work / "jax.npz"))
    inputs = {"x": x}
    models, cases = {}, []
    for name, kw in CASES.items():
        models[name] = kw
        for k, v in jax_out.items():
            if k.startswith(name + "/params/"):
                inputs[name + "/" + k[len(name + "/params/"):]] = v
        cases.append(dict(name=name, mesh=[2, 2], mode="train",
                          model=name, tc={}, kind="moe_layer", x="x",
                          moe_ep="train"))
        cases.append(dict(name=name + "/gspmd", mesh=[2, 2], mode="train",
                          model=name, tc={}, kind="moe_layer", x="x"))
    ranks = run_job(work, {"cases": cases, "models": models, "rl": {}},
                    inputs)
    return x, jax_out, ranks


def _rows(ranks, name):
    """(4, 16, 64) from the ranks' rows (rank 2d + m holds data shard d);
    the two model ranks of a data shard agree bit for bit."""
    parts = []
    for d in range(2):
        a, b = ranks[2 * d][f"{name}/y"], ranks[2 * d + 1][f"{name}/y"]
        np.testing.assert_array_equal(a, b)
        parts.append(a)
    return np.concatenate(parts)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_ep_matches_jax_moe_ffn_ep(runs, name):
    _, jax_out, ranks = runs
    y = _rows(ranks, name)
    assert np.max(np.abs(y - jax_out[name + "/y"])) < 1e-4
    for k in ("moe_load_balance", "moe_z_loss", "moe_drop_frac"):
        want = float(jax_out[f"{name}/metric/{k}"])
        for r in ranks:
            np.testing.assert_allclose(float(r[f"{name}/metric/{k}"]), want,
                                       rtol=1e-5, atol=1e-7, err_msg=k)
    drops = float(jax_out[f"{name}/metric/moe_drop_frac"])
    assert (drops > 0) == name.startswith(("k1-cf0.5", "k2-cf0.5")), drops


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_under_a_data_sharded_plan_drops_as_one_device(runs, name):
    x, jax_out, ranks = runs
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in CASES[name].items()}
    cfg = ModelConfig(**kw)
    tree = {}
    for k, v in jax_out.items():
        if k.startswith(name + "/params/blocks/layer_0/moe/"):
            parts = k.split("/")[5:]
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v[0]
    p = params_from_numpy(tree, device="cpu")
    with torch.no_grad():
        want, aux = moe_ffn(cfg, p, torch.from_numpy(x))
    got = _rows(ranks, name + "/gspmd")
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
    for k, v in aux.items():
        np.testing.assert_allclose(float(ranks[0][f"{name}/gspmd/metric/"
                                                  f"{k}"]), float(v),
                                   rtol=1e-6, err_msg=k)
    assert dataclasses.replace(cfg, moe_ep="serve").moe_ep == "serve"
