"""Publishing on a plan's shard grid: the port's manifest under a 2x2
plan against the JAX package's.

The JAX side publishes in a subprocess on a 2x2 mesh of forced host
devices (``make_debug_mesh(2, 2)``, the params placed by the plan); the
port publishes the same weights (the JAX ``init_params`` carried across)
on an abstract 2x2 plan in this process. The manifest bytes (keys,
dtypes, shapes, every chunk's start, shape, replicas and content hash)
and the publish stats must be equal, for the ``train`` and
``train_fsdp`` modes in bfloat16 and float32. A sync with no plan
assembles the params bit for bit; a rank-scoped sync (``devices=[0]``)
fetches exactly the chunks the JAX package's device-scoped sync fetches
for its first device, fewer than all, and assembles nothing.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import ModelConfig as JModelConfig
from repro.models import init_params as jinit_params
from repro_torch.checkpoint import PolicyStore
from repro_torch.config import ModelConfig
from repro_torch.models import params_from_numpy
from repro_torch.optim import tree_leaves
from repro_torch.parallel import ExecutionPlan, abstract_mesh
from repro_torch.transport import ChunkSubscriber, publish_params

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(name="tiny", family="dense", num_layers=2, d_model=48,
            num_heads=4, num_kv_heads=2, d_ff=96, vocab_size=32,
            attn_impl="naive", remat=False, rope_theta=1e4)
RUNS = [(mode, dtype) for mode in ("train", "train_fsdp")
        for dtype in ("bfloat16", "float32")]

JAX_SCRIPT = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import dataclasses, json
    import jax
    from repro.checkpoint.store import PolicyStore
    from repro.config import ModelConfig
    from repro.models import init_params
    from repro.parallel import ExecutionPlan, make_debug_mesh
    from repro.transport import ChunkSubscriber, publish_params
    kw, runs = json.loads(sys.argv[1]), json.loads(sys.argv[2])
    mesh = make_debug_mesh(2, 2)
    out = {}
    for mode, dtype in runs:
        cfg = ModelConfig(**kw, dtype=dtype)
        plan = ExecutionPlan(mesh=mesh, mode=mode)
        params = plan.device_put_params(
            cfg, init_params(cfg, jax.random.PRNGKey(5)))
        store = PolicyStore()
        stats = publish_params(store, 0, plan, cfg, params)
        _, _, scoped = ChunkSubscriber(store).sync(
            params, cfg=cfg, plan=plan, devices=[mesh.devices.flat[0]])
        out[mode + "/" + dtype] = {
            "manifest": store.fetch(0)[1].decode(),
            "stats": dataclasses.asdict(stats),
            "scoped_chunks": scoped.chunks_fetched}
    print(json.dumps(out))
""")


@pytest.fixture(scope="module")
def jax_runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", JAX_SCRIPT,
                           json.dumps(TINY), json.dumps(RUNS)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mode,dtype", RUNS)
def test_publish_on_a_2x2_plan_matches_jax(jax_runs, mode, dtype):
    want = jax_runs[f"{mode}/{dtype}"]
    jp = jinit_params(JModelConfig(**TINY, dtype=dtype),
                      jax.random.PRNGKey(5))
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                               device="cpu")
    cfg = ModelConfig(**TINY, dtype=dtype)
    plan = ExecutionPlan(abstract_mesh((2, 2)), mode)
    store = PolicyStore()
    stats = publish_params(store, 0, plan, cfg, params)
    assert store.fetch(0)[1].decode() == want["manifest"]
    assert dataclasses.asdict(stats) == want["stats"]
    assert stats.chunks > len(tree_leaves(params))     # the grid is cut
    assert stats.max_host_egress < stats.payload_bytes

    v, tree, s = ChunkSubscriber(store).sync(params)
    assert v == 0 and s.chunks_fetched == stats.chunks_new
    for a, b in zip(tree_leaves(tree), tree_leaves(params)):
        assert a.dtype == b.dtype and torch.equal(a, b)

    sub = ChunkSubscriber(store)
    _, none, scoped = sub.sync(params, cfg=cfg, plan=plan, devices=[0])
    assert none is None
    assert scoped.chunks_fetched == want["scoped_chunks"] < stats.chunks
    with pytest.raises(ValueError, match="partial"):
        sub.sync(params, cfg=cfg, plan=plan, devices=[0], assemble=True)
    # the rest of the grid tops the cache up to a full assembly
    _, full, rest = sub.sync(params)
    assert rest.chunk_hits == scoped.chunks_fetched
    for a, b in zip(tree_leaves(full), tree_leaves(params)):
        assert torch.equal(a, b)
