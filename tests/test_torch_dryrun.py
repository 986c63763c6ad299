"""The port's dry-run (``repro_torch.launch.dryrun``) on a fake process
group, in a subprocess (the group is global to its process).

The JAX package's ``tests/test_dryrun_small.py`` lowers the train step of
three archs' smokes on a (2, 2, 2) mesh of 8 fake devices; its run fails
under jax 0.9.0 (ROADMAP queue 3), so the port is held to the plan's
fitted shardings instead. On an 8-rank ``fake`` group and
``make_debug_mesh(2, 2, multi_pod=True)``, at ``ShapeConfig("tiny_train",
64, 16, "train")``, each smoke's sharded train step runs under fake
tensors, and:

- the rank's input bytes equal the sum over the fitted
  ``state_shardings`` and ``batch_shardings`` of its shard shapes;
- the all-gather bytes the collectives counted equal an independent sum:
  each microbatch gathers, one split dim at a time, the leaves outside
  the blocks once (at the start of its forward) and every block's leaves
  twice (in its forward and in the backward's recompute: the smokes run
  with remat), plus the loss's row gathers of the log-probs and
  entropies, and (the MoE smoke) each MoE forward's gather of its token
  rows, which the remat runs twice;
- the all-reduce bytes are nonzero (the gradients' sum over the rows).

A serve-mode decode at 64 positions on a (2, 4) mesh runs a smoke of 6 q
heads, which 'model' 4 cuts inside a head (``ServeShard.q_cols``), and
``--list`` prints the production grid with no jax imported.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ("internlm2-1.8b", "mamba2-1.3b", "llama4-scout-17b-a16e")

SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import numpy as np
    from repro_torch.config import MOE, RLConfig, ShapeConfig
    from repro_torch.configs import smoke
    from repro_torch.launch import dryrun, step_fns as sf
    from repro_torch.parallel import ExecutionPlan, make_debug_mesh

    dryrun.join_fake_group(8, 0)
    mesh = make_debug_mesh(2, 2, multi_pod=True, device="cpu")
    shape = ShapeConfig("tiny_train", 64, 16, "train")

    def pairs(sh, tree, path=()):
        if isinstance(tree, dict):
            for k in tree:
                yield from pairs(sh[k], tree[k], path + (k,))
        elif isinstance(tree, tuple):
            for s, t in zip(sh, tree):
                yield from pairs(s, t, path)
        else:
            yield sh, tree, path

    def nbytes(shape, t):
        return int(np.prod(shape)) * t.element_size()

    def gathered(s, t, block):
        # one all-gather per split dim, each returning the wider leaf; a
        # block's leaf without the stacked blocks' axis (never split)
        shp, tot = list(s.shard_shape(tuple(t.shape))), 0
        for dim, axes_ in s.sharded_dims():
            shp[dim] *= mesh.axes_size(axes_)
            tot += nbytes(shp[1:] if block else shp, t)
        return tot

    out = {}
    for arch in %(archs)r:
        cfg = dataclasses.replace(smoke(arch), remat=True)
        rec = dryrun.lower_combo(cfg, shape, mesh, rl=RLConfig(group_size=4),
                                 verbose=False)
        plan = ExecutionPlan(mesh, "train")
        sh = plan.state_shardings(cfg, sf.optimizer_for(cfg))
        state = sf.abstract_state(cfg)
        batch = sf.abstract_batch(cfg, shape)
        bsh = plan.batch_shardings(cfg, batch)
        inputs = sum(nbytes(s.shard_shape(tuple(t.shape)), t)
                     for s, t, _ in pairs(sh, state))
        inputs += sum(nbytes(bsh[k].shard_shape(tuple(v.shape)), v)
                      for k, v in batch.items())
        b, s = shape.global_batch, shape.seq_len
        accum = max(1, min(sf.grad_accum_for(cfg), b // 4))   # pod x data
        gathers = 0
        for sh_, t, path in pairs(sh.params, state.params):
            if "blocks" in path:            # per block: forward, recompute
                gathers += accum * 2 * t.shape[0] * gathered(sh_, t, True)
            else:
                gathers += accum * gathered(sh_, t, False)
        gathers += 2 * b * (s - 1) * 4          # log-probs and entropies
        moe = cfg.num_layers // cfg.period * sum(
            cfg.ffn_kind(i) == MOE for i in range(cfg.period))
        gathers += 2 * moe * b * (s - 1) * cfg.d_model * 4
        out[arch] = dict(rec=rec, inputs=inputs, gathers=gathers)

    # serve-mode decode on (2, 4): 6 q heads of 64 columns over 'model' 4
    mesh = make_debug_mesh(2, 4, device="cpu")
    cfg = dataclasses.replace(smoke("qwen2-7b"), num_heads=6)
    decode = ShapeConfig("tiny_decode", 64, 4, "decode")
    rec = dryrun.lower_combo(cfg, decode, mesh, verbose=False)
    shard = ExecutionPlan(mesh, "serve").serve_shard(cfg)
    out["decode"] = dict(rec=rec, q_cols=shard.q_cols,
                         q_heads=shard.q_heads)
    out["jax"] = "jax" in sys.modules
    print(json.dumps(out))
""")


def _run(args, timeout):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    for k in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(k, None)
    proc = subprocess.run([sys.executable] + args, capture_output=True,
                          text=True, env=env, timeout=timeout, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:] + proc.stdout[-2000:]
    return proc.stdout


@pytest.fixture(scope="module")
def runs():
    out = _run(["-c", SCRIPT % {"archs": ARCHS}], timeout=300)
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_runs_on_the_multipod_debug_mesh(runs, arch):
    run = runs[arch]
    rec = run["rec"]
    assert rec["mode"] == "train" and rec["mesh"] == "2x2x2"
    assert rec["devices"] == 8 and rec["rank"] == 0
    assert rec["entry_arg_bytes_per_dev"] == run["inputs"]
    assert rec["collectives"]["all-gather"] == run["gathers"]
    assert rec["collectives"]["all-reduce"] > 0
    assert rec["collective_bytes_per_dev"] == sum(rec["collectives"].values())
    assert rec["hbm_fit_80g"] and rec["flops_per_dev"] > 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")


def test_serve_decode_runs_with_a_q_head_cut_over_model(runs):
    rec, jax_loaded = runs["decode"]["rec"], runs["jax"]
    assert rec["mode"] == "serve" and rec["mesh"] == "2x4"
    assert runs["decode"]["q_cols"] is not None       # cut inside a head
    assert rec["collectives"]["all-gather"] > 0       # q to whole heads
    assert rec["collectives"]["all-reduce"] > 0       # wo's row sums
    assert rec["entry_out_bytes_per_dev"] > 0
    assert not jax_loaded


def test_list_prints_the_production_grid_without_jax():
    code = ("import runpy, sys; sys.argv = ['dryrun', '--list']; "
            "runpy.run_module('repro_torch.launch.dryrun', "
            "run_name='__main__'); print('JAX', 'jax' in sys.modules)")
    lines = _run(["-c", code], timeout=120).strip().splitlines()
    assert lines[-1] == "JAX False"
    grid = lines[:-1]
    assert len(grid) == 10 * 4 * 2               # archs x shapes x meshes
    assert "qwen2-7b x decode_32k x 16x16" in grid
    assert "mamba2-1.3b x long_500k x 2x16x16" in grid
    assert "qwen2-7b x long_500k x 16x16   [SKIP: sub-quadratic gate]" in grid
