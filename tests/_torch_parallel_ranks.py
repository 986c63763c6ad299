"""One rank of the sharded-learner parity jobs (run as a script, one
process a rank, by ``run_job``, which ``tests/test_torch_parallel_*.py``
call).

    python tests/_torch_parallel_ranks.py RANK WORLD STORE_FILE WORKDIR

Joins a gloo group of WORLD ranks through a ``file://`` store (60 s
timeout, one torch thread), reads the numpy inputs of every case from
``WORKDIR/inputs.npz`` and ``WORKDIR/cases.json``, runs each case's
sharded step and writes, per rank, ``WORKDIR/out_<rank>.npz``: the
gathered params after the step and the metrics (rank 0), and the shapes
of the shards the rank stores (every rank). Imports torch and the port
only.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def run_job(work: Path, spec: dict, inputs: dict, world: int = 4,
            timeout: float = 240.0, script: str = __file__) -> list:
    """Run the ``spec`` cases (``{"cases", "models", "rl"}``) on ``world``
    rank processes of ``script`` (default this one; the serving jobs run
    ``_torch_serve_ranks.py``) over a ``file://`` store in ``work``;
    returns each rank's outputs (a dict of arrays). Every rank is killed
    at the timeout, so a hung collective fails the test instead of
    holding its worker."""
    root = Path(__file__).resolve().parents[1]
    np.savez(work / "inputs.npz", **inputs)
    (work / "cases.json").write_text(json.dumps(spec))
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), str(world),
         str(work / "store"), str(work)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            p.kill()
    if not all(p.returncode == 0 for p in procs):
        raise AssertionError("\n".join(log[-3000:] for log in logs))
    return [dict(np.load(work / f"out_{r}.npz", allow_pickle=False))
            for r in range(world)]


def _leaves_with_paths(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_paths(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def main():
    rank, world, store, work = (int(sys.argv[1]), int(sys.argv[2]),
                                sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    from repro_torch.checkpoint import PolicyStore
    from repro_torch.config import ModelConfig, RLConfig, TrainConfig
    from repro_torch.models import params_from_numpy
    from repro_torch.parallel import (ExecutionPlan, make_mesh,
                                      make_sharded_sft_step,
                                      make_sharded_train_step)
    from repro_torch.training import init_state
    from repro_torch.transport import publish_params

    inputs = np.load(os.path.join(work, "inputs.npz"))
    with open(os.path.join(work, "cases.json")) as f:
        spec = json.load(f)
    out = {}
    meshes = {}
    for case in spec["cases"]:
        name, dims = case["name"], tuple(case["mesh"])
        if dims not in meshes:               # every rank builds in order
            names = ("data", "model") if len(dims) == 2 else \
                ("pod", "data", "model")
            meshes[dims] = make_mesh(dims, names, device="cpu")
        plan = ExecutionPlan(meshes[dims], case["mode"])
        cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                             for k, v in spec["models"][case["model"]]
                             .items()})
        if case.get("moe_ep"):
            cfg = dataclasses.replace(cfg, moe_ep=case["moe_ep"],
                                      ep_dp_axes=plan.dp_axes)
        tc = TrainConfig(**case["tc"])
        pre = case["model"] + "/"
        params = params_from_numpy(
            _unflatten({k[len(pre):]: inputs[k] for k in inputs.files
                        if k.startswith(pre)}), device="cpu")
        if case["kind"] == "moe_layer":      # one MoE layer, its rows
            _moe_layer(case, cfg, plan, params, inputs, out)
            continue
        opt = case.get("optimizer", "adamw")
        state = init_state(cfg, tc, params, optimizer=opt, plan=plan)
        b = case["batch"]
        batch = {k: torch.from_numpy(inputs[f"batch{b}/{k}"])
                 for k in ("tokens", "mask", "sampler_lp", "rewards")}
        if case.get("perm"):
            batch = {k: v[case["perm"]] for k, v in batch.items()}
        if case["kind"] == "sft":
            step = make_sharded_sft_step(cfg, tc, plan)
            state, loss = step(state, batch["tokens"], batch["mask"])
            metrics = {"loss": loss}
        else:
            step = make_sharded_train_step(cfg, RLConfig(**spec["rl"]), tc,
                                           plan, optimizer=opt)
            state, metrics = step(state, batch)
        for key, leaf in _leaves_with_paths(state.params):
            out[f"{name}/shard/params/{key}"] = np.array(leaf.shape)
        for field in state.opt._fields:
            for key, leaf in _leaves_with_paths(getattr(state.opt, field)):
                out[f"{name}/shard/opt.{field}/{key}"] = np.array(leaf.shape)
        full = plan.gather_params(cfg, state.params)
        if case.get("publish"):              # every rank publishes
            ps = PolicyStore()
            publish_params(ps, 0, plan, cfg, state.params)
            out[f"{name}/manifest"] = np.frombuffer(ps.fetch(0)[1],
                                                    dtype=np.uint8)
        if rank == 0:
            for key, leaf in _leaves_with_paths(full):
                out[f"{name}/params/{key}"] = leaf.detach().numpy()
            for k, v in metrics.items():
                out[f"{name}/metric/{k}"] = np.array(float(v))
    np.savez(os.path.join(work, f"out_{rank}.npz"), **out)
    dist.destroy_process_group()


def _moe_layer(case, cfg, plan, params, inputs, out):
    """``forward``'s MoE layer alone: block 0's expert weights, this
    rank's rows of the case's x (B, S, d) over the data axes; writes the
    rank's y rows and the aux metrics."""
    from repro_torch.models.model import moe_ffn
    from repro_torch.models.moe_ep import moe_ffn_ep
    from repro_torch.parallel.collectives import own_rows
    from repro_torch.runtime_context import mesh_context
    def first(tree):
        return ({k: first(v) for k, v in tree.items()}
                if isinstance(tree, dict) else tree[0])
    p = first(params["blocks"]["layer_0"]["moe"])
    x = torch.from_numpy(inputs[case["x"]])
    rows = plan.dp_axes
    with mesh_context(plan.mesh, rows):
        fn = moe_ffn_ep if cfg.moe_ep else moe_ffn
        y, aux = fn(cfg, p, own_rows(x, plan.mesh, rows))
    name = case["name"]
    out[f"{name}/y"] = y.detach().numpy()
    for k, v in aux.items():
        out[f"{name}/metric/{k}"] = np.array(float(v))


def _unflatten(flat):
    tree = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


if __name__ == "__main__":
    main()
