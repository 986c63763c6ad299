"""Multi-pod dry-run: run one rank's step of every (architecture x input
shape x mesh) on a fake process group of 256 or 512 ranks, and record
the cost-model and roofline numbers of that rank (the port of
``repro/launch/dryrun.py``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      [--arch all|<id>] [--shape all|<name>] [--mesh single|multi|both] \\
      [--out results/dryrun] [--list] [--include-paper-archs] \\
      [--optimized] [--rank R]

For each mesh (16x16 = 256 ranks, 2x16x16 = 512) the process joins a
``fake`` process group (``torch.testing._internal.distributed.fake_pg``:
collectives return at once, moving nothing) as rank ``--rank`` (default
0) and builds the live production mesh on it. For each combination it
builds the ``ExecutionPlan`` with the JAX dry-run's mode choices
(``train`` / ``serve`` / ``long``; under ``--optimized`` ``train_fsdp``
for dense training, ``moe_ep`` for MoE train and prefill, and
``local_ring_kv`` for sliding-window decode), makes the rank's state,
cache and batch as fake tensors of their fitted shard shapes, and runs
the port's step once under ``FakeTensorMode``: shapes and dtypes flow
through every op, collective and kernel wrapper, and nothing is
allocated. That is the port's "lowers". A combination that raises there
is a failure.

Each record (``--out``/<arch>__<shape>__<mesh>[__opt].json) has the JAX
dry-run's keys where they mean the same thing: ``flops_per_dev``,
``flops_per_dev_ideal``, ``bytes_per_dev``, ``bytes_breakdown`` (the
cost model, ``launch.costmodel``), ``roofline``, ``model_flops_global``,
``model_flops_per_dev``, ``useful_flops_frac`` (``launch.roofline``, on
the H100's constants), ``collective_bytes_per_dev`` and ``collectives``
(the bytes the step's collectives returned on this rank, by kind,
``parallel.collectives.COLLECTIVE_BYTES``: every collective the step
issues, loops included), ``entry_arg_bytes_per_dev`` (the rank's input
bytes, summed over the fitted shardings of the step's inputs) and
``entry_out_bytes_per_dev`` (its outputs' bytes). ``hbm_fit_80g`` says
whether the inputs fit the H100's 80 GB (``parallel.mesh.HBM_BYTES``; the
JAX dry-run's ``hbm_fit_16g`` adds XLA's temporaries, which eager torch
does not plan). ``raw_cost_analysis``, ``memory_analysis`` and
``collectives_body_once`` read XLA's compiled executable; torch gives
them no input, so they are left out. ``step_s`` is the host time of the
fake step.

Combinations an architecture does not run (``configs.supports_shape``)
are skipped; the process exits 1 if any combination failed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.config import (INPUT_SHAPES, SHAPES_BY_NAME, ModelConfig,
                                RLConfig, ShapeConfig, TrainConfig)
from repro_torch.configs import ALL, ARCHS, get_config, supports_shape
from repro_torch.launch import step_fns as sf
from repro_torch.launch.costmodel import bytes_estimate, flops_estimate
from repro_torch.launch.roofline import model_flops, roofline
from repro_torch.optim import tree_leaves
from repro_torch.parallel import axes
from repro_torch.parallel.collectives import (COLLECTIVE_BYTES,
                                              reset_collective_bytes)
from repro_torch.parallel.mesh import (HBM_BYTES, Mesh, data_axes,
                                       make_production_mesh)
from repro_torch.parallel.plan import ExecutionPlan
from repro_torch.runtime_context import mesh_context

MESHES = {False: ("16x16", 256), True: ("2x16x16", 512)}


def _mode_for(shape: ShapeConfig) -> str:
    if shape.kind == "train":
        return "train"
    return "long" if shape.name == "long_500k" else "serve"


def join_fake_group(world: int, rank: int = 0) -> None:
    """Make this process rank ``rank`` of a ``fake`` process group of
    ``world`` ranks (the group it is in already, if it has that size)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)


def _tree_bytes(tree: Any) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def _shard(tree: Any, shardings: Any) -> Any:
    """A fake tensor of each meta leaf's fitted shard shape (call under
    ``FakeTensorMode``), on the CPU."""
    if isinstance(tree, dict):
        return {k: _shard(tree[k], shardings[k]) for k in tree}
    if isinstance(tree, tuple):                    # a NamedTuple state
        return type(tree)(*(_shard(t, s) for t, s in zip(tree, shardings)))
    return torch.zeros(shardings.shard_shape(tuple(tree.shape)),
                       dtype=tree.dtype, device="cpu")


def rank_param_bytes(cfg: ModelConfig, plan: ExecutionPlan) -> int:
    """The parameter bytes a rank of ``plan`` holds: every leaf's fitted
    shard in ``cfg.dtype``, summed (the params of the dry-run's step)."""
    return sum(math.prod(s.shard_shape(tuple(t.shape))) * t.element_size()
               for s, t in zip(tree_leaves(plan.param_shardings(cfg)),
                               tree_leaves(sf.abstract_params(cfg))))


def _configure(cfg: ModelConfig, shape: ShapeConfig, mesh: Mesh,
               optimized: bool) -> Tuple[ModelConfig, str, TrainConfig]:
    """The config, parameter-sharding mode and train config of one
    combination, as the JAX dry-run chooses them."""
    mode = _mode_for(shape)
    dp_prod = mesh.axes_size(data_axes(mesh))
    # micro-batches must still cover the data axes
    tc = TrainConfig(grad_accum=max(1, min(sf.grad_accum_for(cfg),
                                           shape.global_batch // dp_prod)))
    pmode = mode
    if optimized and mode == "train" and not cfg.num_experts:
        pmode, tc = "train_fsdp", TrainConfig(grad_accum=1)
    # the chunked attention in two blocks a side: under fake tensors each
    # block is a round of Python ops, and the FLOPs are the cost model's
    cfg = dataclasses.replace(
        cfg, act_sharding=axes.act_sharding_for(pmode, mesh),
        attn_chunk=max(cfg.attn_chunk, shape.seq_len // 2))
    if optimized and shape.kind == "decode" and "local" in cfg.block_pattern:
        cfg = dataclasses.replace(cfg, local_ring_kv=True)
    if optimized and cfg.num_experts and shape.kind in ("train", "prefill"):
        cfg = dataclasses.replace(
            cfg, moe_ep="train" if mode == "train" else "serve",
            ep_dp_axes=data_axes(mesh))
    return cfg, pmode, tc


def lower_combo(arch: Union[str, ModelConfig],
                shape: Union[str, ShapeConfig], mesh: Mesh, *,
                rl: Optional[RLConfig] = None, optimized: bool = False,
                verbose: bool = True) -> Dict[str, Any]:
    """Run this rank's step of one (arch, shape) on a live ``mesh`` under
    fake tensors; returns its record (see the module note). ``arch`` and
    ``shape`` are registry names, or a config and a shape of the caller's
    (the tests' smoke sizes)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg0 = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES_BY_NAME[shape] if isinstance(shape, str) else shape
    mode = _mode_for(shape)
    n_dev = mesh.size
    rl = rl or RLConfig(group_size=8)
    cfg, pmode, tc = _configure(cfg0, shape, mesh, optimized)
    plan = ExecutionPlan(mesh=mesh, mode=pmode)
    b, s = shape.global_batch, shape.seq_len
    batch = sf.abstract_batch(cfg, shape)
    reset_collective_bytes()
    t0 = time.time()
    with FakeTensorMode(), mesh_context(mesh):
        if mode == "train":
            opt = sf.optimizer_for(cfg)
            state_sh = plan.state_shardings(cfg, opt)
            state = _shard(sf.abstract_state(cfg), state_sh)
            batch_sh = plan.batch_shardings(cfg, batch)
            in_bytes = _tree_bytes(state) + _tree_bytes(
                _shard(batch, batch_sh))
            # the sharded step takes the global batch on every rank
            full = {k: torch.zeros(tuple(v.shape), dtype=v.dtype)
                    for k, v in batch.items()}
            out = sf.make_train_fn(cfg, rl, tc, plan=plan)(state, full)
        elif shape.kind == "prefill":
            keep = ("tokens", "frames", "image_embeds")
            batch = {k: v for k, v in batch.items() if k in keep}
            params = _shard(sf.abstract_params(cfg),
                            plan.param_shardings(cfg))
            rows = _shard(batch, plan.batch_shardings(cfg, batch))
            in_bytes = _tree_bytes(params) + _tree_bytes(rows)
            step = sf.make_prefill_fn(cfg, s, plan=plan, batch=b)
            out = step(params, rows)
        else:                                              # decode
            params = _shard(sf.abstract_params(cfg),
                            plan.param_shardings(cfg))
            cache_meta = sf.abstract_cache(cfg, b, s)
            cache = _shard(cache_meta, plan.cache_shardings(cfg, cache_meta))
            tok_spec = axes.P() if mode == "long" else \
                axes.P(data_axes(mesh))
            tok_sh = axes.NamedSharding(mesh, axes.fit_spec(mesh, tok_spec,
                                                            (b,)))
            token = torch.zeros(tok_sh.shard_shape((b,)), dtype=torch.int32)
            in_bytes = _tree_bytes(params) + _tree_bytes(cache) + \
                _tree_bytes(token) + 4                  # + pos, int32
            step = sf.make_decode_fn(cfg, plan, max_len=s, batch=b)
            out = step(params, cache, token, s - 1)
        out_bytes = _tree_bytes(out)
    t_step = time.time() - t0
    coll = dict(COLLECTIVE_BYTES)
    coll_total = float(sum(coll.values()))

    flops_impl = flops_estimate(cfg, shape) / n_dev
    flops_ideal = flops_estimate(cfg, shape, ideal=True) / n_dev
    byt = bytes_estimate(cfg, shape, n_dev, optimizer=sf.optimizer_for(cfg))
    terms = roofline(flops_impl, byt["total"], coll_total)
    mflops = model_flops(cfg, shape)
    record = {
        "arch": cfg0.name, "shape": shape.name, "mode": mode,
        "mesh": "x".join(map(str, mesh.dims)), "devices": int(n_dev),
        "rank": int(mesh.rank),
        "flops_per_dev": flops_impl,
        "flops_per_dev_ideal": flops_ideal,
        "bytes_per_dev": byt["total"],
        "bytes_breakdown": {k: v for k, v in byt.items() if k != "total"},
        "collective_bytes_per_dev": coll_total,
        "collectives": coll,
        "roofline": terms,
        "model_flops_global": mflops,
        "model_flops_per_dev": mflops / n_dev,
        "useful_flops_frac": (mflops / n_dev) / flops_impl
        if flops_impl else None,
        "entry_arg_bytes_per_dev": int(in_bytes),
        "entry_out_bytes_per_dev": int(out_bytes),
        "hbm_fit_80g": in_bytes < HBM_BYTES,
        "step_s": round(t_step, 2),
    }
    if verbose:
        print(f"[dryrun] {record['arch']} x {shape.name} x {record['mesh']} "
              f"(rank {mesh.rank}): RAN in {t_step:.1f}s | "
              f"args={in_bytes / 2**30:.2f}GiB "
              f"fit80G={record['hbm_fit_80g']} | "
              f"flops/dev={flops_impl:.3e} bytes/dev={byt['total']:.3e} "
              f"coll/dev={coll_total:.3e} -> {terms['bottleneck']}",
              flush=True)
    return record


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--include-paper-archs", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="the beyond-baseline modes (train_fsdp, moe_ep, "
                         "local_ring_kv)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the fake group this process plays")
    args = ap.parse_args()

    archs = (list(ALL) if args.include_paper_archs else list(ARCHS)) \
        if args.arch == "all" else [args.arch]
    shapes = [s.name for s in INPUT_SHAPES] if args.shape == "all" \
        else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    combos = [(a, s, m) for m in meshes for a in archs for s in shapes]
    if args.list:
        for a, s, m in combos:
            skip = "" if supports_shape(a, s) else \
                "   [SKIP: sub-quadratic gate]"
            print(f"{a} x {s} x {MESHES[m][0]}{skip}")
        return

    os.makedirs(args.out, exist_ok=True)
    n_ok = n_skip = n_fail = 0
    built: Dict[bool, Mesh] = {}
    for a, s, m in combos:
        mesh_name, world = MESHES[m]
        if not supports_shape(a, s):
            print(f"[dryrun] {a} x {s} x {mesh_name}: SKIP (full-attention "
                  f"arch, no sub-quadratic variant)", flush=True)
            n_skip += 1
            continue
        if m not in built:
            built.clear()                  # one fake group at a time
            join_fake_group(world, args.rank)
            built[m] = make_production_mesh(multi_pod=m, device="cpu")
        try:
            rec = lower_combo(a, s, built[m], optimized=args.optimized)
            suffix = "__opt" if args.optimized else ""
            fn = os.path.join(args.out, f"{a}__{s}__{mesh_name}{suffix}.json")
            with open(fn, "w") as f:
                json.dump(rec, f, indent=1)
            n_ok += 1
        except Exception:
            print(f"[dryrun] {a} x {s} x {mesh_name}: FAILED", flush=True)
            traceback.print_exc()
            n_fail += 1
    print(f"[dryrun] done: {n_ok} ran, {n_skip} skipped, {n_fail} failed",
          flush=True)
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
