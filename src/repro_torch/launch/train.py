"""Training driver: real RL training end to end, on the port.

The port of ``repro/launch/train.py``: an SFT warm start, then GEPO (or
any of the paper's loss types), online or heterogeneous, on the reduced
(smoke) variant of ``--arch`` with random weights from ``--seed``, on
``--device`` (default ``cuda``). It prints a summary JSON at the end.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
      --loss gepo --steps 200 --mode hetero --max-delay 64
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --mode hetero --steps 2 --sft-steps 2 --num-samplers 2

``--mesh DxM`` (or ``PxDxM``) builds the learner's ``ExecutionPlan``:
the SFT warm start and the RL learner run sharded on it. A mesh of more
than one rank runs under ``torchrun``, one rank a process (NCCL on
``cuda``, gloo on ``cpu``); without enough ranks it raises the
``mesh_from_flag`` error. ``--smoke`` is the quick run (2 SFT steps, 2
RL steps, 2 samplers unless given):
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
      --smoke --mesh 2x1
``--sampler-mesh DxM`` builds the samplers' ``serve`` plan
(``HeteroConfig.sampler_mesh``): every sampler node serves
tensor-parallel on it and fetches its rank's cells of each published
version, through the continuous engine. It spans the same ranks as
``--mesh`` (both meshes cover the whole group):
  torchrun --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
      --smoke --mesh 2x1 --sampler-mesh 1x2
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch.config import HeteroConfig, RLConfig, TrainConfig
from repro_torch.configs import smoke
from repro_torch.core.diagnostics import best_last_gap
from repro_torch.data import (ArithmeticTask, Tokenizer, encode_prompts,
                              score_rollouts)
from repro_torch.data.tasks import EOS
from repro_torch.hetero import HeteroRuntime, run_online
from repro_torch.models import init_params
from repro_torch.optim import tree_leaves
from repro_torch.parallel import plan_from_flag
from repro_torch.sampling import generate
from repro_torch.sampling.prng import PRNGKey
from repro_torch.training import init_state, jit_sft_step


def make_eval_fn(cfg, rl, task, tok, n_prompts=32, seed=1234):
    """Pass@1-style eval on held-out problems (greedy-ish sampling)."""
    eval_task = ArithmeticTask(max_operand=task.max_operand, ops=task.ops,
                               prompt_width=task.prompt_width, seed=seed)
    probs = eval_task.sample_batch(n_prompts)
    prompts = np.repeat(encode_prompts(tok, probs), 2, axis=0)
    key = PRNGKey(seed)

    def eval_fn(params) -> float:
        roll = generate(cfg, rl, params, prompts, key,
                        vocab_limit=tok.vocab_size)
        rewards = score_rollouts(eval_task, tok, probs,
                                 roll["completions"].cpu().numpy(), 2)
        return float(rewards.mean())
    return eval_fn


def sft_warmstart(cfg, tc, task, tok, state, steps=400, batch=64, seed=0,
                  plan=None):
    """Supervised warm start (the paper RL-tunes a pretrained model), in
    place on ``state``, through ``jit_sft_step`` on ``plan`` (default the
    ``TrainConfig.mesh`` knob). Returns ``(state, last loss)``."""
    step_fn = jit_sft_step(cfg, tc, plan=plan)
    dev = tree_leaves(state.params)[0].device
    width = task.prompt_width + 8
    loss = torch.zeros(())
    for _ in range(steps):
        probs = task.sample_batch(batch)
        rows, masks = [], []
        for p in probs:
            ids = tok.encode(p.prompt) + tok.encode(p.answer) + [EOS]
            m = ([0.0] * (len(tok.encode(p.prompt)) - 1)
                 + [1.0] * (len(tok.encode(p.answer)) + 1))
            ids += [0] * (width - len(ids))
            m += [0.0] * (width - 1 - len(m))
            rows.append(ids[:width])
            masks.append(m[:width - 1])
        state, loss = step_fn(
            state,
            torch.tensor(rows, dtype=torch.int32, device=dev),
            torch.tensor(masks, dtype=torch.float32, device=dev))
    return state, float(loss)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--loss", default="gepo")
    ap.add_argument("--mode", default="online",
                    choices=["online", "hetero"])
    ap.add_argument("--steps", type=int, default=None,
                    help="RL steps (default 120; 2 with --smoke)")
    ap.add_argument("--sft-steps", type=int, default=None,
                    help="SFT warm-start steps (default 400; 2 with "
                         "--smoke)")
    ap.add_argument("--smoke", action="store_true",
                    help="the quick run: 2 SFT steps, 2 RL steps, 2 "
                         "samplers unless given")
    ap.add_argument("--group-size", type=int, default=8)
    ap.add_argument("--prompts", type=int, default=8)
    ap.add_argument("--max-delay", type=int, default=64)
    ap.add_argument("--delay-dist", default="lognormal")
    ap.add_argument("--num-samplers", type=int, default=None,
                    help="sampler nodes (default 4; 2 with --smoke)")
    ap.add_argument("--beta-kl", type=float, default=None)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--logprob-impl", default="fused",
                    choices=["fused", "pallas", "chunked", "naive"],
                    help="learner token-logprob backend (see "
                         "TrainConfig.logprob_impl)")
    ap.add_argument("--mesh", default="1x1",
                    help="learner mesh DxM or PxDxM, e.g. 2x1; more than "
                         "one rank runs under torchrun")
    ap.add_argument("--sampler-mesh", default="1x1",
                    help="sampler-node mesh DxM (a serve plan); more than "
                         "one rank runs under torchrun")
    ap.add_argument("--paged-attn-impl", default=None,
                    choices=["auto", "pallas", "ref", "gather"],
                    help="sampler paged-attention backend "
                         "(HeteroConfig.paged_attn_impl; default keeps the "
                         "arch's ModelConfig knob)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    quick = dict(steps=2, sft_steps=2, num_samplers=2) if args.smoke else \
        dict(steps=120, sft_steps=400, num_samplers=4)
    for k, v in quick.items():
        if getattr(args, k) is None:
            setattr(args, k, v)

    HeteroConfig(sampler_mesh=args.sampler_mesh)     # checks the spec
    device = args.device
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world > 1:                                # under torchrun
        import torch.distributed as dist
        if device == "cuda":
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
            torch.cuda.set_device(torch.device(device))
        dist.init_process_group("nccl" if args.device == "cuda" else "gloo")
    learner_plan = plan_from_flag(args.mesh, "train", device)
    sampler_plan = plan_from_flag(args.sampler_mesh, "serve", device)
    rank0 = learner_plan.mesh.rank in (None, 0)
    cfg = smoke(args.arch)
    beta = args.beta_kl if args.beta_kl is not None else (
        0.0 if args.mode == "online" else 0.005)   # paper §4.1
    # a sampler mesh serves through the continuous engine (page pools
    # split over 'model'), one device through the static engine
    rl = RLConfig(loss_type=args.loss, group_size=args.group_size,
                  beta_kl=beta, max_new_tokens=6, temperature=1.0,
                  top_k=0, top_p=1.0,
                  engine="static" if args.sampler_mesh == "1x1"
                  else "continuous")
    tok = Tokenizer()
    task = ArithmeticTask(max_operand=20, ops="+", prompt_width=6,
                          seed=args.seed)
    if rank0:
        print(f"[train] {cfg.name} on {device}: learner "
              f"{learner_plan.describe()} | samplers "
              f"{sampler_plan.describe()}")

    params = init_params(cfg, args.seed, device=device)
    tc_sft = TrainConfig(learning_rate=1e-2, total_steps=args.sft_steps,
                         logprob_impl=args.logprob_impl, mesh=args.mesh)
    state = init_state(cfg, tc_sft, params, plan=learner_plan)
    t0 = time.time()
    state, sft_loss = sft_warmstart(cfg, tc_sft, task, tok, state,
                                    steps=args.sft_steps, seed=args.seed,
                                    plan=learner_plan)
    if rank0:
        print(f"[train] SFT warm start done: loss={sft_loss:.3f} "
              f"({time.time()-t0:.0f}s)")

    tc = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                     logprob_impl=args.logprob_impl, mesh=args.mesh)
    state = state._replace(step=torch.zeros_like(state.step))
    eval_fn = make_eval_fn(cfg, rl, task, tok)

    if args.mode == "online":
        hist, evals, learner = run_online(
            cfg, rl, tc, task, tok, state, num_steps=args.steps,
            prompts_per_batch=args.prompts, seed=args.seed,
            eval_fn=eval_fn, eval_every=args.eval_every,
            device=device, learner_plan=learner_plan,
            sampler_plan=sampler_plan)
    else:
        hcfg = HeteroConfig(num_samplers=args.num_samplers,
                            max_delay_steps=args.max_delay,
                            delay_distribution=args.delay_dist,
                            delay_median_s=300.0, seed=args.seed,
                            paged_attn_impl=args.paged_attn_impl,
                            sampler_mesh=args.sampler_mesh)
        rt = HeteroRuntime(cfg, rl, tc, hcfg, task, tok, state,
                           prompts_per_batch=args.prompts,
                           eval_fn=eval_fn, eval_every=args.eval_every,
                           device=device, learner_plan=learner_plan,
                           sampler_plan=sampler_plan)
        hist = rt.run(args.steps)
        evals = rt.eval_scores
        learner = rt.learner

    best, last, gap = best_last_gap(evals)
    summary = {
        "arch": args.arch, "loss": args.loss, "mode": args.mode,
        "steps": learner.step,
        "reward_mean_last20": float(np.mean(hist.get("reward_mean")[-20:])),
        "iw_var_mean": float(np.nanmean(hist.get("iw_var"))),
        "kl_mean": float(np.nanmean(hist.get("kl"))),
        "eval_best": best, "eval_last": last, "best_to_last_gap": gap,
        "staleness_mean": float(np.nanmean(hist.get("staleness"))),
        "wall_s": round(time.time() - t0, 1),
    }
    if rank0:
        print("[train] " + json.dumps(summary, indent=1))
        if args.out:
            with open(args.out, "w") as f:
                json.dump(summary, f, indent=1)
    if world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
