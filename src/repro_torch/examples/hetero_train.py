"""HeteroRL end to end on the port: 1 learner + 4 samplers over simulated
WAN latency (log-normal, bounded 60-1800 s), staleness window 64 learner
steps: the paper's Fig. 3 topology, compressed to a small model.

    PYTHONPATH=src python -m repro_torch.examples.hetero_train [--method gspo] [--device cpu]

The port of ``examples/hetero_train.py``, with its model, flags
(``--method``, ``--steps``, ``--delay-median``, ``--dist``) and printed
lines, plus ``--device``. Compare ``--method gepo`` (stable) with
``--method gspo`` (the paper's unstable baseline) through the printed
IW-variance and staleness traces. The weights are drawn from seed 0 by
torch, so the numbers are not the JAX run's. On a card the learner's
token log-probs run through the fused kernels K1/K2.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.config import (ATTN, MLP, HeteroConfig, ModelConfig,
                                RLConfig, TrainConfig)
from repro_torch.data import ArithmeticTask, Tokenizer
from repro_torch.hetero import HeteroRuntime
from repro_torch.launch.train import make_eval_fn, sft_warmstart
from repro_torch.models import init_params
from repro_torch.training import init_state

CFG = ModelConfig(name="hetero-lm", family="dense", num_layers=2,
                  d_model=96, num_heads=4, num_kv_heads=2, d_ff=192,
                  vocab_size=32, block_pattern=(ATTN,), ffn_pattern=(MLP,),
                  dtype="float32", attn_impl="naive", remat=False,
                  rope_theta=1e4)


def main(method: str = "gepo", steps: int = 40, delay_median: float = 900.0,
         dist: str = "lognormal", device: str = "cuda",
         sft_steps: int = 300, num_samplers: int = 4,
         eval_every: int = 10) -> dict:
    """The HeteroRL run; returns the printed numbers."""
    rl = RLConfig(loss_type=method, group_size=8, beta_kl=0.005,
                  max_new_tokens=6, temperature=1.0, top_k=0, top_p=1.0)
    task = ArithmeticTask(max_operand=20, ops="+", prompt_width=6, seed=0)
    tok = Tokenizer()

    tc_sft = TrainConfig(learning_rate=1e-2, total_steps=sft_steps)
    state = init_state(CFG, tc_sft, init_params(CFG, 0, device=device))
    state, _ = sft_warmstart(CFG, tc_sft, task, tok, state, steps=sft_steps)
    state = state._replace(step=torch.zeros_like(state.step))

    hcfg = HeteroConfig(num_samplers=num_samplers, max_delay_steps=64,
                        delay_distribution=dist,
                        delay_median_s=delay_median, seed=0)
    tc = TrainConfig(learning_rate=1e-3, total_steps=steps)
    rt = HeteroRuntime(CFG, rl, tc, hcfg, task, tok, state,
                       prompts_per_batch=8,
                       eval_fn=make_eval_fn(CFG, rl, task, tok),
                       eval_every=eval_every, device=device)
    hist = rt.run(steps)

    print(f"\n== {method} under {dist} delay "
          f"(median {delay_median:.0f}s, window 64 steps) ==")
    print(f"learner steps: {rt.learner.step}, sim time {rt.sim.now:.0f}s, "
          f"discarded stale batches: {rt.learner.discarded}")
    print(f"staleness: mean={hist.get('staleness').mean():.1f} "
          f"max={hist.get('staleness').max():.0f}")
    print(f"IW variance: mean={np.nanmean(hist.get('iw_var')):.3e} "
          f"max={np.nanmax(hist.get('iw_var')):.3e}")
    print(f"KL(learner||sampler): mean={np.nanmean(hist.get('kl')):.3e}")
    print(f"reward: first10={hist.get('reward_mean')[:10].mean():.3f} "
          f"last10={hist.get('reward_mean')[-10:].mean():.3f}")
    print(f"eval: {['%.3f' % e for e in rt.eval_scores]}")
    print(f"sampler syncs: {[s.syncs for s in rt.samplers]}")
    return {"learner_steps": rt.learner.step, "sim_s": rt.sim.now,
            "staleness": hist.get("staleness"),
            "iw_var": hist.get("iw_var"), "kl": hist.get("kl"),
            "reward_mean": hist.get("reward_mean"),
            "evals": list(rt.eval_scores),
            "syncs": [s.syncs for s in rt.samplers]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--method", default="gepo")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--delay-median", type=float, default=900.0)
    ap.add_argument("--dist", default="lognormal")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(**vars(ap.parse_args()))
