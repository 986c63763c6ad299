"""Quickstart on the port: GEPO online RL on the verifiable-arithmetic
task.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

The port of ``examples/quickstart.py``: trains a tiny LM (SFT warm start,
then GEPO), printing the paper's stability diagnostics (IW variance, KL,
reward) as it goes, with the same model, task, schedule and printed
lines. The weights are drawn from seed 0 by torch, so the numbers are not
the JAX run's. On a card the learner's token log-probs run through the
fused kernels K1/K2; sampling runs the static engine, whose attention is
the model's "naive" one.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.config import ATTN, MLP, ModelConfig, RLConfig, TrainConfig
from repro_torch.data import ArithmeticTask, Tokenizer
from repro_torch.hetero import run_online
from repro_torch.launch.train import make_eval_fn, sft_warmstart
from repro_torch.models import init_params
from repro_torch.training import init_state

CFG = ModelConfig(name="quickstart-lm", family="dense", num_layers=2,
                  d_model=96, num_heads=4, num_kv_heads=2, d_ff=192,
                  vocab_size=32, block_pattern=(ATTN,), ffn_pattern=(MLP,),
                  dtype="float32", attn_impl="naive", remat=False,
                  rope_theta=1e4)


def main(device: str = "cuda", sft_steps: int = 300, steps: int = 40,
         eval_every: int = 10) -> dict:
    """The quickstart run; returns the printed numbers."""
    rl = RLConfig(loss_type="gepo", group_size=8, beta_kl=0.0,
                  max_new_tokens=6, temperature=1.0, top_k=0, top_p=1.0)
    task = ArithmeticTask(max_operand=20, ops="+", prompt_width=6, seed=0)
    tok = Tokenizer()

    print("== SFT warm start (the paper RL-tunes a pretrained model) ==")
    tc_sft = TrainConfig(learning_rate=1e-2, total_steps=sft_steps)
    state = init_state(CFG, tc_sft, init_params(CFG, 0, device=device))
    state, loss = sft_warmstart(CFG, tc_sft, task, tok, state,
                                steps=sft_steps)
    print(f"SFT loss: {loss:.3f}")

    print("== GEPO online RL ==")
    tc = TrainConfig(learning_rate=1e-3, total_steps=steps)
    state = state._replace(step=torch.zeros_like(state.step))
    hist, evals, _ = run_online(
        CFG, rl, tc, task, tok, state, num_steps=steps, prompts_per_batch=8,
        eval_fn=make_eval_fn(CFG, rl, task, tok), eval_every=eval_every,
        device=device)

    for i in range(0, steps, 10):
        print(f"step {i:3d}: reward={hist.get('reward_mean')[i]:.3f} "
              f"iw_var={hist.get('iw_var')[i]:.2e} "
              f"kl={hist.get('kl')[i]:.2e}")
    print(f"eval scores: {['%.3f' % e for e in evals]}")
    final = float(np.mean(hist.get('reward_mean')[-10:]))
    print(f"final reward (last 10 steps): {final:.3f}")
    return {"sft_loss": loss, "evals": evals, "final_reward": final,
            "reward_mean": hist.get("reward_mean"),
            "iw_var": hist.get("iw_var"), "kl": hist.get("kl")}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    main(**vars(ap.parse_args()))
