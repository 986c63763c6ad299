"""Prompt batching with group replication: the port's own copy of
``repro/data/pipeline.py`` (numpy only).

Each batch row group of G consecutive rows shares one prompt — matching
the paper's localized-reward invariant (App. F): a group is generated and
scored on a single node, so group statistics need no cross-node gather.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List

import numpy as np

from repro_torch.data.tasks import (ArithmeticTask, Problem, Tokenizer,
                                    encode_prompts)


@dataclasses.dataclass
class RolloutRequest:
    """What a sampler node pulls from its local task stream."""
    prompts: np.ndarray            # (n_prompts*G, Tp) group-replicated
    problems: List[Problem]        # len n_prompts (one per group)
    group_size: int


class PromptPipeline:
    def __init__(self, task: ArithmeticTask, tok: Tokenizer,
                 prompts_per_batch: int, group_size: int) -> None:
        self.task = task
        self.tok = tok
        self.n = prompts_per_batch
        self.g = group_size

    def next_batch(self) -> RolloutRequest:
        problems = self.task.sample_batch(self.n)
        enc = encode_prompts(self.tok, problems)            # (n, Tp)
        rep = np.repeat(enc, self.g, axis=0)                # (n*G, Tp)
        return RolloutRequest(prompts=rep, problems=problems,
                              group_size=self.g)

    def __iter__(self) -> Iterator[RolloutRequest]:
        while True:
            yield self.next_batch()


def score_rollouts(task: ArithmeticTask, tok: Tokenizer,
                   problems: List[Problem], completions: np.ndarray,
                   group_size: int) -> np.ndarray:
    """Localized reward computation (App. F): decode + exact-match per
    group, no cross-process communication. completions (n*G, Tnew)."""
    rewards = np.zeros(len(problems) * group_size, np.float32)
    for i, prob in enumerate(problems):
        for j in range(group_size):
            row = completions[i * group_size + j]
            rewards[i * group_size + j] = task.reward(prob, tok.decode(row))
    return rewards
