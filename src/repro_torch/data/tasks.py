"""Synthetic verifiable math tasks + char tokenizer: the port's own copy
of ``repro/data/tasks.py`` (numpy only). With the same seed it draws the
same problems and encodes the same prompt arrays.

The paper trains on MATH level 3-5 with exact-match rewards. On a single
host we substitute arithmetic problems whose rewards are computable
programmatically (same binary exact-match structure), keeping the RL
mechanics — group sampling, verifiable reward, reward collapse dynamics —
identical.

Prompts are rendered at a FIXED width (left-padded with spaces) so batches
need no prompt-side padding mask; the space is an ordinary token.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

PAD, BOS, EOS = 0, 1, 2
_CHARS = "0123456789+-*= "


class Tokenizer:
    """Char-level tokenizer over digits/operators; ids 0..2 are specials."""

    def __init__(self) -> None:
        self.itos = {PAD: "<pad>", BOS: "<bos>", EOS: "<eos>"}
        self.stoi = {}
        for i, ch in enumerate(_CHARS):
            self.stoi[ch] = 3 + i
            self.itos[3 + i] = ch

    @property
    def vocab_size(self) -> int:
        return 3 + len(_CHARS)

    def encode(self, s: str, bos: bool = False, eos: bool = False
               ) -> List[int]:
        ids = [self.stoi[c] for c in s]
        if bos:
            ids = [BOS] + ids
        if eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out = []
        for i in ids:
            i = int(i)
            if i == EOS:
                break
            if i in (PAD, BOS):
                continue
            out.append(self.itos.get(i, "?"))
        return "".join(out)


@dataclasses.dataclass
class Problem:
    prompt: str            # fixed-width rendered prompt, ends with '='
    answer: str            # canonical answer string


class ArithmeticTask:
    """a OP b = ?  with OP in {+,-,*}; difficulty via operand size."""

    def __init__(self, max_operand: int = 99, ops: str = "+-",
                 prompt_width: int = 8, seed: int = 0) -> None:
        self.max_operand = max_operand
        self.ops = ops
        self.prompt_width = prompt_width
        self.rng = np.random.default_rng(seed)

    def sample(self) -> Problem:
        a = int(self.rng.integers(0, self.max_operand + 1))
        b = int(self.rng.integers(0, self.max_operand + 1))
        op = self.ops[int(self.rng.integers(len(self.ops)))]
        if op == "-" and b > a:
            a, b = b, a                       # keep answers non-negative
        expr = f"{a}{op}{b}="
        ans = str(eval(f"{a}{op}{b}"))        # noqa: S307 - ints only
        return Problem(prompt=expr.rjust(self.prompt_width), answer=ans)

    def sample_batch(self, n: int) -> List[Problem]:
        return [self.sample() for _ in range(n)]

    @staticmethod
    def reward(problem: Problem, completion: str) -> float:
        """Binary exact match (the paper's verifiable-reward setting)."""
        return 1.0 if completion.strip() == problem.answer else 0.0


def encode_prompts(tok: Tokenizer, problems: Sequence[Problem]
                   ) -> np.ndarray:
    """(B, Tp) int32 — all prompts share the fixed width."""
    rows = [tok.encode(p.prompt) for p in problems]
    width = len(rows[0])
    if any(len(r) != width for r in rows):
        raise ValueError("prompts must share one rendered width")
    return np.asarray(rows, np.int32)
