"""Speculative decoding: draft proposal and k-token paged verification.

The port of ``repro/sampling/spec.py``. A faster sampler is a less stale
one: slow sampler nodes widen the latency window that inflates KL and
importance-weight variance (PAPER.md §3). This module holds the parts of
the speculative pipeline that need no model:

- :class:`DraftProposer`, the protocol the continuous engine drafts
  through;
- :class:`NGramDrafter`, prompt-lookup drafting over the slot's own token
  history: propose the continuation of the most recent earlier occurrence
  of the current suffix n-gram. Numpy, bit for bit the JAX package's;
- :func:`accept_drafts`, the acceptance rule of the engine's verify round;
- :func:`fused_rescore_diff`, the rescore of every layer's window
  attention through ONE ``paged_prefill_layers`` launch of K4 per mask
  kind, against the attention outputs the forward recorded. Same
  operands, row-independent kernel: the answer is exactly 0, and
  anything else is a kernel fault, surfaced on a gauge.

Acceptance rule (exact replay)
------------------------------
Draw ``g`` of a request is ``sample_token_rows(fold_in(req_key, g),
filtered logits)``, a pure function of (request key, g, logits), as in
the JAX package (``req_key = fold_in(engine key, rid)``). The verify
round scores the window ``[pending, d_1..d_k]`` in one prefill-shaped
forward, so row ``i-1`` holds the target logits after ``d_1..d_{i-1}``;
replaying the engine's draw at every row gives the token the sequential
engine would have emitted, and the accepted prefix is the longest one
whose drafts match those draws. The emitted tokens are the target model's
own sequential samples: greedy and stochastic runs emit what the
non-speculative engine emits, and every logp is the target model's logp
of the emitted token, never the drafter's (GEPO's importance-weight
contract, App. B.1).
"""
from __future__ import annotations

from typing import Dict, Protocol, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import LOCAL, ModelConfig
from repro_torch.data.tasks import EOS, PAD
from repro_torch.kernels.ops import paged_prefill_layers
from repro_torch.sampling.prng import fold_in
from repro_torch.sampling.sample import (mask_vocab, model_logp,
                                         sample_token_rows)

_EMPTY = np.zeros((0,), np.int32)


class DraftProposer(Protocol):
    """Anything that can guess the next ``k`` tokens for one slot."""

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        """Given the slot's token history (prompt + committed completion,
        1-D int32, pending token last), return up to ``k`` proposed next
        tokens (1-D int32, possibly empty)."""
        ...


class NGramDrafter:
    """Prompt-lookup drafting: propose the continuation of the most
    recent earlier occurrence of the current suffix n-gram.

    Tries suffix lengths ``max_ngram`` down to ``min_ngram`` and takes the
    most recent prior match. ``max_history`` bounds the scan."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1,
                 max_history: int = 4096) -> None:
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"({min_ngram}, {max_ngram})")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram
        self.max_history = max_history

    def propose(self, history: np.ndarray, k: int) -> np.ndarray:
        h = np.ascontiguousarray(
            np.asarray(history, np.int32)[-self.max_history:])
        out = self._lookup(h, k)
        # a match near the end of the history (a short loop) continues for
        # fewer than k tokens: extend it by proposing again over history +
        # draft, so a cycle of length c fills all k slots
        while 0 < out.shape[0] < k:
            more = self._lookup(np.concatenate([h, out]), k - out.shape[0])
            if more.shape[0] == 0:
                break
            out = np.concatenate([out, more])
        return out

    def _lookup(self, h: np.ndarray, k: int) -> np.ndarray:
        n = h.shape[0]
        if k <= 0 or n < self.min_ngram + 1:
            return _EMPTY
        # rfind over the bytes: a match at element j0 sits at byte 4 * j0,
        # so unaligned hits are skipped; the end bound (n - 1) * 4 keeps
        # the match strictly before the suffix itself
        hb = h.tobytes()
        for ng in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            pb = h[n - ng:].tobytes()
            j = hb.rfind(pb, 0, (n - 1) * 4)
            while j > 0 and j % 4:
                j = hb.rfind(pb, 0, j + len(pb) - 1)
            if j >= 0:
                j //= 4                             # most recent match
                return h[j + ng:j + ng + k].copy()
        return _EMPTY


def accept_drafts(logits: torch.Tensor, window_tokens: torch.Tensor,
                  draft_len: torch.Tensor, active: torch.Tensor,
                  req_keys: torch.Tensor, gen_base: torch.Tensor,
                  max_new: torch.Tensor, *, temperature: float, top_k: int,
                  top_p: float, vocab_limit: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Longest-valid-prefix acceptance by exact replay (module doc).

    logits (B, W, V) float32 from the verify forward over the window
    ``[pending, d_1..d_{draft_len}, pad...]``; row ``i-1`` is the target
    distribution of emission ``i``. ``gen_base`` (B,) is the pending
    token's draw index (-1 right after prefill, when the pending token is
    the last prompt token); ``req_keys`` (B, 2) are the requests'
    threefry keys, draw ``g`` using ``fold_in(req_keys[b], g)``.
    Returns ``(toks, lps, n_emit, n_acc)``: emitted tokens and logps
    packed into (B, W) (column j = emission j+1, PAD / 0 past
    ``n_emit``), the emitted count, and how many emissions were accepted
    drafts. Emission stops after the first rejection's replayed draw, at
    an emitted EOS and at the request's token budget."""
    b, w, v = logits.shape
    dev = logits.device
    flat = logits.reshape(b * w, v)
    ar = torch.arange(w, device=dev)
    gidx = (gen_base[:, None] + 1 + ar[None, :]).reshape(-1)
    # the draw the sequential engine makes at each row: the same
    # per-request counter stream, the same filtered distribution
    keys = fold_in(req_keys.repeat_interleave(w, dim=0), gidx)
    that = sample_token_rows(keys, mask_vocab(flat, vocab_limit),
                             temperature=temperature, top_k=top_k,
                             top_p=top_p)
    lp_hat = model_logp(flat, that).reshape(b, w)
    that = that.reshape(b, w)

    drafts = window_tokens[:, 1:]                       # (B, W-1)
    match = (drafts == that[:, :-1]) & (ar[None, 1:] <= draft_len[:, None])
    chain = torch.cumprod(match.to(torch.int64), dim=1)  # accepted prefix
    n_acc_chain = chain.sum(dim=1)

    idx = ar[None, :] + 1                               # emission index
    can = ((idx <= n_acc_chain[:, None] + 1)            # prefix + replay
           & (gen_base[:, None] + idx <= max_new[:, None] - 1)
           & active[:, None])
    eos = ((that == EOS) & can).to(torch.int64)
    emit = can & (torch.cumsum(eos, dim=1) - eos == 0)
    toks = torch.where(emit, that, PAD)
    lps = torch.where(emit, lp_hat, 0.0).to(torch.float32)
    n_emit = emit.sum(dim=1)
    n_acc = (chain.bool() & emit[:, :-1]).sum(dim=1)
    return toks, lps, n_emit, n_acc


def _slot_pools(pool: Dict, slots: Sequence[int]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (L', P, page, Hkv, D) pools of pattern slots ``slots``, layer
    order block-major. One slot's are its pool leaves themselves (views);
    several slots' are stacked, which copies."""
    if len(slots) == 1:
        leaf = pool[f"layer_{slots[0]}"]["self"]
        return leaf["kp"], leaf["vp"]
    out = []
    for name in ("kp", "vp"):
        t = torch.stack([pool[f"layer_{i}"]["self"][name] for i in slots],
                        dim=1)
        out.append(t.reshape((-1,) + t.shape[2:]))
    return out[0], out[1]


def stacked_pools(cfg: ModelConfig, pool: Dict
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every layer's pools as (L, P, page, Hkv, D), block-major: the order
    the forward records its q/o tapes in. A period-1 pattern (qwen3)
    gives views of the pool leaves; a mixed pattern is gathered."""
    return _slot_pools(pool, range(cfg.period))


def fused_rescore_diff(cfg: ModelConfig, pool: Dict, q_tape: torch.Tensor,
                       o_tape: torch.Tensor, page_table: torch.Tensor,
                       positions: torch.Tensor) -> torch.Tensor:
    """Replay every layer's window attention through ONE
    ``paged_prefill_layers`` launch per mask kind and return max |fused -
    in-forward| as a float32 scalar tensor. A kind that one pattern slot
    holds (every kind of qwen3 and Gemma2) folds that slot's pool leaves
    as they are: no gather. On a serve plan each rank replays its own:
    the tapes hold its heads and rows, the pools its KV heads, and the
    table and positions are its slots'."""
    period = cfg.period
    diff = torch.zeros((), dtype=torch.float32, device=q_tape.device)
    for kind in dict.fromkeys(cfg.block_pattern):
        slots = [i for i, k in enumerate(cfg.block_pattern) if k == kind]
        kp, vp = _slot_pools(pool, slots)
        if len(slots) == period:
            q, o = q_tape, o_tape
        else:
            idx = torch.tensor([bi * period + i
                                for bi in range(cfg.num_blocks)
                                for i in slots], device=q_tape.device)
            q, o = q_tape[idx], o_tape[idx]
        got = paged_prefill_layers(
            q, kp, vp, page_table, positions,
            kind="local" if kind == LOCAL else "causal",
            window=cfg.sliding_window, softcap=cfg.attn_softcap,
            impl=cfg.paged_attn_impl)
        diff = torch.maximum(diff, (got.float() - o.float()).abs().max())
    return diff


def verify_width_buckets(spec_k: int) -> int:
    """Distinct verify-window widths the engine uses for a draft cap of
    ``spec_k``: max(2, min(next_pow2(1 + k), spec_k + 1)) for k in
    0..spec_k. The floor of 2 keeps the window on the prefill-shaped,
    query-recording path even when nothing was drafted."""
    widths = set()
    for k in range(spec_k + 1):
        w = 1
        while w < 1 + k:
            w *= 2
        widths.add(max(2, min(w, spec_k + 1)))
    return len(widths)


__all__ = ["DraftProposer", "NGramDrafter", "accept_drafts",
           "stacked_pools", "fused_rescore_diff", "verify_width_buckets"]
