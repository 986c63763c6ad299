"""Temperature / top-k / top-p sampling with a counter-based noise source.

The filters follow ``repro/sampling/sample.py``: temperature, then top-k
by thresholding at the k-th largest value (every logit equal to it is
kept, so ties at the boundary survive), then top-p over the sorted
remainder.

Draws are Gumbel-max over the filtered logits. The noise of draw ``g`` of
request ``rid`` at vocab index ``i`` is a hash of (seed, rid, g, i), so a
draw depends only on (seed, rid, g, logits): never on the slot a request
sits in, and vectorised over rows with no generator state. It does not
reproduce jax's threefry bits (ROADMAP queue 1), so stochastic draws match
the JAX package in distribution only; a greedy profile (top_k=1) is
independent of the noise and matches token for token.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30
_M32 = 0xFFFFFFFF


def mask_vocab(lg: torch.Tensor, vocab_limit: int) -> torch.Tensor:
    """Mask padded-vocab tail logits."""
    if vocab_limit < lg.shape[-1]:
        bad = torch.arange(lg.shape[-1], device=lg.device) >= vocab_limit
        lg = torch.where(bad, NEG_INF, lg)
    return lg


def model_logp(last: torch.Tensor, tok: torch.Tensor) -> torch.Tensor:
    """Full-model logp of the drawn token (what the learner's
    teacher-forced recompute sees)."""
    full_lp = torch.log_softmax(last.float(), dim=-1)
    return full_lp.gather(-1, tok.long()[:, None])[:, 0]


def filter_logits(logits: torch.Tensor, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Temperature, then top-k, then top-p (nucleus) filtering.
    logits (..., V) -> filtered logits (masked entries = NEG_INF)."""
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    v = logits.shape[-1]
    if top_k and top_k < v:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, NEG_INF, logits)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep the smallest prefix with cumulative prob >= top_p
        keep_sorted = cum - probs < top_p
        kth = sorted_logits.gather(-1, keep_sorted.sum(-1, keepdim=True) - 1)
        logits = torch.where(logits < kth, NEG_INF, logits)
    return logits


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values
    (products wrap in int64; the mask keeps their low 32 bits)."""
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & _M32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & _M32
    return h ^ (h >> 16)


def gumbel_noise(seed: int, rids: torch.Tensor, gens: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """(B, vocab) float32 Gumbel noise; row r is a pure function of
    (seed, rids[r], gens[r])."""
    dev = rids.device
    key = _fmix32(torch.full_like(rids, seed & _M32, dtype=torch.int64)
                  ^ 0x9E3779B9)
    key = _fmix32(key ^ (rids.long() & _M32))
    key = _fmix32(key ^ (gens.long() & _M32))
    idx = _fmix32(torch.arange(vocab, device=dev, dtype=torch.int64)
                  + 0x632BE5AB)
    u = open_unit(_fmix32(key[:, None] ^ idx[None, :]))
    return -torch.log(-torch.log(u))


def open_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 values (in int64) -> float32 uniforms strictly inside (0, 1):
    the top 23 bits, centred in their cell. With 24 bits the top cell's
    centre, (2^24 - 0.5) / 2^24, rounds to 1.0 in float32, its Gumbel
    noise is +inf, and that index wins the draw through any mask; at a
    vocab of 152k that was ~1% of draws."""
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def sample_token_rows(seed: int, rids: torch.Tensor, gens: torch.Tensor,
                      logits: torch.Tensor, *, temperature: float = 1.0,
                      top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Row-independent sampling: row ``r`` of ``logits`` (B, V) is draw
    ``gens[r]`` of request ``rids[r]``. Returns the tokens (B,); the
    engine scores them with :func:`model_logp`."""
    filt = filter_logits(logits, temperature=temperature, top_k=top_k,
                         top_p=top_p)
    return torch.argmax(filt + gumbel_noise(seed, rids, gens,
                                            logits.shape[-1]), dim=-1)
