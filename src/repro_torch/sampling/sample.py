"""Temperature / top-k / top-p sampling, the port of
``repro/sampling/sample.py``.

The filters: temperature, then top-k by thresholding at the k-th largest
value (every logit equal to it is kept, so ties at the boundary survive),
then top-p over the sorted remainder. Draws are ``jax.random.categorical``
over the filtered logits with the row's threefry key
(``sampling.prng``): the JAX package's draws, token for token, given the
same key and logits.
"""
from __future__ import annotations

import torch

from repro_torch.sampling.prng import categorical, gumbel

NEG_INF = -1e30


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


def sample_token(key: torch.Tensor, logits: torch.Tensor, *,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0):
    """One draw from one threefry key (2,) over float32 logits (..., V),
    as the JAX package's ``sample_token``: ``jax.random.categorical(key,
    filtered)`` takes noise of the logits' whole shape from the one key.
    Returns (token (...), logp under the sampling distribution (...),
    logp under the model (...)). The model logp (pre-filter, temperature
    1) is what the learner recomputes; the filtered distribution is only
    used to draw."""
    filt = filter_logits(logits, temperature=temperature, top_k=top_k,
                         top_p=top_p)
    tok = torch.argmax(filt + gumbel(key, filt.shape), dim=-1)
    lp_model = torch.log_softmax(logits, dim=-1).gather(
        -1, tok[..., None])[..., 0]
    lp_filt = torch.log_softmax(filt, dim=-1).gather(
        -1, tok[..., None])[..., 0]
    return tok, lp_filt, lp_model


def sample_token_rows(keys: torch.Tensor, logits: torch.Tensor, *,
                      temperature: float = 1.0, top_k: int = 0,
                      top_p: float = 1.0) -> torch.Tensor:
    """Row-independent sampling: row ``r`` of ``logits`` (B, V) float32 is
    drawn with its own threefry key ``keys[r]`` (B, 2), as the JAX
    package's ``vmap(sample_token)``: ``argmax(filtered + gumbel(key))``.
    A row's draw depends only on its (key, logits), never on where it
    sits in the batch. Returns the tokens (B,); the engines score them
    with :func:`model_logp`."""
    filt = filter_logits(logits, temperature=temperature, top_k=top_k,
                         top_p=top_p)
    return categorical(keys, filt)
