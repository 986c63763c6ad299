"""jax's default PRNG, threefry2x32, in plain torch: the same bits.

A key is an int64 tensor of shape (..., 2) holding two uint32 words, the
layout of a legacy ``jax.random.PRNGKey`` (uint32 (2,)). Every function
takes a leading batch of keys and works on all of them at once, as
``jax.vmap`` of the jax function would: ``fold_in(keys, data)`` folds
``data[i]`` into ``keys[i]``, and ``gumbel(keys, (V,))`` gives one row of
noise per key. The arithmetic is int64 masked to 32 bits, because torch's
uint32 lacks shifts on many backends; integer results (keys, bits) equal
jax's bit for bit on any device.

What is reproduced is jax 0.9 with ``jax_threefry_partitionable=True``
(its default) and ``jax_enable_x64`` off:

- ``PRNGKey(seed)`` is ``(0, seed mod 2^32)``;
- ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``;
- ``split(key, n)[i]`` is ``fold_in(key, i)`` (the fold-like split);
- ``random_bits(key, shape)`` hashes the counters ``(0, i)`` over the
  flat index ``i`` and XORs the two output words;
- ``uniform`` puts the top 23 bits into the mantissa of a float in
  [1, 2), subtracts 1, then scales to [minval, maxval) and clamps below
  at ``minval``;
- ``gumbel`` is the ``"low"`` mode, ``-log(-log(uniform(tiny, 1)))``;
- ``categorical(key, logits)`` is ``argmax(logits + gumbel(key))``.

Uniforms are exact (integer bits, one exact float subtraction, a scale
by 1 and an add that rounds away). The two logs of the Gumbel noise are
the device's float32 ``log``, which may differ from XLA's by an ulp.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_ONE_F32_BITS = 0x3F800000          # 1.0f: exponent of [1, 2)
TINY_F32 = torch.finfo(torch.float32).tiny

IntLike = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & _M32) | (x >> (32 - d))


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block function (20 rounds) on int64 tensors that
    hold uint32 values; the four operands broadcast. Returns the two
    output words."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds): (2,) int64."""
    return torch.tensor([0, int(seed) & _M32], dtype=torch.int64,
                        device=device)


def as_key(key: Union[torch.Tensor, Sequence[int]],
           device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """A key from anything holding its two uint32 words (a jax key
    converted with ``np.asarray``, a list, a tensor) as (..., 2) int64."""
    if isinstance(key, torch.Tensor):
        t = key.to(torch.int64)
    else:
        t = torch.from_numpy(np.asarray(key).astype(np.int64))
    t = t & _M32
    if t.shape[-1:] != (2,):
        raise ValueError(f"a key has 2 words in its last axis, got shape "
                         f"{tuple(t.shape)}")
    return t if device is None else t.to(device)


def _data(data: IntLike, like: torch.Tensor) -> torch.Tensor:
    d = torch.as_tensor(data, device=like.device).to(torch.int64)
    return d & _M32                   # jax converts the data to uint32


def fold_in(key: torch.Tensor, data: IntLike) -> torch.Tensor:
    """``fold_in`` of ``data`` into ``key``; the batch shapes broadcast:
    keys (..., 2) with data (...) is ``vmap(jax.random.fold_in)``."""
    d = _data(data, key)
    o1, o2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(d), d)
    return torch.stack(torch.broadcast_tensors(o1, o2), dim=-1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: (..., num, 2); new key ``i`` is
    ``fold_in(key, i)``."""
    i = torch.arange(num, device=key.device, dtype=torch.int64)
    return fold_in(key[..., None, :], i)


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element as int64 in [0, 2^32): keys (..., 2) ->
    (..., *shape), each key hashing its own counters ``(0, i)``."""
    shape = tuple(shape)
    n = 1
    for s in shape:
        n *= s
    if n >= 1 << 32:
        raise NotImplementedError("more than 2^32 draws from one key")
    counts = torch.arange(n, device=key.device,
                          dtype=torch.int64).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    o1, o2 = threefry2x32(k1, k2, torch.zeros_like(counts), counts)
    return o1 ^ o2


def uniform(key: torch.Tensor, shape: Sequence[int], *,
            minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """float32 uniforms in [minval, maxval): keys (..., 2) -> (...,
    *shape)."""
    bits = random_bits(key, shape)
    one_two = ((bits >> 9) | _ONE_F32_BITS).to(torch.int32).view(
        torch.float32)
    lo = torch.tensor(minval, dtype=torch.float32, device=key.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=key.device)
    floats = (one_two - 1.0) * (hi - lo) + lo
    return torch.maximum(lo, floats)


def gumbel(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Standard Gumbel noise, float32, ``jax.random.gumbel``'s low mode:
    every value finite (the uniform lies in [tiny, 1 - 2^-23])."""
    u = uniform(key, shape, minval=TINY_F32, maxval=1.0)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """One draw per key from ``softmax(logits)`` over the last axis: keys
    (..., 2) and logits (..., V) -> (...) int64, row ``r`` drawn with
    ``key[r]`` (``vmap(jax.random.categorical)``). float32 logits."""
    if logits.dtype != torch.float32:
        raise TypeError(f"categorical draws float32 noise for float32 "
                        f"logits, got {logits.dtype}")
    noise = gumbel(key, logits.shape[-1:])
    return torch.argmax(logits + noise, dim=-1)


__all__ = ["PRNGKey", "as_key", "fold_in", "split", "random_bits",
           "uniform", "gumbel", "categorical", "threefry2x32", "TINY_F32"]
