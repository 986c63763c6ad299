"""Chunk codec: a leaf's content-addressed chunks, and their assembly.

The port of ``repro/transport/chunks.py``. The port runs one device, so a
leaf's shard grid is one region: start 0, the whole shape, 1 replica —
the chunk the JAX package cuts for a leaf on a 1x1 plan, with the same
bytes and the same content hash. Chunk payloads use the raw-byte codec of
the npz checkpoint format (``repro_torch.checkpoint.store.encode_array``):
bf16 travels as raw bytes + (dtype, shape) sidecar, never upcast.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, List, Tuple

import torch

from repro_torch.checkpoint.store import (decode_array, encode_array,
                                          torch_dtype)


@dataclasses.dataclass(frozen=True)
class ChunkRef:
    """One shard-grid cell of a leaf: where it sits, how many devices of
    the publisher hold it, and the content hash addressing its bytes in
    the store."""
    hash: str
    nbytes: int
    start: Tuple[int, ...]
    shape: Tuple[int, ...]
    replicas: int = 1

    def slices(self) -> Tuple[slice, ...]:
        return tuple(slice(s, s + n)
                     for s, n in zip(self.start, self.shape, strict=True))


def content_hash(data: bytes) -> str:
    return hashlib.blake2b(data, digest_size=16).hexdigest()


def chunk_host_leaf(leaf: torch.Tensor) -> List[Tuple[ChunkRef, bytes]]:
    """Cut ``leaf`` into its chunks: one, the whole leaf, pulled to the
    host once (``encode_array``)."""
    shape = tuple(leaf.shape)
    data = encode_array(leaf)
    return [(ChunkRef(hash=content_hash(data), nbytes=len(data),
                      start=(0,) * len(shape), shape=shape), data)]


def assemble_leaf(dtype: str, shape: Tuple[int, ...],
                  parts: Iterable[Tuple[ChunkRef, bytes]]) -> torch.Tensor:
    """Tile chunks back into a CPU tensor. The chunks must cover the leaf
    exactly once — partial fetches cannot assemble."""
    parts = list(parts)
    if len(parts) == 1 and tuple(parts[0][0].shape) == tuple(shape):
        ref, data = parts[0]
        return decode_array(data, dtype, shape)
    out = torch.empty(shape, dtype=torch_dtype(dtype))
    covered = 0
    for ref, data in parts:
        out[ref.slices()] = decode_array(data, dtype, ref.shape)
        covered += out[ref.slices()].numel()
    if covered != out.numel():
        raise ValueError(f"chunks cover {covered} of {out.numel()} elements "
                         "— partial fetches cannot assemble a full leaf")
    return out


__all__ = ["ChunkRef", "content_hash", "chunk_host_leaf", "assemble_leaf"]
