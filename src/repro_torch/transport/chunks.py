"""Chunk codec: cut a leaf along its ``NamedSharding`` shard grid (the
port of ``repro/transport/chunks.py``).

One chunk per *distinct* shard of a leaf — replicas collapse onto a single
content-addressed chunk (the manifest records the multiplicity), and the
distinct chunks of a leaf tile it exactly once, so assembling them is a
byte-exact restore. The grid comes from an ``ExecutionPlan``'s fitted
shardings (``repro_torch.parallel``); without one a leaf is one region:
start 0, the whole shape, 1 replica, the chunk the JAX package cuts on a
1x1 plan. Chunk payloads use the raw-byte codec of the npz checkpoint
format (``repro_torch.checkpoint.store.encode_array``): bf16 travels as
raw bytes + (dtype, shape) sidecar, never upcast, and a chunk's bytes and
hash equal the JAX package's for the same values.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.checkpoint.store import (decode_array, encode_array,
                                          torch_dtype)

Region = Tuple[Tuple[int, ...], Tuple[int, ...]]     # (start, shape)


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


def _normalize_index(idx: Tuple[slice, ...], shape: Tuple[int, ...]
                     ) -> Region:
    start, cshape = [], []
    for i, dim in enumerate(shape):
        sl = idx[i] if i < len(idx) else slice(None)
        lo = 0 if sl.start is None else int(sl.start)
        hi = dim if sl.stop is None else int(sl.stop)
        start.append(lo)
        cshape.append(hi - lo)
    return tuple(start), tuple(cshape)


def region_map(sharding, shape: Tuple[int, ...],
               devices: Optional[Iterable[int]] = None
               ) -> Dict[Region, List[int]]:
    """Distinct shard regions of ``sharding`` over ``shape`` -> the ranks
    holding each. ``devices`` restricts to a subset of ranks (one host's,
    or one rank's: it needs only its own cells of the grid)."""
    devs = set(devices) if devices is not None else None
    out: Dict[Region, List[int]] = {}
    for dev, idx in sharding.devices_indices_map(tuple(shape)).items():
        if devs is not None and dev not in devs:
            continue
        out.setdefault(_normalize_index(idx, shape), []).append(dev)
    return out


def shard_regions(sharding, shape: Tuple[int, ...],
                  devices: Optional[Iterable[int]] = None
                  ) -> List[Tuple[Tuple[int, ...], Tuple[int, ...], int]]:
    """Sorted ``(start, chunk_shape, replicas)`` triples — the chunk grid
    of a leaf under ``sharding``."""
    return [(start, cshape, len(devs))
            for (start, cshape), devs in sorted(region_map(
                sharding, shape, devices).items())]


def chunk_host_leaf(leaf: torch.Tensor, sharding=None, regions=None
                    ) -> List[Tuple[ChunkRef, bytes]]:
    """Cut the full ``leaf`` into its shard-grid chunks, pulling it to the
    host once. ``regions`` takes a precomputed ``shard_regions`` result;
    with neither ``sharding`` nor ``regions`` the leaf is one chunk."""
    shape = tuple(leaf.shape)
    if regions is None:
        regions = ([((0,) * len(shape), shape, 1)] if sharding is None
                   else shard_regions(sharding, shape))
    host = leaf.detach().cpu()
    out = []
    for start, cshape, replicas in regions:
        view = host[tuple(slice(s, s + n)
                          for s, n in zip(start, cshape, strict=True))]
        data = encode_array(view)
        out.append((ChunkRef(hash=content_hash(data), nbytes=len(data),
                             start=tuple(start), shape=tuple(cshape),
                             replicas=replicas), data))
    return out


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


def overlaps(ref: ChunkRef, start: Tuple[int, ...],
             cshape: Tuple[int, ...]) -> bool:
    """Does chunk ``ref`` intersect the region (start, cshape)?"""
    return all(s0 < s1 + n1 and s1 < s0 + n0
               for s0, n0, s1, n1 in zip(ref.start, ref.shape, start, cshape,
                                         strict=True))


__all__ = ["ChunkRef", "Region", "content_hash", "region_map",
           "shard_regions", "chunk_host_leaf", "assemble_leaf", "overlaps"]
