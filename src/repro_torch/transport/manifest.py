"""Version manifests: the index a publisher ships instead of a blob. The
port's own copy of ``repro/transport/manifest.py``: the same JSON, so a
manifest either package publishes parses in the other.

A manifest names every leaf (same path keys as the npz checkpoint
format), its dtype/shape, and the chunk grid — content hashes, offsets,
replica multiplicity. It is the only thing a subscriber *must* download
per version; chunk payloads follow only where the local cache misses.
JSON-encoded so its wire size is honest and a real cross-host deployment
could speak it as-is.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, FrozenSet, Tuple

from repro_torch.transport.chunks import ChunkRef


@dataclasses.dataclass(frozen=True)
class LeafManifest:
    key: str
    dtype: str
    shape: Tuple[int, ...]
    chunks: Tuple[ChunkRef, ...]

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self.chunks)


@dataclasses.dataclass(frozen=True)
class Manifest:
    version: int
    leaves: Tuple[LeafManifest, ...]

    # ---- accounting ------------------------------------------------------
    @property
    def num_chunks(self) -> int:
        """Distinct shard-grid cells across all leaves."""
        return sum(len(lm.chunks) for lm in self.leaves)

    @property
    def num_entries(self) -> int:
        """Per-device shard entries (replicas counted) — what a naive
        per-device broadcast would push."""
        return sum(c.replicas for lm in self.leaves for c in lm.chunks)

    @property
    def payload_bytes(self) -> int:
        """One full copy of the model: distinct grid cells tile each leaf
        exactly once."""
        return sum(lm.nbytes for lm in self.leaves)

    @property
    def entry_bytes(self) -> int:
        """Replica-weighted bytes (the naive broadcast payload)."""
        return sum(c.nbytes * c.replicas for lm in self.leaves
                   for c in lm.chunks)

    def hashes(self) -> FrozenSet[str]:
        return frozenset(c.hash for lm in self.leaves for c in lm.chunks)

    def hash_bytes(self) -> Dict[str, int]:
        return {c.hash: c.nbytes for lm in self.leaves for c in lm.chunks}

    # ---- wire format -----------------------------------------------------
    def to_json(self) -> bytes:
        doc = {"version": self.version, "leaves": [
            {"key": lm.key, "dtype": lm.dtype, "shape": list(lm.shape),
             "chunks": [[c.hash, c.nbytes, list(c.start), list(c.shape),
                         c.replicas] for c in lm.chunks]}
            for lm in self.leaves]}
        return json.dumps(doc, separators=(",", ":")).encode()

    @staticmethod
    def from_json(data: bytes) -> Manifest:
        doc = json.loads(data.decode())
        leaves = tuple(
            LeafManifest(
                key=ld["key"], dtype=ld["dtype"], shape=tuple(ld["shape"]),
                chunks=tuple(ChunkRef(hash=h, nbytes=n, start=tuple(st),
                                      shape=tuple(sp), replicas=r)
                             for h, n, st, sp, r in ld["chunks"]))
            for ld in doc["leaves"])
        return Manifest(version=doc["version"], leaves=leaves)
