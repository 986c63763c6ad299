"""Subscriber half of the chunked weight transport (the port of
``repro/transport/subscribe.py``).

A ``ChunkSubscriber`` is one sampler's checkpoint client: it pulls the
newest manifest over its ``SimulatedLink``, delta-syncs against its local
content-addressed cache (unchanged chunks never touch the wire), and
survives a dropped link mid-transfer: partial byte progress is kept per
chunk and the next sync resumes from the offset. It assembles the
version on the host, as CPU tensors in the structure of ``like``; the
caller copies them onto its device.

The port runs one device, so a subscriber needs every chunk of the
manifest; the JAX package's plan- and host-scoped fetches join with
parallel/ (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.checkpoint.store import (PolicyStore, flatten_with_paths,
                                          unflatten_like)
from repro_torch.transport.chunks import ChunkRef, assemble_leaf
from repro_torch.transport.link import (LinkDropped, SimulatedLink,
                                        SyncInterrupted)
from repro_torch.transport.manifest import Manifest


@dataclasses.dataclass
class SyncStats:
    version: int = -1
    manifest_bytes: int = 0
    chunk_bytes: int = 0        # chunk payload moved this sync
    bytes_resumed: int = 0      # skipped thanks to partial-progress resume
    chunks_fetched: int = 0
    chunk_hits: int = 0         # needed refs already in the local cache
    seconds: float = 0.0        # simulated serialization seconds charged

    @property
    def bytes_on_wire(self) -> int:
        return self.manifest_bytes + self.chunk_bytes

    @property
    def dedup_ratio(self) -> float:
        """Fraction of needed chunk refs served from the local cache."""
        total = self.chunks_fetched + self.chunk_hits
        return self.chunk_hits / total if total else 0.0


class ChunkSubscriber:
    """Delta-synced, resumable checkpoint client."""

    def __init__(self, store: PolicyStore,
                 link: Optional[SimulatedLink] = None) -> None:
        self.store = store
        self.link = link if link is not None else SimulatedLink()
        self._cache: Dict[str, bytes] = {}
        self._partial: Dict[str, int] = {}   # hash -> bytes received so far
        # cumulative telemetry
        self.syncs = 0
        self.chunks_fetched = 0
        self.chunk_hits = 0
        self.bytes_fetched = 0
        self.manifest_bytes = 0

    def sync(self, like: Any, *,
             version: Optional[int] = None) -> Tuple[int, Any, SyncStats]:
        """Fetch ``version`` (newest when None) and assemble it into the
        structure of ``like``. Returns ``(version, host_tree, stats)``.
        Raises ``SyncInterrupted`` if the link drops; call again to resume
        from the recorded byte offsets."""
        v, blob = self.store.fetch(version)
        manifest = Manifest.from_json(blob)
        stats = SyncStats(version=v, manifest_bytes=len(blob))
        self.manifest_bytes += len(blob)
        try:
            stats.seconds += self.link.transfer(len(blob))
        except LinkDropped:
            raise SyncInterrupted(
                "link dropped while fetching the manifest") from None
        missing: List[ChunkRef] = []
        seen = set()
        for lm in manifest.leaves:
            for ref in lm.chunks:
                if ref.hash in seen:
                    continue
                seen.add(ref.hash)
                if ref.hash in self._cache:
                    stats.chunk_hits += 1
                    self.chunk_hits += 1
                else:
                    missing.append(ref)
        # atomic snapshot: grab every missing chunk under one store lock
        # before paying the (long, interruptible) simulated transfers — a
        # concurrent publisher pruning this manifest mid-sync cannot yank
        # chunks from under us (content is hash-addressed, so a snapshot
        # taken now stays valid across a resume)
        payload = self.store.get_chunks([r.hash for r in missing])
        for ref in missing:
            self._fetch(ref, payload[ref.hash], stats)
        tree = self._assemble(manifest, like)
        # cache hygiene: keep only chunks the current version references —
        # the cache is bounded by one model copy, not the run length
        keep = manifest.hashes()
        self._cache = {h: d for h, d in self._cache.items() if h in keep}
        self._partial = {h: n for h, n in self._partial.items() if h in keep}
        self.syncs += 1
        return v, tree, stats

    def _fetch(self, ref: ChunkRef, data: bytes, stats: SyncStats) -> None:
        got = self._partial.get(ref.hash, 0)
        remaining = ref.nbytes - got
        try:
            stats.seconds += self.link.transfer(remaining)
        except LinkDropped as e:
            self._partial[ref.hash] = got + e.bytes_delivered
            stats.chunk_bytes += e.bytes_delivered
            self.bytes_fetched += e.bytes_delivered
            raise SyncInterrupted(
                f"link dropped {e.bytes_delivered} bytes into chunk "
                f"{ref.hash} ({got + e.bytes_delivered}/{ref.nbytes} "
                "received) — re-sync resumes from this offset") from e
        self._partial.pop(ref.hash, None)
        self._cache[ref.hash] = data
        stats.chunk_bytes += remaining
        stats.bytes_resumed += got
        stats.chunks_fetched += 1
        self.chunks_fetched += 1
        self.bytes_fetched += remaining

    def _assemble(self, manifest: Manifest, like: Any) -> Any:
        by_key = {lm.key: lm for lm in manifest.leaves}
        leaves = {}
        for key, _ in flatten_with_paths(like):
            lm = by_key.get(key)
            if lm is None:
                raise KeyError(f"leaf {key!r} missing from manifest "
                               f"version {manifest.version}")
            leaves[key] = assemble_leaf(
                lm.dtype, lm.shape,
                [(ref, self._cache[ref.hash]) for ref in lm.chunks])
        return unflatten_like(like, leaves)
