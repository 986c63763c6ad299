"""Subscriber half of the shard-streamed transport (the port of
``repro/transport/subscribe.py``).

A ``ChunkSubscriber`` is one sampler's checkpoint client: it pulls the
newest manifest over its ``SimulatedLink``, computes the chunk set its
execution plan needs (the chunks overlapping its plan's shard grid,
optionally scoped to a subset of ranks), delta-syncs against its local
content-addressed cache (unchanged chunks never touch the wire), and
survives a dropped link mid-transfer: partial byte progress is kept per
chunk and the next sync resumes from the offset. It assembles the
version on the host, as CPU tensors in the structure of ``like``; the
caller places them on its device (or its plan). A rank of a live plan
(``rank=``) fetches only the cells of its shards on its plan's grid and
assembles those shards, whatever grid the publisher cut.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from repro_torch.checkpoint.store import (PolicyStore, decode_array,
                                          flatten_with_paths, torch_dtype,
                                          unflatten_like)
from repro_torch.transport.chunks import (ChunkRef, assemble_leaf, overlaps,
                                          shard_regions)
from repro_torch.transport.link import (LinkDropped, SimulatedLink,
                                        SyncInterrupted)
from repro_torch.transport.manifest import LeafManifest, Manifest


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
    """Plan-scoped, delta-synced, resumable checkpoint client."""

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

    # ---- need-set computation -------------------------------------------
    def needed_refs(self, manifest: Manifest, *, plan=None, cfg=None,
                    devices: Optional[Iterable[int]] = None
                    ) -> List[Tuple[LeafManifest, List[ChunkRef]]]:
        """The publisher chunks this plan needs, per leaf: every chunk
        overlapping a distinct shard region of the plan's fitted sharding
        held by one of ``devices`` (ranks). Without rank scoping a plan's
        regions tile every leaf, so the need-set is all chunks."""
        if plan is None or cfg is None or devices is None:
            return [(lm, list(lm.chunks)) for lm in manifest.leaves]
        shardings = dict(flatten_with_paths(plan.param_shardings(cfg)))
        out = []
        for lm in manifest.leaves:
            sharding = shardings.get(lm.key)
            if sharding is None:
                out.append((lm, list(lm.chunks)))
                continue
            regions = shard_regions(sharding, lm.shape, devices=devices)
            need = [ref for ref in lm.chunks
                    if any(overlaps(ref, start, cshape)
                           for start, cshape, _ in regions)]
            out.append((lm, need))
        return out

    # ---- sync ------------------------------------------------------------
    def sync(self, like: Any, *, cfg=None, plan=None,
             version: Optional[int] = None,
             devices: Optional[Iterable[int]] = None,
             assemble: Optional[bool] = None,
             rank: Optional[int] = None
             ) -> Tuple[int, Any, SyncStats]:
        """Fetch ``version`` (newest when None) and assemble it into the
        structure of ``like``. Returns ``(version, host_tree, stats)``;
        ``host_tree`` is None for rank-scoped fetches (``devices``): those
        are partial by construction, so ``assemble`` defaults to
        ``devices is None`` and forcing it on a scoped fetch is an error.
        ``rank`` (with ``plan`` and ``cfg``) fetches that rank's cells
        alone and returns its shard of every leaf. Raises
        ``SyncInterrupted`` if the link drops; call again to resume from
        the recorded byte offsets."""
        if rank is not None:
            devices, assemble = [rank], False
        if assemble is None:
            assemble = devices is None
        elif assemble and devices is not None:
            raise ValueError("a rank-scoped fetch is partial — it cannot "
                             "assemble full leaves; pass assemble=False "
                             "(or drop devices=)")
        v, blob = self.store.fetch(version)
        manifest = Manifest.from_json(blob)
        stats = SyncStats(version=v, manifest_bytes=len(blob))
        self.manifest_bytes += len(blob)
        try:
            stats.seconds += self.link.transfer(len(blob))
        except LinkDropped:
            raise SyncInterrupted(
                "link dropped while fetching the manifest") from None
        needed = self.needed_refs(manifest, plan=plan, cfg=cfg,
                                  devices=devices)
        missing: List[ChunkRef] = []
        seen = set()
        for _, refs in needed:
            for ref in refs:
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
        tree = self._assemble(manifest, like) if assemble else None
        if rank is not None:
            tree = self._assemble_shards(manifest, like, plan, cfg, rank)
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

    def _assemble_shards(self, manifest: Manifest, like: Any, plan, cfg,
                         rank: int) -> Any:
        """``rank``'s shard of every leaf on ``plan``'s grid, tiled from
        the cached chunks that overlap it (the publisher's grid may be
        another's: each chunk gives its intersection with the shard)."""
        shardings = dict(flatten_with_paths(plan.param_shardings(cfg)))
        by_key = {lm.key: lm for lm in manifest.leaves}
        leaves = {}
        for key, _ in flatten_with_paths(like):
            lm = by_key[key]
            cut = shardings[key].index(rank, lm.shape)
            lo = [c.start for c in cut]
            out = torch.empty([c.stop - c.start for c in cut],
                              dtype=torch_dtype(lm.dtype))
            covered = 0
            for ref in lm.chunks:
                if not overlaps(ref, tuple(lo), tuple(out.shape)):
                    continue
                part = decode_array(self._cache[ref.hash], lm.dtype,
                                    ref.shape)
                a = [max(s, c.start) for s, c in zip(ref.start, cut)]
                b = [min(s + n, c.stop)
                     for s, n, c in zip(ref.start, ref.shape, cut)]
                dst = out[tuple(slice(x - o, y - o)
                                for x, y, o in zip(a, b, lo))]
                dst.copy_(part[tuple(slice(x - s, y - s)
                                     for x, y, s in zip(a, b, ref.start))])
                covered += dst.numel()
            if covered != out.numel():
                raise ValueError(f"leaf {key!r}: chunks cover {covered} of "
                                 f"the shard's {out.numel()} elements")
            leaves[key] = out
        return unflatten_like(like, leaves)

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
