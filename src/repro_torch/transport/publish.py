"""Publisher half of the shard-streamed transport (the port of
``repro/transport/publish.py``).

``publish_params`` walks the param tree alongside the publisher plan's
fitted shardings, cuts each leaf along its shard grid, content-addresses
every chunk, and pushes only net-new bytes into the ``PolicyStore`` chunk
index before versioning the manifest. Re-publishing unchanged content is
nearly free: the manifest moves, the chunks do not. The leaves are pulled
to the host once (``.cpu()`` waits for the stream, so a publish sees the
finished step).

On a live plan the params are this rank's shards: the full leaves are
gathered first (a collective, so every rank publishes together, and
each writes the same manifest). ``PublishStats.max_host_egress`` is the
multi-host figure: with the grid cut per shard, each rank would upload
only the cells it owns (the lowest rank holding a cell), so the worst
per-rank upload is ``payload / (cells per leaf)`` rather than the whole
blob.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.checkpoint.store import (PolicyStore, dtype_name,
                                          flatten_with_paths)
from repro_torch.transport.chunks import chunk_host_leaf, region_map
from repro_torch.transport.manifest import LeafManifest, Manifest


@dataclasses.dataclass
class PublishStats:
    version: int
    payload_bytes: int = 0      # one full model copy (distinct chunks)
    bytes_new: int = 0          # net-new chunk bytes entering the store
    manifest_bytes: int = 0
    chunks: int = 0             # distinct grid cells
    chunks_new: int = 0
    entries: int = 0            # per-device shard entries (incl. replicas)
    max_host_egress: int = 0    # worst per-device upload of this publish

    @property
    def delta_ratio(self) -> float:
        """Fraction of the model that actually moved (1.0 on a cold
        store, → 0 as publishes repeat unchanged content)."""
        return self.bytes_new / self.payload_bytes if self.payload_bytes \
            else 0.0


def publish_params(store: PolicyStore, version: int, plan, cfg,
                   params: Any) -> PublishStats:
    """Chunk ``params`` along ``plan``'s fitted shard grid and publish
    (chunks + manifest) to ``store`` as ``version``."""
    shardings = plan.param_shardings(cfg)
    full = dict(flatten_with_paths(plan.gather(params, shardings)))
    flat_shard = dict(flatten_with_paths(shardings))
    stats = PublishStats(version=version)
    seen_this_publish: Dict[str, int] = {}
    egress: Dict[int, int] = {}
    leaves = []
    for key, _ in flatten_with_paths(params):
        leaf = full[key]
        sharding = flat_shard.get(key)
        if sharding is None:
            raise KeyError(f"no sharding for leaf {key!r} — params tree "
                           "does not match plan.param_shardings(cfg)")
        rmap = region_map(sharding, tuple(leaf.shape))
        regions = [(start, cshape, len(devs))
                   for (start, cshape), devs in sorted(rmap.items())]
        items = chunk_host_leaf(leaf, sharding, regions=regions)
        owners = {region: min(devs) for region, devs in rmap.items()}
        refs = []
        for ref, data in items:
            if ref.hash not in seen_this_publish:
                if store.put_chunk(ref.hash, data):
                    stats.chunks_new += 1
                    stats.bytes_new += ref.nbytes
                seen_this_publish[ref.hash] = ref.nbytes
            stats.payload_bytes += ref.nbytes
            stats.chunks += 1
            stats.entries += ref.replicas
            owner = owners[(ref.start, ref.shape)]
            egress[owner] = egress.get(owner, 0) + ref.nbytes
            refs.append(ref)
        leaves.append(LeafManifest(key=key, dtype=dtype_name(leaf.dtype),
                                   shape=tuple(leaf.shape),
                                   chunks=tuple(refs)))
    manifest = Manifest(version=version, leaves=tuple(leaves))
    blob = manifest.to_json()
    store.publish_manifest(version, blob, manifest.hashes())
    stats.manifest_bytes = len(blob)
    stats.max_host_egress = max(egress.values(), default=0)
    return stats
