"""Publisher half of the chunked weight transport (the port of
``repro/transport/publish.py``).

``publish_params`` walks the param tree in the JAX package's leaf order,
pulls each leaf to the host once (``.cpu()`` waits for the stream, so a
publish sees the finished step), content-addresses every chunk, and
pushes only net-new bytes into the ``PolicyStore`` chunk index before
versioning the manifest. Re-publishing unchanged content is nearly free:
the manifest moves, the chunks do not.

The port runs one device: each leaf is one chunk, held by one device, so
``entries == chunks`` and ``max_host_egress`` is the whole payload. A
sharded publisher joins with parallel/ (ROADMAP queue 1 item 10).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

from repro_torch.checkpoint.store import (PolicyStore, dtype_name,
                                          flatten_with_paths)
from repro_torch.transport.chunks import chunk_host_leaf
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


def publish_params(store: PolicyStore, version: int,
                   params: Any) -> PublishStats:
    """Chunk ``params`` and publish (chunks + manifest) to ``store`` as
    ``version``."""
    stats = PublishStats(version=version)
    seen_this_publish: Dict[str, int] = {}
    leaves = []
    for key, leaf in flatten_with_paths(params):
        refs = []
        for ref, data in chunk_host_leaf(leaf):
            if ref.hash not in seen_this_publish:
                if store.put_chunk(ref.hash, data):
                    stats.chunks_new += 1
                    stats.bytes_new += ref.nbytes
                seen_this_publish[ref.hash] = ref.nbytes
            stats.payload_bytes += ref.nbytes
            stats.chunks += 1
            stats.entries += ref.replicas
            refs.append(ref)
        leaves.append(LeafManifest(key=key, dtype=dtype_name(leaf.dtype),
                                   shape=tuple(leaf.shape),
                                   chunks=tuple(refs)))
    manifest = Manifest(version=version, leaves=tuple(leaves))
    blob = manifest.to_json()
    store.publish_manifest(version, blob, manifest.hashes())
    stats.manifest_bytes = len(blob)
    stats.max_host_egress = stats.payload_bytes
    return stats
