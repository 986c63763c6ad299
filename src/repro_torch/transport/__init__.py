"""repro_torch.transport — content-addressed, delta-compressed weight
distribution (the port of ``repro.transport``).

The learner publishes content-addressed chunks of each param leaf, cut
on a plan's shard grid (``publish_params``); samplers subscribe
(``ChunkSubscriber``) and fetch only the chunks whose content changed
(or only a rank's cells), over a ``SimulatedLink`` whose delay depends on
the bytes moved. ``PolicyStore``
(repro_torch.checkpoint) is the chunk-index/version backend. Chunk
hashes and manifests are the JAX package's, byte for byte.
"""
from repro_torch.transport.chunks import (ChunkRef, assemble_leaf,
                                          chunk_host_leaf, content_hash,
                                          overlaps, region_map,
                                          shard_regions)
from repro_torch.transport.link import (LinkDropped, SimulatedLink,
                                        SyncInterrupted)
from repro_torch.transport.manifest import LeafManifest, Manifest
from repro_torch.transport.publish import PublishStats, publish_params
from repro_torch.transport.subscribe import ChunkSubscriber, SyncStats

__all__ = [
    "ChunkRef", "LeafManifest", "Manifest",
    "assemble_leaf", "chunk_host_leaf", "content_hash", "overlaps",
    "region_map", "shard_regions",
    "LinkDropped", "SimulatedLink", "SyncInterrupted",
    "PublishStats", "publish_params",
    "ChunkSubscriber", "SyncStats",
]
