"""repro_torch.transport — content-addressed, delta-compressed weight
distribution (the port of ``repro.transport``, one device).

The learner publishes content-addressed chunks of each param leaf
(``publish_params``); samplers subscribe (``ChunkSubscriber``) and fetch
only the chunks whose content changed, over a ``SimulatedLink`` whose
delay depends on the bytes moved. ``PolicyStore``
(repro_torch.checkpoint) is the chunk-index/version backend. Chunk
hashes and manifests are the JAX package's, byte for byte.
"""
from repro_torch.transport.chunks import (ChunkRef, assemble_leaf,
                                          chunk_host_leaf, content_hash)
from repro_torch.transport.link import (LinkDropped, SimulatedLink,
                                        SyncInterrupted)
from repro_torch.transport.manifest import LeafManifest, Manifest
from repro_torch.transport.publish import PublishStats, publish_params
from repro_torch.transport.subscribe import ChunkSubscriber, SyncStats

__all__ = [
    "ChunkRef", "LeafManifest", "Manifest",
    "assemble_leaf", "chunk_host_leaf", "content_hash",
    "LinkDropped", "SimulatedLink", "SyncInterrupted",
    "PublishStats", "publish_params",
    "ChunkSubscriber", "SyncStats",
]
