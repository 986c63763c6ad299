"""Checkpointing: tree ⇄ npz bytes, plus the versioned policy store that
plays the role of App. E's ``Model_Sync_Path`` (learner publishes, samplers
pull the latest version after their simulated transmission delay). The
port of ``repro/checkpoint/store.py`` for nested dicts of torch tensors.

The formats are the JAX package's, byte for byte, so a blob or a chunk
written by either package loads in the other:

- leaves are named by their "/"-joined dict keys (list/tuple positions by
  index) and walked in sorted-key order, the order jax flattens a dict;
- a dtype travels as its numpy/jax name (``"bfloat16"``, ``"float32"``,
  ``"int32"``), never torch's ``"torch.bfloat16"``;
- a leaf's wire encoding is its raw C-order bytes. bf16 moves as its raw
  16-bit words (``view(torch.int16)``): numpy has no bfloat16, and the
  port needs no ``ml_dtypes``;
- an npz blob stores a bf16 leaf as uint8 bytes plus the
  ``__exotic_dtypes__`` JSON sidecar giving its dtype and shape.

The chunked transport (``repro_torch.transport``) uses this module for
the raw-byte codec (``encode_array``/``decode_array``) and the versioned
store, which doubles as its chunk index (``put_chunk``/
``publish_manifest``).
"""
from __future__ import annotations

import io
import json
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

# npz sidecar key describing leaves numpy cannot hold natively (bfloat16):
# those are stored as raw bytes and re-viewed on load.
_EXOTIC_META = "__exotic_dtypes__"

# dtypes numpy can hold natively; bfloat16 travels as raw bytes
_NATIVE = {torch.float64: "float64", torch.float32: "float32",
           torch.float16: "float16", torch.int64: "int64",
           torch.int32: "int32", torch.int16: "int16", torch.int8: "int8",
           torch.uint8: "uint8", torch.bool: "bool"}
_EXOTIC = {torch.bfloat16: "bfloat16"}
_BY_NAME = {name: dt for dt, name in {**_NATIVE, **_EXOTIC}.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The JAX package's name of a dtype (``str(jax_array.dtype)``)."""
    try:
        return _NATIVE.get(dtype) or _EXOTIC[dtype]
    except KeyError:
        raise TypeError(f"dtype {dtype} has no checkpoint encoding") from None


def torch_dtype(name: str) -> torch.dtype:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise TypeError(f"unknown checkpoint dtype {name!r}") from None


def path_key(path: Tuple) -> str:
    """Stable string key of a leaf's path (dict keys and positions) — the
    one leaf-naming scheme shared by the npz blob format and the chunked
    transport manifests (keys must agree for a sampler to restore)."""
    return "/".join(str(p) for p in path)


def _flatten(tree: Any, path: Tuple) -> List[Tuple[Tuple, Any]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [x for i, t in enumerate(tree)
                for x in _flatten(t, path + (i,))]
    return [(path, tree)]


def flatten_with_paths(tree: Any) -> List[Tuple[str, Any]]:
    """(key, leaf) pairs in the order jax flattens the same tree."""
    return [(path_key(path), leaf) for path, leaf in _flatten(tree, ())]


def unflatten_like(like: Any, leaves: Dict[str, Any], path: Tuple = ()
                   ) -> Any:
    """The structure of ``like`` with each leaf taken from ``leaves`` by
    its path key."""
    if isinstance(like, dict):
        return {k: unflatten_like(v, leaves, path + (k,))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(unflatten_like(t, leaves, path + (i,))
                          for i, t in enumerate(like))
    return leaves[path_key(path)]


def encode_array(arr: Any) -> bytes:
    """Raw C-order bytes of a tensor (any device; bf16 as its 16-bit
    words) or a numpy array — the wire encoding of transport chunks."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach()
        if t.dtype in _EXOTIC:
            t = t.view(torch.int16)
        return t.cpu().contiguous().numpy().tobytes()
    return np.ascontiguousarray(np.asarray(arr)).tobytes()


def decode_array(data: bytes, dtype: str, shape: Tuple[int, ...]
                 ) -> torch.Tensor:
    """Inverse of ``encode_array`` given the (dtype, shape) sidecar: a CPU
    tensor holding a copy of ``data``, re-viewed, never upcast."""
    if not data:
        return torch.empty(tuple(shape), dtype=torch_dtype(dtype))
    flat = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    return flat.view(torch_dtype(dtype)).reshape(tuple(shape))


def save_pytree(tree: Any) -> bytes:
    buf = io.BytesIO()
    arrays = {}
    exotic: Dict[str, Dict] = {}
    for key, leaf in flatten_with_paths(tree):
        t = torch.as_tensor(leaf)
        if t.dtype in _EXOTIC:
            exotic[key] = {"dtype": _EXOTIC[t.dtype],
                           "shape": list(t.shape)}
            arrays[key] = np.frombuffer(encode_array(t), np.uint8)
        else:
            dtype_name(t.dtype)                    # reject unknown dtypes
            arrays[key] = t.detach().cpu().numpy()
    if exotic:
        arrays[_EXOTIC_META] = np.frombuffer(
            json.dumps(exotic).encode(), np.uint8)
    np.savez(buf, **arrays)
    return buf.getvalue()


def load_pytree(data: bytes, like: Any) -> Any:
    """Restore into the structure of ``like`` (paths must match), leaf
    dtypes and devices following ``like``. bf16 leaves are re-viewed
    from their raw-byte encoding, never upcast."""
    buf = io.BytesIO(data)
    with np.load(buf) as z:
        arrays = {k: z[k] for k in z.files}
    exotic = {}
    if _EXOTIC_META in arrays:
        exotic = json.loads(arrays.pop(_EXOTIC_META).tobytes().decode())
    leaves = {}
    for key, leaf in flatten_with_paths(like):
        arr = arrays[key]
        if key in exotic:
            meta = exotic[key]
            t = decode_array(arr.tobytes(), meta["dtype"],
                             tuple(meta["shape"]))
        else:
            t = torch.from_numpy(arr)
        leaves[key] = t.to(device=leaf.device, dtype=leaf.dtype)
    return unflatten_like(like, leaves)


class PolicyStore:
    """Versioned checkpoint store (thread-safe).

    The learner ``publish``es (version, bytes); samplers ``fetch`` the
    newest version. Old versions are pruned beyond ``keep``; fetching a
    version that was pruned degrades to the oldest retained one (counted
    in ``stale_fetches``) — a sampler behind a long WAN delay should get
    the closest surviving policy, not an exception.

    The store is also the chunk-index backend of the chunked transport
    (``repro_torch.transport``): content-addressed chunks live in
    ``put_chunk``/``get_chunk`` and each published version's *manifest*
    rides the same versioned ``_store`` (same prune/degrade semantics).
    Chunks no longer referenced by any retained manifest are garbage
    collected on prune, so a long run holds at most ``keep`` manifests
    plus their live chunk set.

    Bookkeeping is bounded: the exact set of ever-published versions is
    trimmed to the most recent ``track`` entries; versions older than the
    tracking horizon are treated as published-then-pruned (degrade +
    ``stale_fetches``) rather than growing an unbounded set.
    ``bytes_published`` counts net-new bytes only — re-publishing a
    version counts the delta against the blob it replaces, and a chunk
    already in the index costs nothing.
    """

    def __init__(self, keep: int = 8, track: int = 512) -> None:
        self._lock = threading.Lock()
        self._store: Dict[int, bytes] = {}
        self._published: set = set()     # recent versions, bounded by track
        self._forgotten_below: Optional[int] = None  # bookkeeping horizon
        self._latest = -1
        self._keep = keep
        self._track = max(track, keep)
        # chunk index (transport backend)
        self._chunks: Dict[str, bytes] = {}
        self._chunk_refs: Dict[int, frozenset] = {}  # version -> chunk hashes
        self.bytes_published = 0
        self.stale_fetches = 0
        self.chunks_gced = 0

    # ---- whole-blob / manifest versions ---------------------------------
    def publish(self, version: int, data: bytes) -> None:
        with self._lock:
            prev = self._store.get(version)
            self._store[version] = data
            self._published.add(version)
            self._latest = max(self._latest, version)
            self.bytes_published += len(data) - (len(prev) if prev is not None
                                                 else 0)
            self._prune_locked()

    def _prune_locked(self) -> None:
        stale = sorted(self._store)[:-self._keep]
        released = False
        for v in stale:
            del self._store[v]
            released |= self._chunk_refs.pop(v, None) is not None
        if released:
            alive = frozenset().union(*self._chunk_refs.values()) \
                if self._chunk_refs else frozenset()
            dead = [h for h in self._chunks if h not in alive]
            for h in dead:
                del self._chunks[h]
            self.chunks_gced += len(dead)
        if len(self._published) > self._track:
            evicted = sorted(self._published)[:-self._track]
            self._published.difference_update(evicted)
            self._forgotten_below = evicted[-1] + 1

    def latest_version(self) -> int:
        with self._lock:
            return self._latest

    def fetch(self, version: Optional[int] = None) -> Tuple[int, bytes]:
        with self._lock:
            if not self._store:
                raise KeyError("PolicyStore is empty — nothing published")
            if version is None:
                return self._latest, self._store[self._latest]
            if version in self._store:
                return version, self._store[version]
            if version in self._published or (
                    self._forgotten_below is not None
                    and version < self._forgotten_below):
                # published once, pruned (or below the bookkeeping horizon)
                self.stale_fetches += 1
                oldest = min(self._store)
                return oldest, self._store[oldest]
            raise KeyError(
                f"version {version} was never published (retained: "
                f"{sorted(self._store)}, latest: {self._latest})")

    # ---- chunk index (transport backend) --------------------------------
    def put_chunk(self, chunk_hash: str, data: bytes) -> bool:
        """Insert a content-addressed chunk; returns True when net-new
        (and only then counts its bytes as published)."""
        with self._lock:
            if chunk_hash in self._chunks:
                return False
            self._chunks[chunk_hash] = data
            self.bytes_published += len(data)
            return True

    def has_chunk(self, chunk_hash: str) -> bool:
        with self._lock:
            return chunk_hash in self._chunks

    def get_chunk(self, chunk_hash: str) -> bytes:
        with self._lock:
            try:
                return self._chunks[chunk_hash]
            except KeyError:
                raise KeyError(
                    f"chunk {chunk_hash} not in store (referenced by a "
                    "pruned manifest, or never published)") from None

    def get_chunks(self, chunk_hashes) -> Dict[str, bytes]:
        """Atomic multi-get: a subscriber snapshots every chunk it is
        about to transfer under one lock, so a concurrent publisher
        pruning the manifest mid-(simulated)-transfer cannot yank chunks
        from under it."""
        with self._lock:
            missing = [h for h in chunk_hashes if h not in self._chunks]
            if missing:
                raise KeyError(
                    f"{len(missing)} chunks not in store (first: "
                    f"{missing[0]}) — referenced by a pruned manifest, "
                    "or never published")
            return {h: self._chunks[h] for h in chunk_hashes}

    def publish_manifest(self, version: int, manifest_blob: bytes,
                         chunk_hashes) -> None:
        """Version a transport manifest (its JSON bytes ride ``_store``
        with the blob semantics) and pin its chunks against GC."""
        with self._lock:
            missing = [h for h in chunk_hashes if h not in self._chunks]
            if missing:
                raise KeyError(f"manifest {version} references "
                               f"{len(missing)} chunks not in the store "
                               f"(first: {missing[0]}) — put_chunk first")
            self._chunk_refs[version] = frozenset(chunk_hashes)
        self.publish(version, manifest_blob)

    @property
    def num_chunks(self) -> int:
        with self._lock:
            return len(self._chunks)

    def chunk_index_bytes(self) -> int:
        with self._lock:
            return sum(len(d) for d in self._chunks.values())
