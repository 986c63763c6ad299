"""Process-level runtime context: the active rank mesh (the port of
``repro/runtime_context.py``).

Model code is mesh-agnostic except for the layers that split work across
ranks: the expert-parallel MoE (``models/moe_ep.py``) and the MoE
dispatch under a data-sharded plan (``models/moe.py``). Those read the
mesh registered here, and the axes the current batch rows are split over
(``row_axes``), which the sharded step sets around its forward.

Serving has its own entry: ``serve_shard()``, the shard of the current
serving forward (``parallel.plan.ServeShard``), which the engines set
around each forward on a live ``serve`` or ``long`` plan
(``serve_context``). It carries the rank's heads and the axes its
products split over, and, for the static engine's dense cache, the
context-parallel description: the cache's and the memory's global rows
(``ServeShard.with_cache``), from which each layer reads the span of
positions the rank holds (``ServeShard.span``), and the axes its rows and
its Mamba2 channels and heads split over. It is None everywhere else, and
then every model function runs its single-device arithmetic bit for bit.
It is kept per thread: the threaded runtime's nodes forward on threads of
their own."""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import TYPE_CHECKING, Optional, Tuple

if TYPE_CHECKING:                    # no import cycle through the models
    from repro_torch.parallel.mesh import Mesh
    from repro_torch.parallel.plan import ServeShard

_MESH: Optional["Mesh"] = None
_ROWS: Tuple[str, ...] = ()
_SERVE = threading.local()


def set_mesh(mesh: Optional["Mesh"], row_axes: Tuple[str, ...] = ()) -> None:
    global _MESH, _ROWS
    _MESH, _ROWS = mesh, tuple(row_axes)


def get_mesh() -> "Mesh":
    if _MESH is None:
        raise RuntimeError("no mesh registered — the caller must call "
                           "repro_torch.runtime_context.set_mesh(mesh)")
    return _MESH


def active_mesh() -> Optional["Mesh"]:
    """The registered mesh when it is live (its collectives run), else
    None."""
    return _MESH if _MESH is not None and _MESH.live else None


def row_axes() -> Tuple[str, ...]:
    """The mesh axes the rows of the current forward are split over."""
    return _ROWS


@contextmanager
def mesh_context(mesh: "Mesh", row_axes: Tuple[str, ...] = ()):
    prev = (_MESH, _ROWS)
    set_mesh(mesh, row_axes)
    try:
        yield mesh
    finally:
        set_mesh(*prev)


def serve_shard() -> Optional["ServeShard"]:
    """The tensor-parallel shard of the current serving forward, or
    None."""
    return getattr(_SERVE, "shard", None)


@contextmanager
def serve_context(shard: Optional["ServeShard"]):
    prev = serve_shard()
    _SERVE.shard = shard
    try:
        yield shard
    finally:
        _SERVE.shard = prev


__all__ = ["set_mesh", "get_mesh", "active_mesh", "row_axes",
           "mesh_context", "serve_shard", "serve_context"]
