"""Rank meshes for every execution scale (the port of
``repro/parallel/mesh.py``).

A ``Mesh`` names the axes of a grid of ranks: ``("data", "model")``, or
``("pod", "data", "model")`` with the slow inter-pod axis first. Rank r
sits at the row-major coordinates of r in that grid, as
``torch.distributed.device_mesh.init_device_mesh`` lays it out. A mesh is
one of three kinds:

- **live**: built over the initialised process group (one rank a
  process, under ``torchrun`` or a caller's ``init_process_group``), on
  ``init_device_mesh``; it holds one process group for every set of its
  axes, so a collective over ``("data", "model")`` or ``("pod", "data")``
  is one call;
- **local**: ``local_mesh()``, the 1x1 default of every single-device
  path. It needs no process group and launches no collective;
- **abstract**: ``abstract_mesh(shape, names)``, axis sizes alone, for
  placement rules, shard grids and publish manifests without ranks (the
  JAX package's ``AbstractMesh``).

``mesh_from_flag`` parses the ``--mesh DxM`` / ``PxDxM`` form and raises
``RuntimeError`` when the mesh needs more ranks than the group has:
nothing carries on with fewer ranks or on the CPU.
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

# NVIDIA H100 SXM constants (per card) for the roofline arithmetic: dense
# bf16 tensor-core peak, HBM3 bandwidth, and NVLink 4 bandwidth per
# direction in the place of the TPU's ICI link; and the card's memory
# (the dry-run's fit check, in the place of the TPU's 16 GB).
PEAK_BF16_FLOPS = 989e12          # FLOP/s, H100 SXM
HBM_BW = 3.35e12                  # bytes/s, H100 SXM
ICI_BW = 450e9                    # bytes/s, H100 NVLink 4, one direction
HBM_BYTES = 80 * 10 ** 9          # bytes, H100 80GB (the data sheet's)

AXES_2D = ("data", "model")
AXES_3D = ("pod", "data", "model")


class Mesh:
    """Named axes over a grid of ranks. Hashed by identity: the cached
    builders hand every caller the same object, and plans key on it."""

    def __init__(self, dims: Tuple[int, ...], axis_names: Tuple[str, ...],
                 *, device: Optional[torch.device] = None,
                 rank: Optional[int] = None, device_mesh=None,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None):
        if len(dims) != len(axis_names):
            raise ValueError(f"mesh dims {dims} vs axes {axis_names}")
        self.axis_names = tuple(axis_names)
        self.dims = tuple(int(d) for d in dims)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, self.dims))
        self.size = int(np.prod(self.dims))
        self.devices = np.arange(self.size).reshape(self.dims)
        self.device = device
        self.rank = rank
        self.device_mesh = device_mesh
        self.groups = groups or {}

    @property
    def live(self) -> bool:
        """True when the mesh holds process groups (its collectives run)."""
        return bool(self.groups)

    def coords_of(self, rank: int) -> Dict[str, int]:
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(rank, self.dims))))

    def axis_index(self, axes: Tuple[str, ...], rank: Optional[int] = None
                   ) -> int:
        """Row-major index of ``rank`` (default this process) over
        ``axes``, the position of its shard along a dim split over them."""
        c = self.coords_of(self.rank if rank is None else rank)
        idx = 0
        for a in axes:
            idx = idx * self.shape[a] + c[a]
        return idx

    def axes_size(self, axes: Tuple[str, ...]) -> int:
        return int(np.prod([self.shape[a] for a in axes])) if axes else 1

    def group(self, axes: Tuple[str, ...]):
        """The process group over ``axes`` (in mesh order) that holds this
        rank: the ranks that differ from it on those axes alone."""
        key = tuple(a for a in self.axis_names if a in axes)
        if key != tuple(axes):
            raise ValueError(f"axes {axes} not in mesh order "
                             f"{self.axis_names}")
        return self.groups[key]

    def __repr__(self) -> str:
        kind = "live" if self.live else ("local" if self.rank == 0
                                         else "abstract")
        return (f"Mesh({kind}, " + ", ".join(
            f"{a}={n}" for a, n in self.shape.items()) + ")")


def _axis_subsets(names: Tuple[str, ...]):
    for n in range(1, len(names) + 1):
        yield from itertools.combinations(names, n)


def _world() -> int:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 0


def _recipe(spec: str, need: int, have: int) -> str:
    return (f"mesh {spec} needs {need} ranks but the process group has "
            f"{have or 'none (not initialised)'} — run under `torchrun "
            f"--nproc-per-node {need} ...` (or init_process_group with "
            f"world_size={need}) before building the mesh")


def make_mesh(dims: Tuple[int, ...], axis_names: Tuple[str, ...], *,
              device: Optional[DeviceLike] = None) -> Mesh:
    """A live mesh over the initialised process group, which must hold
    exactly ``prod(dims)`` ranks. ``device`` is where the plan places
    tensors: default this process's current card whenever CUDA is
    available, whatever the backend (gloo included), else None, which
    leaves every tensor where it is. The CPU only when the caller asks
    for it. Every rank must call this together, in the same order: it
    creates one process group for every non-empty set of axes."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    need = int(np.prod(dims))
    have = _world()
    spec = "x".join(str(d) for d in dims)
    if have != need:
        raise RuntimeError(_recipe(spec, need, have) if have < need else
                           f"mesh {spec} covers {need} of the group's "
                           f"{have} ranks; a mesh spans the whole group")
    backend = dist.get_backend()
    if device is None and torch.cuda.is_available():
        device = "cuda"
    dev = None if device is None else resolve_device(device)
    if dev is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          tuple(dims), mesh_dim_names=tuple(axis_names))
    rank = dist.get_rank()
    probe = Mesh(dims, axis_names)
    groups: Dict[Tuple[str, ...], object] = {}
    for subset in _axis_subsets(tuple(axis_names)):
        if len(subset) == 1:
            groups[subset] = dm.get_group(subset[0])
            continue
        other = [a for a in axis_names if a not in subset]
        for combo in itertools.product(*(range(probe.shape[a])
                                         for a in other)):
            members = [r for r in range(need)
                       if all(probe.coords_of(r)[a] == c
                              for a, c in zip(other, combo))]
            # every rank builds every group once, in one order, at mesh
            # construction (collective)
            g = dist.new_group(members)  # noqa: RA002 — once per mesh
            if rank in members:
                groups[subset] = g
    return Mesh(dims, axis_names, device=dev, rank=rank, device_mesh=dm,
                groups=groups)


def abstract_mesh(dims: Tuple[int, ...],
                  axis_names: Tuple[str, ...] = AXES_2D) -> Mesh:
    """Axis sizes alone: placement rules and shard grids, no ranks."""
    return Mesh(tuple(dims), tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False,
                         device: Optional[DeviceLike] = None) -> Mesh:
    """(data=16, model=16), or (pod=2, data=16, model=16): 256 or 512
    ranks, which the group must hold."""
    if multi_pod:
        return make_mesh((2, 16, 16), AXES_3D, device=device)
    return make_mesh((16, 16), AXES_2D, device=device)


def make_debug_mesh(n_data: int = 2, n_model: int = 2, *,
                    multi_pod: bool = False,
                    device: Optional[DeviceLike] = None) -> Mesh:
    """A small live mesh over the group (2 x n_data x n_model ranks with
    ``multi_pod``). ``make_debug_mesh(1, 1)`` on a one-rank group is a
    1x1 mesh whose collectives all run, unlike ``local_mesh``."""
    if multi_pod:
        return make_mesh((2, n_data, n_model), AXES_3D, device=device)
    return make_mesh((n_data, n_model), AXES_2D, device=device)


@functools.lru_cache(maxsize=None)
def _local(device: Optional[str], dims: Tuple[int, ...]) -> Mesh:
    names = AXES_2D if len(dims) == 2 else AXES_3D
    return Mesh(dims, names, rank=0,
                device=None if device is None else torch.device(device))


def local_mesh(device: Optional[DeviceLike] = None) -> Mesh:
    """The (data=1, model=1) mesh of single-device plans: no process
    group, no collective. ``device`` is where its plan places tensors
    (None: where they already are). Cached per device, so every caller
    sees one object."""
    return _local(None if device is None else str(resolve_device(device)),
                  (1, 1))


def parse_mesh(spec: str) -> Tuple[int, ...]:
    """The dims of a ``DxM`` / ``PxDxM`` mesh spec; ``ValueError`` on any
    other form."""
    try:
        dims = tuple(int(p) for p in spec.lower().split("x"))
    except ValueError:
        dims = ()
    if len(dims) not in (2, 3) or any(d < 1 for d in dims):
        raise ValueError(f"mesh spec {spec!r}: expected DxM or PxDxM "
                         "positive integers, e.g. '2x2' or '2x2x2'")
    return dims


def mesh_from_flag(spec: str, device: Optional[DeviceLike] = None) -> Mesh:
    """Parse a ``DxM`` (or ``PxDxM``) mesh spec, e.g. "1x1", "2x4",
    "2x2x2". "1x1" (or a one-rank spec with no group) is the local mesh;
    any other is a live mesh over the initialised group, and a mesh that
    needs more ranks than the group has raises ``RuntimeError`` with the
    ``torchrun`` recipe."""
    dims = parse_mesh(spec)
    need = int(np.prod(dims))
    have = _world()
    if need == 1 and (dims == (1, 1) or not have):
        if dims == (1, 1):
            return local_mesh(device)
        return _local(None if device is None
                      else str(resolve_device(device)), dims)
    if need > have:
        raise RuntimeError(_recipe(spec, need, have))
    return make_mesh(dims, AXES_2D if len(dims) == 2 else AXES_3D,
                     device=device)


def data_axes(mesh: Mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


__all__ = ["Mesh", "PEAK_BF16_FLOPS", "HBM_BW", "ICI_BW", "HBM_BYTES",
           "abstract_mesh", "make_mesh", "make_production_mesh",
           "make_debug_mesh", "local_mesh", "mesh_from_flag", "parse_mesh",
           "data_axes"]
