"""Paged (block-table) KV cache for the continuous-batching engine.

The port of ``repro/sampling/paged_cache.py``. The sequence axis is
carved into fixed-size *pages* owned by a global pool:

- **page pools**: per attention layer, ``kp``/``vp`` of shape
  ``(num_blocks, num_pages, page_size, Hkv, head_dim)``, stacked on the
  block axis like the model's parameters;
- **block table**: ``(num_slots, pages_per_slot)`` int32 mapping a slot's
  logical page to a physical page; position ``p`` of slot ``s`` lives at
  ``pool[table[s, p // page_size], p % page_size]``;
- **allocator**: a host-side refcounted free list. Page 0 is the
  *scratch sink*: unassigned table entries point at it, it is never
  handed out, and it may hold garbage (NaN included) that is never
  causally visible.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.config import ATTN, LOCAL, ModelConfig
from repro_torch.device import DeviceLike, resolve_device

SCRATCH_PAGE = 0


def pages_for(total_len: int, page_size: int) -> int:
    """Pages needed to hold ``total_len`` tokens."""
    return -(-total_len // page_size)


class PageAllocator:
    """Refcounted free-list page allocator. Page 0 (scratch) is never
    handed out.

    ``alloc`` hands out pages at refcount 1; ``retain``/``release`` move
    the count, and a page returns to the free list only when its count
    hits zero, so N requests (and the prefix cache) can share the pages of
    a common prompt prefix. Releasing a page that is not live raises.
    """

    def __init__(self, num_pages: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least one scratch + one usable page")
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return len(self._refs)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` pages at refcount 1, or None if the pool cannot
        satisfy the request."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for pg in pages:
            self._refs[pg] = 1
        return pages

    def retain(self, pages: List[int]) -> None:
        """Add one reference to each live page (shared-prefix admission)."""
        for pg in pages:
            if pg not in self._refs:
                raise ValueError(f"retain of dead / foreign page {pg}")
            self._refs[pg] += 1

    def release(self, pages: List[int]) -> List[int]:
        """Drop one reference per page; pages whose count hits zero go
        back on the free list (returned, in order)."""
        freed: List[int] = []
        for pg in pages:
            if pg not in self._refs:
                raise ValueError(f"double free / foreign page {pg}")
            self._refs[pg] -= 1
            if self._refs[pg] == 0:
                del self._refs[pg]
                self._free.append(pg)
                freed.append(pg)
        return freed

    free = release


def init_paged_pool(cfg: ModelConfig, num_pages: int, page_size: int,
                    device: DeviceLike = "cuda",
                    dtype: Optional[torch.dtype] = None,
                    plan=None) -> Dict:
    """Zeroed page pools matching the model's per-block cache structure:
    ``{"layer_i": {"self": {"kp": ..., "vp": ...}}}``. Attention layers
    only; other layer kinds do not page. ``plan`` (an ``ExecutionPlan``)
    allocates this rank's shard of every pool, the KV heads its fitted
    ``cache_shardings`` give it, on the plan's device when it names
    one."""
    dev = resolve_device(device)
    dt = dtype or getattr(torch, cfg.dtype)
    shape = (cfg.num_blocks, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    shapes: Dict[str, Dict] = {}
    for i, kind in enumerate(cfg.block_pattern):
        if kind not in (ATTN, LOCAL):
            raise ValueError(
                f"paged cache supports attention layers only, got {kind!r}")
        shapes[f"layer_{i}"] = {"self": {"kp": shape, "vp": shape}}
    if plan is not None:
        sh = plan.cache_shardings(cfg, shapes)
        shapes = {k: {"self": {n: sh[k]["self"][n].shard_shape(shape)
                               for n in ("kp", "vp")}}
                  for k in shapes}
        dev = plan.device or dev
    return {k: {"self": {n: torch.zeros(s, dtype=dt, device=dev)
                         for n, s in layer["self"].items()}}
            for k, layer in shapes.items()}


def paged_cache_supported(cfg: ModelConfig) -> bool:
    """True when the continuous engine's paged cache can serve ``cfg``."""
    return (all(k in (ATTN, LOCAL) for k in cfg.block_pattern)
            and not cfg.is_encdec
            and not cfg.local_ring_kv
            and cfg.memory_seq == 0)


def new_block_table(num_slots: int, pages_per_slot: int) -> np.ndarray:
    """Host-side block table, all entries parked on the scratch page."""
    return np.full((num_slots, pages_per_slot), SCRATCH_PAGE, np.int32)
