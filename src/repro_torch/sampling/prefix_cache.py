"""Shared-prefix KV page cache for the continuous-batching engine.

N requests that share a system prompt should prefill it once. The cache
maps prompt-token prefixes to the physical KV pages that already hold
their keys/values, keyed on the prompt-token hash (bucketing) with an
exact token-array compare (correctness). Because K/V at position ``j``
depend only on tokens ``[0, j]`` under causal attention, any cached
prefix whose tokens match a new request's first ``m`` tokens serves that
request's positions ``[0, m)`` verbatim — bit-exactly.

Sharing rules (enforced by the scheduler at admission):

- **full pages** of the common prefix are shared in place: the new
  request's block table points at the cached physical pages, which are
  ``retain``-ed on the refcounted :class:`~repro_torch.sampling.paged_cache.
  PageAllocator` so they outlive any single request;
- the **partial tail page** (a prefix ending mid-page) is *copied on
  write*: the sharer gets a fresh page, the engine copies the cached
  page's contents into it device-side, and the sharer appends its own
  tokens into the copy — the cached page is never written by a sharer.
  (The original owner keeps decoding into the cached tail page, but only
  at positions ``>= m``, which the sharer either overwrites in its copy
  or masks — so the shared region ``[0, m)`` is immutable in practice.)

The cache holds its own reference on every cached page; eviction (LRU,
triggered by pool pressure or the entry cap) just drops that reference —
pages still shared by live requests survive until those finish.

Entries are whole inserted prefixes compared exactly; the hash is a
bucketing hint, not trusted. A production variant would chain per-page
hashes (vLLM-style) for O(pages) lookup; at this repo's scale a scan
over a bounded entry list is simpler and obviously correct.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sampling.paged_cache import PageAllocator, pages_for


def _common_prefix_len(a: np.ndarray, b: np.ndarray) -> int:
    n = min(a.shape[0], b.shape[0])
    if n == 0:
        return 0
    neq = a[:n] != b[:n]
    return int(np.argmax(neq)) if neq.any() else n


@dataclasses.dataclass
class PrefixEntry:
    tokens: np.ndarray          # (L,) int32 prompt prefix held by this entry
    pages: List[int]            # pages_for(L) physical pages, cache-retained
    tick: int                   # LRU stamp


class PrefixCache:
    """LRU prompt-prefix → KV-page cache over a refcounted allocator."""

    def __init__(self, page_size: int, allocator: PageAllocator, *,
                 max_entries: int = 64) -> None:
        self.page_size = page_size
        self.allocator = allocator
        self.max_entries = max_entries
        self._entries: Dict[int, PrefixEntry] = {}   # token-hash -> entry
        self._tick = 0
        self.stats: Dict[str, int] = {
            "lookups": 0, "hits": 0, "tokens_reused": 0,
            "inserts": 0, "evictions": 0,
        }

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def _key(tokens: np.ndarray) -> int:
        return hash(tokens.tobytes())

    # ------------------------------------------------------------------
    def lookup(self, prompt: np.ndarray) -> Tuple[int, List[int], int]:
        """Longest cached prefix of ``prompt``.

        Returns ``(m, shared_pages, cow_src)``: ``m`` matched tokens
        (capped at ``len(prompt) - 1`` so the final prompt token is
        always prefilled — its logits seed decoding), the cached
        physical pages for the ``m // page_size`` *full* matched pages
        (NOT yet retained — the caller retains before allocating the
        rest), and the cached page to copy-on-write for a mid-page tail
        (``-1`` when ``m`` is page-aligned). Best-match across entries;
        bumps the winner's LRU stamp.
        """
        self.stats["lookups"] += 1
        prompt = np.asarray(prompt)
        best_m, best = 0, None
        for ent in self._entries.values():
            m = _common_prefix_len(ent.tokens, prompt)
            if m > best_m:
                best_m, best = m, ent
        best_m = min(best_m, int(prompt.shape[0]) - 1)
        if best is None or best_m <= 0:
            return 0, [], -1
        self._tick += 1
        best.tick = self._tick
        full = best_m // self.page_size
        cow_src = best.pages[full] if best_m % self.page_size else -1
        self.stats["hits"] += 1
        self.stats["tokens_reused"] += best_m
        return best_m, list(best.pages[:full]), cow_src

    def peek(self, prompt: np.ndarray) -> Tuple[int, List[int], int]:
        """``lookup`` without side effects (no stats, no LRU bump) — what
        the admission controller uses to estimate how many pages a
        request would actually allocate."""
        prompt = np.asarray(prompt)
        best_m = 0
        best: Optional[PrefixEntry] = None
        for ent in self._entries.values():
            m = _common_prefix_len(ent.tokens, prompt)
            if m > best_m:
                best_m, best = m, ent
        best_m = min(best_m, int(prompt.shape[0]) - 1)
        if best is None or best_m <= 0:
            return 0, [], -1
        full = best_m // self.page_size
        cow_src = best.pages[full] if best_m % self.page_size else -1
        return best_m, list(best.pages[:full]), cow_src

    def insert(self, prompt: np.ndarray, pages: List[int]) -> bool:
        """Cache ``prompt``'s prefix pages (``pages_for(len(prompt))`` of
        ``pages``). The cache retains them; skips prompts an existing
        entry already covers in full. Returns True if inserted."""
        prompt = np.asarray(prompt, np.int32)
        n = int(prompt.shape[0])
        if n < self.page_size:            # not worth a cache slot
            return False
        for ent in self._entries.values():
            if _common_prefix_len(ent.tokens, prompt) == n:
                return False
        need = pages_for(n, self.page_size)
        held = list(pages[:need])
        self.allocator.retain(held)
        self._tick += 1
        key = self._key(prompt)
        if key in self._entries:          # same tokens re-inserted: replace
            self.allocator.release(self._entries[key].pages)
        self._entries[key] = PrefixEntry(tokens=prompt, pages=held,
                                         tick=self._tick)
        self.stats["inserts"] += 1
        while len(self._entries) > self.max_entries:
            self._evict_lru()
        return True

    # ------------------------------------------------------------------
    def _evict_lru(self) -> bool:
        if not self._entries:
            return False
        key = min(self._entries, key=lambda k: self._entries[k].tick)
        self.allocator.release(self._entries.pop(key).pages)
        self.stats["evictions"] += 1
        return True

    def evict_until(self, need_free: int) -> int:
        """Drop LRU entries until the allocator can hand out
        ``need_free`` pages (or the cache is empty). Pages still shared
        by live requests only lose the cache's reference — they free for
        real when the last request releases them. Returns entries
        evicted."""
        n = 0
        while self.allocator.available < need_free and self._evict_lru():
            n += 1
        return n

    def clear(self) -> None:
        while self._evict_lru():
            pass
