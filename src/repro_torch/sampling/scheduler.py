"""Request scheduler for the continuous-batching engine.

The port of ``repro/sampling/scheduler.py``, unchanged in behaviour.
Lifecycle: QUEUED → PREFILL → DECODE → DONE. A fixed pool of decode
slots is recycled: admission binds a queued request to a free slot and
allocates its KV pages; finishing (EOS / token budget) releases both
immediately so the next queued prompt takes over mid-batch — no slot ever
pads out to the global ``max_new``.

Serving extensions:

- **priority classes** — one FIFO per integer priority (0 = most
  urgent); admission always drains the most urgent non-empty class
  first, head-of-line within a class (a large head request blocks its
  class until pages free up, which prevents starvation by later small
  requests);
- **deadlines** — a queued request whose absolute ``deadline_s`` has
  passed is expired at admission time (state DONE, reason "expired")
  instead of wasting pages; requests are *never* dropped after
  admission, because their full KV page budget is reserved up front;
- **shared-prefix reuse** — with a :class:`~repro_torch.sampling.prefix_cache.
  PrefixCache` attached, admission looks up the longest cached prefix of
  the prompt, retains its full pages in place, and only allocates the
  remainder (plus one copy-on-write page when the prefix ends mid-page —
  the engine performs the device-side copy). Pool pressure evicts LRU
  cache entries before deferring admission.

The scheduler is pure host-side bookkeeping (numpy block table, python
queues); all device work stays in the engine.
Per-request engine log-probs are kept as *metadata* for the learner's
recompute path (App. B.1), mirroring the static engine's contract.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np

from repro_torch.sampling.paged_cache import (PageAllocator, SCRATCH_PAGE,
                                              new_block_table, pages_for)
from repro_torch.sampling.prefix_cache import PrefixCache

QUEUED, PREFILL, DECODE, DONE = "queued", "prefill", "decode", "done"


@dataclasses.dataclass
class GenRequest:
    """One generation request moving through the slot pool."""
    rid: int                      # row id; also the RNG fold_in stream
    prompt: np.ndarray            # (Tp,) int32 true prompt tokens
    max_new: int
    priority: int = 1             # 0 = most urgent
    deadline_s: Optional[float] = None   # absolute clock deadline (TTFT SLO)
    arrival_s: float = 0.0
    state: str = QUEUED
    slot: int = -1
    pages: List[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0          # prompt tokens already prefilled
    prefix_hit_tokens: int = 0    # tokens served from the prefix cache
    cow_src: int = -1             # cached page to copy-on-write from ...
    cow_dst: int = -1             # ... into this freshly allocated page
    tokens: List[int] = dataclasses.field(default_factory=list)
    logps: List[float] = dataclasses.field(default_factory=list)
    spec_ok: bool = True          # request opts in to speculative decode
    finish_reason: str = ""       # "eos" | "length" | "expired"
    t_first_token: float = -1.0   # host clock at first decoded token
    t_done: float = -1.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def gen_count(self) -> int:
        return len(self.tokens)

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.max_new

    @property
    def next_pos(self) -> int:
        """Next KV write position (prompt length + generated so far)."""
        return self.prompt_len + self.gen_count


class ContinuousScheduler:
    """Admission + slot/page recycling over a fixed slot pool."""

    def __init__(self, num_slots: int, pages_per_slot: int, page_size: int,
                 allocator: PageAllocator,
                 prefix_cache: Optional[PrefixCache] = None) -> None:
        self.num_slots = num_slots
        self.pages_per_slot = pages_per_slot
        self.page_size = page_size
        self.allocator = allocator
        self.prefix_cache = prefix_cache
        self.block_table = new_block_table(num_slots, pages_per_slot)
        self.slots: List[Optional[GenRequest]] = [None] * num_slots
        self.queues: Dict[int, Deque[GenRequest]] = {}
        self.finished: List[GenRequest] = []
        self._expired: List[GenRequest] = []
        self.stats: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "completed": 0, "expired": 0,
            "max_active": 0, "decode_steps": 0, "decode_slot_steps": 0,
            "prefill_chunks": 0, "prefill_tokens": 0,
            "prefix_hits": 0, "prefix_tokens_reused": 0, "cow_copies": 0,
            # speculative decode (zero when spec_k == 0)
            "spec_rounds": 0, "spec_slot_rounds": 0,
            "drafted_tokens_total": 0, "accepted_tokens_total": 0,
            "draft_hits": 0, "spec_fallback_chunks": 0,
        }

    # ------------------------------------------------------------------
    @property
    def queue_depth(self) -> int:
        return sum(len(q) for q in self.queues.values())

    def submit(self, req: GenRequest) -> None:
        assert req.state == QUEUED
        self.stats["submitted"] += 1
        self.queues.setdefault(req.priority, deque()).append(req)

    def _expire(self, req: GenRequest, now_s: float) -> None:
        req.state, req.finish_reason = DONE, "expired"
        req.t_done = now_s
        self.finished.append(req)
        self._expired.append(req)
        self.stats["expired"] += 1

    def _head(self, now_s: float) -> Optional[Deque[GenRequest]]:
        """Queue holding the most urgent admissible head request;
        expired heads are retired on the way."""
        for pr in sorted(self.queues):
            q = self.queues[pr]
            while q:
                req = q[0]
                if req.deadline_s is not None and now_s > req.deadline_s:
                    q.popleft()
                    self._expire(req, now_s)
                    continue
                return q
        return None

    def drain_expired(self) -> List[GenRequest]:
        """Requests expired since the last drain (the engine emits their
        terminal events)."""
        out, self._expired = self._expired, []
        return out

    def admit(self, now_s: float = 0.0) -> List[GenRequest]:
        """Bind queued requests to free slots while pages last — most
        urgent priority class first, FIFO within a class. A request's
        *entire* KV budget (``pages_for(total_len)`` minus shared prefix
        pages) is reserved here, so admitted requests can never be
        dropped mid-decode. Returns the newly admitted requests (state
        PREFILL)."""
        newly: List[GenRequest] = []
        for s in range(self.num_slots):
            if self.slots[s] is not None:
                continue
            q = self._head(now_s)
            if q is None:
                break
            req = q[0]
            need = pages_for(req.total_len, self.page_size)
            if need > self.pages_per_slot:
                raise ValueError(
                    f"request {req.rid}: {req.total_len} tokens need {need} "
                    f"pages > pages_per_slot={self.pages_per_slot}")
            m, shared, cow_src = 0, [], -1
            if self.prefix_cache is not None:
                m, shared, cow_src = self.prefix_cache.lookup(req.prompt)
            if shared:                    # pin before allocating the rest
                self.allocator.retain(shared)
            need_new = need - len(shared)
            pages = self.allocator.alloc(need_new)
            if pages is None and self.prefix_cache is not None:
                # pool pressure: drop cache-only references, retry
                self.prefix_cache.evict_until(need_new)
                pages = self.allocator.alloc(need_new)
            if pages is None:             # pool exhausted — wait for frees
                if shared:
                    self.allocator.release(shared)
                break
            q.popleft()
            req.state, req.slot = PREFILL, s
            req.pages = shared + pages
            req.prefill_pos = req.prefix_hit_tokens = m
            if cow_src >= 0:              # engine copies src -> dst on device
                req.cow_src, req.cow_dst = cow_src, pages[0]
            self.block_table[s, :need] = req.pages
            self.block_table[s, need:] = SCRATCH_PAGE
            self.slots[s] = req
            newly.append(req)
            self.stats["admitted"] += 1
            if m:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_tokens_reused"] += m
        self.stats["max_active"] = max(self.stats["max_active"],
                                       sum(r is not None for r in self.slots))
        return newly

    def finish(self, req: GenRequest, reason: str,
               now_s: float = 0.0) -> None:
        """Release the request's references on its slot and pages; pages
        still shared (prefix cache / other requests) survive."""
        assert req.state in (PREFILL, DECODE)
        self.allocator.release(req.pages)
        req.pages = []
        self.block_table[req.slot] = SCRATCH_PAGE
        self.slots[req.slot] = None
        req.state, req.finish_reason = DONE, reason
        req.t_done = now_s
        self.finished.append(req)
        self.stats["completed"] += 1

    # ------------------------------------------------------------------
    def next_prefill(self) -> Optional[GenRequest]:
        for r in self.slots:
            if r is not None and r.state == PREFILL:
                return r
        return None

    def decoding(self) -> List[GenRequest]:
        return [r for r in self.slots if r is not None and r.state == DECODE]

    @property
    def all_done(self) -> bool:
        return self.queue_depth == 0 and all(r is None for r in self.slots)

    def slot_utilization(self) -> float:
        """Fraction of decode-step slot positions that carried a live
        request — the headline efficiency number for serving."""
        steps = self.stats["decode_steps"]
        if steps == 0:
            return 0.0
        return self.stats["decode_slot_steps"] / (steps * self.num_slots)
