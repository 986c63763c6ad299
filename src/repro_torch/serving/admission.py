"""Admission control for the serving front door: the port of
``repro/serving/admission.py``.

The scheduler already guarantees the hard invariant — a request's whole
KV page budget is reserved when it *binds to a slot*, so nothing is ever
dropped mid-decode. What it cannot do is bound how much demand piles up
in front of the slots. The front door closes that gap by refusing
requests the deployment can't credibly serve, at arrival time, with a
reason the client can act on:

- ``infeasible`` — prompt + token budget exceed ``max_total_tokens``
  (would raise at admission; reject it at the door instead);
- ``expired`` — the deadline already passed on arrival;
- ``queue_full`` — more than ``ServeConfig.max_queue`` requests waiting;
- ``overloaded`` — the *pages* promised to queued requests (net of
  shared-prefix reuse) would exceed ``queue_overcommit`` turns of the
  page pool: the queue may hold a bounded multiple of what the pool
  serves per drain, beyond that new arrivals are shed rather than
  building an unbounded TTFT tail.

Everything here is a pure read of scheduler/allocator state on the host
— the controller holds no state of its own beyond its reject counters,
so it can't drift from the engine, and it never touches the card.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.config import ServeConfig
from repro_torch.sampling.paged_cache import pages_for
from repro_torch.serving.api import Request

OK = "ok"
INFEASIBLE = "infeasible"
EXPIRED = "expired"
QUEUE_FULL = "queue_full"
OVERLOADED = "overloaded"


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    reason: str                 # one of the module constants
    detail: str = ""

    def __bool__(self) -> bool:
        return self.admitted


class AdmissionController:
    """Decide, per arriving request, whether the engine should queue it."""

    def __init__(self, serve: ServeConfig, engine) -> None:
        self.serve = serve
        self.engine = engine
        self.rejected = {INFEASIBLE: 0, EXPIRED: 0, QUEUE_FULL: 0,
                         OVERLOADED: 0}

    def _queued_pages(self) -> int:
        """KV pages promised to requests still waiting in the scheduler's
        priority queues (their budgets are not yet reserved — admission
        reserves — so the controller must count them itself)."""
        sched = self.engine.sched
        return sum(pages_for(r.total_len, self.serve.page_size)
                   for q in sched.queues.values() for r in q)

    def check(self, req: Request,
              now_s: Optional[float] = None) -> AdmissionDecision:
        serve, eng = self.serve, self.engine
        need = pages_for(req.prompt_len + req.params.max_new_tokens,
                         serve.page_size)
        if need > eng.pages_per_slot:
            return self._reject(
                INFEASIBLE,
                f"{req.prompt_len}+{req.params.max_new_tokens} tokens need "
                f"{need} pages > {eng.pages_per_slot} per slot "
                f"(max_total_tokens={serve.max_total_tokens})")
        if (req.deadline_s is not None and now_s is not None
                and now_s > req.deadline_s):
            return self._reject(EXPIRED, "deadline passed before admission")
        depth = eng.sched.queue_depth
        if depth >= serve.max_queue:
            return self._reject(QUEUE_FULL,
                                f"{depth} requests queued >= max_queue="
                                f"{serve.max_queue}")
        # shed load once queued demand exceeds the overcommit budget —
        # the shared-prefix cache effectively enlarges the pool for
        # prompts it already holds, so count only the pages this request
        # would newly allocate
        if eng.prefix_cache is not None:
            m, shared, cow = eng.prefix_cache.peek(req.prompt)
            need -= len(shared)
        capacity = eng.num_pages - 1            # page 0 is scratch
        budget = capacity * serve.queue_overcommit
        promised = self._queued_pages()
        if promised + need > budget:
            return self._reject(
                OVERLOADED,
                f"{promised} pages already promised to the queue + {need} "
                f"> {serve.queue_overcommit:g}x pool capacity {capacity}")
        return AdmissionDecision(True, OK)

    def _reject(self, reason: str, detail: str) -> AdmissionDecision:
        self.rejected[reason] += 1
        return AdmissionDecision(False, reason, detail)

    @property
    def rejected_total(self) -> int:
        return sum(self.rejected.values())
