"""Deterministic discrete-event simulation kernel: the port's own copy of
``repro/hetero/events.py`` (pure Python).

HeteroRL's decentralized star topology runs as a virtual-clock simulation:
every node action (generate a batch, take a learner step, deliver a
checkpoint) is an event with a simulated duration. This makes multi-node
asynchrony — including the latency→staleness→KL causal chain of
Fig. 5 — fully reproducible on one host.
"""
from __future__ import annotations

import heapq
import itertools
import threading
from typing import Callable, List, Optional, Tuple


class EventSim:
    """Event queue + virtual clock.

    The queue is lock-guarded so events may be scheduled from helper
    threads; handlers run on whichever thread drives :meth:`step`,
    *outside* the lock, so they can reschedule reentrantly. Events at the
    same time fire in the order they were scheduled."""

    def __init__(self) -> None:
        self.now = 0.0
        self._q: List[Tuple[float, int, Callable[[], None]]] = []
        self._counter = itertools.count()
        self._lock = threading.Lock()

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        if not delay >= 0.0:
            raise ValueError(f"negative or NaN delay {delay}")
        with self._lock:
            heapq.heappush(self._q,
                           (self.now + delay, next(self._counter), fn))

    def step(self) -> bool:
        with self._lock:
            if not self._q:
                return False
            t, _, fn = heapq.heappop(self._q)
            self.now = t
        fn()
        return True

    def run_until(self, t_end: float = float("inf"),
                  stop: Optional[Callable[[], bool]] = None) -> None:
        while self._q and self.now <= t_end:
            if stop is not None and stop():
                return
            self.step()


class Transport:
    """Star-topology message passing with per-message delay."""

    def __init__(self, sim: EventSim) -> None:
        self.sim = sim
        self.messages_sent = 0
        self.bytes_sent = 0
        self._lock = threading.Lock()

    def send(self, delay_s: float, deliver: Callable[[], None],
             nbytes: int = 0) -> None:
        with self._lock:
            self.messages_sent += 1
            self.bytes_sent += nbytes
        self.sim.schedule(delay_s, deliver)
