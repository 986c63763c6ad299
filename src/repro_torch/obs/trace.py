"""Span tracer: one timeline vocabulary for live and simulated runs.

``tracer.span("prefill", slot=3)`` opens a duration span on the current
*track* (a logical timeline — "learner", "sampler-0", or the OS thread
name by default); spans nest per track through a thread-local stack, and
a span that raises still closes and records its duration plus the
exception type. Events accumulate in a bounded ring buffer and export as
Chrome-trace/Perfetto JSON or a JSONL event log (``repro_torch.obs.export``).

The clock is pluggable: ``time.perf_counter`` for real runs, or any
zero-arg callable — ``use_sim(sim)`` points it at an
:class:`~repro_torch.hetero.events.EventSim`'s virtual ``now``, so a
discrete-event hetero run emits the *same* trace format as a live one
(simulated seconds on the x-axis instead of wall seconds). For scheduled
work whose duration is known to the simulator rather than measured,
``complete(name, start_s, end_s)`` records an explicitly-timed span.

Zero-cost contract: a disabled tracer's ``span()`` returns a shared
no-op singleton — no allocation, no clock read; mutators check
``enabled`` first. The ring buffer (``deque(maxlen=...)``) bounds memory
on long-lived servers; the oldest events fall off.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

DEFAULT_MAX_EVENTS = 200_000


class _NoopSpan:
    """Shared do-nothing span for the disabled fast path."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


_NOOP_SPAN = _NoopSpan()


class Span:
    """Open duration span; records a complete ("X") event on exit —
    including the exceptional exit, which additionally tags the event
    with the exception type so failed phases are visible in the trace."""

    __slots__ = ("_tracer", "name", "args", "track", "t0")

    def __init__(self, tracer: "Tracer", name: str, track: Optional[str],
                 args: Dict[str, Any]) -> None:
        self._tracer = tracer
        self.name = name
        self.track = track
        self.args = args
        self.t0 = 0.0

    def __enter__(self) -> "Span":
        self.t0 = self._tracer.now()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        tr = self._tracer
        t1 = tr.now()
        args = self.args
        if exc_type is not None:
            args = dict(args)
            args["error"] = exc_type.__name__
        tr._emit({"ph": "X", "name": self.name, "ts": self.t0,
                  "dur": max(t1 - self.t0, 0.0),
                  "track": self.track or tr.current_track(), "args": args})
        return False                      # never swallow the exception


class _TrackCtx:
    __slots__ = ("_tracer", "_name")

    def __init__(self, tracer: "Tracer", name: str) -> None:
        self._tracer = tracer
        self._name = name

    def __enter__(self) -> None:
        self._tracer._track_stack().append(self._name)

    def __exit__(self, *exc) -> bool:
        stack = self._tracer._track_stack()
        if stack:
            stack.pop()
        return False


class Tracer:
    """Bounded event recorder with a pluggable clock; see module doc."""

    def __init__(self, enabled: bool = False,
                 clock: Callable[[], float] = time.perf_counter,
                 max_events: int = DEFAULT_MAX_EVENTS) -> None:
        self.enabled = enabled
        self.clock = clock
        # deque.append is atomic under the GIL — sampler threads and the
        # learner emit concurrently without a lock on the hot path
        self._events: deque = deque(maxlen=max_events)
        self._tls = threading.local()
        self._aid = 0                     # async-flow id source
        self._aid_lock = threading.Lock()

    # -- clock ---------------------------------------------------------
    def now(self) -> float:
        return self.clock()

    def set_clock(self, clock: Callable[[], float]) -> None:
        self.clock = clock

    def use_wall_clock(self) -> None:
        self.clock = time.perf_counter

    def use_sim(self, sim: Any) -> None:
        """Read timestamps from a discrete-event sim's virtual clock
        (anything with a float ``now`` attribute)."""
        self.clock = lambda: sim.now

    # -- track (logical timeline) context ------------------------------
    def _track_stack(self) -> List[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def current_track(self) -> str:
        stack = self._track_stack()
        return stack[-1] if stack else threading.current_thread().name

    def track(self, name: str) -> _TrackCtx:
        """Context manager: spans opened inside land on track ``name``."""
        return _TrackCtx(self, name)

    def set_track(self, name: str) -> None:
        """Pin the current thread's default track (worker-loop entry)."""
        self._tls.stack = [name]

    # -- emitters --------------------------------------------------------
    def _emit(self, ev: Dict[str, Any]) -> None:
        self._events.append(ev)

    def span(self, name: str, track: Optional[str] = None, **args):
        """Open a duration span (context manager). No-op when disabled."""
        if not self.enabled:
            return _NOOP_SPAN
        return Span(self, name, track, args)

    def instant(self, name: str, track: Optional[str] = None,
                **args) -> None:
        if not self.enabled:
            return
        self._emit({"ph": "i", "name": name, "ts": self.now(),
                    "track": track or self.current_track(), "args": args})

    def complete(self, name: str, start_s: float, end_s: float,
                 track: Optional[str] = None, **args) -> None:
        """Explicitly-timed span — scheduled work whose duration the
        simulator knows (a learner-step window, a WAN transfer)."""
        if not self.enabled:
            return
        self._emit({"ph": "X", "name": name, "ts": start_s,
                    "dur": max(end_s - start_s, 0.0),
                    "track": track or self.current_track(), "args": args})

    def next_flow_id(self) -> int:
        with self._aid_lock:
            self._aid += 1
            return self._aid

    def async_begin(self, name: str, flow_id: int, cat: str = "flow",
                    ts: Optional[float] = None, track: Optional[str] = None,
                    **args) -> None:
        """Async-flow begin ("b"): overlapping operations (chunk fetches
        in flight) that don't nest on a single track."""
        if not self.enabled:
            return
        self._emit({"ph": "b", "name": name, "id": flow_id, "cat": cat,
                    "ts": self.now() if ts is None else ts,
                    "track": track or self.current_track(), "args": args})

    def async_end(self, name: str, flow_id: int, cat: str = "flow",
                  ts: Optional[float] = None, track: Optional[str] = None,
                  **args) -> None:
        if not self.enabled:
            return
        self._emit({"ph": "e", "name": name, "id": flow_id, "cat": cat,
                    "ts": self.now() if ts is None else ts,
                    "track": track or self.current_track(), "args": args})

    # -- access ----------------------------------------------------------
    def events(self) -> List[Dict[str, Any]]:
        return list(self._events)

    def __len__(self) -> int:
        return len(self._events)

    def clear(self) -> None:
        self._events.clear()
