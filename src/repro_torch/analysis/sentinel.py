"""Launch-shape sentinel: the port of ``repro/analysis/sentinel.py``.

The JAX package counts XLA backend compiles, so that tests and the
front door can hold the continuous engine to its promise of O(log)
executables: the block tables are narrowed to pow2 widths
(``_live_width``), so a steady run compiles nothing new. Eager torch
compiles nothing, so the port counts what a compile stands for: the
first launch in the process of a new shape signature of a kernel route.
A signature is the kernel, its route ("kernel": the Hopper kernel;
"twin": its plain PyTorch version; "gather": the paged dense view;
"naive") and the shapes a jit would key on: batch rows, chunk or verify
width, and block-table width (``record_launch``, called at every
dispatch of ``kernels.ops``, on the kernel and the twin route alike, so
a CPU run counts what a card run counts).

Usage::

    with RecompileSentinel() as s:
        engine.step(); engine.step()
    s.assert_bound(bound)

Sentinels nest: each one open sees the new signatures recorded while it
is. ``install_metrics_listener()`` feeds two counters of ``obs.metrics``
for the process's lifetime (the front door installs it):
``kernel_launch_shapes_total`` (new signatures, in the place of the
reference's ``xla_compiles_total``) and ``kernel_launches_total`` (every
dispatch), each labelled with the kernel and the route.

The bound functions are the reference's, as they are.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Set, Tuple

from repro_torch import obs

_seen: Set[Tuple] = set()
_active: List["RecompileSentinel"] = []
_lock = threading.Lock()
_feeding = False
# (kernel, route) -> its (launches, new shapes) counters, bound once
_handles: Dict[Tuple[str, str], Tuple[obs.Counter, obs.Counter]] = {}


def _counters(kernel: str, route: str) -> Tuple[obs.Counter, obs.Counter]:
    h = _handles.get((kernel, route))
    if h is None:
        h = _handles[(kernel, route)] = (
            obs.metrics.counter("kernel_launches_total",
                                "kernel dispatches (kernel or twin route)",
                                kernel=kernel, route=route),
            obs.metrics.counter(
                "kernel_launch_shapes_total",
                "first launches of a new shape signature (the eager "
                "stand-in for an XLA compile)", kernel=kernel, route=route))
    return h


def record_launch(kernel: str, route: str, *shape: int) -> None:
    """One dispatch of ``kernel`` by ``route`` at ``shape`` (the dims a
    jit keys on). The first of its signature in the process is a new
    launch shape for every open sentinel."""
    sig = (kernel, route) + tuple(int(d) for d in shape)
    with _lock:
        new = sig not in _seen
        if new:
            _seen.add(sig)
            for s in _active:
                s._record(sig)
    if _feeding:
        launches, shapes = _counters(kernel, route)
        launches.inc()
        if new:
            shapes.inc()


def install_metrics_listener() -> None:
    """Start counting launches and new launch shapes into the unified
    registry without opening a sentinel: long-lived processes (the
    serving front door) call this once, so both series are live for
    their whole lifetime."""
    global _feeding
    _feeding = True


class RecompileSentinel:
    """Context manager counting new launch shapes while open."""

    def __init__(self, label: str = "") -> None:
        self.label = label
        self.compiles = 0
        self.events: List[Tuple] = []

    def _record(self, sig: Tuple) -> None:      # under the module lock
        self.compiles += 1
        self.events.append(sig)

    def __enter__(self) -> RecompileSentinel:
        with _lock:
            _active.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _lock:
            if self in _active:
                _active.remove(self)

    def assert_bound(self, bound: int, context: str = "") -> None:
        if self.compiles > bound:
            where = f" [{context or self.label}]" if (context or self.label) \
                else ""
            raise AssertionError(
                f"recompile sentinel{where}: {self.compiles} new launch "
                f"shapes observed, bound is {bound}")


def pow2_bucket_count(max_pages: int) -> int:
    """Number of distinct block-table widths the engine's pow2 bucketing
    (``_live_width`` in sampling/continuous.py) can produce for a cap of
    ``max_pages`` pages: widths are min(next_pow2(need), cap) for need in
    1..cap."""
    widths = set()
    for need in range(1, max_pages + 1):
        w = 1
        while w < need:
            w *= 2
        widths.add(min(w, max_pages))
    return len(widths)


def executable_bound(max_pages: int, phases: int = 3, slack: int = 4) -> int:
    """Conservative bound for a steady engine run: ``phases`` shape
    families (prefill chunk / decode chunk / page copy), each over the
    pow2 width buckets, plus ``slack`` for one-off helpers."""
    return phases * pow2_bucket_count(max_pages) + slack


def spec_verify_width_buckets(spec_k: int) -> int:
    """Distinct verify widths speculative decoding can request: 1 pending
    token plus 0..spec_k drafts, through the pow2 rounding of
    ``_live_width`` with a floor of 2 (``sampling.spec.
    verify_width_buckets``)."""
    widths = set()
    for k in range(spec_k + 1):
        need = 1 + k
        w = 1
        while w < need:
            w *= 2
        widths.add(max(2, min(w, spec_k + 1)))
    return len(widths)


def spec_verify_executable_bound(spec_k: int, max_pages: int) -> int:
    """Ceiling on the spec engine's round shapes: verify chunks key on
    (verify width bucket, table width bucket), and no-draft fallback
    decode chunks add one more family over the table-width buckets.
    Per-round acceptance lengths change neither key."""
    if spec_k <= 0:
        return 0
    return ((spec_verify_width_buckets(spec_k) + 1)
            * pow2_bucket_count(max_pages))


def prefill_executable_bound(prefill_chunk: int, max_pages: int) -> int:
    """Ceiling on prefill-chunk shapes, keyed by (chunk width, table width
    bucket): the configured ``prefill_chunk`` and every shorter final
    tail, at most ``prefill_chunk`` widths, times the table buckets
    (None/0, whole-prompt prefill, counts one width)."""
    return (prefill_chunk or 1) * pow2_bucket_count(max_pages)


__all__ = ["RecompileSentinel", "pow2_bucket_count", "executable_bound",
           "prefill_executable_bound", "spec_verify_width_buckets",
           "spec_verify_executable_bound", "install_metrics_listener",
           "record_launch"]
