"""Metrics registry: counters, gauges, bounded histograms — one store.

The port's own copy of ``repro/obs/registry.py``. Every live telemetry
surface of the port (the learner's and samplers' counters, the hetero
sync accounting) records into one :class:`MetricsRegistry` so a single
exporter — Prometheus text exposition, or a JSON snapshot — sees the
whole system.

Design constraints, in order:

1. **Zero-cost when disabled.** The module-level default registry starts
   disabled; every mutator's first statement is an ``enabled`` check, so
   instrumented hot paths (engine ``step()``, decode chunks) pay one
   attribute read + branch per call site. Call sites bind metric handles
   once (``self._m_x = registry.counter(...)``) so the per-event cost
   never includes a name lookup.
2. **Bounded.** Histograms hold fixed bucket counts (no per-sample
   storage); label cardinality is capped per family so a bug that
   interpolates request ids into labels cannot grow without limit.
3. **Thread-safe.** Hetero sampler threads and the learner mutate
   concurrently; one registry lock guards creation and mutation (the
   rates here are per-batch / per-chunk, far below contention).

Metric identity is ``(name, sorted(labels))``; the same call always
returns the same child, so handles may be bound at construction and used
forever — enabling/disabling the registry flips live behavior without
rebinding.
"""
from __future__ import annotations

import math
import re
import threading
from typing import Dict, Iterable, List, Optional, Tuple

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")

# Prometheus-style default latency buckets (seconds), exponential-ish.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0)

MAX_CHILDREN_PER_FAMILY = 256


def _sanitize(name: str) -> str:
    return _NAME_RE.sub("_", name)


def _label_key(labels: Dict[str, object]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _fmt_labels(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in key)
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class _Metric:
    """Base child metric: holds its registry ref for the enabled check."""

    __slots__ = ("_reg", "name", "label_key")

    def __init__(self, reg: "MetricsRegistry", name: str,
                 label_key: Tuple[Tuple[str, str], ...]) -> None:
        self._reg = reg
        self.name = name
        self.label_key = label_key


class Counter(_Metric):
    """Monotonically increasing count."""

    __slots__ = ("value",)

    def __init__(self, reg, name, label_key) -> None:
        super().__init__(reg, name, label_key)
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        if v < 0:
            raise ValueError(f"counter {self.name}: negative inc {v}")
        with reg._lock:
            self.value += v


class Gauge(_Metric):
    """Point-in-time value (may go up or down)."""

    __slots__ = ("value",)

    def __init__(self, reg, name, label_key) -> None:
        super().__init__(reg, name, label_key)
        self.value = float("nan")

    def set(self, v: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            self.value = float(v)

    def add(self, v: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        with reg._lock:
            cur = self.value
            self.value = v if math.isnan(cur) else cur + v


class Histogram(_Metric):
    """Bounded histogram: fixed cumulative-bucket counts + sum + count.

    Storage is O(len(buckets)) regardless of how many samples are
    observed — the bounded contract a long-lived front door needs.
    """

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, reg, name, label_key,
                 buckets: Tuple[float, ...] = DEFAULT_BUCKETS) -> None:
        super().__init__(reg, name, label_key)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"histogram {name}: needs >= 1 bucket bound")
        self.buckets = bs
        self.counts = [0] * (len(bs) + 1)           # +1 = +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        reg = self._reg
        if not reg.enabled:
            return
        v = float(v)
        if math.isnan(v):
            return
        with reg._lock:
            i = 0
            for b in self.buckets:
                if v <= b:
                    break
                i += 1
            self.counts[i] += 1
            self.sum += v
            self.count += 1


class _Family:
    __slots__ = ("name", "kind", "help", "buckets", "children")

    def __init__(self, name: str, kind: str, help_: str,
                 buckets: Optional[Tuple[float, ...]] = None) -> None:
        self.name = name
        self.kind = kind
        self.help = help_
        self.buckets = buckets
        self.children: Dict[Tuple[Tuple[str, str], ...], _Metric] = {}


class MetricsRegistry:
    """One coherent metrics store; see module docstring for contracts."""

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    # -- creation / lookup (idempotent) --------------------------------
    def _child(self, name: str, kind: str, help_: str,
               labels: Dict[str, object],
               buckets: Optional[Tuple[float, ...]] = None) -> _Metric:
        name = _sanitize(name)
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_, buckets)
                self._families[name] = fam
            elif fam.kind != kind:
                raise ValueError(f"metric {name} already registered as "
                                 f"{fam.kind}, not {kind}")
            child = fam.children.get(key)
            if child is None:
                if len(fam.children) >= MAX_CHILDREN_PER_FAMILY:
                    raise ValueError(
                        f"metric {name}: label cardinality exceeds "
                        f"{MAX_CHILDREN_PER_FAMILY} — labels must be "
                        "bounded (no request ids)")
                if kind == "counter":
                    child = Counter(self, name, key)
                elif kind == "gauge":
                    child = Gauge(self, name, key)
                else:
                    child = Histogram(self, name, key,
                                      fam.buckets or DEFAULT_BUCKETS)
                fam.children[key] = child
            return child

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._child(name, "counter", help, labels)  # type: ignore

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._child(name, "gauge", help, labels)  # type: ignore

    def histogram(self, name: str, help: str = "",
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._child(name, "histogram", help, labels,  # type: ignore
                           buckets=buckets)

    def set_many(self, prefix: str, values: Dict[str, float],
                 **labels) -> None:
        """Fan a metrics dict (e.g. one train step's scalars) into gauges
        ``<prefix>_<key>`` — the per-step fan-in used by the learner."""
        if not self.enabled:
            return
        for k, v in values.items():
            try:
                fv = float(v)
            except (TypeError, ValueError):
                continue
            self.gauge(f"{prefix}_{k}", **labels).set(fv)

    # -- export --------------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Flat ``{name{labels}: value}`` view (JSON-friendly).
        Histograms contribute ``_sum`` and ``_count``."""
        out: Dict[str, float] = {}
        with self._lock:
            for fam in self._families.values():
                for key, m in fam.children.items():
                    lab = _fmt_labels(key)
                    if isinstance(m, Histogram):
                        out[f"{fam.name}_sum{lab}"] = m.sum
                        out[f"{fam.name}_count{lab}"] = float(m.count)
                    else:
                        out[f"{fam.name}{lab}"] = m.value  # type: ignore
        return out

    def prometheus_text(self) -> str:
        """Prometheus text exposition (format 0.0.4) of every family."""
        lines: List[str] = []
        with self._lock:
            for name in sorted(self._families):
                fam = self._families[name]
                if fam.help:
                    lines.append(f"# HELP {name} {fam.help}")
                lines.append(f"# TYPE {name} {fam.kind}")
                for key, m in sorted(fam.children.items()):
                    if isinstance(m, Histogram):
                        cum = 0
                        for b, c in zip(m.buckets,
                                        m.counts[:-1], strict=True):
                            cum += c
                            lk = _fmt_labels(key + (("le", _fmt_value(b)),))
                            lines.append(f"{name}_bucket{lk} {cum}")
                        cum += m.counts[-1]
                        lk = _fmt_labels(key + (("le", "+Inf"),))
                        lines.append(f"{name}_bucket{lk} {cum}")
                        lab = _fmt_labels(key)
                        lines.append(f"{name}_sum{lab} {_fmt_value(m.sum)}")
                        lines.append(f"{name}_count{lab} {m.count}")
                    else:
                        lab = _fmt_labels(key)
                        lines.append(
                            f"{name}{lab} {_fmt_value(m.value)}")  # type: ignore
        return "\n".join(lines) + "\n"

    def clear(self) -> None:
        """Reset every child's value **in place** — families and children
        survive, so handles bound before the clear keep recording into
        metrics the exporters can still see (the handles-bound-forever
        contract). Dropping families would silently orphan every
        already-instrumented call site."""
        with self._lock:
            for fam in self._families.values():
                for m in fam.children.values():
                    if isinstance(m, Histogram):
                        m.counts = [0] * (len(m.buckets) + 1)
                        m.sum = 0.0
                        m.count = 0
                    elif isinstance(m, Gauge):
                        m.value = float("nan")
                    else:
                        m.value = 0.0


class Reservoir:
    """Fixed-size uniform sample over an unbounded stream (Algorithm R).

    Keeps exact values below ``capacity``; beyond it, each new value
    replaces a uniformly random slot with probability ``capacity/n`` —
    nearest-rank percentiles over the sample stay unbiased, and a seeded
    RNG keeps them deterministic in tests. ``append`` aliases ``add`` so
    a Reservoir drops in for the unbounded lists it replaces.
    """

    __slots__ = ("capacity", "n", "_values", "_rng")

    def __init__(self, capacity: int = 2048, seed: int = 0) -> None:
        if capacity < 1:
            raise ValueError(f"capacity={capacity} < 1")
        import random
        self.capacity = capacity
        self.n = 0                       # total values offered
        self._values: List[float] = []
        self._rng = random.Random(seed)

    def add(self, v: float) -> None:
        self.n += 1
        if len(self._values) < self.capacity:
            self._values.append(float(v))
            return
        j = self._rng.randrange(self.n)
        if j < self.capacity:
            self._values[j] = float(v)

    append = add

    @property
    def values(self) -> List[float]:
        return list(self._values)

    def __len__(self) -> int:
        return len(self._values)

    def __iter__(self) -> Iterable[float]:
        return iter(self._values)
