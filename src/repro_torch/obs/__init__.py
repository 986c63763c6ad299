"""repro_torch.obs — the unified tracing + metrics spine: the port's own
copy of ``repro.obs`` (pure Python), the same vocabulary and output
formats.

One registry, one tracer, one trace format across the learner, sampler
nodes, the continuous engine, the weight transport, and the serving
front door. Everything is **disabled by default** and contractually
zero-cost until :func:`configure` turns it on:

    from repro_torch import obs
    obs.configure()                      # wall clock (serving, threads)
    obs.configure(sim=runtime.sim)       # EventSim virtual clock (hetero)
    ...
    obs.export_chrome_trace("trace.json")    # load in ui.perfetto.dev
    print(obs.metrics.prometheus_text())     # or scrape GET /metrics

``obs.metrics`` is the module-level :class:`MetricsRegistry` (counters /
gauges / bounded histograms; Prometheus text exposition); ``obs.trace``
is the module-level :class:`Tracer` (``with obs.trace.span("prefill",
slot=3): ...``). Instrumented call sites bind handles once and hold
them forever; enabling/disabling flips live behavior in place.
"""
from __future__ import annotations

from typing import Any, Optional

from repro_torch.obs.export import (chrome_trace, validate_chrome_trace,
                                    write_chrome_trace, write_jsonl)
from repro_torch.obs.registry import (DEFAULT_BUCKETS, Counter, Gauge,
                                      Histogram, MetricsRegistry, Reservoir)
from repro_torch.obs.trace import Span, Tracer

# The process-wide default surfaces. Disabled at import: every mutator's
# first statement is an `enabled` check, so un-configured runs pay one
# attribute read + branch per instrumented call site.
metrics = MetricsRegistry(enabled=False)
trace = Tracer(enabled=False)


def enabled() -> bool:
    return metrics.enabled or trace.enabled


def configure(on: bool = True, *, sim: Optional[Any] = None,
              clear: bool = False) -> None:
    """Flip the default registry + tracer on (or off).

    ``sim`` points the tracer's clock at a discrete-event simulator's
    virtual ``now`` (hetero EventSim runs); omitted, the clock resets to
    the monotonic wall clock. ``clear`` drops previously recorded
    metrics/events first (benchmark A/B hygiene).
    """
    if clear:
        metrics.clear()
        trace.clear()
    metrics.enabled = on
    trace.enabled = on
    if sim is not None:
        trace.use_sim(sim)
    else:
        trace.use_wall_clock()


def export_chrome_trace(path: str, process_name: str = "repro") -> int:
    """Write the default tracer's events as Perfetto-loadable JSON;
    returns the event count."""
    return write_chrome_trace(trace, path, process_name)


def export_jsonl(path: str) -> int:
    return write_jsonl(trace, path)


__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "Reservoir",
    "Span", "Tracer", "DEFAULT_BUCKETS",
    "chrome_trace", "write_chrome_trace", "write_jsonl",
    "validate_chrome_trace",
    "metrics", "trace", "configure", "enabled",
    "export_chrome_trace", "export_jsonl",
]
