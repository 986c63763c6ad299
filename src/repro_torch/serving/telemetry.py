"""Serving telemetry: the SLO numbers the front door reports. The port of
``repro/serving/telemetry.py``, metric names and labels unchanged.

Collects per-request outcomes (:class:`~repro_torch.serving.api.
GenerationResult` carries TTFT and end-to-end latency measured on the
submitter's clock) and engine counters, and reduces them to the numbers
an operator actually pages on:

- **p50/p99 TTFT** — time to first token, the interactive SLO;
- **p50/p99 latency** — end-to-end completion time;
- **tokens/s/slot** — decoded tokens per second per decode slot, the
  serving-efficiency headline (decode wall time is approximated by the
  window between the first and last recorded completion);
- admission-control outcomes (rejections by reason, expirations).

``ServeTelemetry`` is a thin view over the unified metrics registry
(:mod:`repro_torch.obs`): every ``record`` also feeds registry counters and
bounded histograms, so ``/metrics`` Prometheus scrapes and the JSON
snapshot come from one pipeline. Percentiles use the nearest-rank
method over a **bounded seeded reservoir** (uniform sample, Algorithm
R) rather than an unbounded list — a long-lived front door holds O(1)
memory per SLO series, and the seeded sampling keeps test percentiles
deterministic. No numpy dependency on the hot path.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

from repro_torch import obs
from repro_torch.obs import MetricsRegistry, Reservoir
from repro_torch.serving.api import GenerationResult

# Reservoir capacity per SLO series. Nearest-rank p99 over a 4096-sample
# uniform reservoir is exact until 4096 requests and a tight estimate
# after; the serving benchmarks record far fewer, so their percentiles
# are bit-identical to the unbounded-list behavior.
RESERVOIR_CAPACITY = 4096

# Latency-shaped buckets for the registry histograms (seconds).
_LAT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 15.0, 60.0)


def percentile(values: Iterable[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of ``values``; NaN when
    empty or all-NaN. Deterministic and exact for the small samples
    serving benchmarks collect — no interpolation surprises across
    numpy versions. ``q=0`` is the minimum, ``q=100`` the maximum."""
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q={q} outside [0, 100]")
    vals = sorted(v for v in values if not math.isnan(v))
    if not vals:
        return float("nan")
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[min(rank, len(vals)) - 1]


class ServeTelemetry:
    """Accumulates per-request outcomes into SLO summary statistics.

    ``registry`` defaults to the process-wide ``obs.metrics``; pass a
    private :class:`MetricsRegistry` to isolate (tests, benchmarks).
    """

    def __init__(self, num_slots: int, *,
                 registry: Optional[MetricsRegistry] = None,
                 reservoir_capacity: int = RESERVOIR_CAPACITY,
                 seed: int = 0) -> None:
        self.num_slots = num_slots
        self.reservoir_capacity = reservoir_capacity
        self.seed = seed
        reg = registry if registry is not None else obs.metrics
        self._m_completed = reg.counter(
            "serve_requests_completed_total", "requests run to completion")
        self._m_expired = reg.counter(
            "serve_requests_expired_total", "requests expired past deadline")
        self._m_tokens = reg.counter(
            "serve_tokens_out_total", "completion tokens decoded")
        self._m_prompt = reg.counter(
            "serve_prompt_tokens_total", "prompt tokens admitted")
        self._m_prefix_hit = reg.counter(
            "serve_prefix_hit_tokens_total",
            "prompt tokens served from the shared-prefix cache")
        self._h_ttft = reg.histogram(
            "serve_ttft_seconds", "time to first token",
            buckets=_LAT_BUCKETS)
        self._h_latency = reg.histogram(
            "serve_latency_seconds", "end-to-end request latency",
            buckets=_LAT_BUCKETS)
        self.reset()

    def reset(self) -> None:
        self.ttfts = Reservoir(self.reservoir_capacity, seed=self.seed)
        self.latencies = Reservoir(self.reservoir_capacity,
                                   seed=self.seed + 1)
        self.tokens_out = 0
        self.prefix_hit_tokens = 0
        self.prompt_tokens = 0
        self.completed = 0
        self.expired = 0
        self._t_first: Optional[float] = None
        self._t_last: Optional[float] = None

    def record(self, res: GenerationResult,
               done_s: Optional[float] = None) -> None:
        if res.finish_reason == "expired":
            self.expired += 1
            self._m_expired.inc()
            return
        self.completed += 1
        self.tokens_out += res.gen_count
        self.prompt_tokens += res.prompt_len
        self.prefix_hit_tokens += res.prefix_hit_tokens
        self.ttfts.append(res.ttft_s)
        self.latencies.append(res.latency_s)
        self._m_completed.inc()
        self._m_tokens.inc(res.gen_count)
        self._m_prompt.inc(res.prompt_len)
        self._m_prefix_hit.inc(res.prefix_hit_tokens)
        self._h_ttft.observe(res.ttft_s)
        self._h_latency.observe(res.latency_s)
        if done_s is not None:
            if self._t_first is None:
                self._t_first = done_s
            self._t_last = done_s

    @property
    def span_s(self) -> float:
        """Wall span between the first and last recorded completion."""
        if self._t_first is None or self._t_last is None \
                or self._t_last <= self._t_first:
            return float("nan")
        return self._t_last - self._t_first

    def snapshot(self) -> Dict[str, float]:
        span = self.span_s
        tput = float("nan") if math.isnan(span) else self.tokens_out / span
        return {
            "completed": self.completed,
            "expired": self.expired,
            "tokens_out": self.tokens_out,
            "prompt_tokens": self.prompt_tokens,
            "prefix_hit_tokens": self.prefix_hit_tokens,
            "ttft_p50_s": percentile(self.ttfts, 50),
            "ttft_p99_s": percentile(self.ttfts, 99),
            "latency_p50_s": percentile(self.latencies, 50),
            "latency_p99_s": percentile(self.latencies, 99),
            "tokens_per_s": tput,
            "tokens_per_s_per_slot": (tput / self.num_slots
                                      if not math.isnan(tput)
                                      else float("nan")),
        }
