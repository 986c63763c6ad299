"""Request-level serving API: the one vocabulary every engine speaks.

The port of ``repro/serving/api.py``, with the same validation:

- :class:`SamplingParams` — *how* to sample (temperature/top-k/top-p,
  token budget), validated at construction so meaningless combinations
  fail loudly instead of being silently dropped;
- :class:`Request` — *what* to generate (prompt tokens) plus its SLO
  envelope (priority class, absolute deadline, arrival time);
- :class:`GenerationResult` — the per-request outcome (tokens, engine
  log-probs as App. B.1 metadata, finish reason, latency telemetry);
- :class:`Engine` — the protocol both engines implement.

Engine *capacity* knobs (slots, page size, decode horizon, pool size)
live in ``repro_torch.config.ServeConfig``, not here: sampling parameters
describe a request, serve config describes a deployment.

``TokenEvent`` is the streaming unit the continuous engine emits per
scheduler sync — the asyncio front door (``repro_torch.serving.server``)
fans these out to HTTP/websocket subscribers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Optional, Protocol, Sequence, runtime_checkable

import numpy as np

from repro_torch.config import RLConfig


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling settings.

    Validation raises on out-of-range or conflicting values (the old
    ``generate`` dropped them on the floor): ``temperature < 0``,
    ``top_k < 0``, ``top_p`` outside ``(0, 1]``, a non-positive token
    budget, and greedy/filter conflicts (``temperature == 0`` with
    ``top_k``/``top_p`` filtering — the filters would select from a
    distribution the zero temperature then ignores).
    """
    temperature: float = 0.6
    top_k: int = 20
    top_p: float = 0.95
    max_new_tokens: int = 32
    # opt this request in to speculative decode (an engine with spec_k >
    # 0); not part of ``profile``: speculation never changes
    # the distribution a request samples from
    spec: bool = True

    def __post_init__(self) -> None:
        if not math.isfinite(self.temperature) or self.temperature < 0:
            raise ValueError(f"temperature={self.temperature} must be a "
                             "finite value >= 0")
        if self.top_k < 0:
            raise ValueError(f"top_k={self.top_k} must be >= 0 (0 = off)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p={self.top_p} outside (0, 1]")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens={self.max_new_tokens} < 1")
        if self.temperature == 0.0 and (self.top_k > 0 or self.top_p < 1.0):
            raise ValueError(
                "temperature=0 (greedy) conflicts with top_k/top_p "
                "filtering — drop the filters or use temperature > 0")

    @property
    def profile(self) -> tuple:
        """The (temperature, top_k, top_p) triple one engine serves.
        Requests sharing an engine must share it; ``max_new_tokens`` is
        per-request."""
        return (self.temperature, self.top_k, self.top_p)

    @classmethod
    def from_rl(cls, rl: RLConfig,
                max_new: Optional[int] = None) -> SamplingParams:
        return cls(temperature=rl.temperature, top_k=rl.top_k,
                   top_p=rl.top_p,
                   max_new_tokens=max_new or rl.max_new_tokens)

    def rl(self, base: Optional[RLConfig] = None) -> RLConfig:
        """An RLConfig carrying this profile (the engines' sampling
        argument)."""
        base = base or RLConfig()
        return dataclasses.replace(base, temperature=self.temperature,
                                   top_k=self.top_k, top_p=self.top_p,
                                   max_new_tokens=self.max_new_tokens)


@dataclasses.dataclass
class Request:
    """One generation request. ``rid`` is the identity *and* the RNG
    stream: token draws use ``fold_in(fold_in(key, rid), t)``, so the
    same (key, rid) yields the same completion on any engine, any slot.
    ``deadline_s`` is an absolute clock value (same clock as
    ``arrival_s``): a request still queued past it is expired, never
    one that is already decoding."""
    rid: int
    prompt: np.ndarray
    params: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    priority: int = 1
    deadline_s: Optional[float] = None
    arrival_s: float = 0.0

    def __post_init__(self) -> None:
        self.prompt = np.asarray(self.prompt, np.int32)
        if self.prompt.ndim != 1 or self.prompt.shape[0] < 1:
            raise ValueError("prompt must be a non-empty 1-D token array, "
                             f"got shape {self.prompt.shape}")
        if self.priority < 0:
            raise ValueError(f"priority={self.priority} must be >= 0")
        if self.deadline_s is not None and self.deadline_s <= self.arrival_s:
            raise ValueError(f"deadline_s={self.deadline_s} not after "
                             f"arrival_s={self.arrival_s}")

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])


@dataclasses.dataclass(frozen=True)
class TokenEvent:
    """One streamed token (or terminal event) of a request."""
    rid: int
    token: int                   # PAD on a tokenless terminal event
    logp: float
    index: int                   # 0-based position in the completion
    finished: bool = False
    finish_reason: str = ""      # set when finished


@dataclasses.dataclass
class GenerationResult:
    """Per-request outcome. ``logps`` are engine-side *metadata* (the
    learner recomputes by default, App. B.1). ``ttft_s``/``latency_s``
    are measured against ``Request.arrival_s`` on the submitter's
    clock; ``prefix_hit_tokens`` counts prompt tokens served from the
    shared-prefix cache instead of being prefilled."""
    rid: int
    tokens: np.ndarray           # (n,) int32 completion (includes EOS)
    logps: np.ndarray            # (n,) float32
    finish_reason: str           # "eos" | "length" | "expired"
    prompt_len: int
    prefix_hit_tokens: int = 0
    ttft_s: float = float("nan")
    latency_s: float = float("nan")

    @property
    def gen_count(self) -> int:
        return int(self.tokens.shape[0])


@runtime_checkable
class Engine(Protocol):
    """What every generation engine offers the serving layer. Static and
    continuous engines both implement it; the continuous engine
    additionally offers the incremental ``submit()``/``step()`` surface
    the asyncio front door streams from."""

    def generate(self, requests: Sequence[Request],
                 key: Optional[Any] = None) -> List[GenerationResult]:
        """Run ``requests`` to completion, results in request order."""
        ...

    def update_params(self, params: Any) -> None:
        """Swap in new model parameters (sampler weight sync)."""
        ...
