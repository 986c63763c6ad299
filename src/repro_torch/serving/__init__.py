"""SLO serving front door for the generation engines: the port of
``repro.serving``.

- :mod:`repro_torch.serving.api` — the request-level vocabulary
  (``SamplingParams`` / ``Request`` / ``GenerationResult`` /
  ``TokenEvent`` / ``Engine``);
- :mod:`repro_torch.serving.admission` — admission control against the
  real KV page budget (feasibility, queue caps, deadline triage);
- :mod:`repro_torch.serving.telemetry` — p50/p99 TTFT, per-slot
  throughput;
- :mod:`repro_torch.serving.server` — the asyncio HTTP/websocket front
  door (imported lazily: it pulls in the engines, which import this
  package's ``api`` module).
"""
from repro_torch.serving.admission import (EXPIRED, INFEASIBLE, OK,
                                           OVERLOADED, QUEUE_FULL,
                                           AdmissionController,
                                           AdmissionDecision)
from repro_torch.serving.api import (Engine, GenerationResult, Request,
                                     SamplingParams, TokenEvent)
from repro_torch.serving.telemetry import ServeTelemetry

__all__ = ["SamplingParams", "Request", "GenerationResult", "TokenEvent",
           "Engine", "AdmissionController", "AdmissionDecision", "ServeTelemetry",
           "OK", "INFEASIBLE", "EXPIRED", "QUEUE_FULL", "OVERLOADED"]
