"""Simulated WAN link: bytes cost time. The port's own copy of
``repro/transport/link.py``.

A transfer charges ``payload_bytes / bandwidth`` simulated seconds; the
propagation term stays with ``hetero.latency.sample_delay``'s
distributions, and ``hetero.latency.sync_delay_s`` composes the two.
``bandwidth_mbps=inf`` (the default everywhere) makes every transfer
free.

The link can also drop mid-transfer (``drop_after_bytes`` one-shot fuse):
the exception reports how many bytes made it, so a subscriber can keep
partial progress and resume from the byte offset instead of re-paying the
whole chunk.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch import obs


class LinkDropped(Exception):
    """The link died mid-transfer; ``bytes_delivered`` made it across."""

    def __init__(self, bytes_delivered: int) -> None:
        super().__init__(f"link dropped after {bytes_delivered} bytes")
        self.bytes_delivered = int(bytes_delivered)


class SyncInterrupted(RuntimeError):
    """A sync aborted on a dropped link. Partial progress is retained by
    the subscriber; the next attempt resumes from the byte offset."""


def serialization_seconds(nbytes: int, bandwidth_mbps: float) -> float:
    """The one bytes→seconds formula (``nbytes / bandwidth``) shared by
    the link telemetry and the event-sim delay model
    (``hetero.latency.sync_delay_s``) — they must never disagree."""
    if not math.isfinite(bandwidth_mbps) or bandwidth_mbps <= 0:
        return 0.0
    return nbytes * 8.0 / (bandwidth_mbps * 1e6)


class SimulatedLink:
    """Per-sampler WAN link with byte/time/drop telemetry."""

    def __init__(self, bandwidth_mbps: float = float("inf"), *,
                 drop_after_bytes: Optional[int] = None) -> None:
        self.bandwidth_mbps = float(bandwidth_mbps)
        self.drop_after_bytes = drop_after_bytes    # one-shot fuse (tests)
        self.bytes_on_wire = 0
        self.transfers = 0
        self.drops = 0
        self.seconds = 0.0          # simulated serialization time charged

    def transfer_seconds(self, nbytes: int) -> float:
        return serialization_seconds(nbytes, self.bandwidth_mbps)

    def _charge(self, nbytes: int) -> float:
        secs = self.transfer_seconds(nbytes)
        self.bytes_on_wire += int(nbytes)
        self.transfers += 1
        self.seconds += secs
        tr = obs.trace
        if tr.enabled:
            # chunk fetches render as async flows: transfers overlap in
            # wall/sim time, so they must not nest on the caller's track
            fid = tr.next_flow_id()
            t0 = tr.now()
            tr.async_begin("chunk_transfer", fid, cat="transport", ts=t0,
                           bytes=int(nbytes))
            tr.async_end("chunk_transfer", fid, cat="transport",
                         ts=t0 + secs)
        if obs.metrics.enabled:
            obs.metrics.counter(
                "link_transfer_bytes_total",
                "bytes moved over simulated WAN links").inc(nbytes)
            obs.metrics.counter(
                "link_transfers_total", "chunk/manifest transfers").inc()
        return secs

    def transfer(self, nbytes: int) -> float:
        """Move ``nbytes``; returns the simulated seconds charged. Raises
        ``LinkDropped`` (after charging the partial bytes) when the drop
        fuse fires inside this transfer."""
        if (self.drop_after_bytes is not None
                and self.bytes_on_wire + nbytes > self.drop_after_bytes):
            delivered = max(self.drop_after_bytes - self.bytes_on_wire, 0)
            self.drop_after_bytes = None
            self.drops += 1
            if delivered:
                self._charge(delivered)
            raise LinkDropped(delivered)
        return self._charge(nbytes)
