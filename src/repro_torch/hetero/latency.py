"""Network-latency models (App. E.1): the port's own copy of
``repro/hetero/latency.py`` (numpy only). The same generator state gives
the same delays, bit for bit.

The paper simulates WAN delays with log-normal (default), Weibull and
exponential distributions, bounded to [60 s, 1800 s]; the default median
delay is 60 s. Weibull is reported as the most challenging (Table 7).
"""
from __future__ import annotations

import numpy as np

from repro_torch.config import HeteroConfig
from repro_torch.transport.link import serialization_seconds

DISTRIBUTIONS = ("lognormal", "weibull", "exponential", "constant")


def sample_delay(rng: np.random.Generator, hcfg: HeteroConfig) -> float:
    """One model-sync delay D_M in (simulated) seconds."""
    med = hcfg.delay_median_s
    dist = hcfg.delay_distribution
    if dist == "lognormal":
        # sigma chosen so the 99.5% CI spans ~[lo, hi] around the median
        sigma = float(np.log(hcfg.delay_max_s / max(med, 1e-9))) / 2.807
        d = rng.lognormal(mean=np.log(med), sigma=max(sigma, 1e-3))
    elif dist == "weibull":
        k = 1.2                                    # heavy-ish tail
        lam = med / np.log(2.0) ** (1.0 / k)       # median-matched scale
        d = lam * rng.weibull(k)
    elif dist == "exponential":
        d = rng.exponential(med / np.log(2.0))     # median-matched
    elif dist == "constant":
        d = med
    else:
        raise ValueError(f"unknown delay distribution {dist!r}")
    return float(np.clip(d, hcfg.delay_min_s, hcfg.delay_max_s))


def sync_delay_s(rng: np.random.Generator, hcfg: HeteroConfig,
                 payload_bytes: int = 0) -> float:
    """Payload-aware model-sync delay: sampled propagation (D_M as above,
    clipped) plus ``payload_bytes / bandwidth`` serialization time. With
    ``bandwidth_mbps=inf`` (the default) or zero payload this is exactly
    ``sample_delay`` (the same rng draw)."""
    base = sample_delay(rng, hcfg)
    if payload_bytes <= 0:
        return base
    return base + serialization_seconds(payload_bytes, hcfg.bandwidth_mbps)
