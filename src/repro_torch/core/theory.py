"""Analytic machinery for Theorems 1-3 (App. A): exact variance of the
standard and group-expectation importance weights over discrete
distributions, the KL/chi^2 bounds, and the bias bound, for the
property-based tests and the Fig. 2 benchmark.

The port's numpy-only copy of ``repro/core/theory.py``: the same
functions on the same float64 arithmetic, so each gives the JAX
package's value bit for bit. Nothing of the port's main path calls it.

Population form (App. A): E_q[q] := sum_i q_i^2 (= ||q||_2^2).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _norm(p: np.ndarray) -> np.ndarray:
    p = np.asarray(p, np.float64)
    return p / p.sum()


def kl(p: np.ndarray, q: np.ndarray) -> float:
    p, q = _norm(p), _norm(q)
    return float(np.sum(p * (np.log(p) - np.log(q))))


def chi2(p: np.ndarray, q: np.ndarray) -> float:
    p, q = _norm(p), _norm(q)
    return float(np.sum(p * p / q) - 1.0)


def var_std(p: np.ndarray, q: np.ndarray) -> float:
    """Var_q[p/q] = Σ p²/q − 1   (eq. 10)."""
    p, q = _norm(p), _norm(q)
    return float(np.sum(p * p / q) - 1.0)


def var_new(p: np.ndarray, q: np.ndarray) -> float:
    """Var_q[p/Ê_q[q]] (eq. 14) with Ê_q[q] = Σ q²."""
    p, q = _norm(p), _norm(q)
    eq = np.sum(q * q)
    i2 = np.sum(p * p * q)
    b = np.sum(p * q)
    return float((i2 - b * b) / (eq * eq))


def theorem1_terms(p: np.ndarray, q: np.ndarray) -> Tuple[float, float, float]:
    """Returns (Δ = Var_std − Var_new, exp(KL), C = n²+1): Theorem 1 states
    Δ ≥ exp(KL) − C."""
    p, q = _norm(p), _norm(q)
    n = p.shape[0]
    delta = var_std(p, q) - var_new(p, q)
    return delta, float(np.exp(kl(p, q))), float(n * n + 1)


def bias_gepo(p: np.ndarray, q: np.ndarray, a: np.ndarray) -> float:
    """|E_p[A] − E_q[(p/Ê_q[q])·A]| with E_p[A] = 0 enforced by centering
    (Theorem 2 setting)."""
    p, q = _norm(p), _norm(q)
    a = np.asarray(a, np.float64)
    a = a - np.sum(p * a)                      # center so E_p[A] = 0
    a = a / max(np.abs(a).max(), 1e-12)        # |A| <= 1
    eq = np.sum(q * q)
    return float(abs(np.sum(p * q * a) / eq))


def bias_bound(p: np.ndarray, q: np.ndarray) -> float:
    """‖p‖₂ / ‖q‖₂ (Theorem 2)."""
    p, q = _norm(p), _norm(q)
    return float(np.linalg.norm(p) / np.linalg.norm(q))


# --------------------------------------------------------------------------
# Fig. 2 closed forms / quadrature


def bernoulli_vars(a: float, b: float) -> Tuple[float, float]:
    """p ~ Bernoulli(a), q ~ Bernoulli(b): (Var_std, Var_new)."""
    p = np.array([1 - a, a])
    q = np.array([1 - b, b])
    return var_std(p, q), var_new(p, q)


def gaussian_vars(a: float, b: float, num: int = 20001,
                  span: float = 12.0) -> Tuple[float, float, float]:
    """p ~ N(a,1), q ~ N(b,1) by quadrature: (Var_std, Var_new, KL)."""
    lo = min(a, b) - span
    hi = max(a, b) + span
    y = np.linspace(lo, hi, num)
    dy = y[1] - y[0]

    def pdf(m):
        return np.exp(-0.5 * (y - m) ** 2) / np.sqrt(2 * np.pi)

    p, q = pdf(a), pdf(b)
    eq = np.sum(q * q) * dy                    # ∫ q²
    v_std = np.sum(p * p / np.maximum(q, 1e-300)) * dy - 1.0
    i2 = np.sum(p * p * q) * dy
    ipq = np.sum(p * q) * dy
    v_new = (i2 - ipq ** 2) / eq ** 2
    kl_pq = 0.5 * (a - b) ** 2                 # exact for unit-variance
    return float(v_std), float(v_new), float(kl_pq)
