"""Training-stability diagnostics (Fig. 4/5/7): metric history accumulation
and the correlation analysis between staleness, KL, IW variance and
estimation error. The port's own copy of ``repro/core/diagnostics.py``
(numpy only)."""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np


class MetricsHistory:
    """Append-only store of scalar metrics per learner step."""

    def __init__(self) -> None:
        self._data: Dict[str, List[float]] = defaultdict(list)

    def append(self, step: int, metrics: Dict[str, float]) -> None:
        self._data["step"].append(float(step))
        for k, v in metrics.items():
            self._data[k].append(float(v))

    def get(self, key: str) -> np.ndarray:
        return np.asarray(self._data[key], np.float64)

    def keys(self):
        return self._data.keys()

    def last(self, key: str, default: float = float("nan")) -> float:
        v = self._data.get(key)
        return v[-1] if v else default

    def summary(self, keys: Sequence[str]) -> Dict[str, float]:
        out = {}
        for k in keys:
            v = self.get(k)
            if len(v):
                out[f"{k}_mean"] = float(v.mean())
                out[f"{k}_last"] = float(v[-1])
                out[f"{k}_max"] = float(v.max())
        return out


def pearson(x: np.ndarray, y: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(x) < 2 or x.std() == 0 or y.std() == 0:
        return float("nan")
    return float(np.corrcoef(x, y)[0, 1])


def correlation_matrix(hist: MetricsHistory,
                       keys: Sequence[str]) -> Dict[Tuple[str, str], float]:
    """Pairwise Pearson correlations (Fig. 7)."""
    out = {}
    for i, a in enumerate(keys):
        for b_ in keys[i + 1:]:
            out[(a, b_)] = pearson(hist.get(a), hist.get(b_))
    return out


def best_last_gap(eval_scores: Sequence[float]) -> Tuple[float, float, float]:
    """(best, last, gap) — the paper's stability headline (Δ, Table 2)."""
    s = np.asarray(list(eval_scores), np.float64)
    if len(s) == 0:
        return float("nan"), float("nan"), float("nan")
    return float(s.max()), float(s[-1]), float(s.max() - s[-1])
