"""Fit-quality metrics: parameter recovery and tuning-curve distribution
distances.

The port's own copy of :mod:`tcgan_tpu.analysis.metrics` (NumPy only; the
JAX package cannot be imported where JAX is absent).

Reference parity: the analyzers' parameter-recovery and TC-distribution
comparisons (SURVEY.md §2 "Analyzers / loaders"); the W1 (Wasserstein-1)
parity metric is the benchmark gate named in BASELINE.md.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def param_recovery_error(fitted: Dict[str, np.ndarray],
                         true: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Relative Frobenius error per parameter block (J, D, S)."""
    out = {}
    for name in fitted:
        f = np.asarray(fitted[name], dtype=np.float64)
        t = np.asarray(true[name], dtype=np.float64)
        out[name] = float(np.linalg.norm(f - t) / (np.linalg.norm(t) + 1e-12))
    return out


def w1_per_feature(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-feature 1-D Wasserstein-1 distance between two sample sets
    (n_a, D) and (n_b, D), via the quantile-function integral."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    n = max(a.shape[0], b.shape[0])
    qs = (np.arange(n) + 0.5) / n
    qa = np.quantile(a, qs, axis=0)
    qb = np.quantile(b, qs, axis=0)
    return np.abs(qa - qb).mean(axis=0)


def tc_w1(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-feature W1 between tuning-curve sample distributions — the
    'tuning-curve W1 parity' number of BASELINE.md."""
    return float(w1_per_feature(a, b).mean())


def sliced_w1(a: np.ndarray, b: np.ndarray, n_proj: int = 64,
              seed: int = 0) -> float:
    """Sliced Wasserstein-1: W1 averaged over random 1-D projections —
    sensitive to joint structure that per-feature W1 misses."""
    rng = np.random.default_rng(seed)
    d = a.shape[1]
    proj = rng.normal(size=(d, n_proj))
    proj /= np.linalg.norm(proj, axis=0, keepdims=True)
    return float(w1_per_feature(a @ proj, b @ proj).mean())
