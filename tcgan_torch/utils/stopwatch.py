"""Wall-clock instrumentation for per-step timing columns.

Reference parity: the StopWatch-style helper behind the reference's
``SSsolve_time`` / ``gradient_time`` learning-CSV columns (SURVEY.md §5.1).
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import Dict


class StopWatch:
    """Accumulates named wall-clock intervals; ``laps`` are per-call, and
    ``total(name)`` / ``mean(name)`` aggregate them."""

    def __init__(self):
        self._laps: Dict[str, list] = defaultdict(list)

    @contextmanager
    def time(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._laps[name].append(time.perf_counter() - t0)

    def total(self, name: str) -> float:
        return sum(self._laps.get(name, []))

    def mean(self, name: str) -> float:
        laps = self._laps.get(name, [])
        return sum(laps) / len(laps) if laps else 0.0

    def last(self, name: str) -> float:
        laps = self._laps.get(name, [])
        return laps[-1] if laps else 0.0

    def reset(self):
        self._laps.clear()
