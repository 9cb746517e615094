"""Global query-pipeline counters (port of rabitq_tpu.metrics).

``rough`` (estimator evaluations) and ``precise`` (exact rerank
distances). The rough/precise ratio is the pruning-effectiveness probe.
"""

from __future__ import annotations

import threading

import torch


class Metrics:
    __slots__ = ("_lock", "rough", "precise")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.rough = 0
        self.precise = 0

    def add_rough_count(self, n: int = 1) -> None:
        with self._lock:
            self.rough += int(n)

    def add_precise_count(self, n: int = 1) -> None:
        with self._lock:
            self.precise += int(n)

    def reset(self) -> None:
        with self._lock:
            self.rough = self.precise = 0

    def to_str(self) -> str:
        with self._lock:
            ratio = (self.rough / self.precise) if self.precise else 0.0
            return (
                f"rough: {self.rough}, precise: {self.precise}, "
                f"ratio: {ratio:.2f}"
            )


METRICS = Metrics()


def record_search_stats(stats) -> None:
    """Add a SearchStats (tensors [B]) into the global METRICS. Sums run
    in int64."""
    METRICS.add_rough_count(int(stats.rough.sum(dtype=torch.int64)))
    METRICS.add_precise_count(int(stats.precise.sum(dtype=torch.int64)))
