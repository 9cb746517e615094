"""Global query-pipeline counters (port of rabitq_tpu.metrics).

``rough`` (estimator evaluations), ``precise`` (exact rerank distances)
and ``query`` (queries served, counted by the CLI). The rough/precise
ratio is the pruning-effectiveness probe.
"""

from __future__ import annotations

import threading

import torch


class Metrics:
    __slots__ = ("_lock", "rough", "precise", "query")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.rough = 0
        self.precise = 0
        self.query = 0

    def add_rough_count(self, n: int = 1) -> None:
        with self._lock:
            self.rough += int(n)

    def add_precise_count(self, n: int = 1) -> None:
        with self._lock:
            self.precise += int(n)

    def add_query_count(self, n: int = 1) -> None:
        with self._lock:
            self.query += int(n)

    def reset(self) -> None:
        with self._lock:
            self.rough = self.precise = self.query = 0

    def to_str(self) -> str:
        with self._lock:
            ratio = (self.rough / self.precise) if self.precise else 0.0
            return (
                f"query: {self.query}, rough: {self.rough}, "
                f"precise: {self.precise}, ratio: {ratio:.2f}"
            )


METRICS = Metrics()


def record_search_stats(stats, valid: int | None = None) -> None:
    """Add a SearchStats (tensors [B]) into the global METRICS, counting
    only its first ``valid`` queries (a batch padded to its size). Sums
    run in int64."""
    METRICS.add_rough_count(int(stats.rough[:valid].sum(dtype=torch.int64)))
    METRICS.add_precise_count(
        int(stats.precise[:valid].sum(dtype=torch.int64))
    )
