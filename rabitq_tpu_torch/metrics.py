"""Global query-pipeline counters (port of rabitq_tpu.metrics).

``rough`` (estimator evaluations), ``precise`` (exact rerank distances),
``query`` (queries served) and ``miss`` (vector-store cache misses: blocks
fetched from a store's source). The rough/precise ratio is the
pruning-effectiveness probe of the service's ``GET /metrics``.
"""

from __future__ import annotations

import threading

import torch


class Metrics:
    __slots__ = ("_lock", "rough", "precise", "query", "miss")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.rough = 0
        self.precise = 0
        self.query = 0
        self.miss = 0

    def add_rough_count(self, n: int = 1) -> None:
        with self._lock:
            self.rough += int(n)

    def add_precise_count(self, n: int = 1) -> None:
        with self._lock:
            self.precise += int(n)

    def add_query_count(self, n: int = 1) -> None:
        with self._lock:
            self.query += int(n)

    def add_miss_count(self, n: int = 1) -> None:
        with self._lock:
            self.miss += int(n)

    def reset(self) -> None:
        with self._lock:
            self.rough = self.precise = self.query = self.miss = 0

    def to_str(self) -> str:
        # The JAX package's wording, word for word, so /metrics scrapers
        # can switch between the two implementations unchanged.
        with self._lock:
            ratio = (self.rough / self.precise) if self.precise else 0.0
            return (
                f"query: {self.query}, "
                f"rough: {self.rough}, precise: {self.precise}, "
                f"ratio: {ratio:.2f}, cache miss: {self.miss}"
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
