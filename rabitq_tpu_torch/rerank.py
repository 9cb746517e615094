"""Host-side rerankers with the reference's dynamic-pruning semantics
(port of rabitq_tpu.rerank).

Search reranks a static top-R budget on the device. These host rerankers
keep the reference's data-dependent pruning: HeapReRanker prunes against
the current k-th exact distance, HeuristicReRanker against the largest
exact distance of each WINDOW_SIZE-candidate window. They run a Python
loop a candidate, for parity checks (the CLI's ``--rerank-mode heap`` and
``heuristic``), never on the search path.
"""

from __future__ import annotations

import heapq
from typing import Callable

import numpy as np

from rabitq_tpu_torch.consts import WINDOW_SIZE
from rabitq_tpu_torch.metrics import METRICS
from rabitq_tpu_torch.ord32 import f32_to_ord32, ord32_to_f32

# An accessor returns the exact squared distance between the query and the
# cluster-sorted row ``pos``.
DistanceFn = Callable[[int], float]


class HeapReRanker:
    """Max-heap of the current top-k; a candidate whose rough distance is
    not below the current k-th exact distance is pruned. Heap keys are
    ord32 integers, so comparisons follow f32 total order (NaN above
    +inf)."""

    def __init__(self, topk: int, distance_fn: DistanceFn):
        self.topk = topk
        self.distance_fn = distance_fn
        self._thresh_ord = int(f32_to_ord32(np.float32(np.inf)))
        self._heap: list[tuple[int, int]] = []  # (-ord32(dist), id)

    @property
    def threshold(self) -> float:
        return float(ord32_to_f32(np.int32(self._thresh_ord)))

    def rank_batch(self, rough: np.ndarray, pos: np.ndarray, map_ids) -> None:
        precise = 0
        rough_ord = np.asarray(f32_to_ord32(rough))
        for r, p in zip(rough_ord.tolist(), pos.tolist()):
            if r >= self._thresh_ord:
                continue
            accurate = int(f32_to_ord32(np.float32(self.distance_fn(p))))
            precise += 1
            if accurate < self._thresh_ord:
                heapq.heappush(self._heap, (-accurate, int(map_ids[p])))
                if len(self._heap) > self.topk:
                    heapq.heappop(self._heap)
                if len(self._heap) == self.topk:
                    self._thresh_ord = -self._heap[0][0]
        METRICS.add_precise_count(precise)
        METRICS.add_rough_count(len(rough))

    def get_result(self) -> list[tuple[float, int]]:
        return sorted(
            (float(ord32_to_f32(np.int32(-d))), i) for d, i in self._heap
        )


class HeuristicReRanker:
    """Unbounded list; the threshold becomes the largest exact distance of
    each WINDOW_SIZE accepted candidates; final top-k by sorting."""

    def __init__(self, topk: int, distance_fn: DistanceFn):
        self.topk = topk
        self.distance_fn = distance_fn
        self.threshold = np.inf
        self.recent_max = -np.inf
        self.count = 0
        self._arr: list[tuple[float, int]] = []

    def rank_batch(self, rough: np.ndarray, pos: np.ndarray, map_ids) -> None:
        precise = 0
        for r, p in zip(rough.tolist(), pos.tolist()):
            if r >= self.threshold:
                continue
            accurate = float(self.distance_fn(p))
            precise += 1
            if accurate < self.threshold:
                self._arr.append((accurate, int(map_ids[p])))
                self.count += 1
                self.recent_max = max(self.recent_max, accurate)
                if self.count >= WINDOW_SIZE:
                    self.threshold = self.recent_max
                    self.count = 0
                    self.recent_max = -np.inf
        METRICS.add_precise_count(precise)
        METRICS.add_rough_count(len(rough))

    def get_result(self) -> list[tuple[float, int]]:
        return sorted(self._arr)[: self.topk]


def new_re_ranker(topk: int, distance_fn: DistanceFn, heuristic: bool = False):
    """HeuristicReRanker if ``heuristic``, else HeapReRanker."""
    return (
        HeuristicReRanker(topk, distance_fn)
        if heuristic
        else HeapReRanker(topk, distance_fn)
    )
