"""The comparison that decides ``correct``.

Every answer that reached the host in a run is judged against the plain
reference (truth.py) on the benchmark's own data:

- ``miss``: 1 - recall@topk over every answered query against the exact
  top-k (the ranking, the rough scan and the selection).
- ``dist_gap``: the widest relative gap between a returned distance and
  the exact squared L2 of the returned id, summed in float64 (the rerank).
- ``dup``: ids repeated within a query's result (the dedup of a spilled
  index).
- ``bad_slots``: slots that break the result's form: an id outside
  [-1, n), an id of -1 with a finite distance or a real id with none, a
  NaN, or distances out of ascending order.

In a filtered cell the exact top-k is taken over the allowed rows alone,
so ``miss`` is judged against it, and a fifth check is added:

- ``filtered``: returned ids outside the cell's allow-list.

``dup``, ``bad_slots`` and ``filtered`` are exact (limit 0); ``miss`` and
``dist_gap`` have limits set from sound runs and the control
(``limits/<cell>.json``).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import truth

NAMES = ("miss", "dist_gap", "dup", "bad_slots")
# Relative gaps are taken against max(exact, FLOOR * median exact), so a
# query lying on a base row does not divide by ~0.
FLOOR = 1e-3
QUERY_CHUNK = 256


class Answers:
    """What the host saw of a run's batches. Batches of one pool slice
    give the same answer on every pass of a deterministic program, so the
    first answer of each slice is kept with a count of the answers equal to
    it, and every answer that differs from it is kept whole."""

    def __init__(self, n_batches: int):
        self.first = [None] * n_batches
        self.count = [0] * n_batches
        self.other = []

    def add(self, b: int, ids: np.ndarray, dists: np.ndarray) -> None:
        first = self.first[b]
        if first is None:
            self.first[b] = (ids.copy(), dists.copy())
        elif not (np.array_equal(first[0], ids)
                  and np.array_equal(first[1], dists)):
            self.other.append((b, ids.copy(), dists.copy()))
            return
        self.count[b] += 1

    def distinct(self):
        """(pool slice, ids, dists, times answered) of each distinct
        answer."""
        for b, first in enumerate(self.first):
            if first is not None:
                yield b, first[0], first[1], self.count[b]
        for b, ids, dists in self.other:
            yield b, ids, dists, 1


def _judge(base, q, ids, dists, true_ids, allow):
    """Per query of one answer: (hits, widest relative gap, duplicates,
    bad slots, ids outside ``allow`` [n] bool, or None), each [B]."""
    n = base.shape[0]
    fin = torch.isfinite(dists)
    bad = ((ids < -1) | (ids >= n) | ((ids >= 0) != fin)
           | torch.isnan(dists)).sum(1)
    bad += (dists[:, 1:] < dists[:, :-1]).sum(1)
    srt = torch.sort(ids, dim=1).values
    dup = ((srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)).sum(1)
    ok = (ids >= 0) & (ids < n) & fin
    out = (None if allow is None else
           (ok & ~allow[ids.clamp(0, n - 1)]).sum(1))
    gap = torch.zeros(ids.shape[0], dtype=torch.float64, device=ids.device)
    for a in range(0, ids.shape[0], QUERY_CHUNK):
        sl = slice(a, a + QUERY_CHUNK)
        if not bool(ok[sl].any()):
            continue
        ref = truth.exact_sq_l2(base, q[sl], torch.where(ok[sl], ids[sl], -1))
        floor = FLOOR * float(torch.nanmedian(ref))
        rel = (dists[sl].double() - ref).abs() / ref.clamp(min=floor)
        gap[sl] = torch.where(ok[sl], rel, 0.0).amax(1)
    return truth.hits(ids, true_ids), gap, dup, bad, out


def compare(answers: Answers, base, batches, true_ids, topk: int,
            limits: dict, allowed=None):
    """(checks {name: {"value", "limit"}}, correct, failed queries) of a
    run's answers; ``batches`` [nb, B, dim] is the query pool as the run
    sent it, ``true_ids`` [nb * B, topk] its exact neighbours, over the
    rows of ``allowed`` (the run ids a filtered cell allows) alone where
    it is given."""
    dev = base.device
    b_size = batches.shape[1]
    allow = None
    if allowed is not None:
        allow = torch.zeros(base.shape[0], dtype=torch.bool, device=dev)
        allow[allowed] = True
    n_hits = n_slots = failed = 0
    dist_gap, dup, bad, outside = 0.0, 0, 0, 0
    for b, ids, dists, times in answers.distinct():
        ids_t = torch.as_tensor(ids, device=dev)
        d_t = torch.as_tensor(dists, device=dev)
        tr = true_ids[b * b_size : (b + 1) * b_size]
        h, gap, dp, bd, out = _judge(base, batches[b], ids_t, d_t, tr, allow)
        n_hits += int(h.sum()) * times
        n_slots += ids.shape[0] * topk * times
        dist_gap = max(dist_gap, float(gap.max()))
        dup += int(dp.sum()) * times
        bad += int(bd.sum()) * times
        broken = (gap > limits["dist_gap"]) | (dp > 0) | (bd > 0)
        if out is not None:
            outside += int(out.sum()) * times
            broken |= out > 0
        failed += int(broken.sum()) * times
    values = dict(miss=1.0 - n_hits / max(n_slots, 1), dist_gap=dist_gap,
                  dup=dup, bad_slots=bad, filtered=outside)
    names = NAMES + (("filtered",) if allow is not None else ())
    checks = {k: dict(value=values[k], limit=limits[k]) for k in names}
    correct = n_slots > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return checks, correct, failed
