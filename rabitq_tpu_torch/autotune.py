"""Automatic (probe, rerank) selection for a target recall (port of
rabitq_tpu.autotune).

Given an index and a sample of representative queries, ``autotune``
measures recall against exact brute-force ground truth over a probe
ladder (the rerank budget scaled with the probe as the serving defaults
do) and returns the cheapest SearchParams that meets the target, with the
measured curve. Configurations are ranked by probe (device cost grows
with probe at fixed shapes), so the tuner runs one search a rung.

    params, curve = autotune(index, sample_queries, target_recall=0.95)
    dists, ids = search(index, queries, params)

The ground truth (``exact_topk``) runs on the index's device: chunked fp32
distances over the live base rows and the live memtable rows, merged
there, each id once.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from rabitq_tpu_torch.index.index import RaBitQIndex, SearchParams
from rabitq_tpu_torch.index.search import _prep_queries, search
from rabitq_tpu_torch.ops import pairwise_l2sq
from rabitq_tpu_torch.utils import calculate_recall

_DEFAULT_LADDER = (4, 8, 16, 24, 32, 36, 40, 48, 64, 80, 96, 128, 192,
                   256, 384, 512)


class TunePoint(NamedTuple):
    probe: int
    rerank: int
    recall: float


def _queries_on(index: RaBitQIndex, queries) -> torch.Tensor:
    dev = index.map_ids.device
    if isinstance(queries, torch.Tensor):
        return queries.to(device=dev, dtype=torch.float32)
    return torch.from_numpy(np.asarray(queries, np.float32)).to(dev)


def exact_topk(
    index: RaBitQIndex, queries, topk: int, chunk: int = 262_144
) -> np.ndarray:
    """Exact brute-force top-k original ids [B, topk] (int64, -1 where
    fewer than topk live rows exist) over the index's corpus: the stored
    base less tombstones, plus the live memtable rows. The tuner's ground
    truth.

    Each id counts once. A spilled build stores some rows twice, so the
    best ``c * topk`` candidates (c = 2, 3 with a memtable, the bound of
    search's dedup) are kept across chunks and deduplicated by id at the
    end. (The JAX package's exact_topk keeps both copies, so its truth on
    a spilled index can name one id twice; ROADMAP queue 3.) Chunks of
    ``chunk`` rows bound the [B, chunk] distance block.
    """
    if index.base is None:
        raise ValueError("exact_topk needs the stored base")
    q = _prep_queries(index, _queries_on(index, queries))
    keep = (3 if index.m else 2) * topk
    best_d = torch.empty((q.shape[0], 0), device=q.device)
    best_i = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)

    def merge(rows, ids):
        nonlocal best_d, best_i
        d = torch.where(ids[None, :] >= 0, pairwise_l2sq(q, rows), torch.inf)
        v, sel = torch.topk(d, min(keep, rows.shape[0]), dim=-1, largest=False)
        md = torch.cat([best_d, v], dim=1)
        mi = torch.cat([best_i, ids.long()[sel]], dim=1)
        order = torch.sort(md, dim=-1, stable=True).indices[:, :keep]
        best_d, best_i = md.gather(1, order), mi.gather(1, order)

    for s in range(0, index.n, chunk):
        merge(index.base[s : s + chunk], index.map_ids[s : s + chunk])
    if index.m:
        merge(index.extra_base, index.extra_ids)
    # Each id's best copy leads its run after a stable sort by id.
    by_id = torch.sort(best_i, dim=-1, stable=True).indices
    ids, d = best_i.gather(1, by_id), best_d.gather(1, by_id)
    dup = torch.zeros_like(d, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    d, by_d = torch.sort(torch.where(dup, torch.inf, d), dim=-1, stable=True)
    ids = torch.where(torch.isfinite(d), ids.gather(1, by_d), -1)[:, :topk]
    out = torch.full((q.shape[0], topk), -1, dtype=torch.int64)
    out[:, : ids.shape[1]] = ids.cpu()
    return out.numpy()


def default_rerank_for(index: RaBitQIndex, probe: int, topk: int) -> int:
    """The serving-default rerank budget at a given probe.

    Multi-bit codes rank candidates near-exactly, so the budget floor is
    ~3x topk; 1-bit estimates need the budget to grow with probe, because
    a fixed top-R dilutes as more clusters are scanned."""
    if index.code_bits >= 3:
        return max(32, topk * 5 // 2)
    return max(140, 3 * probe, 4 * topk)


def autotune(
    index: RaBitQIndex,
    sample_queries,
    target_recall: float = 0.95,
    *,
    topk: int = 10,
    ladder: Sequence[int] = _DEFAULT_LADDER,
    margin: float = 0.0,
    truth: np.ndarray | None = None,
    base_params: SearchParams | None = None,
) -> tuple[SearchParams, list[TunePoint]]:
    """The cheapest SearchParams meeting ``target_recall`` @ topk.

    Walks ``ladder`` (ascending probes, each with
    ``default_rerank_for``), measuring the recall of ``search`` against
    exact ground truth on ``sample_queries``; returns the first rung whose
    recall is >= target_recall + margin, and every measured (probe,
    rerank, recall) point. If no rung reaches the target, the best-recall
    rung is returned. ``truth`` (original ids, at least topk wide) skips
    the ground-truth pass; ``base_params`` carries the knobs not tuned
    (probe_rank, select_reduce, ...).
    """
    qs = _queries_on(index, sample_queries)
    if truth is None:
        truth = exact_topk(index, qs, topk)
    truth = np.asarray(truth)
    if truth.shape[0] != qs.shape[0] or truth.shape[1] < topk:
        raise ValueError(f"truth {truth.shape} for {qs.shape[0]} queries at "
                         f"topk {topk}")
    base = base_params or SearchParams()
    curve: list[TunePoint] = []
    best: tuple[float, SearchParams] | None = None
    for probe in ladder:
        probe = min(probe, index.k)
        rr = default_rerank_for(index, probe, topk)
        params = base._replace(probe=probe, topk=topk, rerank=rr)
        ids = search(index, qs, params)[1].cpu().numpy()
        rec = float(np.mean([calculate_recall(truth[i], ids[i], topk)
                             for i in range(ids.shape[0])]))
        curve.append(TunePoint(probe, rr, rec))
        if best is None or rec > best[0]:
            best = (rec, params)
        if rec >= target_recall + margin:
            return params, curve
        if probe >= index.k:
            break
    return best[1], curve
