"""Batched query pipeline (port of rabitq_tpu.index.search).

For a batch of queries:

  1. rotate the queries and rank every centroid by fp32 distance; the
     ``probe`` nearest clusters are scanned (stable sort: ties go to the
     lower cluster id, as with ``lax.top_k``);
  2. quantize the [B, probe] query residuals to 4 bits;
  3. rough scan: the RaBitQ estimator on every row of every probed
     cluster (ops/scan_kernel.py — the CUDA kernel on the GPU);
  4. select the R lowest rough distances exactly (per-task top-R, then a
     global top-R over the survivors);
  5. gather the candidates' full-precision rows, exact L2, and the final
     top-k — deduplicated by id when the build spilled rows.

Slots past a cluster's size estimate to +inf and never survive selection.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rabitq_tpu_torch.index.index import RaBitQIndex, SearchParams
from rabitq_tpu_torch.ops import (
    cuda_rough_scan,
    pairwise_l2sq,
    quantize_query_residuals,
    rotate,
)


class Candidates(NamedTuple):
    """Rerank candidates: positions are rows of the cluster-sorted arrays."""

    pos: torch.Tensor          # [B, R] int64
    lower_bound: torch.Tensor  # [B, R] f32 rough distances (+inf pad)
    n_scanned: torch.Tensor    # [B] int64 estimator evaluations


class SearchStats(NamedTuple):
    """Per-query counters: ``rough`` = estimator evaluations (rows in the
    probed clusters), ``precise`` = exact distances computed in the
    rerank (finite-lower-bound candidates)."""

    rough: torch.Tensor    # [B] int64
    precise: torch.Tensor  # [B] int64


class RoughScan(NamedTuple):
    """Rough-distance scan output in cluster-visit order: the row of flat
    value j of query b is ``starts[b, j // width] + j % width``."""

    rough: torch.Tensor      # [B, probe * width] f32 (+inf on padded slots)
    starts: torch.Tensor     # [B, probe] int32 cluster start rows
    n_scanned: torch.Tensor  # [B] int64


def _resolve(index: RaBitQIndex, params: SearchParams) -> tuple[int, int, int]:
    """(probe, width, rerank) for this index: probe capped at k, the scan
    width = capacity, and R capped at the rows that can be scanned."""
    probe = min(params.probe, index.k)
    cap = index.capacity
    rerank = max(params.topk, min(params.rerank, probe * cap))
    return probe, cap, rerank


def _prep_queries(index: RaBitQIndex, queries: torch.Tensor) -> torch.Tensor:
    """Pad to the index dim; L2-normalize for cosine-metric indexes."""
    q = torch.nn.functional.pad(queries, (0, index.dim - queries.shape[1]))
    if index.metric == "cosine":
        norms = torch.linalg.norm(q, dim=-1, keepdim=True)
        q = q / torch.clamp(norms, min=1e-30)
    return q


def _rank_clusters(cdist: torch.Tensor, probe: int) -> torch.Tensor:
    """The ``probe`` nearest cluster ids per row, nearest first; ties go to
    the lower id (split clusters' duplicated centroids tie exactly, and
    the nearer segments have the lower ids)."""
    return torch.sort(cdist, dim=-1, stable=True).indices[:, :probe]


def rough_scan(
    index: RaBitQIndex, queries: torch.Tensor, params: SearchParams
) -> RoughScan:
    """Stages 1-3: rough distances of every row of every probed cluster,
    clusters nearest-first, rows in cluster (centroid-distance) order."""
    probe, width, _ = _resolve(index, params)
    b = queries.shape[0]
    y = rotate(_prep_queries(index, queries), index.orthogonal)  # [B, D]
    cids = _rank_clusters(pairwise_l2sq(y, index.centroids_rot), probe)
    yr = y[:, None, :] - index.centroids_rot[cids]  # [B, probe, D]
    ycd = torch.sum(yr * yr, dim=-1)  # [B, probe] exact
    qq = quantize_query_residuals(
        yr, index.rand_bias if params.dither else None
    )
    offsets = index.offsets
    starts = offsets[cids]  # [B, probe] int32
    sizes = offsets[cids + 1] - starts
    scal = torch.stack([qq.lower, qq.delta, qq.code_sum, ycd], dim=-1)
    s = b * probe
    rough = cuda_rough_scan(
        index.codes,
        index.factors,
        starts.reshape(s).contiguous(),
        sizes.reshape(s).contiguous(),
        qq.quantized.reshape(s, index.dim).contiguous(),
        scal.reshape(s, 4).contiguous(),
        width,
    )
    return RoughScan(
        rough=rough.reshape(b, probe * width),
        starts=starts,
        n_scanned=sizes.sum(dim=-1, dtype=torch.int64),
    )


def _exact_two_stage(
    rough: torch.Tensor, probe: int, width: int, rerank: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact top-R of [B, probe*width]: any value in the global top-R ranks
    <= R within its own task, so a per-task top-min(R, width) followed by
    a global top-R over the survivors returns exactly the global top-R
    values. Returns (lower bounds [B, R], flat indices [B, R])."""
    b = rough.shape[0]
    m = min(rerank, width)
    vt, ji = torch.topk(rough.reshape(b, probe, width), m, dim=-1, largest=False)
    flat = (
        torch.arange(probe, device=rough.device)[None, :, None] * width + ji
    ).reshape(b, probe * m)
    lb, sel = torch.topk(vt.reshape(b, probe * m), rerank, dim=-1, largest=False)
    return lb, torch.gather(flat, 1, sel)


def estimate_candidates(
    index: RaBitQIndex, queries: torch.Tensor, params: SearchParams
) -> Candidates:
    """Stages 1-4: rough scan and exact rerank-candidate selection."""
    probe, width, rerank = _resolve(index, params)
    scan = rough_scan(index, queries, params)
    lb, flat_idx = _exact_two_stage(scan.rough, probe, width, rerank)
    task = flat_idx // width  # [B, R] index into the probed clusters
    pos = torch.gather(scan.starts.long(), 1, task) + flat_idx % width
    pos = torch.clamp(pos, max=index.n - 1)  # invalid slots are +inf anyway
    return Candidates(pos=pos, lower_bound=lb, n_scanned=scan.n_scanned)


def _exact_rerank(
    index: RaBitQIndex, q_pad: torch.Tensor, cand: Candidates
) -> torch.Tensor:
    """Exact squared L2 of the candidates' rows, +inf where the rough
    distance was +inf. [B, R]."""
    diff = index.base[cand.pos] - q_pad[:, None, :]  # [B, R, D]
    exact = torch.sum(diff * diff, dim=-1)
    return torch.where(torch.isfinite(cand.lower_bound), exact, torch.inf)


def _dedup_topk(
    index: RaBitQIndex, vals: torch.Tensor, pos: torch.Tensor, topk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k with id dedup (spilled builds index some ids twice).

    Each id has at most 2 copies, so the best copy of the j-th best
    distinct id ranks within the top 2(j-1)+1 values: deduping the top
    2*topk is exact. Sort by (id, value) — two stable sorts, the value
    first — so each id's best copy leads its run; the rest go to +inf;
    a stable re-sort by value gives the final ranking.
    Returns (dists [B, topk], ids [B, topk]; -1 where not finite).
    """
    m = min(2 * topk, vals.shape[-1])
    v, ei = torch.topk(vals, m, dim=-1, largest=False, sorted=True)
    ids = index.map_ids[torch.gather(pos, 1, ei)].long()
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    ids = torch.gather(ids, 1, by_id)
    v = torch.gather(v, 1, by_id)
    dup = torch.zeros_like(v, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    v = torch.where(dup, torch.inf, v)
    v, by_v = torch.sort(v, dim=-1, stable=True)
    ids = torch.gather(ids, 1, by_v)
    dists = v[:, :topk]
    return dists, torch.where(torch.isfinite(dists), ids[:, :topk], -1)


def search_with_stats(
    index: RaBitQIndex, queries: torch.Tensor, params: SearchParams
) -> tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """search() plus per-query SearchStats (rough/precise counters)."""
    if index.base is None:
        raise ValueError("index has no base rows to rerank against")
    cand = estimate_candidates(index, queries, params)
    exact = _exact_rerank(index, _prep_queries(index, queries), cand)
    precise = torch.isfinite(exact).sum(dim=1)
    if index.dedup_ids:
        dists, ids = _dedup_topk(index, exact, cand.pos, params.topk)
    else:
        dists, ei = torch.topk(exact, params.topk, dim=-1, largest=False)
        ids = index.map_ids[torch.gather(cand.pos, 1, ei)].long()
        ids = torch.where(torch.isfinite(dists), ids, -1)
    return dists, ids, SearchStats(rough=cand.n_scanned, precise=precise)


def search(
    index: RaBitQIndex, queries: torch.Tensor, params: SearchParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Search a batch: (distances [B, topk], ids [B, topk]). Slots with
    fewer than topk reachable candidates have distance +inf and id -1."""
    dists, ids, _ = search_with_stats(index, queries, params)
    return dists, ids


def search_many(
    index: RaBitQIndex, queries: torch.Tensor, params: SearchParams
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-queryset search: queries [nb, batch, dim_orig], batches run
    in order; returns (dists, ids) shaped [nb, batch, topk]."""
    outs = [search(index, q, params) for q in queries]
    return (
        torch.stack([d for d, _ in outs]),
        torch.stack([i for _, i in outs]),
    )
