"""Batched query pipeline (port of rabitq_tpu.index.search).

For a batch of queries, all inside a ``search`` span, each stage inside
the span named first (profiling.span: recorded only while spans are
enabled):

  1. ``search.rank``: rotate the queries and rank every centroid by fp32
     distance (one bf16 pass at ``rank_precision="default"``), or by the
     annulus lower bound (``probe_rank="annulus"``); the ``probe`` best
     clusters are scanned, those ranked [probe_lo, probe) on an adaptive
     escalation. The selection is one launch, in a ``search.rank.sort``
     span of its own (ops/probe_rank.py — on the GPU the CUDA kernel, which
     forms the distance from the GEMM's terms in registers and keeps the
     ``probe`` best, the ids of a stable sort: ties go to the lower cluster
     id, as with ``lax.top_k``);
  2. ``search.quantize``: quantize the [B, probe] query residuals to 4
     bits (ops/quantize.py — the fused CUDA kernel on the GPU, which never
     materialises the [B, probe, D] f32 residual), nibble-packed when
     D % 256 == 0 as in the JAX search;
  3. ``search.scan``: the rough scan, the RaBitQ estimator on every row
     of every probed cluster (ops/scan_kernel.py — the CUDA kernel on the
     GPU, on the packed query operand when there is one), lane-folded to
     the best 2 slot-packed values per (task, slot % 128) by default
     (SearchParams.select_reduce); a row filter's penalty is added in the
     kernel, and forces the fold off;
  4. ``search.select``: select the R lowest rough values exactly and
     decode their rows (ops/select_kernel.py — one CUDA kernel on the GPU,
     a radix select of each query's row fused with the slot decode);
  5. ``search.rerank``: exact L2 of the candidates' full-precision rows
     (ops/rerank_kernel.py — the CUDA gather+L2 kernel on the GPU; with
     ``rerank_bf16`` first its bf16-row instance over every candidate,
     then the f32 one over the best ``rerank_refine``), merged with the
     exact distances of the insert memtable's rows;
  6. ``search.topk``: the final top-k — deduplicated by id when the
     build spilled rows or a memtable is live.

Slots past a cluster's size, and tombstoned rows (cdsq +inf), estimate to
+inf and never survive selection. ``search_adaptive`` escalates the probe
until an annulus-bound certificate shows no unprobed cluster can hold a
closer row.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rabitq_tpu_torch.consts import LANES
from rabitq_tpu_torch.index.filter import RowFilter
from rabitq_tpu_torch.index import replay
from rabitq_tpu_torch.index.index import RaBitQIndex, SearchParams
from rabitq_tpu_torch.ops import (
    cuda_gather_l2,
    cuda_probe_rank,
    cuda_quantize_residuals,
    cuda_rough_scan,
    cuda_select_candidates,
    pairwise_l2sq,
    rotate,
)
from rabitq_tpu_torch.ops.distances import L2Terms, l2sq_epilogue, pairwise_terms
from rabitq_tpu_torch.ops.scan_kernel import effective_fold, fold_slot_bits
from rabitq_tpu_torch.profiling import span


class Candidates(NamedTuple):
    """Rerank candidates: positions are rows of the cluster-sorted arrays."""

    pos: torch.Tensor          # [B, R] int64
    lower_bound: torch.Tensor  # [B, R] f32 rough distances (+inf pad)
    n_scanned: torch.Tensor    # [B] int64 estimator evaluations


class SearchStats(NamedTuple):
    """Per-query counters: ``rough`` = estimator evaluations (rows in the
    probed clusters), ``precise`` = exact distances computed in the
    rerank (finite-lower-bound candidates and live memtable rows)."""

    rough: torch.Tensor    # [B] int64
    precise: torch.Tensor  # [B] int64


class RoughScan(NamedTuple):
    """Rough-distance scan output in cluster-visit order. Unfolded, width
    is the index capacity and the row of flat value j of query b is
    ``starts[b, j // width] + j % width``. Folded at depth f, width is
    f * 128 and each finite value is slot-packed: its row is
    ``starts[b, j // width]`` plus its low ``fold_slot_bits(capacity)``
    bits (ops/scan_kernel.py)."""

    rough: torch.Tensor      # [B, probe * width] f32 (+inf on padded slots)
    starts: torch.Tensor     # [B, probe] int32 cluster start rows
    n_scanned: torch.Tensor  # [B] int64


def _resolve(
    index: RaBitQIndex, params: SearchParams
) -> tuple[int, int, int, int]:
    """(probe, lo, capacity, rerank) for this index: probe capped at k, the
    clusters ranked [lo, probe) are scanned (lo > 0 only on search_adaptive
    escalations), the capacity is the scan span, and R is capped at the
    rows that can be scanned."""
    probe = min(params.probe, index.k)
    lo = min(params.probe_lo, probe)
    cap = index.capacity
    rerank = max(params.topk, min(params.rerank, (probe - lo) * cap))
    return probe, lo, cap, rerank


def _prep_queries(index: RaBitQIndex, queries: torch.Tensor) -> torch.Tensor:
    """Pad to the index dim; L2-normalize for cosine-metric indexes."""
    q = torch.nn.functional.pad(queries, (0, index.dim - queries.shape[1]))
    if index.metric == "cosine":
        norms = torch.linalg.norm(q, dim=-1, keepdim=True)
        q = q / torch.clamp(norms, min=1e-30)
    return q


def _rank_terms(
    index: RaBitQIndex, y: torch.Tensor, params: SearchParams
) -> L2Terms:
    """The terms (xx, xc, cc) of the rotated queries' squared distances to
    every centroid at ``params.rank_precision`` (fp32, or one bf16 pass):
    the probe ranking's input, shared by the scan and the early-stop
    certificate, which recompute them identically."""
    return pairwise_terms(y, index.centroids_rot, params.rank_precision)


def _cluster_radius_band(
    index: RaBitQIndex,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster member centroid-distance band (r_lo, r_hi), [K] each.

    Rows are sorted by centroid distance within a cluster, so the cdsq
    factors of the first and last rows bound every member's d(x, c).
    A tombstone sets its row's cdsq to +inf: where the first row's is not
    finite, r_lo is 0, always a sound lower bound. (The JAX package reads
    it unguarded, so a cluster whose first row is deleted bounds to +inf
    and is treated as empty; ROADMAP queue 3.) An infinite r_hi is
    already conservative."""
    off = index.offsets.long()
    sizes = off[1:] - off[:-1]
    last_row = index.n - 1
    first = off[:-1].clamp(max=last_row)
    last = (off[:-1] + (sizes - 1).clamp(min=0)).clamp(max=last_row)
    cdsq = index.factors[:, 3]
    c_lo, c_hi = cdsq[first], cdsq[last]
    c_lo = torch.where(torch.isfinite(c_lo), c_lo, 0.0)
    return (
        torch.sqrt(torch.clamp(c_lo, min=0.0)),
        torch.sqrt(torch.clamp(c_hi, min=0.0)),
    )


def _annulus_bound(index: RaBitQIndex, cdist: torch.Tensor) -> torch.Tensor:
    """Exact lower bound on any member's squared distance per cluster: the
    squared distance from d(q, c) to the member-radius band [r_lo, r_hi]
    (triangle inequality both ways). Empty clusters bound to +inf. [B, K]."""
    sizes = index.offsets[1:] - index.offsets[:-1]
    r_lo, r_hi = _cluster_radius_band(index)
    d = torch.sqrt(torch.clamp(cdist, min=0.0))
    gap = torch.clamp(
        torch.maximum(d - r_hi[None, :], r_lo[None, :] - d), min=0.0
    )
    return torch.where(sizes[None, :] == 0, torch.inf, gap * gap)


def _rank_clusters(
    index: RaBitQIndex, terms: L2Terms, probe: int, params: SearchParams
) -> torch.Tensor:
    """The ``probe`` best cluster ids per row by the ranking key of
    ``params.probe_rank`` (centroid distance or the annulus bound), best
    first; ties go to the lower id (split clusters' duplicated centroids
    tie exactly, and the nearer segments have the lower ids): the ids of a
    stable sort of the key (ops/probe_rank.py). ``terms`` are the
    distances' terms (_rank_terms): by centroid distance the kernel forms
    the key from them itself; the annulus bound is built from the
    distances."""
    if params.probe_rank == "annulus":
        xx = cc = None
        key = _annulus_bound(index, l2sq_epilogue(terms))
    elif params.probe_rank == "centroid":
        xx, key, cc = terms
    else:
        raise ValueError(f"unknown probe_rank {params.probe_rank!r}")
    with span("search.rank.sort", key.device):
        return cuda_probe_rank(key, probe, xx, cc)


def rough_scan(
    index: RaBitQIndex,
    queries: torch.Tensor,
    params: SearchParams,
    fold: int = 0,
    penalty: torch.Tensor | None = None,
) -> RoughScan:
    """Stages 1-3: rough distances of every row of the clusters ranked
    [probe_lo, probe), clusters best-first, rows in cluster
    (centroid-distance) order; lane-folded at depth
    ``effective_fold(capacity, fold)``. ``penalty`` (a RowFilter's, [N]) is
    added to every estimate in the kernel."""
    probe, lo, cap, _ = _resolve(index, params)
    pe = probe - lo
    b = queries.shape[0]
    dev = index.codes.device
    with span("search.rank", dev):
        y = rotate(_prep_queries(index, queries), index.orthogonal)  # [B, D]
        # Both rankings return rank-sorted columns, so [lo:] are exactly
        # the clusters an escalation adds.
        cids = _rank_clusters(index, _rank_terms(index, y, params), probe,
                              params)[:, lo:]
    # The JAX gate of the nibble-packed query operand
    # (rabitq_tpu/index/search.py:403).
    qpack = index.dim % 256 == 0
    s = b * pe
    with span("search.quantize", dev):
        qvals, scal = cuda_quantize_residuals(
            y,
            index.centroids_rot,
            cids.contiguous(),
            index.rand_bias if params.dither else None,
            pack=qpack,
        )
        offsets = index.offsets
        starts = offsets[cids]  # [B, pe] int32
        sizes = offsets[cids + 1] - starts
    with span("search.scan", dev):
        rough = cuda_rough_scan(
            index.codes,
            index.factors,
            starts.reshape(s).contiguous(),
            sizes.reshape(s).contiguous(),
            qvals,
            scal,
            cap,
            fold,
            qpack,
            penalty,
        )
        n_scanned = sizes.sum(dim=-1, dtype=torch.int64)
    return RoughScan(
        rough=rough.reshape(b, pe * rough.shape[1]),
        starts=starts,
        n_scanned=n_scanned,
    )


def estimate_candidates(
    index: RaBitQIndex,
    queries: torch.Tensor,
    params: SearchParams,
    row_filter: RowFilter | None = None,
) -> Candidates:
    """Stages 1-4: rough scan and exact rerank-candidate selection, in a
    ``search`` span of its own (the store tier's and the sharded path's
    batch).

    The fold gate of rabitq_tpu.index.search.estimate_candidates: on with
    ``select_reduce`` when the capacity exceeds ``fold_depth`` * 128 and
    the folded width holds the rerank budget. A ``row_filter``
    (index/filter.py) forces the fold off, as in JAX, and its penalty goes
    to the scan kernel, so filtered rows estimate to +inf and never take
    a rerank slot."""
    with span("search", index.codes.device):
        return _estimate_candidates(index, queries, params, row_filter)


def _estimate_candidates(
    index: RaBitQIndex,
    queries: torch.Tensor,
    params: SearchParams,
    row_filter: RowFilter | None,
) -> Candidates:
    probe, lo, cap, rerank = _resolve(index, params)
    pe = probe - lo
    depth = effective_fold(cap, max(1, min(2, int(params.fold_depth))))
    fold = (
        depth
        if depth
        and params.select_reduce
        and row_filter is None
        and rerank <= pe * depth * LANES
        else 0
    )
    scan = rough_scan(
        index, queries, params, fold,
        penalty=None if row_filter is None else row_filter.penalty,
    )
    width = scan.rough.shape[1] // pe
    with span("search.select", index.codes.device):
        # One kernel launch on the card (csrc/select.cu): a radix select
        # of each query's row fused with the slot decode, bound by one
        # read of the rough values; the candidates come in task order.
        pos, lb = cuda_select_candidates(
            scan.rough, scan.starts, width, rerank,
            fold_slot_bits(cap) if fold else 0, index.n,
        )
    return Candidates(pos=pos, lower_bound=lb, n_scanned=scan.n_scanned)


def _exact_rerank(
    index: RaBitQIndex,
    q_pad: torch.Tensor,
    cand: Candidates,
    params: SearchParams,
    include_memtable: bool = True,
    row_filter: RowFilter | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact squared L2 of the candidates' rows (+inf where the rough
    distance was +inf), with the insert memtable merged in as virtual
    positions >= n: its [B, M] distances by one fp32 product (TF32 off),
    +inf for deleted rows, plus the filter's memtable penalty.
    ``include_memtable`` is False on adaptive levels after the first.

    With ``params.rerank_bf16`` and the index's bf16 copy (JAX's two-level
    rerank, rabitq_tpu/index/search.py:793-818): every candidate's
    distance from the bf16 rows first; at refine 0 those are the result
    (ranked and reported); else the best min(R, refine) of them are
    recomputed from the f32 base, their bf16 distance as their bound.
    Returns (exact [B, R' (+ M)], pos [B, R' (+ M)]), R' = R or the
    refined rows."""
    # estimate_candidates clamps positions into [0, n): no range check,
    # whose device-to-host read would stall the stream every batch.
    q = q_pad.contiguous()
    exact = None
    if params.rerank_bf16 and index.base_bf16 is not None:
        approx = cuda_gather_l2(index.base_bf16, cand.pos, q, check_pos=False)
        approx = torch.where(
            torch.isfinite(cand.lower_bound), approx, torch.inf)
        refine = params.rerank_refine
        if refine < 0:
            refine = max(4 * params.topk, 32)
        if refine == 0:
            exact = approx
        else:
            a, ei = torch.topk(approx, min(cand.pos.shape[1], refine),
                               dim=-1, largest=False)
            cand = cand._replace(pos=torch.gather(cand.pos, 1, ei),
                                 lower_bound=a)
    if exact is None:
        exact = cuda_gather_l2(index.base, cand.pos, q, check_pos=False)
        exact = torch.where(torch.isfinite(cand.lower_bound), exact, torch.inf)
    pos = cand.pos
    if include_memtable and index.m:
        ex_d = pairwise_l2sq(q_pad, index.extra_base)  # [B, M]
        ex_d = torch.where(index.extra_ids[None, :] >= 0, ex_d, torch.inf)
        if row_filter is not None and row_filter.extra_penalty is not None:
            ex_d = ex_d + row_filter.extra_penalty[None, :]
        virt = index.n + torch.arange(index.m, device=pos.device)
        exact = torch.cat([exact, ex_d], dim=1)
        pos = torch.cat([pos, virt[None, :].expand(pos.shape[0], -1)], dim=1)
    return exact, pos


def _raw_ids(index: RaBitQIndex, pos: torch.Tensor) -> torch.Tensor:
    """Original ids (int64) of cluster-sorted positions, memtable virtual
    positions >= n included, with no validity masking."""
    n = index.n
    ids = index.map_ids[torch.clamp(pos, max=n - 1)].long()
    if index.m:
        ex = index.extra_ids[torch.clamp(pos - n, min=0, max=index.m - 1)]
        ids = torch.where(pos >= n, ex.long(), ids)
    return ids


def _pos_to_ids(
    index: RaBitQIndex, pos: torch.Tensor, dists: torch.Tensor
) -> torch.Tensor:
    """Original ids of the [B, topk] winners; -1 where the distance is not
    finite."""
    return torch.where(torch.isfinite(dists), _raw_ids(index, pos), -1)


def _dedup_topk(
    index: RaBitQIndex, vals: torch.Tensor, pos: torch.Tensor, topk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k with id dedup (spilled builds index some ids twice).

    Each id has at most c copies among ``vals`` (c = 2; 3 with a live
    memtable, where an insert of an existing id adds one), so the best
    copy of the j-th best distinct id ranks within the top c(j-1)+1
    values: deduping the top c*topk is exact. Sort by (id, value) — two
    stable sorts, the value first — so each id's best copy leads its run;
    the rest go to +inf; a stable re-sort by value gives the ranking.
    Returns (dists [B, topk], ids [B, topk]; -1 where not finite,
    pos [B, topk]).
    """
    copies = 3 if index.m else 2
    m = min(copies * topk, vals.shape[-1])
    v, ei = torch.topk(vals, m, dim=-1, largest=False, sorted=True)
    p = torch.gather(pos, 1, ei)
    ids = _raw_ids(index, p)
    by_id = torch.sort(ids, dim=-1, stable=True).indices
    ids, v, p = (torch.gather(t, 1, by_id) for t in (ids, v, p))
    dup = torch.zeros_like(v, dtype=torch.bool)
    dup[:, 1:] = ids[:, 1:] == ids[:, :-1]
    v = torch.where(dup, torch.inf, v)
    v, by_v = torch.sort(v, dim=-1, stable=True)
    ids, p = torch.gather(ids, 1, by_v), torch.gather(p, 1, by_v)
    dists = v[:, :topk]
    return (
        dists,
        torch.where(torch.isfinite(dists), ids[:, :topk], -1),
        p[:, :topk],
    )


def _top_results(
    index: RaBitQIndex, exact: torch.Tensor, pos: torch.Tensor, topk: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dists, ids, pos) of the best ``topk`` of [B, W] exact distances,
    deduplicated by id when the build spilled rows."""
    if index.dedup_ids:
        return _dedup_topk(index, exact, pos, topk)
    dists, ei = torch.topk(exact, topk, dim=-1, largest=False)
    psel = torch.gather(pos, 1, ei)
    return dists, _pos_to_ids(index, psel, dists), psel


def search_with_stats(
    index: RaBitQIndex,
    queries: torch.Tensor,
    params: SearchParams,
    row_filter: RowFilter | None = None,
) -> tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """search() plus per-query SearchStats (rough/precise counters; precise
    counts the live memtable rows too)."""
    if index.base is None:
        raise ValueError(
            "index has no base rows to rerank against (loaded with "
            "keep_base=False?): the store tier serves such an index, "
            "through rabitq_tpu_torch.store.search_with_store"
        )
    dev = index.codes.device
    with span("search", dev):
        cand = _estimate_candidates(index, queries, params, row_filter)
        with span("search.rerank", dev):
            exact, pos = _exact_rerank(
                index, _prep_queries(index, queries), cand, params,
                row_filter=row_filter,
            )
        with span("search.topk", dev):
            precise = torch.isfinite(exact).sum(dim=1)
            dists, ids, _ = _top_results(index, exact, pos, params.topk)
    return dists, ids, SearchStats(rough=cand.n_scanned, precise=precise)


def search(
    index: RaBitQIndex,
    queries: torch.Tensor,
    params: SearchParams,
    row_filter: RowFilter | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Search a batch: (distances [B, topk], ids [B, topk]). Slots with
    fewer than topk reachable candidates have distance +inf and id -1.
    ``row_filter`` (make_row_filter) restricts results to rows whose id
    passes its predicate. On a card an unfiltered batch is replayed from
    a CUDA graph of its launches from its shape's second call on
    (index/replay.py)."""
    if row_filter is None and replay.eligible(queries):
        return replay.run(_search, index, queries, params)
    return _search(index, queries, params, row_filter)


def _search(index, queries, params, row_filter=None):
    dists, ids, _ = search_with_stats(index, queries, params, row_filter)
    return dists, ids


def search_many(
    index: RaBitQIndex,
    queries: torch.Tensor,
    params: SearchParams,
    row_filter: RowFilter | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-queryset search: queries [nb, batch, dim_orig], batches run
    in order, one ``row_filter`` for all; returns (dists, ids) shaped
    [nb, batch, topk]."""
    outs = [search(index, q, params, row_filter) for q in queries]
    return (
        torch.stack([d for d, _ in outs]),
        torch.stack([i for _, i in outs]),
    )


def search_many_packed(
    index: RaBitQIndex,
    queries: torch.Tensor,
    params: SearchParams,
    nbits: int,
    row_filter: RowFilter | None = None,
) -> torch.Tensor:
    """search_many returning only the ids, bit-packed to ``nbits`` bits
    each (ops/idpack.py, the JAX package's layout bit for bit): [nb *
    batch * topk / 32 rounded up, nbits] torch.uint32 words on the index's
    device. Decode on the host with
    ``ops.idpack.unpack_ids(words, nbits, nb * batch * topk)``. Invalid
    slots (id -1) pack as all ones. For a link slower than the card,
    such as remote serving; distances are dropped."""
    from rabitq_tpu_torch.ops.idpack import pack_ids

    _, ids = search_many(index, queries, params, row_filter)
    return pack_ids(ids, nbits)


def _certificate_safe(
    index: RaBitQIndex,
    y: torch.Tensor,
    probe: int,
    kth: torch.Tensor,
    params: SearchParams,
) -> torch.Tensor:
    """Per-query early-stop certificate, [B] bool.

    True when no unprobed cluster can hold a vector closer than the
    current k-th result: every member x of cluster c has d(q, x)^2 >= the
    annulus bound of c (_annulus_bound). The probed set is ranked as the
    scan ranked it (_rank_terms, _rank_clusters on the same inputs give
    the same values, at the same rank_precision), and the bound always
    comes from fp32 distances: a bf16 pass could overestimate d(q, c) and
    void the lower bound (rabitq_tpu/index/search.py:1010-1040)."""
    terms = _rank_terms(index, y, params)
    cids = _rank_clusters(index, terms, probe, params)
    cd = (pairwise_l2sq(y, index.centroids_rot)
          if params.rank_precision != "highest" else l2sq_epilogue(terms))
    bound = _annulus_bound(index, cd)  # [B, K]; empty clusters +inf
    probed = torch.zeros_like(bound, dtype=torch.bool).scatter_(1, cids, True)
    min_unprobed = torch.where(probed, torch.inf, bound).min(dim=-1).values
    return (kth <= min_unprobed) | (probe >= index.k)


def _search_with_certificate(
    index: RaBitQIndex, queries: torch.Tensor, params: SearchParams
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """search() plus the early-stop certificate (see _certificate_safe):
    (dists, ids, safe [B])."""
    probe = _resolve(index, params)[0]
    dists, ids = search(index, queries, params)
    y = rotate(_prep_queries(index, queries), index.orthogonal)
    return dists, ids, _certificate_safe(index, y, probe, dists[:, -1], params)


def _adaptive_level(
    index: RaBitQIndex,
    queries: torch.Tensor,
    params: SearchParams,
    prev_dists: torch.Tensor,  # [B, topk] f32 (+inf on the first level)
    prev_pos: torch.Tensor,  # [B, topk] int64
    row_filter: RowFilter | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One escalation of search_adaptive.

    Scans only the clusters ranked [params.probe_lo, params.probe),
    reranks the new candidates exactly and merges them with the previous
    level's top-k: newly scanned clusters are disjoint from earlier ones,
    so only a spilled index's second copy of an id can arrive twice, and
    the dedup drops it. The memtable joins at the first level only: later
    levels merely add candidates. Certifies against all top-probe
    clusters. Returns (dists, pos, safe)."""
    dev = index.codes.device
    with span("search", dev):
        cand = _estimate_candidates(index, queries, params, row_filter)
        with span("search.rerank", dev):
            q_pad = _prep_queries(index, queries)
            exact, pos = _exact_rerank(
                index, q_pad, cand, params,
                include_memtable=params.probe_lo == 0, row_filter=row_filter,
            )
        with span("search.topk", dev):
            dists, _, pos = _top_results(
                index,
                torch.cat([prev_dists, exact], dim=1),
                torch.cat([prev_pos, pos], dim=1),
                params.topk,
            )
        y = rotate(q_pad, index.orthogonal)
        probe = min(params.probe, index.k)
        safe = _certificate_safe(index, y, probe, dists[:, -1], params)
    return dists, pos, safe


def search_adaptive(
    index: RaBitQIndex,
    queries: torch.Tensor,
    params: SearchParams,
    *,
    max_probe: int | None = None,
    level_width: int = 256,
    row_filter: RowFilter | None = None,
) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Early-stopping search: probe geometrically more clusters (from
    ``params.probe``, doubling) until every query's result is certified
    (no unprobed cluster can hold a closer vector) or ``max_probe`` is
    reached. Each level scans only the newly probed cluster ranks and
    merges with the running top-k, so the scan work is about that of the
    final probe. Returns (dists, ids, probe_used).

    ``level_width`` caps the cluster ranks of one call; a wider level runs
    as several sub-calls, and the certificate is read once per geometric
    level, after its last sub-call: one device-to-host read a level.

    Under a ``row_filter`` the certificate stays sound: it bounds the
    unfiltered member distances, and the filtered k-th result is at least
    the unfiltered one, so it can only escalate more than needed.
    """
    k = index.k
    cap_probe = min(max_probe or k, k)
    probe = min(params.probe, cap_probe)
    b = queries.shape[0]
    dev = index.codes.device
    dists = torch.full((b, params.topk), torch.inf, device=dev)
    pos = torch.zeros((b, params.topk), dtype=torch.int64, device=dev)
    w = max(1, level_width)
    lo = 0
    while True:
        while lo < probe:
            hi = min(lo + w, probe)
            dists, pos, safe = _adaptive_level(
                index, queries, params._replace(probe=hi, probe_lo=lo),
                dists, pos, row_filter,
            )
            lo = hi
        if probe >= cap_probe or bool(safe.all()):
            return dists, _pos_to_ids(index, pos, dists), probe
        probe = min(probe * 2, cap_probe)
