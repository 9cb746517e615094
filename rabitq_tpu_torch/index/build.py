"""Index construction (port of rabitq_tpu.index.build, resident path).

The corpus is uploaded once and stays on the device: rotate + rank the
nearest centroids per row chunk, quantize every row against its final
centroid, quantize the spilled copies against their second centroid, then
cluster-sort codes, factors and base rows on the device. Capacity
balancing, spill admission and cluster splitting are metadata bookkeeping
over the assignment labels and run in numpy on the host (the three helpers
below are copies of the JAX package's).

Factor math (per row, residual r = rot(x) - c, code grid v):
  x_dot        = <r, v> / (|r| |v|)            (guarded)
  error_bound  = 2*EPSILON/sqrt(D-1) * sqrt((|r|/x_dot)^2 - |r|^2)
  factor_ip    = -2/|v| * |r|/x_dot
  factor_ppc   = factor_ip * sum(v)
v = sign(r) at bits=1 (sign(0) = -1); at bits > 1 it is the odd-integer
grid v = 2u - (2^bits - 1) whose scale maximizes cos(r, v) (_quantize_grid).
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from rabitq_tpu_torch.consts import DEFAULT_X_DOT_PRODUCT, EPSILON, LANES
from rabitq_tpu_torch.index.index import RaBitQIndex
from rabitq_tpu_torch.ops import gen_random_orthogonal, pairwise_l2sq, rotate
from rabitq_tpu_torch.utils import (
    normalize_rows,
    pad_last_dim,
    resolve_device,
    round_up,
)

logger = logging.getLogger(__name__)

# Smallest positive normal f32 (guards the x_dot division).
_MIN_NORMAL_F32 = np.float32(1.17549435e-38)

# Scale-search candidates for the multi-bit grid (relative to the scale
# mapping max|r| onto the grid edge).
_SCALE_GRID = (0.55, 0.65, 0.75, 0.85, 0.95, 1.05, 1.15, 1.25)


def chunk_rows(n: int, chunk: int) -> int:
    """Rows of every device step of a build of ``n`` rows: ``chunk``, or
    fewer for a small corpus. Every step runs on exactly this many rows
    (the last padded with zero rows), so each product and row reduction
    has the same shape in every step: a row's codes and factors are then
    the same bits wherever it lies in a step, which lets
    parallel.build_index_sharded quantize each shard's rows on its own
    device and still equal build_index bit for bit."""
    return min(chunk, round_up(max(n, 1), 256))


def _padded(a: torch.Tensor, rows: int) -> torch.Tensor:
    """``a`` with zero rows appended up to ``rows``."""
    if a.shape[0] == rows:
        return a
    pad = a.new_zeros((rows - a.shape[0],) + tuple(a.shape[1:]))
    return torch.cat([a, pad])


def _assign_top(
    x_all: torch.Tensor,
    orthogonal: torch.Tensor,
    centroids_rot: torch.Tensor,
    top: int,
    chunk: int,
    exact_cdsq: bool = False,
):
    """The ``top`` nearest rotated centroids of every row, best-first, in
    fp32, in steps of ``chunk`` rows (chunk_rows). Returns host (labels
    [n, top] int32, dists [n, top] f32), and with ``exact_cdsq`` also each
    candidate's exact squared residual norm [n, top] f32, by
    _build_chunk's own expression on the same shapes, so the values are
    the bits the quantize pass computes for the row in that cluster."""
    top = min(top, centroids_rot.shape[0])
    n = x_all.shape[0]
    labs, dists, cds = [], [], []
    for a in range(0, n, chunk):
        m = min(chunk, n - a)
        y = rotate(_padded(x_all[a : a + chunk], chunk), orthogonal)
        d = pairwise_l2sq(y, centroids_rot)
        v, i = torch.topk(d, top, dim=-1, largest=False, sorted=True)
        labs.append(i[:m].to(torch.int32))
        dists.append(v[:m])
        if exact_cdsq:
            cols = []
            for j in range(top):
                r = y - centroids_rot[i[:, j]]
                cols.append(torch.sum(r * r, dim=-1))
            cds.append(torch.stack(cols, dim=-1)[:m])
    out = (torch.cat(labs).cpu().numpy(), torch.cat(dists).cpu().numpy())
    if exact_cdsq:
        out += (torch.cat(cds).cpu().numpy(),)
    return out


def _quantize_grid(r: torch.Tensor, bits: int):
    """Best odd-integer-grid code of each residual row.

    r: [C, D] f32. Returns (v [C, D] f32 in [-(2^bits-1), 2^bits-1] odd,
    x_dot [C] = cos(r, v) guarded, v_norm [C], v_sum [C]): per row, the
    scale t in max|r|-relative _SCALE_GRID maximizing cos(r, v(t)) where
    v(t) = 2*clip(round((t*r + m)/2), 0, m) - m, m = 2^bits - 1.
    """
    m = float((1 << bits) - 1)
    absmax = torch.amax(torch.abs(r), dim=-1, keepdim=True)  # [C, 1]
    base_t = m / torch.clamp(absmax, min=float(_MIN_NORMAL_F32))
    # A (near-)zero residual overflows the scale to inf and 0 * inf is NaN
    # (the JAX package's _quantize_grid yields NaN factors for a row equal
    # to its centroid). Scale 0 instead: v = +1 everywhere, x_dot falls back
    # to the default, and the factors are finite.
    base_t = torch.where(torch.isfinite(base_t), base_t, 0.0)
    ts = torch.tensor(_SCALE_GRID, dtype=torch.float32, device=r.device)
    scaled = r[:, None, :] * (base_t[:, :, None] * ts[None, :, None])
    u = torch.clamp(torch.round((scaled + m) * 0.5), 0.0, m)  # [C, S, D]
    v = 2.0 * u - m
    rv = torch.sum(r[:, None, :] * v, dim=-1)  # [C, S]
    vsq = torch.sum(v * v, dim=-1)  # [C, S]
    # cos^2 with sign: compare rv/|v| via rv*|rv|/vsq to avoid sqrt.
    score = rv * torch.abs(rv) / torch.clamp(vsq, min=1.0)
    pick = torch.argmax(score, dim=-1)  # [C], first max on ties
    rows = torch.arange(r.shape[0], device=r.device)
    v_best = v[rows, pick]  # [C, D]
    rv_b = rv[rows, pick]
    vn_b = torch.sqrt(vsq[rows, pick])
    rn = torch.sqrt(torch.sum(r * r, dim=-1))
    denom = rn * vn_b
    ok = torch.isfinite(denom) & (denom >= _MIN_NORMAL_F32) & (rv_b > 0)
    x_dot = torch.where(
        ok,
        rv_b / torch.clamp(denom, min=float(_MIN_NORMAL_F32)),
        DEFAULT_X_DOT_PRODUCT,
    )
    return v_best, x_dot, vn_b, torch.sum(v_best, dim=-1)


def _build_chunk(
    x_pad: torch.Tensor,
    label: torch.Tensor,
    orthogonal: torch.Tensor,
    centroids_rot: torch.Tensor,
    bits: int,
):
    """Quantize one chunk of padded rows against their assigned centroids.

    Returns (cdsq [C] f32, codes [C, D] int8 grid values, factors [C, 4]
    f32 = ip, ppc, err, cdsq).
    """
    dim = x_pad.shape[1]
    d = np.float32(dim)
    sqrt_d = np.sqrt(d)
    r = rotate(x_pad, orthogonal) - centroids_rot[label]  # [C, D]
    cdsq = torch.sum(r * r, dim=-1)  # exact, not the matmul identity
    norm = torch.sqrt(cdsq)
    if bits == 1:
        positive = r > 0.0
        l1 = torch.sum(torch.abs(r), dim=-1)
        pop = positive.sum(dim=-1).to(torch.float32)
        denom = norm * sqrt_d
        x_dot = torch.where(
            torch.isfinite(denom) & (denom >= _MIN_NORMAL_F32),
            l1 / torch.clamp(denom, min=float(_MIN_NORMAL_F32)),
            DEFAULT_X_DOT_PRODUCT,
        )
        v_norm = sqrt_d
        v_sum = 2.0 * pop - float(d)  # <1, sign(r)> with sign(0) = -1
        codes = torch.where(positive, 1, -1).to(torch.int8)
    else:
        v, x_dot, v_norm, v_sum = _quantize_grid(r, bits)
        codes = v.to(torch.int8)
    x_c_over_ip = norm / x_dot
    error_base = np.float32(2.0) * np.float32(EPSILON) / np.sqrt(d - 1)
    error_bound = error_base * torch.sqrt(
        torch.clamp(x_c_over_ip * x_c_over_ip - cdsq, min=0.0)
    )
    factor_ip = -2.0 / v_norm * x_c_over_ip
    factor_ppc = factor_ip * v_sum
    factors = torch.stack([factor_ip, factor_ppc, error_bound, cdsq], dim=-1)
    return cdsq, codes, factors


def _quantize_rows(
    x: torch.Tensor,
    labels: torch.Tensor,
    orthogonal: torch.Tensor,
    centroids_rot: torch.Tensor,
    bits: int,
    chunk: int,
):
    """_build_chunk over every row of x in steps of exactly ``chunk`` rows
    (chunk_rows; the last padded with zero rows); concatenated outputs."""
    n = x.shape[0]
    outs = [
        tuple(
            t[: min(chunk, n - a)]
            for t in _build_chunk(
                _padded(x[a : a + chunk], chunk),
                _padded(labels[a : a + chunk], chunk),
                orthogonal, centroids_rot, bits,
            )
        )
        for a in range(0, n, chunk)
    ]
    return tuple(torch.cat(parts) for parts in zip(*outs))


def balance_assignments(
    labels: np.ndarray,
    dists: np.ndarray,
    k: int,
    cap: int,
    rounds: int = 4,
) -> np.ndarray:
    """Capacity-capped assignment by vectorized eviction rounds.

    labels/dists: [n, top] candidate centroids per vector, best-first. Each
    round keeps the `cap` closest members of every over-full cluster and
    moves the rest to their next-best candidate. Bounds the max cluster
    size (which sets the scan window span, i.e. per-probe cost) at
    ~cap; vectors that run out of candidates stay put, so heavy outliers
    can still exceed cap slightly.
    """
    n, top = labels.shape
    choice = np.zeros(n, dtype=np.int32)
    cur = labels[:, 0].copy()
    cur_d = dists[:, 0].copy()
    for _ in range(rounds):
        order = np.lexsort((cur_d, cur))
        sorted_lab = cur[order]
        # Rank of each vector within its (current) cluster, distance order.
        starts = np.searchsorted(sorted_lab, np.arange(k))
        ranks = np.arange(n) - starts[sorted_lab]
        evict_sorted = (ranks >= cap) & (choice[order] < top - 1)
        if not evict_sorted.any():
            break
        evict = order[evict_sorted]
        choice[evict] += 1
        cur[evict] = labels[evict, choice[evict]]
        cur_d[evict] = dists[evict, choice[evict]]
    return cur


def split_oversized_clusters(
    offsets: np.ndarray, cap: int
) -> tuple[np.ndarray, np.ndarray]:
    """Split clusters larger than ``cap`` into consecutive segments.

    Pure metadata surgery: row positions are untouched — only the offsets
    table grows and each extra segment duplicates its source centroid.
    This hard-bounds the scan span when eviction balancing cannot spread
    the mass. Segments inherit the within-cluster centroid-distance sort.
    Duplicated centroids tie exactly in the probe ranking, and the search
    breaks ties toward lower cluster ids = nearer segments (stable sort).

    Returns (new_offsets [k'+1], seg_src [k'] source cluster per segment).
    Each call is counted on the function's attributes, so that a build's
    split can be read after it: ``calls``, ``clusters_split`` (clusters
    cut into two or more segments, summed over the calls), and
    ``k_before`` / ``k_after`` of the last call.
    """
    sizes = offsets[1:] - offsets[:-1]
    k = sizes.shape[0]
    segs = np.maximum(1, -(-sizes // cap))  # ceil, empties keep 1 slot
    seg_src = np.repeat(np.arange(k, dtype=np.int32), segs)
    split_oversized_clusters.calls += 1
    split_oversized_clusters.clusters_split += int((segs > 1).sum())
    split_oversized_clusters.k_before = k
    split_oversized_clusters.k_after = int(segs.sum())
    new_offsets = np.empty(int(segs.sum()) + 1, np.int32)
    new_offsets[0] = 0
    at = 1
    for c in range(k):
        a, b = int(offsets[c]), int(offsets[c + 1])
        for j in range(int(segs[c])):
            new_offsets[at] = min(a + (j + 1) * cap, b)
            at += 1
    return new_offsets, seg_src


split_oversized_clusters.calls = 0
split_oversized_clusters.clusters_split = 0
split_oversized_clusters.k_before = split_oversized_clusters.k_after = 0


def _spill_admit(
    cand_labels: np.ndarray,
    cand_dists: np.ndarray,
    labels: np.ndarray,
    base: np.ndarray,
    centroids: np.ndarray,
    *,
    k: int,
    spill: float,
    spill_mode: str,
    spill_soar_lambda: float,
    balance: float | None,
    split: bool,
) -> tuple[np.ndarray, np.ndarray, int | None]:
    """Pick + admit the spill (multi-assignment) copies.

    Pure metadata bookkeeping over the assignment outputs. Returns (pick [m]
    source rows, spill_tgt [m] target clusters, cap_unspilled) with m = 0
    arrays when spill is off.

    Capacity-preserving quota: every probed cluster scans a window of the
    index's capacity, so spill is scan-time free exactly while capacity
    stays at the unspilled value. Admit picks most-ambiguous-first, per
    target cluster, only up to the unspilled capacity. Cascading
    admission: round 0 offers each pick its runner-up cluster; a pick
    whose target is quota-full is re-offered to its NEXT-nearest
    candidate cluster with room instead of being dropped outright.
    """
    n = labels.shape[0]
    n_spill = min(n, int(round(spill * n))) if (spill > 0 and k >= 2) else 0
    if n_spill == 0:
        empty = np.zeros(0, np.int32)
        return empty, empty.copy(), None
    moved = cand_labels[:, 0] != labels
    sec_dist = np.where(moved, cand_dists[:, 0], cand_dists[:, 1])
    # f64 division: an inf/huge runner-up distance over a subnormal-
    # clamped denominator overflows f32; the ratio only RANKS picks.
    ratio = sec_dist.astype(np.float64) / np.maximum(
        cand_dists[:, 0].astype(np.float64), _MIN_NORMAL_F32
    )
    pick = np.argpartition(ratio, n_spill - 1)[:n_spill].astype(np.int32)
    sizes0 = np.bincount(labels, minlength=k)
    cap_unspilled = max(LANES, round_up(int(sizes0.max(initial=1)), LANES))
    if balance and split:
        cap_unspilled = min(
            cap_unspilled,
            max(LANES, round_up(int(np.ceil(balance * n / k)), LANES)),
        )
    pick = pick[np.argsort(ratio[pick], kind="stable")]
    quota = np.maximum(cap_unspilled - sizes0, 0)

    def _arrival_rank(tgt_r: np.ndarray) -> np.ndarray:
        # Per-cluster arrival rank (stable sort keeps ambiguity order
        # within a cluster): rank j is admitted iff j < quota[cluster].
        srt = np.argsort(tgt_r, kind="stable")
        t_s = tgt_r[srt]
        idx = np.arange(t_s.size)
        grp_start = np.maximum.accumulate(
            np.where(np.r_[True, t_s[1:] != t_s[:-1]], idx, 0)
        )
        arrival = np.empty(t_s.size, dtype=np.int64)
        arrival[srt] = idx - grp_start
        return arrival

    # Preference order per pick: its distance-sorted top-``top``
    # candidate clusters minus its home cluster.
    prefs = cand_labels[pick]  # [m, top], distance-sorted
    valid = prefs != labels[pick][:, None]
    if spill_mode == "soar":
        # SOAR preference: d(x, c_j)^2 + lambda * ((x-c_j)·r̂1)^2,
        # r1 = x - c_home (Sun et al. 2023, ScaNN's multi-assignment).
        # Chunked: the [m, top, d] diff transient is the peak.
        score = np.empty(prefs.shape, dtype=np.float32)
        for s in range(0, pick.size, 16384):
            pk = pick[s : s + 16384]
            x = base[pk]
            r1 = x - centroids[labels[pk]]
            r1 /= np.maximum(
                np.linalg.norm(r1, axis=1, keepdims=True),
                _MIN_NORMAL_F32,
            )
            diff = x[:, None, :] - centroids[prefs[s : s + 16384]]
            proj = np.einsum("mtd,md->mt", diff, r1, optimize=True)
            score[s : s + 16384] = (
                np.sum(diff * diff, axis=2)
                + spill_soar_lambda * proj * proj
            )
        order = np.argsort(
            np.where(valid, score, np.inf), axis=1, kind="stable"
        )
    else:
        order = np.argsort(~valid, axis=1, kind="stable")
    prefs = np.take_along_axis(prefs, order, axis=1)
    nvalid = valid.sum(axis=1)
    admitted = np.full(pick.size, -1, dtype=np.int64)
    remaining = quota.copy()
    per_round = []
    for r in range(prefs.shape[1]):
        todo = np.nonzero((admitted < 0) & (r < nvalid))[0]
        if todo.size == 0:
            break
        tgt_r = prefs[todo, r]
        keep_r = _arrival_rank(tgt_r) < remaining[tgt_r]
        hit = todo[keep_r]
        admitted[hit] = tgt_r[keep_r]
        remaining -= np.bincount(tgt_r[keep_r], minlength=k).astype(
            remaining.dtype
        )
        per_round.append(int(hit.size))
    ok = admitted >= 0
    if not ok.all() or len(per_round) > 1:
        logger.info(
            "build: spill quota admitted %d/%d picks "
            "(per cascade round %s, capacity %d)",
            int(ok.sum()),
            pick.size,
            per_round,
            cap_unspilled,
        )
    return pick[ok], admitted[ok].astype(np.int32), cap_unspilled


def plan_assignment(
    cand_labels: np.ndarray,
    cand_dists: np.ndarray,
    base: np.ndarray,
    centroids: np.ndarray,
    *,
    k: int,
    balance: float | None,
    split: bool,
    spill: float,
    spill_mode: str,
    spill_soar_lambda: float,
):
    """Every row's cluster (balanced when ``balance``, else its nearest)
    and the admitted spill copies, from _assign_top's candidates. Returns
    (labels [n] int32, pick [m] source rows, spill_tgt [m] target
    clusters, cap_unspilled). Shared by build_index and
    parallel.build_index_sharded."""
    n = cand_labels.shape[0]
    if balance:
        cap = max(1, int(np.ceil(balance * n / k)))
        labels = balance_assignments(cand_labels, cand_dists, k, cap)
    else:
        labels = cand_labels[:, 0].copy()
    pick, spill_tgt, cap_unspilled = _spill_admit(
        cand_labels, cand_dists, labels, base, centroids, k=k, spill=spill,
        spill_mode=spill_mode, spill_soar_lambda=spill_soar_lambda,
        balance=balance, split=split,
    )
    return labels, pick, spill_tgt, cap_unspilled


def plan_layout(
    labels: np.ndarray,
    pick: np.ndarray,
    spill_tgt: np.ndarray,
    sort_key: torch.Tensor,
    *,
    k: int,
    balance: float | None,
    split: bool,
    cap_unspilled: int | None,
):
    """The cluster layout of the rows and their spilled copies, shared by
    build_index and parallel.build_index_sharded.

    ``sort_key`` [n + m] is each row's and then each copy's squared
    residual norm against its cluster; the sort runs where it lies. Rows
    sort by cluster, then by the key (two stable sorts, the secondary key
    first). Returns (labels_ext [n + m], orig_of [n + m] source rows,
    order [n + m] on the key's device, offsets [k' + 1], capacity,
    seg_src [k'] each segment's source cluster or None when no cluster
    was split)."""
    n = labels.shape[0]
    orig_of = np.arange(n, dtype=np.int32)
    if pick.size:
        labels = np.concatenate([labels, spill_tgt])
        orig_of = np.concatenate([orig_of, pick])
    labels_key = torch.as_tensor(labels, device=sort_key.device).long()
    by_key = torch.sort(sort_key, stable=True).indices
    order = by_key[torch.sort(labels_key[by_key], stable=True).indices]
    sizes = np.bincount(labels, minlength=k).astype(np.int32)
    offsets = np.zeros(k + 1, dtype=np.int32)
    np.cumsum(sizes, out=offsets[1:])
    capacity = max(LANES, round_up(int(sizes.max(initial=1)), LANES))
    seg_src = None
    if balance and split:
        # Hard capacity backstop where eviction balancing stalls.
        if cap_unspilled is not None:
            cap_target = cap_unspilled
        else:
            cap_target = max(
                LANES,
                round_up(int(np.ceil(balance * labels.shape[0] / k)), LANES),
            )
        if capacity > cap_target:
            offsets, seg_src = split_oversized_clusters(offsets, cap_target)
            new_sizes = offsets[1:] - offsets[:-1]
            capacity = max(
                LANES, round_up(int(new_sizes.max(initial=1)), LANES)
            )
            logger.info(
                "build: split oversized clusters: k %d -> %d, capacity %d",
                k, offsets.shape[0] - 1, capacity,
            )
    return labels, orig_of, order, offsets, capacity, seg_src


def build_index(
    base,
    centroids,
    *,
    generator: torch.Generator | None = None,
    orthogonal=None,
    chunk: int = 16384,
    metric: str = "l2",
    balance: float | None = 2.0,
    split: bool = True,
    bits: int = 1,
    spill: float = 0.0,
    spill_mode: str = "dist",
    spill_soar_lambda: float = 1.0,
    keep_base: bool = True,
    device: torch.device | str | None = None,
) -> RaBitQIndex:
    """Build a RaBitQ index from base vectors and trained centroids.

    base:       [n, d] float32 corpus (numpy).
    centroids:  [k, d] float32 IVF centroids (numpy or tensor, e.g. from
                rabitq_tpu_torch.kmeans).
    generator:  draws the rotation (unless ``orthogonal`` is given) and the
                query dither; default seed 0 on ``device``.
    orthogonal: [D, D] rotation override (D = d rounded up to 128).
    device:     where the index lives and the build runs; defaults to the
                generator's device, else the centroids' (a tensor), else
                CUDA (raising without a card).
    metric:     "l2" or "cosine" (rows and centroids are L2-normalized).
    balance:    cap cluster sizes at ``balance * n / k`` by moving the
                farthest overflow members to their next-nearest centroid.
                None = pure nearest-centroid assignment.
    split:      split still-oversized clusters into capacity-bounded
                segments with duplicated centroids.
    bits:       bits per dimension of the residual code (1..7).
    spill:      additionally index the ``spill * n`` most boundary-ambiguous
                rows in a second cluster ("dist": nearest other candidate
                first; "soar": by the SOAR objective with
                ``spill_soar_lambda``); the search then dedups ids.
    chunk:      rows per device step (bounds the [chunk, k] distances;
                chunk_rows).
    keep_base:  keep the full-precision rows on the device for the rerank.
                False builds the store tier's index (base None; searched
                with store.search_with_store), with no sorted copy of the
                rows on the device.
    """
    if metric not in ("l2", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    if not 1 <= bits <= 7:  # grid |v| <= 127 fits the int8 operand
        raise ValueError(f"bits must be in 1..7, got {bits}")
    if not 0.0 <= spill <= 1.0:
        raise ValueError(f"spill must be in [0, 1], got {spill}")
    if spill_mode not in ("dist", "soar"):
        raise ValueError(f"unknown spill_mode {spill_mode!r}")
    t_start = time.perf_counter()
    device = resolve_device(device, generator, centroids)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    base = np.asarray(base, dtype=np.float32)
    if isinstance(centroids, torch.Tensor):
        centroids = centroids.detach().cpu().numpy()
    centroids = np.asarray(centroids, dtype=np.float32)
    if metric == "cosine":
        base = normalize_rows(base)
        centroids = normalize_rows(centroids)
    n, d_orig = base.shape
    k = centroids.shape[0]
    if centroids.shape[1] != d_orig:
        raise ValueError(f"centroids dim {centroids.shape[1]} != {d_orig}")
    dim = round_up(d_orig, LANES)

    if orthogonal is None:
        p = gen_random_orthogonal(dim, generator, device)
    else:
        p = torch.as_tensor(orthogonal, dtype=torch.float32, device=device)
        if tuple(p.shape) != (dim, dim):
            raise ValueError(f"orthogonal must be [{dim}, {dim}]")
    rand_bias = torch.rand(
        dim, generator=generator, device=device, dtype=torch.float32
    )
    centroids_rot = rotate(
        torch.as_tensor(pad_last_dim(centroids, dim), device=device), p
    )
    x_all = torch.as_tensor(pad_last_dim(base, dim), device=device)
    chunk = chunk_rows(n, chunk)

    # Pass 1: the top-M nearest centroids per row, then balancing and
    # spill admission (host bookkeeping).
    top = 4 if (balance or spill > 0) else 1
    cand_labels, cand_dists = _assign_top(x_all, p, centroids_rot, top, chunk)
    labels, pick, spill_tgt, cap_unspilled = plan_assignment(
        cand_labels, cand_dists, base, centroids, k=k, balance=balance,
        split=split, spill=spill, spill_mode=spill_mode,
        spill_soar_lambda=spill_soar_lambda,
    )
    t_assign = time.perf_counter()

    # Pass 2: quantize against the final assignment, and the spilled
    # copies (the most boundary-ambiguous rows) a second time against
    # another centroid; the copies flow through the cluster sort.
    cdsq, codes, factors = _quantize_rows(
        x_all, torch.as_tensor(labels, device=device).long(), p,
        centroids_rot, bits, chunk,
    )
    if pick.size:
        pick_dev = torch.as_tensor(pick, device=device).long()
        sp = _quantize_rows(
            x_all[pick_dev],
            torch.as_tensor(spill_tgt, device=device).long(),
            p, centroids_rot, bits, chunk,
        )
        cdsq, codes, factors = (
            torch.cat([a, b]) for a, b in zip((cdsq, codes, factors), sp)
        )
    t_quant = time.perf_counter()

    # Cluster sort on the device by (cluster, centroid distance), then the
    # split of oversized clusters.
    _, orig_of, order, offsets, capacity, seg_src = plan_layout(
        labels, pick, spill_tgt, cdsq, k=k, balance=balance, split=split,
        cap_unspilled=cap_unspilled,
    )
    if seg_src is not None:
        centroids_rot = centroids_rot[
            torch.as_tensor(seg_src, device=device).long()
        ]

    map_ids = torch.as_tensor(orig_of, device=device)[order]
    # Spilled copies gather the same original row, so their rerank
    # distances are bitwise equal (the dedup relies on this).
    base_sorted = x_all[map_ids.long()] if keep_base else None
    del x_all
    index = RaBitQIndex(
        codes=codes[order].contiguous(),
        factors=factors[order].contiguous(),
        offsets=torch.as_tensor(offsets, device=device),
        map_ids=map_ids.to(torch.int32),
        centroids_rot=centroids_rot,
        orthogonal=p,
        rand_bias=rand_bias,
        base=base_sorted,
        dim=dim,
        dim_orig=d_orig,
        capacity=capacity,
        metric=metric,
        code_bits=bits,
        dedup_ids=bool(pick.size),
    )
    logger.info(
        "build: assign %.2fs, quantize+spill %.2fs, sort %.2fs "
        "(n %d, spilled %d, capacity %d)",
        t_assign - t_start, t_quant - t_assign,
        time.perf_counter() - t_quant, n, int(pick.size), capacity,
    )
    return index
