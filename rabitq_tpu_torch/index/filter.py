"""Per-call row filtering (port of rabitq_tpu.index.filter).

A filter is a dense [N] f32 *penalty* in the index's cluster-sorted row
order: 0 where the row's original id passes the predicate, +inf where it
does not. It is built once per predicate on the host from ORIGINAL ids,
uploaded once, and reused by every query batch that carries the
predicate. The scan kernel adds it to each estimate (the ``penalty``
operand of ops/scan_kernel.py), so a filtered row estimates to +inf and
never takes a rerank slot; the rerank and top-k stages need no change.

- A filter forces the scan's lane fold off (``estimate_candidates``), as in
  the JAX package: the selection runs over the unfolded estimates.
- IVF probe selection is not filtered: a cluster whose rows are all
  masked still takes a probe slot. Under a selective filter raise
  ``probe``.
- The penalty is defined per original id and expanded through
  ``map_ids``, so every spilled copy of an id carries the same penalty,
  and tombstoned rows (cdsq +inf) stay masked whatever the filter says.

The JAX package lays the penalty out in its lane-tiled padded blob order
([n_tiles, 128], cluster padding +inf) because a TPU gathers 128-lane
tiles fast; the port's dense order is that array read at
``index.dense_to_padded`` positions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from rabitq_tpu_torch.index.index import RaBitQIndex


class RowFilter(NamedTuple):
    """Device-resident predicate: pass as ``search(..., row_filter=)``.

    ``penalty``: [N] f32 in the dense row order, 0 = allowed, +inf =
    filtered. ``extra_penalty``: [M] f32 for the insert memtable, or None.
    """

    penalty: torch.Tensor
    extra_penalty: Optional[torch.Tensor]


def _allowed_mask(ids: np.ndarray, allow_ids, deny_ids) -> np.ndarray:
    """Boolean pass/fail per id: membership in ``allow_ids``, or absence
    from ``deny_ids`` (one ``np.isin`` pass)."""
    if allow_ids is not None:
        return np.isin(ids, np.asarray(allow_ids))
    return ~np.isin(ids, np.asarray(deny_ids))


def penalty_from_mask(allowed: np.ndarray) -> np.ndarray:
    """A per-row pass mask [N] bool -> the penalty [N] f32 (0 or +inf)."""
    return np.where(np.asarray(allowed), 0.0, np.inf).astype(np.float32)


def _memtable_ids(index: RaBitQIndex) -> np.ndarray | None:
    return None if index.m == 0 else index.extra_ids.cpu().numpy()


class RowFilterContext:
    """Per-index-generation state shared across filter builds.

    The direct build costs one ``np.isin`` over all N rows per predicate.
    The context hoists what depends only on the index: ``map_ids`` sorted
    once (``sorted_ids``, ``sort_idx``), so one predicate's rows are m
    binary searches (``rows_of``), and the deny-mode template (0 at every
    row), copied per predicate.

    Use: ``ctx = RowFilterContext(index)`` once per index, then
    ``make_row_filter(index, allow_ids=..., ctx=ctx)`` per predicate.
    """

    def __init__(self, index: RaBitQIndex):
        map_ids = index.map_ids.cpu().numpy()
        self.sort_idx = np.argsort(map_ids, kind="stable").astype(np.int64)
        self.sorted_ids = map_ids[self.sort_idx]
        self.zero_template = np.zeros(map_ids.shape[0], np.float32)
        self.extra_ids = _memtable_ids(index)

    def rows_of(self, ids) -> np.ndarray:
        """Dense rows whose original id is in ``ids``, every spilled copy
        included (a left/right searchsorted range per id)."""
        ids = np.unique(np.asarray(ids))
        lo = np.searchsorted(self.sorted_ids, ids, side="left")
        hi = np.searchsorted(self.sorted_ids, ids, side="right")
        counts = hi - lo
        first = np.cumsum(counts) - counts  # each id's first output slot
        out = np.repeat(lo, counts) + (
            np.arange(counts.sum()) - np.repeat(first, counts)
        )
        return self.sort_idx[out]


def make_row_filter(
    index: RaBitQIndex,
    allow_ids=None,
    deny_ids=None,
    ctx: RowFilterContext | None = None,
) -> RowFilter:
    """A RowFilter from an allowlist OR a denylist of original ids, on the
    index's device.

    Exactly one of ``allow_ids`` / ``deny_ids`` must be given. Without
    ``ctx`` the host cost is one ``np.isin`` over the N rows; with a
    ``RowFilterContext`` it is m binary searches and one [N] copy. Build
    once per predicate and reuse it across batches.
    """
    if (allow_ids is None) == (deny_ids is None):
        raise ValueError("pass exactly one of allow_ids / deny_ids")
    if ctx is not None:
        if allow_ids is not None:
            pen = np.full(ctx.zero_template.shape[0], np.inf, np.float32)
            pen[ctx.rows_of(allow_ids)] = 0.0
        else:
            pen = ctx.zero_template.copy()
            pen[ctx.rows_of(deny_ids)] = np.inf
        eids = ctx.extra_ids
    else:
        allowed = _allowed_mask(index.map_ids.cpu().numpy(), allow_ids, deny_ids)
        pen = penalty_from_mask(allowed)
        eids = _memtable_ids(index)
    dev = index.map_ids.device
    extra = None
    if eids is not None:
        extra = torch.from_numpy(
            penalty_from_mask(_allowed_mask(eids, allow_ids, deny_ids))
        ).to(dev)
    return RowFilter(penalty=torch.from_numpy(pen).to(dev), extra_penalty=extra)
