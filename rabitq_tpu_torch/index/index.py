"""The RaBitQ index data model on the GPU (port of rabitq_tpu.index.index).

Rows are cluster-sorted and dense: cluster c occupies rows
``[offsets[c], offsets[c+1])``, each cluster ordered by distance to its
centroid.

- ``codes``     [N, D] int8 — the residual code grid v = 2u - (2^bits - 1)
                (±1 at bits=1), the operand of the rough-scan kernel's
                int8 dot.
- ``factors``   [N, 4] f32 — per-row (ip, ppc, err, cdsq) estimator factors.
- ``base``      [N, D] f32 or None — full-precision rows for the rerank.
- ``base_bf16`` [N, D] bf16 or None — a copy of ``base`` for the two-level
                rerank (SearchParams.rerank_bf16), derived by
                with_bf16_base and never serialized.
- ``offsets``   [K + 1] int32 — prefix sums of cluster sizes.
- ``map_ids``   [N] int32 — sorted row -> original id (duplicates when the
                build spilled rows into a second cluster).
- ``centroids_rot`` [K, D] f32, ``orthogonal`` [D, D] f32, ``rand_bias``
                [D] f32 — rotated centroids, rotation, query dither.
- ``extra_base`` [M, D] f32 or None, ``extra_ids`` [M] int32 or None — the
                insert memtable (index/mutate.py): rows added after the
                build, searched exactly beside the quantized rows.

Tombstones (index/mutate.py ``delete``) keep the JAX encoding: the row's
cdsq factor (column 3 of ``factors``) is +inf, so it estimates to +inf, and
its ``map_ids`` entry is -1; a deleted memtable row has ``extra_ids`` -1.

Metadata: padded dim, original dim, capacity (largest cluster rounded up
to 128; the scan span), metric ("l2" or "cosine"), code_bits and dedup_ids.
The JAX package's lane-tiled TPU layouts (the uint32 blob, the
[n_tiles, 128, D] code tiling, base_tiled) have no counterpart here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from rabitq_tpu_torch.consts import LANES


@dataclasses.dataclass(frozen=True)
class RaBitQIndex:
    codes: torch.Tensor
    factors: torch.Tensor
    offsets: torch.Tensor
    map_ids: torch.Tensor
    centroids_rot: torch.Tensor
    orthogonal: torch.Tensor
    rand_bias: torch.Tensor
    base: Optional[torch.Tensor]
    dim: int = 0
    dim_orig: int = 0
    capacity: int = 0
    metric: str = "l2"
    code_bits: int = 1
    dedup_ids: bool = False
    extra_base: Optional[torch.Tensor] = None
    extra_ids: Optional[torch.Tensor] = None
    base_bf16: Optional[torch.Tensor] = None

    @property
    def n(self) -> int:
        return self.map_ids.shape[0]

    @property
    def k(self) -> int:
        return self.offsets.shape[0] - 1

    @property
    def m(self) -> int:
        """Memtable rows (tombstoned ones included)."""
        return 0 if self.extra_base is None else self.extra_base.shape[0]


def with_bf16_base(index):
    """The index with the bf16 rerank copy of its base set (as
    rabitq_tpu.index.index.with_bf16_base): unchanged when the copy is
    already set or there is no base. The copy rounds to nearest even, as
    ``astype(bfloat16)`` does, and costs half the base's bytes on its
    device. A sharded index (parallel.ShardedIndex) gets one copy a local
    shard."""
    shards = getattr(index, "shards", None)
    if shards is not None:
        return dataclasses.replace(index, shards=[
            None if s is None else with_bf16_base(s) for s in shards])
    if index.base_bf16 is not None or index.base is None:
        return index
    return dataclasses.replace(index, base_bf16=index.base.to(torch.bfloat16))


def padded_offsets(offsets: np.ndarray) -> np.ndarray:
    """Cluster starts in the JAX package's aligned blob layout: every
    cluster's extent padded to whole 128-lane tiles. [k+1] like offsets."""
    sizes = offsets[1:] - offsets[:-1]
    spans = ((sizes + LANES - 1) // LANES) * LANES
    out = np.zeros_like(offsets)
    np.cumsum(spans, out=out[1:])
    return out


def dense_to_padded(offsets: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Translate dense (cluster-sorted) positions to aligned-blob columns."""
    offsets = np.asarray(offsets)
    opad = padded_offsets(offsets)
    c = np.searchsorted(offsets, pos, side="right") - 1
    return (opad[c] + (pos - offsets[c])).astype(np.int32)


class SearchParams(NamedTuple):
    """Query-pipeline configuration.

    probe:  IVF clusters scanned per query.
    topk:   results returned per query.
    rerank: rerank budget R — the number of lowest rough-distance
            candidates whose exact distance is computed. They are always
            selected exactly (per-task top-R, then global top-R).
    dither: quantize query residuals by floor + the index's dither
            instead of round-to-nearest.
    select_reduce: lane-fold the scan before selection, as the JAX
            default does: the scan keeps the best ``fold_depth`` estimates
            of each (task, slot % 128) bucket, slot-packed, so selection
            reads fold_depth * 128 columns a task instead of capacity. A
            candidate is lost only when fold_depth + 1 better values share
            its bucket. Off when capacity <= fold_depth * 128 or
            rerank > probe * fold_depth * 128. The port folds on the CPU
            too (the kernel's twin), so both devices give the same
            candidates; False gives the full scan output, which is what
            the JAX package's CPU path selects from.
    fold_depth: estimates kept per bucket, 1 or 2 (clamped).
    probe_lo: first probed-cluster rank to scan: the scan covers the
            clusters ranked [probe_lo, probe). 0 is a normal search;
            search_adaptive sets it on escalation so that each level
            scans only the newly probed clusters.
    probe_rank: the probe ranking key. "centroid": squared distance to
            the centroid. "annulus": the exact lower bound on any
            member's squared distance, the squared distance from d(q, c)
            to the cluster's member-radius band [r_lo, r_hi] (rows are
            sorted by centroid distance, so the first and last rows'
            cdsq bound it). It separates the tied segments of a split
            cluster and ranks empty clusters last.
    rerank_bf16: two-level rerank: the candidates' distances come first
            from the index's bf16 copy of the base (with_bf16_base; the
            gather_l2 kernel's bf16-row instance), then the best
            ``rerank_refine`` of them are recomputed from the f32 base.
            Silently off when the index has no bf16 copy.
    rerank_refine: rows re-verified in f32 under rerank_bf16. -1: auto,
            max(4 * topk, 32); 0: none, rank and report by the bf16
            distances; > 0: that many rows.
    rank_precision: the cluster ranking's matmul. "highest": full fp32
            (TF32 off). "default": one bf16 pass, as the TPU MXU's
            DEFAULT: operands rounded to bf16, products summed in f32, an
            f32 output. The early-stop certificate's bound stays fp32.

    The selection is always the JAX ``select_mode="exact"`` two-stage
    top-R, over the folded or the full scan output.

    Not ported from the JAX package's SearchParams (none changes a result
    off a TPU):
    select_mode, approx_select, select_recall, select_passes: the JAX
                    package takes ``approx_min_k`` only when its backend
                    is a TPU and selects exactly on any other, as the port
                    always does.
    rerank_chunk:   caps the JAX path's [B, R, D] gather transient, which
                    the kernel never makes; the results are identical.
    rerank_kernel:  selects a Mosaic layout (the lane-tiled base copy);
                    the port always reranks with its gather_l2 kernel on
                    the dense base.
    """

    probe: int = 100
    topk: int = 10
    rerank: int = 128
    dither: bool = False
    select_reduce: bool = True
    fold_depth: int = 2
    probe_lo: int = 0
    probe_rank: str = "centroid"
    rerank_bf16: bool = False
    rerank_refine: int = -1
    rank_precision: str = "highest"
