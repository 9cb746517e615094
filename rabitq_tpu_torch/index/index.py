"""The RaBitQ index data model on the GPU (port of rabitq_tpu.index.index).

Rows are cluster-sorted and dense: cluster c occupies rows
``[offsets[c], offsets[c+1])``, each cluster ordered by distance to its
centroid.

- ``codes``     [N, D] int8 — the residual code grid v = 2u - (2^bits - 1)
                (±1 at bits=1), the operand of the rough-scan kernel's
                int8 dot.
- ``factors``   [N, 4] f32 — per-row (ip, ppc, err, cdsq) estimator factors.
- ``base``      [N, D] f32 or None — full-precision rows for the rerank.
- ``offsets``   [K + 1] int32 — prefix sums of cluster sizes.
- ``map_ids``   [N] int32 — sorted row -> original id (duplicates when the
                build spilled rows into a second cluster).
- ``centroids_rot`` [K, D] f32, ``orthogonal`` [D, D] f32, ``rand_bias``
                [D] f32 — rotated centroids, rotation, query dither.

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

    @property
    def n(self) -> int:
        return self.map_ids.shape[0]

    @property
    def k(self) -> int:
        return self.offsets.shape[0] - 1


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
    """

    probe: int = 100
    topk: int = 10
    rerank: int = 128
    dither: bool = False
