"""Build the port's index from the arrays of a JAX-built index."""

from __future__ import annotations

import numpy as np
import torch

from rabitq_tpu_torch.index.index import RaBitQIndex, dense_to_padded
from rabitq_tpu_torch.utils import resolve_device


def index_from_arrays(
    *,
    codes_pm1: np.ndarray,
    factors_tiled: np.ndarray,
    offsets: np.ndarray,
    map_ids: np.ndarray,
    centroids_rot: np.ndarray,
    orthogonal: np.ndarray,
    rand_bias: np.ndarray,
    base: np.ndarray | None,
    dim: int,
    dim_orig: int,
    capacity: int,
    metric: str,
    code_bits: int,
    dedup_ids: bool,
    extra_base: np.ndarray | None = None,
    extra_ids: np.ndarray | None = None,
    device: torch.device | str | None = None,
) -> RaBitQIndex:
    """The JAX index's arrays (numpy, e.g. ``np.asarray(jidx.codes_pm1)``)
    -> the port's dense cluster-sorted index on ``device`` (default CUDA,
    raising without a card).

    ``codes_pm1`` [n_tiles, 128, D] int8 and ``factors_tiled``
    [n_tiles, 8, 128] f32 are lane-tiled in the aligned padded column
    order; dense row p lives at column ``dense_to_padded(offsets, p)``.
    Every other field is carried across unchanged, a mutated index's
    tombstones (cdsq +inf, map_ids -1) and insert memtable (``extra_base``
    [M, D], ``extra_ids`` [M]; an empty one becomes None) included.
    """
    device = resolve_device(device)
    offsets = np.asarray(offsets, dtype=np.int32)
    n = int(np.asarray(map_ids).shape[0])
    cols = dense_to_padded(offsets, np.arange(n))
    codes_pm1 = np.asarray(codes_pm1)
    d = codes_pm1.shape[-1]
    codes = codes_pm1.reshape(-1, d)[cols]
    fac = np.asarray(factors_tiled).transpose(0, 2, 1).reshape(-1, 8)
    factors = np.ascontiguousarray(fac[cols, :4])

    def t(a, dtype):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    if extra_base is not None and np.asarray(extra_base).shape[0] == 0:
        extra_base = extra_ids = None

    return RaBitQIndex(
        codes=t(codes, torch.int8),
        factors=t(factors, torch.float32),
        offsets=t(offsets, torch.int32),
        map_ids=t(map_ids, torch.int32),
        centroids_rot=t(centroids_rot, torch.float32),
        orthogonal=t(orthogonal, torch.float32),
        rand_bias=t(rand_bias, torch.float32),
        base=None if base is None else t(base, torch.float32),
        dim=int(dim),
        dim_orig=int(dim_orig),
        capacity=int(capacity),
        metric=metric,
        code_bits=int(code_bits),
        dedup_ids=bool(dedup_ids),
        extra_base=None if extra_base is None else t(extra_base, torch.float32),
        extra_ids=None if extra_base is None else t(extra_ids, torch.int32),
    )
