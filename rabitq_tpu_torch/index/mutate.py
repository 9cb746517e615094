"""Index mutation: insert, update, delete, compact (port of
rabitq_tpu.index.mutate).

The quantized index stays immutable; mutations layer on top of it:

- ``insert``  — an LSM-style memtable: new vectors live full-precision in
  ``extra_base``, which every query scores exactly and merges into its
  top-k. O(M) per query; ``compact`` when M grows.
- ``update``  — an id-preserving replace: tombstone every row that carries
  the id, then insert the new vector into the memtable under the same id.
- ``delete``  — tombstones, on the device: the row's cdsq factor becomes
  +inf (it estimates to +inf and is never selected) and its ``map_ids``
  entry -1; a memtable row's id becomes -1. No cost at query time.
- ``compact`` — a rebuild that folds the memtable in and drops tombstones,
  from the reconstructed corpus and the un-rotated centroids. Original ids
  are preserved, so updates keep answering under their ids.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from rabitq_tpu_torch.index.build import build_index
from rabitq_tpu_torch.index.index import RaBitQIndex
from rabitq_tpu_torch.utils import normalize_rows, pad_last_dim


def insert(index: RaBitQIndex, vectors, ids=None) -> RaBitQIndex:
    """Append ``vectors`` [m, dim_orig] to the memtable; returns a new index.

    ``ids`` default to consecutive values after the largest id present
    (quantized rows and memtable).
    """
    vectors = np.asarray(vectors, dtype=np.float32)
    if vectors.ndim != 2 or vectors.shape[1] != index.dim_orig:
        raise ValueError(f"vectors must be [m, {index.dim_orig}], got "
                         f"{vectors.shape}")
    if index.metric == "cosine":
        vectors = normalize_rows(vectors)
    vectors = pad_last_dim(vectors, index.dim)
    if ids is None:
        max_id = int(index.map_ids.max()) if index.n else -1
        if index.m:
            max_id = max(max_id, int(index.extra_ids.max()))
        ids = np.arange(max_id + 1, max_id + 1 + vectors.shape[0])
    ids = np.asarray(ids, dtype=np.int32)
    if ids.shape != (vectors.shape[0],):
        raise ValueError(f"{ids.shape[0]} ids for {vectors.shape[0]} vectors")
    dev = index.map_ids.device
    new_base = torch.from_numpy(vectors).to(dev)
    new_ids = torch.from_numpy(ids).to(dev)
    if index.m:
        new_base = torch.cat([index.extra_base, new_base])
        new_ids = torch.cat([index.extra_ids, new_ids])
    return dataclasses.replace(index, extra_base=new_base, extra_ids=new_ids)


def update(index: RaBitQIndex, vectors, ids) -> RaBitQIndex:
    """Id-preserving replace: afterwards a search near the new vector
    returns the same original id, and the old vector is gone. Tombstones
    the ids, then inserts the vectors under them; an id not in the index
    is simply inserted (upsert)."""
    vectors = np.asarray(vectors, dtype=np.float32)
    ids = np.asarray(ids, dtype=np.int32)
    if vectors.ndim != 2 or ids.shape != (vectors.shape[0],):
        raise ValueError(f"{ids.shape} ids for vectors {vectors.shape}")
    if np.unique(ids).shape != ids.shape:
        raise ValueError("duplicate ids in one update")
    return insert(delete(index, ids), vectors, ids=ids)


def delete(index: RaBitQIndex, ids) -> RaBitQIndex:
    """Tombstone the given original ids on the device (``torch.isin``, no
    host read); returns a new index. Unknown ids are ignored."""
    dev = index.map_ids.device
    victims = torch.as_tensor(np.asarray(ids, dtype=np.int64), device=dev)
    hit = torch.isin(index.map_ids.long(), victims)
    factors = index.factors.clone()
    factors[:, 3] = torch.where(hit, torch.inf, factors[:, 3])
    map_ids = torch.where(hit, -1, index.map_ids)
    extra_ids = index.extra_ids
    if index.m:
        extra_ids = torch.where(
            torch.isin(extra_ids.long(), victims), -1, extra_ids
        )
    return dataclasses.replace(
        index, factors=factors, map_ids=map_ids, extra_ids=extra_ids
    )


def reconstruct_corpus(index: RaBitQIndex) -> tuple[np.ndarray, np.ndarray]:
    """(vectors [n_live, dim_orig] f32, ids [n_live] int32) of every live
    row, as numpy: the stored base less tombstones, each spilled id once
    (ordered by id, as ``np.unique`` orders them), then the live memtable
    rows in insertion order."""
    if index.base is None:
        raise ValueError("reconstruction needs the stored base")
    base = index.base[:, : index.dim_orig].cpu().numpy()
    ids = index.map_ids.cpu().numpy()
    live = ids >= 0
    b, i = base[live], ids[live]
    if index.dedup_ids:
        _, first = np.unique(i, return_index=True)
        b, i = b[first], i[first]
    vecs, out_ids = [b], [i]
    if index.m:
        ex_ids = index.extra_ids.cpu().numpy()
        ex_live = ex_ids >= 0
        vecs.append(index.extra_base[:, : index.dim_orig].cpu().numpy()[ex_live])
        out_ids.append(ex_ids[ex_live])
    return np.concatenate(vecs), np.concatenate(out_ids)


def compact(
    index: RaBitQIndex,
    *,
    generator: torch.Generator | None = None,
    orthogonal=None,
) -> tuple[RaBitQIndex, np.ndarray]:
    """Fold the memtable in and drop tombstones by rebuilding with the
    port's ``build_index`` on the index's device, from the un-rotated
    centroids (fp32) and, for a spilled index, the spill fraction observed
    among its live rows. ``generator`` and ``orthogonal`` go to the build
    (``orthogonal`` lets a caller hand over a given rotation: torch and
    ``jax.random`` draw different ones).

    Returns (new_index, live_ids): the new index's ``map_ids`` carry the
    original ids, and ``live_ids`` lists them in reconstruction order.
    """
    vectors, old_ids = reconstruct_corpus(index)
    centroids = torch.matmul(index.centroids_rot, index.orthogonal.T)[
        :, : index.dim_orig
    ]
    spill = 0.0
    if index.dedup_ids:
        ids_q = index.map_ids.cpu().numpy()
        ids_q = ids_q[ids_q >= 0]
        n_unique = np.unique(ids_q).shape[0]
        spill = (ids_q.shape[0] - n_unique) / max(n_unique, 1)
    dev = index.map_ids.device
    new_index = build_index(
        vectors,
        centroids,
        generator=generator,
        orthogonal=orthogonal,
        metric=index.metric,
        bits=index.code_bits,
        spill=spill,
        device=dev,
    )
    # build_index numbers its input rows 0..n-1; map back to the original ids.
    old = torch.from_numpy(old_ids.astype(np.int32)).to(dev)
    new_index = dataclasses.replace(
        new_index, map_ids=old[new_index.map_ids.long()]
    )
    return new_index, old_ids
