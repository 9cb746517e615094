"""Sharded checkpoints (port of rabitq_tpu.parallel.checkpoint): dump and
load a sharded index one shard at a time, byte for byte in the JAX
package's layout, so a checkpoint written by either package loads in the
other.

    <path>/meta.json              the sharded layout: shard count, the
                                  padded shapes (k_max, rows_max,
                                  tiles_max), the static fields
    <path>/shard_00000/...        one reference-format directory a shard
                                  (index/serialize.py dump_to_dir), each
                                  loadable alone with load_from_dir
    <path>/shard_*/global_pos.ivecs  optional: each local row's global
                                  cluster-sorted position (the store
                                  tier's mapping, shard_global_positions)

``tiles_max`` is the JAX scan blob's tile count, which the port has no
blob for: ShardedIndex carries it, computed from the shards' offsets as
the JAX make_blob sizes its blob. Under a multi-process world each process
dumps and loads only its own shards; the process holding shard 0 (and the
memtable) writes meta.json.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path

import numpy as np

from rabitq_tpu_torch.index.index import RaBitQIndex
from rabitq_tpu_torch.index.serialize import dump_to_dir, load_from_dir
from rabitq_tpu_torch.io import read_vecs, write_vecs
from rabitq_tpu_torch.parallel.sharding import (
    Mesh,
    ShardedIndex,
    pad_empty_shard,
)

logger = logging.getLogger(__name__)

_META = "meta.json"


def _shard_dir(path: Path, si: int) -> Path:
    return path / f"shard_{si:05d}"


def is_sharded_checkpoint(path: str | Path) -> bool:
    """True when ``path`` holds a dump_index_sharded checkpoint (a
    top-level meta.json with a shard count)."""
    meta = Path(path) / _META
    try:
        return "shards" in json.loads(meta.read_text())
    except (OSError, json.JSONDecodeError):
        return False


def dump_index_sharded(
    sindex: ShardedIndex,
    path: str | Path,
    *,
    global_pos: np.ndarray | None = None,
) -> None:
    """Write a sharded index as per-shard reference-format directories.

    A base-less index (keep_base=False) dumps without base.fvecs: pass
    ``global_pos`` (shard_global_positions, or build_index_sharded's
    ``return_global_pos``) so that the store tier's mapping survives."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    mesh = sindex.mesh
    if 0 in mesh.local_shards:
        shard0 = sindex.shards[0]
        (path / _META).write_text(json.dumps(dict(
            format=1,
            shards=mesh.size,
            dim=sindex.dim,
            dim_orig=sindex.dim_orig,
            capacity=sindex.capacity,
            metric=sindex.metric,
            code_bits=sindex.code_bits,
            dedup_ids=sindex.dedup_ids,
            k_max=sindex.k_max,
            rows_max=sindex.rows_max,
            tiles_max=sindex.tiles_max,
            memtable_slots=shard0.m,
            has_base=sindex.has_base,
            has_global_pos=global_pos is not None,
        )))
    for si, shard in sindex.local():
        sd = _shard_dir(path, si)
        n_real = int(shard.offsets[-1])  # 0 for a padded empty shard
        dump_to_dir(_real_rows(shard, n_real), sd, require_base=False)
        if global_pos is not None:
            gp = np.asarray(global_pos[si][:n_real], np.int32)
            write_vecs(sd / "global_pos.ivecs", [gp.astype(np.uint32)])
        logger.info("checkpoint: dumped shard %d (%d rows) to %s", si,
                    n_real, sd)


def _real_rows(shard: RaBitQIndex, n_real: int) -> RaBitQIndex:
    """The shard without the padding rows of an empty one (JAX dumps a
    shard's first offsets[-1] rows)."""
    if shard.n == n_real:
        return shard
    return dataclasses.replace(
        shard, codes=shard.codes[:n_real], factors=shard.factors[:n_real],
        map_ids=shard.map_ids[:n_real],
        base=None if shard.base is None else shard.base[:n_real])


def load_index_sharded(
    path: str | Path, mesh: Mesh, *, keep_base: bool = True
) -> ShardedIndex:
    """Load a dump_index_sharded checkpoint onto ``mesh``: each local
    shard's directory straight onto its device, one shard's host arrays
    at a time. The shard count must equal the mesh's (to re-shard, load
    each shard directory with load_shard_as_single and shard again, or
    rebuild). ``keep_base=False`` (or a checkpoint dumped without base)
    gives a base-less index for the store tier."""
    path = Path(path)
    meta = json.loads((path / _META).read_text())
    s = int(meta["shards"])
    if mesh.size != s:
        raise ValueError(f"checkpoint has {s} shards, the mesh {mesh.size}")
    keep_base = keep_base and bool(meta.get("has_base", True))
    k_max = int(meta["k_max"])
    shards: list = [None] * s
    for si in mesh.local_shards:
        shard: RaBitQIndex = load_from_dir(
            _shard_dir(path, si), keep_base=keep_base,
            device=mesh.devices[si])
        if shard.k != k_max:
            raise ValueError(f"shard {si} has {shard.k} clusters, meta.json "
                             f"k_max {k_max}")
        shards[si] = pad_empty_shard(shard, int(meta["rows_max"]))
        logger.info("checkpoint: loaded shard %d (%d rows) onto %s", si,
                    shard.n, mesh.devices[si])
    return ShardedIndex(shards, k_max, int(meta["rows_max"]),
                        int(meta["tiles_max"]), mesh)


def load_global_positions(path: str | Path) -> np.ndarray | None:
    """[S, rows_max] int32 global cluster-sorted positions (-1 pad) from a
    checkpoint dumped with ``global_pos=``; None when absent. The store
    tier's mapping for sharded_search_with_store."""
    path = Path(path)
    meta = json.loads((path / _META).read_text())
    if not meta.get("has_global_pos", False):
        return None
    out = np.full((int(meta["shards"]), int(meta["rows_max"])), -1, np.int32)
    for si in range(out.shape[0]):
        gp = read_vecs(_shard_dir(path, si) / "global_pos.ivecs", np.int32)[0]
        out[si, : gp.shape[0]] = gp
    return out


def load_shard_as_single(path: str | Path, si: int, **kw) -> RaBitQIndex:
    """One shard's directory as a standalone index (load_from_dir's
    keywords: keep_base, device, ...): debugging and re-sharding."""
    return load_from_dir(_shard_dir(Path(path), si), **kw)
