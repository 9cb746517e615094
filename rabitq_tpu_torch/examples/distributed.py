"""Search sharded over a mesh of devices (the port's twin of
examples/distributed.py).

A mesh is an explicit list of devices, one a shard; a device may repeat.
Here S shards share ``--device`` (one card, or the CPU), as the JAX
example's run on virtual CPU devices; ``make_mesh(n)`` takes one card a
shard. Any S works, more shards than clusters holding rows included (the
empty shards are padded and return nothing).

    python -m rabitq_tpu_torch.examples.distributed [--shards 4]
        [--device cpu]
"""

from __future__ import annotations

import dataclasses
import tempfile

import numpy as np
import torch

import rabitq_tpu_torch as rt
from rabitq_tpu_torch.examples._common import generator, parse
from rabitq_tpu_torch.parallel import (
    dump_index_sharded,
    load_index_sharded,
    make_mesh,
    make_sharded_row_filter,
    shard_global_positions,
    shard_index,
    sharded_search,
    sharded_search_with_store,
)
from rabitq_tpu_torch.service.server import BatchingEngine


class ArrayStore:
    """Rows by global cluster-sorted position (stands in for MmapStore)."""

    def __init__(self, mat):
        self._m = np.asarray(mat)
        self.dim = int(self._m.shape[1])

    def get_rows(self, pos):
        return self._m[pos]


def main(argv=None) -> dict:
    args = parse(__doc__, argv, lambda ap: ap.add_argument(
        "--shards", type=int, default=4, help="shards on the device"))
    dev = args.device
    rng = np.random.default_rng(0)
    base = rng.standard_normal((20_000, 64)).astype(np.float32)
    centroids = rt.kmeans(base, 128, generator=generator(dev, 0), device=dev)
    index = rt.build_index(base, centroids, generator=generator(dev, 1),
                           device=dev)

    mesh = make_mesh(devices=[dev] * args.shards)
    sharded = shard_index(index, mesh)
    print(f"index sharded over {mesh.size} shard(s) on {dev}")

    queries = base[:4]
    params = rt.SearchParams(probe=16, topk=5, rerank=100)
    q = torch.from_numpy(queries).to(dev)
    _, ids = sharded_search(sharded, q, params, mesh)
    ids = ids.cpu().numpy()
    print("ids:", ids)

    # The sharded store tier: no base on the devices; one host store
    # (indexed by global cluster-sorted position, the base.fvecs order)
    # serves every shard's rerank through a position map.
    store = ArrayStore(index.base.cpu().numpy())  # stands in for MmapStore
    baseless = dataclasses.replace(index, base=None)
    sharded_disk = shard_index(baseless, mesh)
    gpos = shard_global_positions(baseless, mesh.size)
    _, ids_store = sharded_search_with_store(sharded_disk, queries, params,
                                             mesh, store, gpos)
    assert np.array_equal(ids[:, 0], ids_store[:, 0])
    print("sharded disk-tier ids:", ids_store)

    # Sharded checkpoint: one reference-format directory a shard; loading
    # places each shard's arrays straight onto its device.
    with tempfile.TemporaryDirectory() as ckpt:
        dump_index_sharded(sharded, ckpt)
        reloaded = load_index_sharded(ckpt, mesh)
        _, ids_ckpt = sharded_search(reloaded, q, params, mesh)
        assert np.array_equal(ids_ckpt.cpu().numpy(), ids)
    print("checkpoint round-trip: identical results")

    # Filtered sharded search: an id predicate applied per shard.
    rf = make_sharded_row_filter(sharded, mesh,
                                 allow_ids=np.arange(0, 20_000, 2))
    _, ids_even = sharded_search(sharded, q, params, mesh, row_filter=rf)
    ids_even = ids_even.cpu().numpy()
    assert all(i % 2 == 0 for i in ids_even.ravel() if i >= 0)
    print("filtered sharded ids:", ids_even)

    # Serving: the micro-batching engine in front of the mesh, each batch
    # one sharded search (service.server --shards for the HTTP server).
    eng = BatchingEngine(sharded, mesh=mesh, max_batch=16)
    try:
        _, top = eng.submit(queries[0], 5, 16)
        assert top[0] == ids[0, 0]
        print("mesh-served top hit:", top[0])
    finally:
        eng.close()
    return dict(base=base, queries=queries, ids=ids, ids_store=ids_store,
                ids_even=ids_even, served=np.asarray(top))


if __name__ == "__main__":
    main()
