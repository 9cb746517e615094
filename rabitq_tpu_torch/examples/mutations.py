"""Insert, update, delete and compact, and the cosine metric (the port's
twin of examples/mutations.py).

    python -m rabitq_tpu_torch.examples.mutations [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import rabitq_tpu_torch as rt
from rabitq_tpu_torch.examples._common import generator, parse


def main(argv=None) -> dict:
    dev = parse(__doc__, argv).device
    rng = np.random.default_rng(0)
    base = rng.standard_normal((30_000, 64)).astype(np.float32)
    centroids = rt.kmeans(base, 128, generator=generator(dev, 0), device=dev)
    index = rt.build_index(base, centroids, generator=generator(dev, 1),
                           metric="cosine", device=dev)
    params = rt.SearchParams(probe=16, topk=5, rerank=100)

    def top(idx, vec):
        return rt.search(idx, torch.from_numpy(vec).to(dev),
                         params)[1].cpu().numpy()[0]

    new_vec = rng.standard_normal((1, 64)).astype(np.float32)
    index = rt.insert(index, new_vec, ids=[123456])
    ids_inserted = top(index, new_vec)
    assert 123456 in ids_inserted, "inserted vector should be found"

    moved = rng.standard_normal((1, 64)).astype(np.float32)
    index = rt.update(index, moved, ids=[123456])  # replace, same id
    ids_updated = top(index, moved)
    assert 123456 in ids_updated, "updated vector keeps its id"

    index = rt.delete(index, [123456, 0, 1])
    ids_deleted = top(index, moved)
    assert 123456 not in ids_deleted

    index, live_ids = rt.compact(index)  # fold memtable, drop tombstones
    print("compacted to", index.n, "vectors (ids preserved)")
    queries = base[2:10]
    ids_compacted = rt.search(index, torch.from_numpy(queries).to(dev),
                              params)[1].cpu().numpy()
    return dict(base=base, queries=queries, ids_inserted=ids_inserted,
                ids_updated=ids_updated, ids_deleted=ids_deleted,
                live_ids=live_ids, ids_compacted=ids_compacted,
                n=index.n)


if __name__ == "__main__":
    main()
