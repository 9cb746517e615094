"""The store tier: quantized state on the card, full-precision rows behind
a host store (the port's twin of examples/disk_tier.py).

The estimate runs on the card; only the rerank reads the host store (mmap
here; BlockCachedStore for object-store backends).

    python -m rabitq_tpu_torch.examples.disk_tier [--device cpu]
"""

from __future__ import annotations

import shutil
import tempfile
from pathlib import Path

import numpy as np

import rabitq_tpu_torch as rt
from rabitq_tpu_torch.examples._common import generator, parse
from rabitq_tpu_torch.index.serialize import dump_to_dir, load_from_dir
from rabitq_tpu_torch.store import MmapStore, search_with_store


def main(argv=None) -> dict:
    dev = parse(__doc__, argv).device
    rng = np.random.default_rng(0)
    base = rng.standard_normal((100_000, 64)).astype(np.float32)
    centroids = rt.kmeans(base, 512, generator=generator(dev, 0), device=dev)
    index = rt.build_index(base, centroids, generator=generator(dev, 1),
                           device=dev)

    workdir = Path(tempfile.mkdtemp())
    try:
        dump_to_dir(index, workdir / "index")
        # Reload without the full-precision vectors on the card.
        index_lean = load_from_dir(workdir / "index", keep_base=False,
                                   device=dev)
        store = MmapStore(workdir / "index" / "base.fvecs")
        # or: BlockCachedStore(FileBlockSource(...), index_lean.dim,
        #                      sqlite_path=...)
        # or, credentialed S3 (SigV4 from the env/profile chain,
        # AWS_ENDPOINT_URL for S3-compatible stores):
        #     BlockCachedStore(S3RangeSource("s3://bucket/idx/base.fvecs"),
        #                      dim)
        queries = base[:4]
        dists, ids = search_with_store(
            index_lean, queries,
            rt.SearchParams(probe=16, topk=5, rerank=100), store)
        print("ids:", ids)
        print("metrics:", rt.METRICS.to_str())
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    return dict(base=base, queries=queries, ids=ids, dists=dists)


if __name__ == "__main__":
    main()
