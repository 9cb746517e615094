"""Build an index and search it: a minimal end-to-end example (the port's
twin of examples/quickstart.py).

    python -m rabitq_tpu_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

import rabitq_tpu_torch as rt
from rabitq_tpu_torch.examples._common import generator, parse


def main(argv=None) -> dict:
    dev = parse(__doc__, argv).device
    rng = np.random.default_rng(0)
    base = rng.standard_normal((50_000, 128)).astype(np.float32)

    centroids = rt.kmeans(base, 256, generator=generator(dev, 0), device=dev)
    index = rt.build_index(base, centroids, generator=generator(dev, 1),
                           device=dev)

    queries = base[:8] + 0.01 * rng.standard_normal((8, 128)).astype(
        np.float32)
    q = torch.from_numpy(queries).to(dev)
    dists, ids = rt.search(index, q,
                           rt.SearchParams(probe=16, topk=5, rerank=100))
    print("ids:\n", ids.cpu().numpy())
    print("dists:\n", dists.cpu().numpy())

    # Early-stop variant: probes more clusters only until each query's
    # result is geometrically certified.
    _, ids_adaptive, probe_used = rt.search_adaptive(
        index, q, rt.SearchParams(probe=4, topk=5, rerank=100))
    print("adaptive probe used:", probe_used)

    # Multi-bit codes: the same scan cost, ~8x lower estimator error, so a
    # ~2x-topk rerank budget suffices. bits=1 stays reference-format
    # compatible.
    index4 = rt.build_index(base, centroids, generator=generator(dev, 1),
                            bits=4, device=dev)
    _, ids4 = rt.search(index4, q,
                        rt.SearchParams(probe=16, topk=5, rerank=16))
    print("bits=4 ids:\n", ids4.cpu().numpy())

    # Automatic tuning: the cheapest (probe, rerank) meeting a recall
    # target, measured on a query sample against exact ground truth.
    params, curve = rt.autotune(index4, queries, target_recall=0.95, topk=5)
    print("autotuned:", params.probe, params.rerank,
          [c.recall for c in curve])
    return dict(base=base, queries=queries, ids=ids.cpu().numpy(),
                dists=dists.cpu().numpy(),
                ids_adaptive=ids_adaptive.cpu().numpy(),
                probe_used=probe_used, ids4=ids4.cpu().numpy(),
                index4=index4, tuned=params, curve=curve)


if __name__ == "__main__":
    main()
