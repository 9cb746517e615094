"""The plain reference: exact nearest neighbours by brute force, and the
exact squared L2 of given rows, in plain PyTorch. It imports nothing of
the program and takes nothing the program made: only the benchmark's own
base rows and queries, and in a filtered cell its own allow-list, over
whose rows alone the brute force ranks."""

from __future__ import annotations

import torch

# Each chunk of base rows gives at most this many bytes of [nq, rows]
# distances.
CHUNK_BYTES = 1 << 30


def brute_force_topk(base, queries, k, allowed=None):
    """(squared distances [nq, k] f32, ids [nq, k] int64) of the ``k``
    nearest base rows of every query, ascending: ||q||^2 - 2<q, x> +
    ||x||^2 over row chunks of at most ``CHUNK_BYTES`` of distances, each
    chunk's top-k merged into the running one. The product runs in float32
    as the process sets it (the harness turns TF32 off). With ``allowed``
    (ids [m]) only those base rows are ranked."""
    if allowed is not None:
        d, i = brute_force_topk(base[allowed], queries, k)
        return d, allowed[i]
    nq, n = queries.shape[0], base.shape[0]
    rows = max(k, min(n, CHUNK_BYTES // (4 * max(nq, 1))))
    qq = (queries * queries).sum(1, keepdim=True)
    best_d = best_i = None
    for a in range(0, n, rows):
        xb = base[a : a + rows]
        d = torch.addmm((xb * xb).sum(1)[None, :] + qq, queries, xb.T,
                        alpha=-2.0)
        d, i = torch.topk(d, min(k, xb.shape[0]), dim=1, largest=False)
        i += a
        if best_d is not None:
            d, j = torch.topk(torch.cat([best_d, d], 1), k, dim=1,
                              largest=False)
            i = torch.gather(torch.cat([best_i, i], 1), 1, j)
        best_d, best_i = d, i
    return best_d.clamp_(min=0.0), best_i


def exact_sq_l2(base, queries, ids):
    """Squared L2 [nq, k] float64 between each query and the base rows its
    ``ids`` name, summed in float64; NaN where an id is negative."""
    ok = ids >= 0
    rows = base[ids.clamp(min=0)].double()
    d = ((rows - queries.double()[:, None, :]) ** 2).sum(-1)
    return torch.where(ok, d, torch.nan)


def hits(ids, truth):
    """Per query, how many of its ``ids`` are among its true neighbours."""
    return (ids[:, :, None] == truth[:, None, :]).any(-1).sum(-1)
