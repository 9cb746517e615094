"""Shared helpers of the port's parity tests (tests/test_torch_*.py)."""

from __future__ import annotations

import numpy as np

from rabitq_tpu_torch import index_from_arrays


def port_index_from_jax(jidx, device="cpu"):
    """The port's index holding exactly the arrays of a JAX-built index."""
    return index_from_arrays(
        codes_pm1=np.asarray(jidx.codes_pm1),
        factors_tiled=np.asarray(jidx.factors_tiled),
        offsets=np.asarray(jidx.offsets),
        map_ids=np.asarray(jidx.map_ids),
        centroids_rot=np.asarray(jidx.centroids_rot),
        orthogonal=np.asarray(jidx.orthogonal),
        rand_bias=np.asarray(jidx.rand_bias),
        base=None if jidx.base is None else np.asarray(jidx.base),
        dim=jidx.dim,
        dim_orig=jidx.dim_orig,
        capacity=jidx.capacity,
        metric=jidx.metric,
        code_bits=jidx.code_bits,
        dedup_ids=jidx.dedup_ids,
        device=device,
    )


def random_orthogonal(rng, dim):
    """A numpy rotation both packages can be handed as ``orthogonal=``."""
    q, r = np.linalg.qr(rng.standard_normal((dim, dim)))
    return (q * np.sign(np.diagonal(r))[None, :]).astype(np.float32)


def gist_like_corpus(seed=7, n=3000, nq=16, k=32):
    """A small 960-d corpus from the bench generator with k jittered
    centroids (no row equals its centroid: the JAX build gives such a row
    NaN factors at bits > 1) and a 1024-d rotation for both packages."""
    from bench import make_dataset

    base, queries = make_dataset(n, 960, 64, nq, seed=seed)
    rng = np.random.default_rng(seed)
    pick = base[rng.choice(n, k, replace=False)]
    centers = pick + 0.01 * rng.standard_normal(pick.shape).astype(np.float32)
    return base, queries, centers, random_orthogonal(rng, 1024)
