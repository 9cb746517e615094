"""IVF centroid training (port of rabitq_tpu.kmeans: kmeans and its
k-means|| seeding).

Lloyd's algorithm over row chunks: one fp32 distance matmul per chunk, then
per-cluster sums and counts by ``index_add_`` (which sums in an order that
can change from run to run on the GPU, so centroids may differ in the last
bits between runs).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from rabitq_tpu_torch.ops import pairwise_l2sq

logger = logging.getLogger(__name__)


def _nearest(
    x: torch.Tensor, c: torch.Tensor, chunk: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(min squared distance [n], nearest centroid [n]) of every row of x."""
    mind = torch.empty(x.shape[0], dtype=torch.float32, device=x.device)
    lab = torch.empty(x.shape[0], dtype=torch.int64, device=x.device)
    for a in range(0, x.shape[0], chunk):
        mind[a : a + chunk], lab[a : a + chunk] = pairwise_l2sq(
            x[a : a + chunk], c
        ).min(dim=-1)
    return mind, lab


def _weighted_means(
    x: torch.Tensor,
    lab: torch.Tensor,
    w: torch.Tensor | None,
    prev: torch.Tensor,
) -> torch.Tensor:
    """Per-cluster (weighted) means of x; empty clusters keep ``prev``."""
    k, d = prev.shape
    sums = torch.zeros((k, d), dtype=torch.float32, device=x.device)
    counts = torch.zeros(k, dtype=torch.float32, device=x.device)
    if w is None:
        sums.index_add_(0, lab, x)
        counts.index_add_(0, lab, torch.ones_like(lab, dtype=torch.float32))
    else:
        sums.index_add_(0, lab, x * w[:, None])
        counts.index_add_(0, lab, w)
    return torch.where(
        counts[:, None] > 0, sums / torch.clamp(counts, min=1.0)[:, None], prev
    )


def _kmeans_parallel_init(
    x: torch.Tensor,
    k: int,
    generator: torch.Generator,
    *,
    rounds: int = 4,
    per_round: int = 0,
    lloyd_iters: int = 8,
    chunk: int = 8192,
) -> torch.Tensor:
    """k-means|| (parallel kmeans++) seeding, Bahmani et al. 2012.

    ``rounds`` rounds each draw ``per_round`` candidates without
    replacement with probability proportional to the current min-distance
    (Gumbel-top-k); the ~2k candidates are weighted by how many points
    they attract and reduced to k seeds by a few weighted Lloyd iterations
    on the candidate set.
    """
    n, _ = x.shape
    dev = x.device
    if per_round <= 0:
        per_round = max(1, -(-k // 2))
    first = x[torch.randint(n, (1,), generator=generator, device=dev)]
    mind = torch.sum((x - first) ** 2, dim=-1)
    cands = [first]
    for _ in range(rounds):
        e = torch.empty(n, dtype=torch.float32, device=dev)
        gumbel = -torch.log(e.exponential_(generator=generator))
        logw = torch.where(
            mind > 0, torch.log(torch.clamp(mind, min=1e-30)), -torch.inf
        )
        idx = torch.topk(logw + gumbel, min(per_round, n)).indices
        cr = x[idx]
        mind = torch.minimum(mind, _nearest(x, cr, chunk)[0])
        cands.append(cr)
    cands = torch.cat(cands)  # [m, d], m = 1 + rounds * per_round
    m = cands.shape[0]
    w = torch.bincount(_nearest(x, cands, chunk)[1], minlength=m).float()
    c = cands[torch.topk(w, k).indices]
    for _ in range(lloyd_iters):
        c = _weighted_means(cands, _nearest(cands, c, chunk)[1], w, c)
    return c


def _lloyd_iteration(
    x: torch.Tensor, centroids: torch.Tensor, chunk: int
) -> tuple[torch.Tensor, float]:
    """One Lloyd iteration: (new centroids, cost under the old ones)."""
    mind, lab = _nearest(x, centroids, chunk)
    return _weighted_means(x, lab, None, centroids), float(mind.sum())


def kmeans(
    x,
    k: int,
    *,
    iters: int = 25,
    generator: torch.Generator | None = None,
    chunk: int = 16384,
    tol: float = 1e-4,
    init: str = "kmeans++",
    init_sample_cap: int = 131072,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """Flat Lloyd k-means; returns [k, d] float32 centroids on ``device``.

    x: [n, d] numpy array or tensor. ``device`` defaults to x's device (for
    a tensor), else the generator's, else the CPU; ``generator`` (default:
    seed 0 on ``device``) drives every random draw. Init: k-means|| on a
    subsample of at most ``init_sample_cap`` rows, or ``init="random"``
    for uniform sampling. Empty clusters keep their previous centroid.
    Stops early when the relative cost improvement drops below ``tol``.
    """
    if init not in ("kmeans++", "random"):
        raise ValueError(f"unknown init {init!r}")
    if device is None:
        if isinstance(x, torch.Tensor):
            device = x.device
        elif generator is not None:
            device = generator.device
        else:
            device = "cpu"
    if not isinstance(x, torch.Tensor):
        x = np.asarray(x, dtype=np.float32)
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    if generator.device.type != x.device.type:
        raise ValueError(f"generator on {generator.device}, data on {x.device}")
    n, _ = x.shape
    k = min(k, n)

    def sample(size: int) -> torch.Tensor:
        return torch.randperm(n, generator=generator, device=x.device)[:size]

    if init == "random":
        centroids = x[sample(k)]
    else:
        cap = max(k, min(n, init_sample_cap))
        x_init = x[sample(cap)] if cap < n else x
        centroids = _kmeans_parallel_init(x_init, k, generator)

    prev_cost = np.inf
    for it in range(iters):
        centroids, cost = _lloyd_iteration(x, centroids, chunk)
        logger.debug("kmeans iter %d cost %.6g", it, cost)
        if prev_cost - cost <= tol * max(abs(prev_cost), 1e-30):
            break
        prev_cost = cost
    return centroids
