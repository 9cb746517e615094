"""Synthetic corpora at a configuration's published shape, drawn on the
device from the run's seed in a few large calls.

The distributions are those of the repository's benchmark generators:
``manifold`` is a Gaussian mixture in a low-dimensional latent space,
linearly embedded in ``dim`` dimensions plus small ambient noise (cluster
structure whose neighbourhoods straddle partition boundaries, as real
SIFT and GIST descriptors have); ``blobs`` is well separated blobs whose
sizes follow Zipf's law.

A configuration's corpus is one fixed set of rows, as a real corpus is:
it is drawn from the configuration's ``structure_seed``, and so is the
k-means training sample. The run's seed draws the order of the base rows
and of the query pool, so every seed asks the same work of the index, on
batches made up otherwise; a seed that drew its own rows could change the
index's shape (a split cluster) and with it the work. The first ``rows``
rows are the base, the rest the pool.

A filtered cell's allow-list (``allowed_ids``) is one fixed set of corpus
rows too, drawn from ``structure_seed`` on a stream of its own after
nothing else, so the rows above are the same with or without it; a run
sees it in its own ids, through its base order.
"""

from __future__ import annotations

import math

import torch


FILTER = 4  # the stream of a corpus's allow-list


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on ``device`` for one random stream of ``seed``: a
    run's order (0) and build (2), or a corpus's rows (3), k-means (1) and
    allow-list (``FILTER``). Streams past 3 set bit 62 of the key, which
    no (seed, stream) pair below it reaches."""
    g = torch.Generator(device=device)
    key = (seed << 2) | (stream & 3) | (stream >> 2) << 62
    g.manual_seed(key & ((1 << 63) - 1))
    return g


def manifold(n, dim, data, gen, device):
    k, d_int = data["centers"], data["latent_dim"]
    centers = torch.randn((k, d_int), generator=gen, device=device)
    a = torch.randn((d_int, dim), generator=gen, device=device)
    a.div_(math.sqrt(d_int))
    lab = torch.randint(0, k, (n,), generator=gen, device=device)
    z = centers[lab]
    z.add_(torch.randn((n, d_int), generator=gen, device=device),
           alpha=data["spread"])
    x = torch.randn((n, dim), generator=gen, device=device)
    x.mul_(data["noise"])
    return x.addmm_(z, a)


def blobs(n, dim, data, gen, device):
    k = data["centers"]
    centers = torch.randn((k, dim), generator=gen, device=device)
    w = torch.arange(1, k + 1, dtype=torch.float64, device=device)
    w = w.pow_(-data["zipf"])
    lab = torch.multinomial(w, n, replacement=True, generator=gen)
    x = torch.randn((n, dim), generator=gen, device=device)
    x.mul_(data["spread"])
    return x.add_(centers[lab])


GENERATORS = {"manifold": manifold, "blobs": blobs}


def make(config: dict, pool: int, seed: int, device):
    """(base [rows, dim], queries [pool, dim], train [train_rows, dim])
    float32 on ``device``: the corpus's base rows and query pool in the
    order ``seed`` draws, and its k-means training rows."""
    data, rows = config["data"], config["rows"]
    g = generator(data["structure_seed"], 3, device)
    x = GENERATORS[data["generator"]](rows + pool, config["dim"], data, g,
                                      device)
    train = x[torch.randperm(rows, generator=g, device=device)[
        : config["kmeans"]["train_rows"]]]
    order = generator(seed, 0, device)
    base = x[:rows][torch.randperm(rows, generator=order, device=device)]
    queries = x[rows:][torch.randperm(pool, generator=order, device=device)]
    return base, queries, train


def allowed_ids(config: dict, fraction: float, seed: int, device):
    """Run ids [m] int64, ascending, of the corpus rows the allow-list
    keeps: ``round(fraction * rows)`` of them, uniform and unrelated to
    the vectors, drawn from the corpus's ``structure_seed``; a run's id i
    holds the corpus row that ``make``'s base order (the first draw of
    ``seed``'s order stream) puts there."""
    rows = config["rows"]
    g = generator(config["data"]["structure_seed"], FILTER, device)
    keep = torch.zeros(rows, dtype=torch.bool, device=device)
    keep[torch.randperm(rows, generator=g, device=device)[
        : round(fraction * rows)]] = True
    order = torch.randperm(rows, generator=generator(seed, 0, device),
                           device=device)
    return torch.nonzero(keep[order]).squeeze(1)
