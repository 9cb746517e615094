"""The port's examples (rabitq_tpu_torch/examples/) on the CPU at their
JAX examples' sizes, each result held against brute force.

The examples' corpora are i.i.d. Gaussian, as the JAX examples': no
cluster structure, so a search at probe 16 of 128-512 clusters finds
40-60% of the true top-5 (the floors below), while the certified adaptive
search, and autotune's pick, find them all or nearly all. Every returned
distance must be its id's exact distance, and a query that is a base row
(or nearly) must find that row first.
"""

import numpy as np
import pytest
import torch

import rabitq_tpu_torch as rt
from rabitq_tpu_torch.examples import disk_tier, distributed, mutations
from rabitq_tpu_torch.examples import quickstart


def brute(base, queries, topk, metric="l2"):
    if metric == "cosine":
        base = base / np.linalg.norm(base, axis=1, keepdims=True)
        queries = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    d = ((queries[:, None, :].astype(np.float64) - base[None]) ** 2).sum(-1)
    return np.argsort(d, axis=1)[:, :topk]


def recall(ids, truth):
    return np.mean([len(set(a) & set(b)) / len(b)
                    for a, b in zip(ids, truth)])


def assert_exact(base, queries, ids, dists):
    exact = ((base[ids] - queries[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(dists, exact, rtol=1e-5, atol=1e-4)
    assert (np.diff(dists, axis=1) >= 0).all()


def test_quickstart():
    out = quickstart.main(["--device", "cpu"])
    base, q = out["base"], out["queries"]
    truth = brute(base, q, 5)
    assert_exact(base, q, out["ids"], out["dists"])
    # Certified: the adaptive search returns the exact top-5.
    np.testing.assert_array_equal(np.sort(out["ids_adaptive"], 1),
                                  np.sort(truth, 1))
    assert out["probe_used"] >= 4
    assert recall(out["ids"], truth) >= 0.3
    assert recall(out["ids4"], truth) >= recall(out["ids"], truth)
    # autotune's pick meets its target against brute force.
    tuned = out["tuned"]
    assert tuned.topk == 5 and out["curve"][-1].recall >= 0.95
    _, ids = rt.search(out["index4"], torch.from_numpy(q), tuned)
    assert recall(ids.numpy(), truth) >= 0.95


def test_mutations():
    out = mutations.main(["--device", "cpu"])
    assert out["ids_inserted"][0] == 123456
    assert out["ids_updated"][0] == 123456
    assert 123456 not in out["ids_deleted"]
    live = np.setdiff1d(np.arange(30_000), [0, 1])
    assert out["n"] == live.size
    np.testing.assert_array_equal(np.sort(out["live_ids"]), live)
    truth = live[brute(out["base"][live], out["queries"], 5, "cosine")]
    # The queries are live base rows 2..9: each finds itself first.
    np.testing.assert_array_equal(out["ids_compacted"][:, 0], truth[:, 0])
    assert recall(out["ids_compacted"], truth) >= 0.4


def test_disk_tier():
    out = disk_tier.main(["--device", "cpu"])
    truth = brute(out["base"], out["queries"], 5)
    np.testing.assert_array_equal(out["ids"][:, 0], truth[:, 0])
    assert_exact(out["base"], out["queries"], out["ids"], out["dists"])
    assert recall(out["ids"], truth) >= 0.4


@pytest.mark.parametrize("shards", [3, 8])
def test_distributed(shards):
    out = distributed.main(["--device", "cpu", "--shards", str(shards)])
    truth = brute(out["base"], out["queries"], 5)
    np.testing.assert_array_equal(out["ids"][:, 0], truth[:, 0])
    assert recall(out["ids"], truth) >= 0.4
    np.testing.assert_array_equal(out["ids_store"][:, 0], out["ids"][:, 0])
    even = out["ids_even"]
    assert (even[even >= 0] % 2 == 0).all() and (even >= 0).any()
    assert out["served"][0] == out["ids"][0, 0]
