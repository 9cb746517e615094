"""The port's hierarchical k-means and nearest-centroid assignment
(rabitq_tpu_torch.kmeans) against the JAX package's, on the CPU.

``assign`` must give JAX's labels exactly on data without near-ties. The
tree draws its samples from another generator than JAX's, so builds are
compared by structure (T * D finite centroids) and by cost, within 5% of
JAX's tree on the same data, never seed for seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu.kmeans as jkmeans
from bench import make_dataset
from rabitq_tpu.ops import pairwise_l2sq
from rabitq_tpu_torch.kmeans import assign, hierarchical_kmeans


def _cost(x, c):
    d = np.asarray(pairwise_l2sq(jnp.asarray(x), jnp.asarray(c)))
    return d.min(axis=1).mean()


@pytest.mark.parametrize("chunk", [4096, 1000])
def test_assign_matches_jax(chunk):
    x, _ = make_dataset(5000, 48, 64, 1, seed=6)
    c = x[np.random.default_rng(6).choice(5000, 40, replace=False)] + 0.01
    want = jkmeans.assign(x, c)
    got = assign(x, torch.from_numpy(c), chunk=chunk)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # A tensor corpus and numpy centroids (then on the CPU) give the same.
    np.testing.assert_array_equal(assign(torch.from_numpy(x), c), want)


@pytest.mark.parametrize("t,d_sub", [(4, 8), (8, 4)])
def test_hierarchical_kmeans_cost_matches_jax(t, d_sub):
    x, _ = make_dataset(3000, 32, 128, 1, seed=7)
    cj = jkmeans.hierarchical_kmeans(x, t, d_sub, iters=8,
                                     key=jax.random.key(1))
    ct = hierarchical_kmeans(x, t, d_sub, iters=8,
                             generator=torch.Generator().manual_seed(1))
    assert ct.shape == (t * d_sub, 32) and ct.dtype == torch.float32
    assert ct.device.type == "cpu" and torch.isfinite(ct).all()
    assert abs(_cost(x, ct.numpy()) / _cost(x, cj) - 1.0) <= 0.05


def test_hierarchical_kmeans_small_top_clusters():
    """A top cluster with fewer members than d_sub repeats its centroids
    up to d_sub; the result always has t * d_sub rows."""
    rng = np.random.default_rng(8)
    x = np.concatenate([
        rng.standard_normal((400, 16)),
        100.0 + rng.standard_normal((3, 16)),  # a tiny, far cluster
    ]).astype(np.float32)
    c = hierarchical_kmeans(x, 2, 8, iters=5, device="cpu")
    assert c.shape == (16, 16) and torch.isfinite(c).all()
    far = c[(c.mean(dim=1) > 50)]
    assert far.shape[0] == 8  # the 3-member cluster's 3 centroids, repeated
    assert torch.unique(far, dim=0).shape[0] <= 3


def test_hierarchical_kmeans_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hierarchical_kmeans(np.zeros((10, 4), np.float32), 2, 2)


# Tree against flat k-means recall: the port's gap (flat - tree) must not
# exceed the JAX package's by more than this, on the mean of four seeds
# and two probes. Measured at this shape, the two packages' gaps
# (0.018-0.063) differed by at most 0.014 point for point, and their means
# by 0.003 (JAX 0.0366, port 0.0395).
TREE_GAP_TOL = 0.015


def test_tree_kmeans_recall_gap_matches_jax():
    """Flat and tree (T 16 x D 16, 64 sampled rows a centroid) centroids
    of each package, each built into the same port index (4 bits, balance
    1.5, one generator seed) and searched unfolded at probes 4 and 8 over
    1,000 queries: recall@10 against brute force. The tree costs recall in
    both packages; the port's tree must cost no more than JAX's."""
    import rabitq_tpu_torch as rt
    from rabitq_tpu_torch.tools.bench import ground_truth, recall_at

    base, q = make_dataset(40_000, 128, 256, 1000)
    truth = ground_truth(base, q, 10, "cpu")
    tree = dict(samples_per_centroid=64, iters=15)

    def recalls(c):
        idx = rt.build_index(base, c, bits=4, balance=1.5, device="cpu",
                             generator=torch.Generator().manual_seed(2))
        return [recall_at(rt.search(idx, torch.from_numpy(q), rt.SearchParams(
            probe=p, topk=10, rerank=32, select_reduce=False))[1].numpy(),
            truth) for p in (4, 8)]

    gaps = {"jax": [], "port": []}
    for seed in range(4):
        jf = jkmeans.kmeans(base, 256, iters=15, key=jax.random.key(seed))
        jt = jkmeans.hierarchical_kmeans(base, 16, 16,
                                         key=jax.random.key(seed), **tree)
        gen = torch.Generator().manual_seed
        tf = rt.kmeans(base, 256, iters=15, device="cpu", generator=gen(seed))
        tt = hierarchical_kmeans(base, 16, 16, device="cpu",
                                 generator=gen(seed), **tree)
        for pkg, (flat, tree_c) in (("jax", (jf, jt)), ("port", (tf, tt))):
            gaps[pkg] += [a - b
                          for a, b in zip(recalls(flat), recalls(tree_c))]
    jax_gap, port_gap = np.mean(gaps["jax"]), np.mean(gaps["port"])
    assert jax_gap > 0  # the tree costs recall at this shape
    assert port_gap <= jax_gap + TREE_GAP_TOL, gaps
