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
