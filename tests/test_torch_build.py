"""Parity of the port's build and k-means with the JAX package's.

Both packages get the same corpus, centroids and rotation (``orthogonal=``):
their random draws differ, so builds from one seed are never compared.
Offsets, map_ids and codes must be equal except rows within f32 rounding of
a tie (the balancing eviction order, the grid-scale pick; at most 0.1% of
rows, matched by (id, cluster)). Factors of the rows whose codes agree must
be within rtol 1e-5 (f32 sums in a different order), except the error bound: err = c*sqrt((|r|/x_dot)^2 -
|r|^2) cancels badly at x_dot ~ 0.99 (bits=4), so it is held to an absolute
1e-5*|r| instead. k-means is compared by cost, within 2%, on the main
path's data generator (bench.make_dataset), whose local optima lie within
about 1% of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu.index.build as jbuild
import rabitq_tpu.kmeans as jkmeans
import rabitq_tpu_torch as rt
import rabitq_tpu_torch.index.build as tbuild
from bench import make_dataset
from conftest import make_clustered_dataset
from rabitq_tpu.ops import pairwise_l2sq
from torch_parity import (
    gist_like_corpus,
    port_index_from_jax,
    random_orthogonal,
)

MAX_TIE_ROWS = 1e-3


def _skewed(rng, n, dim):
    """Zipf-sized blobs: one hot cluster forces eviction and a split."""
    centers = rng.standard_normal((16, dim)).astype(np.float32)
    w = 1.0 / np.arange(1, 17) ** 1.5
    lab = rng.choice(16, size=n, p=w / w.sum())
    x = centers[lab] + 0.05 * rng.standard_normal((n, dim))
    return x.astype(np.float32), centers


@pytest.mark.parametrize(
    "bits,spill,metric,skewed",
    [
        (1, 0.0, "l2", False),
        (1, 0.2, "l2", False),
        (4, 0.0, "l2", False),
        (4, 0.2, "l2", False),
        (4, 0.2, "cosine", False),
        (4, 0.0, "l2", True),
    ],
)
def test_build_matches_jax(bits, spill, metric, skewed):
    rng = np.random.default_rng(7)
    if skewed:
        # One eviction tie moves a row AND shifts one row across each
        # boundary of the split segments: n large enough for that chain.
        base, centers = _skewed(rng, 4000, 64)
    else:
        base, centers = make_clustered_dataset(rng, n=3000, dim=64, k=16)
    p = random_orthogonal(rng, 128)
    kw = dict(orthogonal=p, bits=bits, spill=spill, metric=metric, balance=1.5)
    jidx = rq.build_index(base, centers, key=jax.random.key(0), **kw)
    got = rt.build_index(base, centers, device="cpu", **kw)
    _assert_build_matches(got, port_index_from_jax(jidx), p, spill)
    if skewed:
        assert got.k > centers.shape[0]  # the split happened in both


def test_build_matches_jax_at_960d():
    """The GIST width: dim 960 pads to 1024 in both packages. With 1024
    coordinates a row, more rows hold one coordinate within f32 rounding
    of a grid step's rounding boundary: codes may differ in at most 1e-5
    of all elements (about 1% of rows), each by one grid step (2)."""
    base, _, centers, p = gist_like_corpus()
    kw = dict(orthogonal=p, bits=4, spill=0.2, balance=1.5)
    jidx = rq.build_index(base, centers, key=jax.random.key(0), **kw)
    got = rt.build_index(base, centers, device="cpu", **kw)
    want = port_index_from_jax(jidx)
    assert (got.dim, got.dim_orig) == (1024, 960)
    np.testing.assert_array_equal(got.offsets.numpy(), want.offsets.numpy())
    np.testing.assert_array_equal(got.map_ids.numpy(), want.map_ids.numpy())
    diff = got.codes.numpy().astype(np.int32) - want.codes.numpy()
    assert np.count_nonzero(diff) <= 1e-5 * diff.size
    assert np.isin(diff, (-2, 0, 2)).all()
    _assert_build_matches(got, want, p, 0.2, max_code_rows=1e-2)
    np.testing.assert_array_equal(got.base.numpy()[:, 960:], 0.0)


def _assert_build_matches(got, want, p, spill, max_code_rows=MAX_TIE_ROWS):
    sizes_g, sizes_w = (np.diff(i.offsets.numpy()) for i in (got, want))
    assert sizes_g.shape == sizes_w.shape
    assert np.abs(sizes_g - sizes_w).sum() <= 2 * MAX_TIE_ROWS * got.n
    for f in ("capacity", "dim", "dim_orig", "code_bits", "dedup_ids", "n"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.dedup_ids == (spill > 0)
    np.testing.assert_array_equal(got.orthogonal.numpy(), p)
    np.testing.assert_allclose(
        got.centroids_rot.numpy(), want.centroids_rot.numpy(),
        rtol=1e-5, atol=1e-5,
    )
    # Match rows by (id, cluster): a row placed differently at a tie shifts
    # the dense positions of everything after it in its cluster.
    kg, kw_ = _row_keys(got), _row_keys(want)
    _, rg, rw = np.intersect1d(kg, kw_, assume_unique=True, return_indices=True)
    assert 1 - rg.size / got.n <= MAX_TIE_ROWS
    same_code = (got.codes.numpy()[rg] == want.codes.numpy()[rw]).all(axis=1)
    assert (~same_code).mean() <= max_code_rows
    rg, rw = rg[same_code], rw[same_code]
    fg, fw = got.factors.numpy()[rg], want.factors.numpy()[rw]
    # ip, ppc, cdsq; ppc is exactly 0 where sum(v) == 0.
    np.testing.assert_allclose(
        fg[:, [0, 1, 3]], fw[:, [0, 1, 3]], rtol=1e-5, atol=1e-30
    )
    assert (np.abs(fg[:, 2] - fw[:, 2]) <= 1e-5 * np.sqrt(fw[:, 3])).all()
    np.testing.assert_array_equal(got.base.numpy()[rg], want.base.numpy()[rw])
    # Rows sorted by centroid distance within every cluster.
    cd = got.factors.numpy()[:, 3]
    same_cluster = np.diff(_row_cluster(got)) == 0
    assert (np.diff(cd)[same_cluster] >= 0).all()


def _row_cluster(idx):
    off = idx.offsets.numpy()
    return np.searchsorted(off, np.arange(idx.n), side="right") - 1


def _row_keys(idx):
    """One key per row: (original id, cluster). Unique even with spill,
    since a spilled copy never lands in its row's home cluster."""
    return idx.map_ids.numpy().astype(np.int64) * (idx.k + 1) + _row_cluster(idx)


def test_codes_lie_on_the_grid():
    rng = np.random.default_rng(3)
    base, centers = make_clustered_dataset(rng, n=800, dim=64, k=8)
    for bits in (1, 2, 4):
        idx = rt.build_index(base, centers, bits=bits, device="cpu")
        v = idx.codes.numpy().astype(np.int64)
        m = (1 << bits) - 1
        assert ((v + m) % 2 == 0).all() and np.abs(v).max() <= m
        assert idx.codes.dtype == torch.int8 and idx.factors.shape == (800, 4)


def test_numpy_helpers_match_jax():
    """balance_assignments, split_oversized_clusters and _spill_admit are
    copies of the JAX package's: same outputs on the same inputs."""
    rng = np.random.default_rng(5)
    n, k, top, d = 2000, 20, 4, 16
    labels = np.stack([rng.permutation(k)[:top] for _ in range(n)]).astype(
        np.int32
    )
    dists = np.sort(rng.random((n, top)).astype(np.float32), axis=1)
    for cap in (60, 100, 150):
        np.testing.assert_array_equal(
            tbuild.balance_assignments(labels, dists, k, cap),
            jbuild.balance_assignments(labels, dists, k, cap),
        )
    sizes = rng.integers(0, 500, k)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    for a, b in zip(
        tbuild.split_oversized_clusters(offsets, 128),
        jbuild.split_oversized_clusters(offsets, 128),
    ):
        np.testing.assert_array_equal(a, b)
    base = rng.standard_normal((n, d)).astype(np.float32)
    cents = rng.standard_normal((k, d)).astype(np.float32)
    home = labels[:, 0].copy()
    for mode in ("dist", "soar"):
        kw = dict(k=k, spill=0.2, spill_mode=mode, spill_soar_lambda=1.0,
                  balance=1.5, split=True)
        for a, b in zip(
            tbuild._spill_admit(labels, dists, home, base, cents, **kw),
            jbuild._spill_admit(labels, dists, home, base, cents, **kw),
        ):
            np.testing.assert_array_equal(a, b)


def test_build_rejects_bad_arguments():
    base = np.zeros((10, 8), np.float32)
    with pytest.raises(ValueError):
        rt.build_index(base, base[:2], bits=8, device="cpu")
    with pytest.raises(ValueError):
        rt.build_index(base, base[:2], metric="ip", device="cpu")
    with pytest.raises(ValueError):
        rt.build_index(base, base[:2], orthogonal=np.eye(8), device="cpu")


def _cost(x, c):
    d = np.asarray(pairwise_l2sq(jnp.asarray(x), jnp.asarray(c)))
    return d.min(axis=1).mean()


@pytest.mark.parametrize("k,dim", [(16, 128), (32, 64)])
def test_kmeans_cost_matches_jax(k, dim):
    x, _ = make_dataset(4000, dim, 256, 1, seed=3)
    cj = jkmeans.kmeans(x, k, iters=15, key=jax.random.key(1))
    ct = rt.kmeans(x, k, iters=15, generator=torch.Generator().manual_seed(1))
    assert ct.shape == (k, dim) and ct.dtype == torch.float32
    assert abs(_cost(x, ct.numpy()) / _cost(x, cj) - 1.0) <= 0.02


def test_kmeans_random_init_and_k_clamp():
    x, _ = make_dataset(2000, 32, 64, 1, seed=4)
    c = rt.kmeans(x, 16, iters=15, init="random", device="cpu")
    cj = jkmeans.kmeans(x, 16, iters=15, init="random", key=jax.random.key(2))
    assert abs(_cost(x, c.numpy()) / _cost(x, cj) - 1.0) <= 0.05
    assert rt.kmeans(x[:5], 16, device="cpu").shape == (5, 32)
    with pytest.raises(ValueError):
        rt.kmeans(x, 4, init="kmeans||", device="cpu")


_NO_DEVICE_CALLS = {
    "kmeans": lambda: rt.kmeans(np.zeros((10, 4), np.float32), 2),
    "build_index": lambda: rt.build_index(
        np.zeros((10, 8), np.float32), np.zeros((2, 8), np.float32)
    ),
    "gen_random_orthogonal": lambda: rt.ops.gen_random_orthogonal(8),
    "index_from_arrays": lambda: rt.index_from_arrays(
        codes_pm1=None, factors_tiled=None, offsets=None, map_ids=None,
        centroids_rot=None, orthogonal=None, rand_bias=None, base=None,
        dim=8, dim_orig=8, capacity=128, metric="l2", code_bits=1,
        dedup_ids=False,
    ),
}


@pytest.mark.parametrize("entry", sorted(_NO_DEVICE_CALLS))
def test_entry_points_default_to_the_card(entry):
    """Without a device, tensor or generator that names one, an entry point
    runs on CUDA: on a machine without a card it raises instead of
    carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default call would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _NO_DEVICE_CALLS[entry]()


def test_cpu_hints_keep_the_entry_points_on_the_cpu():
    """A CPU generator or a CPU tensor names the device."""
    x = torch.from_numpy(make_dataset(200, 16, 8, 1, seed=5)[0])
    assert rt.kmeans(x, 4, iters=2).device.type == "cpu"
    g = torch.Generator().manual_seed(0)
    assert rt.ops.gen_random_orthogonal(8, g).device.type == "cpu"
    c = rt.kmeans(x.numpy(), 4, iters=2, generator=g)
    assert rt.build_index(x.numpy(), c).codes.device.type == "cpu"
