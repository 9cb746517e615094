"""Whole-slice parity: the port's search against the JAX package's CPU path.

A JAX-built index goes through ``index_from_arrays`` and both packages
search it with exact candidate selection. Ids must be equal except at
near-ties (distances of the two results within rtol 1e-5 wherever the ids
differ), the returned distances within rtol 1e-5, and recall against brute
force equal within 0.005.
"""

import importlib
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu_torch as rt
from bench import make_dataset
from conftest import brute_force_topk
from rabitq_tpu_torch.index.search import SearchStats
from rabitq_tpu_torch.metrics import METRICS, record_search_stats
from torch_parity import port_index_from_jax, random_orthogonal

# The package exports a ``search`` function that shadows the module name.
jsearch = importlib.import_module("rabitq_tpu.index.search")

REPO = Path(__file__).resolve().parents[1]
TOPK = 10


def _recall(truth, ids):
    return np.mean([rt.calculate_recall(t, i, TOPK) for t, i in zip(truth, ids)])


def _assert_results_match(d_got, i_got, d_want, i_want):
    d_got, i_got = np.asarray(d_got), np.asarray(i_got)
    d_want, i_want = np.asarray(d_want), np.asarray(i_want)
    np.testing.assert_allclose(d_got, d_want, rtol=1e-5, atol=1e-6)
    differ = i_got != i_want
    assert differ.mean() <= 0.02, differ.mean()
    # Where ids differ, the two candidates tie to f32 rounding.
    np.testing.assert_allclose(d_got[differ], d_want[differ], rtol=1e-5)


def _centers(rng, base, k):
    """Jittered base rows: no row equals its centroid (the JAX build gives
    such a row NaN factors at bits > 1; see test_row_at_its_centroid)."""
    pick = base[rng.choice(base.shape[0], k, replace=False)]
    return pick + 0.01 * rng.standard_normal(pick.shape).astype(np.float32)


@pytest.fixture(scope="module")
def corpus():
    base, queries = make_dataset(4000, 96, 128, 24, seed=5)
    return base, queries, brute_force_topk(base, queries, TOPK)


@pytest.mark.parametrize(
    "bits,spill,metric,dither",
    [
        (1, 0.0, "l2", False),
        (4, 0.2, "l2", False),
        (4, 0.2, "l2", True),
        (4, 0.0, "cosine", False),
    ],
)
def test_search_matches_jax_on_jax_index(corpus, bits, spill, metric, dither):
    base, queries, truth = corpus
    rng = np.random.default_rng(1)
    centers = _centers(rng, base, 24)
    jidx = rq.build_index(
        base, centers, key=jax.random.key(4), bits=bits, spill=spill,
        metric=metric, balance=1.5,
    )
    pidx = port_index_from_jax(jidx)
    jp = rq.SearchParams(
        probe=6, topk=TOPK, rerank=40, dither=dither, select_mode="exact"
    )
    tp = rt.SearchParams(probe=6, topk=TOPK, rerank=40, dither=dither)
    dj, ij = rq.search(jidx, jnp.asarray(queries), jp)
    dt, it, stats = rt.search_with_stats(pidx, torch.from_numpy(queries), tp)
    _assert_results_match(dt, it, dj, ij)
    if metric == "l2":
        assert abs(_recall(truth, it.numpy()) - _recall(truth, np.asarray(ij))) <= 0.005
    jstats = jsearch.search_with_stats(jidx, jnp.asarray(queries), jp)[2]
    np.testing.assert_array_equal(stats.rough.numpy(), np.asarray(jstats.rough))
    np.testing.assert_array_equal(
        stats.precise.numpy(), np.asarray(jstats.precise)
    )


def test_port_build_and_search_match_jax(corpus):
    """The port's own build searched by the port, against the JAX build
    searched by JAX, given the same centroids and rotation."""
    base, queries, truth = corpus
    rng = np.random.default_rng(2)
    centers = _centers(rng, base, 32)
    kw = dict(orthogonal=random_orthogonal(rng, 128), bits=4, spill=0.2,
              balance=1.5)
    jidx = rq.build_index(base, centers, key=jax.random.key(0), **kw)
    pidx = rt.build_index(base, centers, **kw)
    dj, ij = rq.search(
        jidx, jnp.asarray(queries),
        rq.SearchParams(probe=8, topk=TOPK, rerank=32, select_mode="exact"),
    )
    dt, it = rt.search(
        pidx, torch.from_numpy(queries),
        rt.SearchParams(probe=8, topk=TOPK, rerank=32),
    )
    _assert_results_match(dt, it, dj, ij)
    assert abs(_recall(truth, it.numpy()) - _recall(truth, np.asarray(ij))) <= 0.005


def test_kmeans_build_search_many_end_to_end(corpus):
    base, queries, truth = corpus
    c = rt.kmeans(base, 32, iters=10)
    idx = rt.build_index(base, c, bits=4, spill=0.2, balance=1.5)
    params = rt.SearchParams(probe=12, topk=TOPK, rerank=32)
    d, ids = rt.search_many(idx, torch.from_numpy(queries).reshape(3, 8, -1), params)
    assert d.shape == ids.shape == (3, 8, TOPK)
    ids = ids.reshape(-1, TOPK).numpy()
    assert _recall(truth, ids) >= 0.9
    for row in ids:  # deduped: every id at most once per query
        assert len(set(row.tolist())) == TOPK
    d1, i1 = rt.search(idx, torch.from_numpy(queries[:8]), params)
    assert torch.equal(i1, torch.from_numpy(ids[:8]))
    assert torch.all(d1[:, 1:] >= d1[:, :-1])


def test_unreachable_slots_are_inf_and_minus_one(corpus):
    base, queries, _ = corpus
    rng = np.random.default_rng(3)
    idx = rt.build_index(base[:300], base[rng.choice(300, 16, replace=False)])
    d, ids = rt.search(
        idx, torch.from_numpy(queries[:4]),
        rt.SearchParams(probe=1, topk=50, rerank=50),  # clusters of ~19
    )
    unreached = ~torch.isfinite(d)
    assert unreached.any()
    assert (ids[unreached] == -1).all() and (ids[~unreached] >= 0).all()


@pytest.mark.parametrize("bits", [1, 4])
def test_row_at_its_centroid(corpus, bits):
    """A row equal to its centroid (zero residual) gets a valid code and
    finite factors, and a query at that row finds it at distance 0."""
    base, _, _ = corpus
    idx = rt.build_index(base, base[:16], bits=bits)
    assert torch.isfinite(idx.factors).all()
    d, ids = rt.search(
        idx, torch.from_numpy(base[:16]), rt.SearchParams(probe=2, topk=1, rerank=16)
    )
    np.testing.assert_array_equal(ids[:, 0].numpy(), np.arange(16))
    np.testing.assert_array_equal(d[:, 0].numpy(), 0.0)


def test_record_search_stats():
    METRICS.reset()
    stats = SearchStats(
        rough=torch.tensor([5, 7, 100]), precise=torch.tensor([2, 3, 50])
    )
    record_search_stats(stats)
    assert (METRICS.rough, METRICS.precise) == (112, 55)
    assert "ratio: 2.04" in METRICS.to_str()
    METRICS.reset()


def test_search_params_cap_probe_and_rerank(corpus):
    """probe beyond k and rerank beyond the scannable rows are capped: the
    results equal those at probe = k and R = every row."""
    base, queries, _ = corpus
    idx = rt.build_index(base[:500], base[:8])
    q = torch.from_numpy(queries[:4])
    d_big, i_big = rt.search(idx, q, rt.SearchParams(probe=50, rerank=10**6))
    d_cap, i_cap = rt.search(idx, q, rt.SearchParams(probe=8, rerank=idx.n))
    assert torch.equal(i_big, i_cap) and torch.equal(d_big, d_cap)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, rabitq_tpu_torch, rabitq_tpu_torch.index.search, "
        "rabitq_tpu_torch.index.build, rabitq_tpu_torch.ops._cuda; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'rabitq_tpu' or m.startswith('rabitq_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], env=_env(), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_fails_fast_without_a_gpu():
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], env=_env(), cwd=REPO,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert time.perf_counter() - t0 < 60


def test_chip_smoke_dataset_is_bench_dataset():
    sys.path.insert(0, str(REPO))
    import chip_smoke

    for a, b in zip(
        chip_smoke.make_dataset(500, 128, 16, 7, seed=0),
        make_dataset(500, 128, 16, 7, seed=0),
    ):
        np.testing.assert_array_equal(a, b)
