"""The port's adaptive search, annulus probe ranking and autotune against
the JAX package's, case for case with tests/test_adaptive.py and
tests/test_autotune.py.

Both packages search one JAX-built index (``port_of``): JAX with
``approx_select=False``, the port with ``select_reduce=False`` (JAX's CPU
path never folds). The certificate, ``probe_used`` and the autotune curve
must be equal; ids equal except at near-ties, distances to f32 rounding.
JAX's certificate case under ``rank_precision="default"`` (a bf16
ranking pass) has its counterpart in tests/test_torch_precision.py, held
to a numpy model of the pass (XLA on the CPU ignores Precision.DEFAULT);
here the case runs under ``probe_rank="annulus"``.

Two faults of the JAX package that the port guards are pinned: a cluster
whose first row is deleted bounds to +inf under the annulus ranking, and
``exact_topk`` names a spilled id twice (ROADMAP queue 3).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu_torch as rt
from conftest import brute_force_topk, make_clustered_dataset
from rabitq_tpu.autotune import autotune as jautotune
from rabitq_tpu.autotune import exact_topk as jexact_topk
from test_torch_mutate import assert_results_match, port_of

jsearch = importlib.import_module("rabitq_tpu.index.search")
tsearch = importlib.import_module("rabitq_tpu_torch.index.search")


def _params(**kw):
    """(JAX, port) SearchParams of one setting."""
    return (rq.SearchParams(approx_select=False, **kw),
            rt.SearchParams(select_reduce=False, **kw))


def _recall(truth, ids, topk=10):
    return np.mean([rt.calculate_recall(truth[i], ids[i], topk)
                    for i in range(ids.shape[0])])


def _adaptive_both(jidx, tidx, queries, params, **kw):
    jp, tp = params
    dj, ij, pj = jsearch.search_adaptive(jidx, jnp.asarray(queries), jp, **kw)
    dt, it, pt = rt.search_adaptive(tidx, torch.from_numpy(queries), tp, **kw)
    assert pt == pj
    assert_results_match((np.asarray(ij), np.asarray(dj)),
                         (it.numpy(), dt.numpy()))
    return dt.numpy(), it.numpy(), pt


def _certified_both(jidx, tidx, queries, params):
    jp, tp = params
    dj, ij, sj = jsearch._search_with_certificate(jidx, jnp.asarray(queries),
                                                  jp)
    dt, it, st = tsearch._search_with_certificate(
        tidx, torch.from_numpy(queries), tp)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    assert_results_match((np.asarray(ij), np.asarray(dj)),
                         (it.numpy(), dt.numpy()))
    return it.numpy(), st.numpy()


@pytest.fixture(scope="module")
def sound_case():
    rng = np.random.default_rng(42)
    base, centers = make_clustered_dataset(rng, n=2000, dim=32, k=16,
                                           spread=0.1)
    jidx = rq.build_index(base, centers, key=jax.random.key(1))
    queries = base[rng.choice(2000, 16, replace=False)] + (
        0.01 * rng.standard_normal((16, 32)).astype(np.float32)
    )
    return jidx, port_of(jidx), queries, brute_force_topk(base, queries, 10)


def test_certificate_is_sound(sound_case):
    """At full probe every query is certified and the result exact."""
    jidx, tidx, queries, truth = sound_case
    ids, safe = _certified_both(jidx, tidx, queries,
                                _params(probe=16, topk=10, rerank=2000))
    assert safe.all()
    assert _recall(truth, ids) == 1.0


def test_adaptive_stops_early_on_easy_queries(rng):
    base, centers = make_clustered_dataset(rng, n=3000, dim=48, k=32,
                                           spread=0.05)
    jidx = rq.build_index(base, centers, key=jax.random.key(2))
    queries = base[:8] + 1e-5
    _, ids, probe_used = _adaptive_both(
        jidx, port_of(jidx), queries, _params(probe=2, topk=5, rerank=200))
    assert probe_used < 32
    assert (ids[:, 0] == np.arange(8)).all()


@pytest.mark.parametrize("probe_rank", ["centroid", "annulus"])
def test_probe_lo_scans_only_the_slice(rng, probe_rank):
    """rough_scan with probe_lo returns exactly the columns [probe_lo,
    probe) of the full scan, and JAX's, in either ranking."""
    base, centers = make_clustered_dataset(rng, n=1500, dim=32, k=16)
    jidx = rq.build_index(base, centers, key=jax.random.key(5))
    tidx = port_of(jidx)
    q = base[:6]
    cap = tidx.capacity
    kw = dict(topk=5, rerank=64, probe_rank=probe_rank)
    full = tsearch.rough_scan(tidx, torch.from_numpy(q),
                              rt.SearchParams(probe=8, **kw))
    part = tsearch.rough_scan(tidx, torch.from_numpy(q),
                              rt.SearchParams(probe=8, probe_lo=5, **kw))
    assert part.rough.shape == (6, 3 * cap) and part.starts.shape == (6, 3)
    assert torch.equal(part.rough,
                       full.rough.reshape(6, 8, cap)[:, 5:].reshape(6, -1))
    assert torch.equal(part.starts, full.starts[:, 5:])
    assert 0 < int(part.n_scanned.sum()) < int(full.n_scanned.sum())
    jpart = jsearch.rough_scan(jidx, jnp.asarray(q), rq.SearchParams(
        probe=8, probe_lo=5, approx_select=False, **kw))
    np.testing.assert_array_equal(part.starts.numpy(),
                                  np.asarray(jpart.starts))
    np.testing.assert_array_equal(part.n_scanned.numpy(),
                                  np.asarray(jpart.n_scanned))


def test_adaptive_incremental_matches_single_shot(rng, monkeypatch):
    """Escalating through levels ends with the single-shot result at the
    final probe, with a memtable present; the levels partition the
    cluster ranks [0, probe_used)."""
    base, centers = make_clustered_dataset(rng, n=2000, dim=32, k=16,
                                           spread=0.4)
    jidx = rq.build_index(base, centers, key=jax.random.key(6))
    extra = rng.standard_normal((4, 32)).astype(np.float32)
    jidx = rq.insert(jidx, extra)
    tidx = port_of(jidx)
    queries = rng.standard_normal((8, 32)).astype(np.float32)
    params = _params(probe=2, topk=10, rerank=1999)

    windows = []
    stage = tsearch.rough_scan

    def spy(index, q, p, fold=0, **kw):
        windows.append((p.probe_lo, min(p.probe, index.k)))
        return stage(index, q, p, fold, **kw)

    monkeypatch.setattr(tsearch, "rough_scan", spy)
    dists, ids, probe_used = _adaptive_both(jidx, tidx, queries, params)
    monkeypatch.setattr(tsearch, "rough_scan", stage)

    windows.sort()
    assert windows[0][0] == 0 and windows[-1][1] == probe_used
    for (_, hi1), (lo2, _) in zip(windows, windows[1:]):
        assert lo2 == hi1, windows
    d1, i1 = rt.search(tidx, torch.from_numpy(queries),
                       params[1]._replace(probe=probe_used))
    np.testing.assert_array_equal(ids, i1.numpy())
    np.testing.assert_allclose(dists, d1.numpy(), rtol=1e-6, atol=1e-6)


def test_adaptive_expands_probe_when_needed(rng):
    base, centers = make_clustered_dataset(rng, n=2000, dim=32, k=16,
                                           spread=0.4)
    jidx = rq.build_index(base, centers, key=jax.random.key(3))
    queries = rng.standard_normal((8, 32)).astype(np.float32)
    truth = brute_force_topk(base, queries, 10)
    _, ids, probe_used = _adaptive_both(
        jidx, port_of(jidx), queries, _params(probe=1, topk=10, rerank=800))
    assert probe_used > 1
    assert _recall(truth, ids) >= 0.95


def test_certificate_sound_under_annulus_ranking(sound_case):
    """Under probe_rank="annulus" the certificate certifies the set the
    scan ranked: certified queries are exact, adaptive search too."""
    jidx, tidx, queries, truth = sound_case
    params = _params(probe=16, topk=10, rerank=2000, probe_rank="annulus")
    ids, safe = _certified_both(jidx, tidx, queries, params)
    assert safe.all() and _recall(truth, ids) == 1.0
    _, ids2, _ = _adaptive_both(jidx, tidx, queries, params)
    assert _recall(truth, ids2) == 1.0
    # Part-way, the certificates agree query for query.
    _certified_both(jidx, tidx, queries,
                    _params(probe=3, topk=10, rerank=2000,
                            probe_rank="annulus"))


def test_level_width_chunking_matches_unchunked(rng):
    """Fixed-width sub-calls (level_width below the level) return what the
    unchunked ladder returns."""
    base, centers = make_clustered_dataset(rng, n=3000, dim=48, k=32,
                                           spread=0.4)
    jidx = rq.build_index(base, centers, key=jax.random.key(9), spill=0.1)
    tidx = port_of(jidx)
    queries = base[rng.choice(3000, 12, replace=False)] + (
        0.3 * rng.standard_normal((12, 48)).astype(np.float32)
    )
    params = _params(probe=3, topk=5, rerank=64)
    d_ref, i_ref, p_ref = _adaptive_both(jidx, tidx, queries, params,
                                         level_width=10_000)
    d_chk, i_chk, p_chk = _adaptive_both(jidx, tidx, queries, params,
                                         level_width=4)
    assert p_ref == p_chk
    np.testing.assert_array_equal(i_ref, i_chk)
    np.testing.assert_allclose(d_ref, d_chk, rtol=1e-6, atol=1e-6)


def test_annulus_bound_survives_a_deleted_first_row(rng):
    """Delete the first row of cluster 0 and query its second row, with
    the annulus ranking at probe 2. The JAX package reads the cluster's
    r_lo off the tombstone's +inf cdsq, bounds the cluster to +inf and
    misses the row; the port's guard (r_lo = 0) finds it at distance 0."""
    base, centers = make_clustered_dataset(rng, n=2000, dim=32, k=8)
    jidx = rq.build_index(base, centers, key=jax.random.key(0), bits=4)
    off, mid = np.asarray(jidx.offsets), np.asarray(jidx.map_ids)
    live = int(mid[off[0] + 1])
    q = np.array(jidx.base)[off[0] + 1][None, :32]
    kw = dict(probe=2, topk=1, rerank=32, probe_rank="annulus")
    jp, tp = _params(**kw)
    _, i0 = rq.search(jidx, jnp.asarray(q), jp)
    assert int(i0[0, 0]) == live
    j2 = rq.delete(jidx, [int(mid[off[0]])])
    dj, ij = rq.search(j2, jnp.asarray(q), jp)
    assert int(ij[0, 0]) != live and float(dj[0, 0]) > 1.0  # the JAX fault
    t2 = rt.delete(port_of(jidx), [int(mid[off[0]])])
    dt, it = rt.search(t2, torch.from_numpy(q), tp)
    assert int(it[0, 0]) == live and float(dt[0, 0]) == 0.0
    r_lo, _ = tsearch._cluster_radius_band(t2)
    assert float(r_lo[0]) == 0.0 and torch.isfinite(r_lo).all()


# --- autotune (tests/test_autotune.py) ---------------------------------


def _clustered(rng, n=3000, dim=48, k=24):
    centers = rng.standard_normal((k, dim)).astype(np.float32)
    base = (
        centers[rng.integers(0, k, n)]
        + 0.25 * rng.standard_normal((n, dim)).astype(np.float32)
    ).astype(np.float32)
    return base, centers


@pytest.fixture
def trng():
    return np.random.default_rng(11)


def test_exact_topk_matches_brute_force(trng):
    base, centers = _clustered(trng)
    jidx = rq.build_index(base, centers, key=jax.random.key(3))
    queries = base[:32] + 0.01 * trng.standard_normal((32, 48)).astype(
        np.float32)
    got = rt.exact_topk(port_of(jidx), queries, topk=10, chunk=1024)
    want = brute_force_topk(base, queries, 10)
    jgot = jexact_topk(jidx, queries, topk=10, chunk=1024)
    for b in range(32):
        assert set(got[b]) == set(want[b]) == set(jgot[b]), b


def test_exact_topk_sees_mutations(trng):
    base, centers = _clustered(trng, n=1200)
    jidx = rq.build_index(base, centers, key=jax.random.key(3))
    q = base[:8].copy()
    new_id = 1_000_000
    tidx = rt.delete(rt.insert(port_of(jidx), q[:1], ids=np.array([new_id])),
                     np.array([5]))
    jidx = rq.delete(rq.insert(jidx, q[:1], ids=np.array([new_id])),
                     np.array([5]))
    got = rt.exact_topk(tidx, q, topk=5, chunk=512)
    jgot = jexact_topk(jidx, q, topk=5, chunk=512)
    # The inserted duplicate ties exactly with base row 0.
    assert new_id in set(got[0]) and 0 in set(got[0])
    assert not np.isin(5, got)
    for b in range(8):
        assert set(got[b]) == set(jgot[b]), b


def test_exact_topk_names_each_spilled_id_once(trng):
    """A spilled build stores boundary rows twice; the port's truth names
    each id once and equals brute force over the corpus, where the JAX
    package's repeats ids."""
    base, centers = _clustered(trng, n=3000, dim=32, k=16)
    jidx = rq.build_index(base, centers, key=jax.random.key(0), bits=4,
                          spill=0.2)
    queries = base[:64] + 0.01
    got = rt.exact_topk(port_of(jidx), queries, topk=10, chunk=1024)
    want = brute_force_topk(base, queries, 10)
    for b in range(64):
        assert len(set(got[b])) == 10 and set(got[b]) == set(want[b]), b
    jgot = jexact_topk(jidx, queries, topk=10)
    assert any(len(set(r.tolist())) < 10 for r in jgot)  # the JAX fault


def test_autotune_reaches_target_and_curve_is_monotoneish(trng):
    base, centers = _clustered(trng, n=4000, dim=32, k=32)
    jidx = rq.build_index(base, centers, key=jax.random.key(5), bits=4)
    tidx = port_of(jidx)
    sample = base[:64] + 0.02 * trng.standard_normal((64, 32)).astype(
        np.float32)
    kw = dict(target_recall=0.9, topk=10, ladder=(2, 4, 8, 16, 32))
    params, curve = rt.autotune(
        tidx, sample, base_params=rt.SearchParams(select_reduce=False), **kw)
    jparams, jcurve = jautotune(
        jidx, sample, base_params=rq.SearchParams(approx_select=False), **kw)
    assert [tuple(p) for p in curve] == [tuple(p) for p in jcurve]
    assert (params.probe, params.rerank) == (jparams.probe, jparams.rerank)
    assert curve[-1].probe == params.probe and curve[-1].recall >= 0.9
    for pt in curve[:-1]:
        assert pt.recall < 0.9
    truth = rt.exact_topk(tidx, sample, 10)
    ids = rt.search(tidx, torch.from_numpy(sample), params)[1].numpy()
    assert _recall(truth, ids) >= 0.9 - 1e-9


def test_autotune_exhausted_ladder_returns_best(trng):
    base, centers = _clustered(trng, n=2000, dim=32, k=16)
    jidx = rq.build_index(base, centers, key=jax.random.key(5))
    kw = dict(target_recall=1.1, topk=10, ladder=(2, 4, 16))
    params, curve = rt.autotune(port_of(jidx), base[:32], **kw)
    _, jcurve = jautotune(jidx, base[:32], **kw)
    assert [(p.probe, p.rerank) for p in curve] == [
        (p.probe, p.rerank) for p in jcurve]
    best = max(curve, key=lambda p: p.recall)
    assert params.probe == best.probe
    assert curve[-1].probe == min(16, jidx.k)


def test_autotune_respects_base_params(trng):
    base, centers = _clustered(trng, n=1500, dim=32, k=16)
    tidx = port_of(rq.build_index(base, centers, key=jax.random.key(5)))
    bp = rt.SearchParams(probe_rank="annulus", fold_depth=1)
    params, _ = rt.autotune(tidx, base[:16], target_recall=0.5, topk=5,
                            ladder=(4, 8), base_params=bp)
    assert params.probe_rank == "annulus"
    assert params.fold_depth == 1
    assert params.topk == 5
