"""The port's reduced-precision search options against the JAX package's,
on the CPU: the bf16 two-level rerank (``with_bf16_base``,
``SearchParams.rerank_bf16`` / ``rerank_refine``) and the bf16 cluster
ranking (``rank_precision="default"``).

Each index is built by JAX, dumped with dump_to_dir and loaded by the
port's load_from_dir; both packages search it with exact selection (JAX
``approx_select=False``, the port ``select_reduce=False``: JAX's CPU path
never folds). Tolerances:

- the bf16 copy is bit-equal to JAX's ``astype(bfloat16)`` (uint16 views);
- the bf16 gather's twin matches JAX's ``_gather_l2(..., cast_f32=True)``
  to rtol 1e-5 (the same widened rows, f32 squares summed in other
  orders);
- ids are equal except at near-ties (where they differ, the two returned
  distances agree to rtol 1e-5), refined distances match JAX's f32 ones
  and refine-0 distances JAX's bf16 ones, to rtol 1e-5.

XLA on the CPU ignores ``Precision.DEFAULT`` (a test below checks that), so
JAX's CPU search is no oracle for ``rank_precision="default"``: the port's
bf16 pass is held instead to a numpy model of one MXU DEFAULT pass,
operands rounded to bf16 (nearest even) and an f32 product, and the
early-stop certificate's bound must stay fp32 (tests/test_adaptive.py's
case).
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu.parallel as jp
import rabitq_tpu_torch as rt
import rabitq_tpu_torch.parallel as tp
from bench import make_dataset
from conftest import brute_force_topk, make_clustered_dataset
from rabitq_tpu.cli import main as jax_cli
from rabitq_tpu.index import serialize as jser
from rabitq_tpu.index.index import with_bf16_base as jwith_bf16
from rabitq_tpu.ops import pairwise_l2sq as jpairwise
from rabitq_tpu_torch.cli import main as port_cli
from rabitq_tpu_torch.index import serialize as tser
from rabitq_tpu_torch.index.index import with_bf16_base
from rabitq_tpu_torch.io import write_matrix
from rabitq_tpu_torch.ops import gather_l2_reference
from rabitq_tpu_torch.ops.distances import bf16_gemm_route, pairwise_l2sq
from rabitq_tpu_torch.service import server as tserver
from torch_parity import gist_like_corpus

jsearch = importlib.import_module("rabitq_tpu.index.search")
tsearch = importlib.import_module("rabitq_tpu_torch.index.search")

RTOL = 1e-5


def _centers(rng, base, k):
    """Jittered base rows (no row equals its centroid)."""
    pick = base[rng.choice(base.shape[0], k, replace=False)]
    return pick + 0.01 * rng.standard_normal(pick.shape).astype(np.float32)


def _port_copy(jidx, path):
    jser.dump_to_dir(jidx, path)
    return tser.load_from_dir(path, device="cpu")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A spilled 4-bit JAX index of 3,000 x 96 rows (padded to 128), its
    port copy from a dump, and 24 queries."""
    base, queries = make_dataset(3000, 96, 64, 24, seed=11)
    cent = _centers(np.random.default_rng(11), base, 32)
    jidx = rq.build_index(base, cent, key=jax.random.key(3), bits=4,
                          spill=0.2)
    tidx = _port_copy(jidx, tmp_path_factory.mktemp("prec") / "idx")
    return base, queries, jidx, tidx


@pytest.fixture(scope="module")
def gist_built(tmp_path_factory):
    """A 960-d (padded to 1024) JAX index of 3,000 rows and its port copy."""
    base, queries, centers, orth = gist_like_corpus(seed=13, n=3000, nq=8)
    jidx = rq.build_index(base, centers, key=jax.random.key(4), bits=4,
                          orthogonal=jnp.asarray(orth))
    tidx = _port_copy(jidx, tmp_path_factory.mktemp("prec_gist") / "idx")
    return base, queries, jidx, tidx


def _u16(x):
    return np.asarray(x).view(np.uint16) if not isinstance(
        x, torch.Tensor) else x.view(torch.int16).numpy().view(np.uint16)


def _assert_match(t, j):
    """(dists, ids) of the port and JAX: equal ids but at near-ties,
    distances within RTOL rank by rank, +inf slots equal."""
    dt, it = (np.asarray(a) for a in t)
    dj, ij = (np.asarray(a) for a in j)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    np.testing.assert_allclose(dt[fin], dj[fin], rtol=RTOL)
    differ = it != ij
    assert differ.mean() <= 0.02, differ.mean()
    np.testing.assert_allclose(dt[differ], dj[differ], rtol=RTOL)


def _both(jidx, tidx, queries, refine, *, rerank_bf16=True, **kw):
    jpar = rq.SearchParams(approx_select=False, rerank_bf16=rerank_bf16,
                           rerank_refine=refine, **kw)
    tpar = rt.SearchParams(select_reduce=False, rerank_bf16=rerank_bf16,
                           rerank_refine=refine, **kw)
    return (rt.search(tidx, torch.from_numpy(queries), tpar),
            rq.search(jidx, jnp.asarray(queries), jpar))


# --- the bf16 copy ---------------------------------------------------------


@pytest.mark.parametrize("fixture", ["built", "gist_built"])
def test_bf16_copy_bit_equal_to_jax(fixture, request):
    _, _, jidx, tidx = request.getfixturevalue(fixture)
    assert tidx.base_bf16 is None
    got = with_bf16_base(tidx)
    want = jwith_bf16(jidx).base_bf16
    assert got.base_bf16.dtype == torch.bfloat16
    assert tuple(got.base_bf16.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_u16(got.base_bf16), _u16(want))
    # Set once: a second call returns the index unchanged.
    assert with_bf16_base(got) is got
    lean = dataclasses.replace(tidx, base=None)
    assert with_bf16_base(lean) is lean


def test_bf16_copy_rounds_to_nearest_even():
    """Values halfway between two bf16 round to the even one, as
    jnp.astype(bfloat16) rounds them."""
    bits = np.array([0x3F808000, 0x3F818000, 0x3F807FFF, 0xBF808001],
                    np.uint32)
    x = bits.view(np.float32).reshape(1, 4)
    idx = dataclasses.replace(_tiny_index(), base=torch.from_numpy(x))
    got = _u16(with_bf16_base(idx).base_bf16)
    want = _u16(jnp.asarray(x).astype(jnp.bfloat16))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], [0x3F80, 0x3F82, 0x3F80, 0xBF81])


def _tiny_index():
    rng = np.random.default_rng(0)
    base = rng.standard_normal((200, 8)).astype(np.float32)
    return rt.build_index(base, base[:4] + 0.01, device="cpu",
                          generator=torch.Generator().manual_seed(0))


# --- the bf16 gather's twin -------------------------------------------------


@pytest.mark.parametrize("d,b,r", [(128, 12, 40), (1024, 4, 150)])
def test_bf16_gather_twin_matches_jax(d, b, r):
    rng = np.random.default_rng(d)
    n = 1500
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    pos = rng.integers(0, n, (b, r))
    pos[:, 0], pos[:, 1], pos[:, 2] = n - 1, 0, pos[:, 3]
    jb = jnp.asarray(base).astype(jnp.bfloat16)
    want = np.asarray(jsearch._gather_l2(jb, jnp.asarray(pos),
                                         jnp.asarray(q), 0, cast_f32=True))
    tb = torch.from_numpy(base).to(torch.bfloat16)
    got = gather_l2_reference(tb, torch.from_numpy(pos),
                              torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    # It is a different function from the f32 gather of the same rows.
    f32 = gather_l2_reference(torch.from_numpy(base), torch.from_numpy(pos),
                              torch.from_numpy(q)).numpy()
    assert not np.allclose(got, f32, rtol=1e-6)
    # Outside [0, N): NaN, as the f32 twin.
    pos[0, 5] = n
    out = gather_l2_reference(tb, torch.from_numpy(pos), torch.from_numpy(q))
    assert torch.isnan(out[0, 5]) and torch.isfinite(out[0, :5]).all()


def test_bf16_gather_checks_its_operands():
    tb = torch.zeros((10, 16), dtype=torch.bfloat16)
    pos = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        gather_l2_reference(tb.half(), pos, torch.zeros((2, 16)))
    with pytest.raises(ValueError, match="q: expected"):
        gather_l2_reference(tb, pos, torch.zeros((2, 16), dtype=torch.bfloat16))


# --- search with the two-level rerank --------------------------------------


@pytest.mark.parametrize("refine", [-1, 0, 8])
def test_rerank_bf16_search_matches_jax(built, refine):
    """Counterparts of tests/test_index.py's two-level rerank cases, at
    the auto refine (max(4 topk, 32) = 40 < R = 60), refine 0 (bf16
    distances reported) and refine 8 < topk, where both packages return
    only the 8 refined rows a query on this spilled index (an unspilled
    one raises in both: top-k of 10 out of 8; ROADMAP queue 3)."""
    base, queries, jidx, tidx = built
    t, j = _both(jwith_bf16(jidx), with_bf16_base(tidx), queries, refine,
                 probe=8, topk=10, rerank=60)
    _assert_match(t, j)
    dt, it = (a.numpy() for a in t)
    assert it.shape == np.asarray(j[1]).shape == (
        queries.shape[0], 8 if refine == 8 else 10)
    # Refined distances are the ids' f32 distances; refine 0 reports the
    # bf16 rows' distances.
    rows = base[np.maximum(it, 0)]
    if refine == 0:
        bf = jnp.asarray(rows).astype(jnp.bfloat16).astype(jnp.float32)
        rows = np.asarray(bf)
    exact = ((rows - queries[:, None, :]) ** 2).sum(-1)
    fin = it >= 0
    np.testing.assert_allclose(dt[fin], exact[fin], rtol=1e-4)
    truth = brute_force_topk(base, queries, 10)
    rec, jrec = (np.mean([rt.calculate_recall(a, b, 10)
                          for a, b in zip(truth, ids)])
                 for ids in (it, np.asarray(j[1])))
    assert abs(rec - jrec) <= 0.01 and rec >= (0.7 if refine == 8 else 0.9)


def test_rerank_bf16_at_gist_width_matches_jax(gist_built):
    """D 960 -> 1024, topk 20, R 60 below the auto refine of 80: every
    candidate is gathered in bf16 and again in f32 (tests/test_rerank_chunk
    's bf16 case at refine 0 too)."""
    _, queries, jidx, tidx = gist_built
    jb, tb = jwith_bf16(jidx), with_bf16_base(tidx)
    for refine in (-1, 0):
        t, j = _both(jb, tb, queries, refine, probe=6, topk=20, rerank=60)
        _assert_match(t, j)


def test_rerank_bf16_reaches_every_search_entry(built):
    """search_adaptive and a filtered search run the two-level rerank as
    JAX's do (both go through _exact_rerank)."""
    base, queries, jidx, tidx = built
    jb, tb = jwith_bf16(jidx), with_bf16_base(tidx)
    kw = dict(probe=4, topk=10, rerank=60, rerank_bf16=True, rerank_refine=0)
    dj, ij, pj = jsearch.search_adaptive(
        jb, jnp.asarray(queries), rq.SearchParams(approx_select=False, **kw),
        max_probe=16)
    dt, it, pt = rt.search_adaptive(
        tb, torch.from_numpy(queries),
        rt.SearchParams(select_reduce=False, **kw), max_probe=16)
    assert pt == pj
    _assert_match((dt, it), (dj, ij))
    allow = np.arange(0, 3000, 2)
    jf = rq.make_row_filter(jb, allow_ids=allow)
    tf = rt.make_row_filter(tb, allow_ids=allow)
    dj, ij = rq.search(jb, jnp.asarray(queries),
                       rq.SearchParams(approx_select=False, **kw), jf)
    dt, it = rt.search(tb, torch.from_numpy(queries),
                       rt.SearchParams(select_reduce=False, **kw), tf)
    _assert_match((dt, it), (dj, ij))
    assert np.isin(it.numpy()[it.numpy() >= 0], allow).all()


def test_rerank_bf16_is_off_without_the_copy(built):
    """The option is silently off on an index without its bf16 copy, as
    in JAX: the f32 rerank's results, bit for bit."""
    _, queries, _, tidx = built
    p = rt.SearchParams(probe=8, topk=10, rerank=60)
    q = torch.from_numpy(queries)
    want = rt.search(tidx, q, p)
    got = rt.search(tidx, q, p._replace(rerank_bf16=True, rerank_refine=0))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_compact_drops_the_copy_and_search_runs_f32(built):
    _, queries, _, tidx = built
    tb = with_bf16_base(rt.delete(tidx, [1, 2, 3]))
    assert tb.base_bf16 is not None
    new, _ = rt.compact(tb, generator=torch.Generator().manual_seed(5))
    assert new.base_bf16 is None
    p = rt.SearchParams(probe=8, topk=10, rerank=60)
    q = torch.from_numpy(queries)
    want = rt.search(new, q, p)
    got = rt.search(new, q, p._replace(rerank_bf16=True, rerank_refine=0))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    # A mutation keeps the copy: the memtable holds the inserted rows.
    grown = rt.insert(tb, queries[:2], ids=[9001, 9002])
    assert grown.base_bf16 is tb.base_bf16
    _, ids = rt.search(grown, q[:2], p._replace(rerank_bf16=True))
    assert ids[:, 0].tolist() == [9001, 9002]


# --- sharded ----------------------------------------------------------------


@pytest.fixture(scope="module")
def jmesh():
    return jp.make_mesh(8)


@pytest.fixture(scope="module")
def tmesh():
    return tp.make_mesh(devices=["cpu"] * 8)


def test_sharded_bf16_search_equals_unsharded_and_jax(built, jmesh, tmesh):
    """Each shard carries the rows of the unsharded copy; exact-mode
    sharded search at the full probe equals the unsharded search (both
    scan every row) and JAX's sharded search of its own sharded copy."""
    _, queries, jidx, tidx = built
    tb = with_bf16_base(tidx)
    ts = tp.shard_index(tb, tmesh)
    for sh in ts.shards:
        assert sh.base_bf16 is not None
        np.testing.assert_array_equal(_u16(sh.base_bf16),
                                      _u16(sh.base.to(torch.bfloat16)))
    # with_bf16_base on a sharded index derives one copy a shard.
    late = with_bf16_base(tp.shard_index(tidx, tmesh))
    assert all(torch.equal(a.base_bf16.view(torch.int16),
                           b.base_bf16.view(torch.int16))
               for a, b in zip(late.shards, ts.shards))
    kw = dict(probe=tidx.k, topk=10, rerank=4000, rerank_bf16=True)
    q = torch.from_numpy(queries)
    for refine in (-1, 0):
        p = rt.SearchParams(select_reduce=False, rerank_refine=refine, **kw)
        got = tp.sharded_search(ts, q, p, tmesh, exact=True)
        want = rt.search(tb, q, p)
        _assert_match(got, want)
    js = jp.shard_index(jwith_bf16(jidx), jmesh)
    kw.update(probe=8, rerank=60, rerank_refine=0)
    dj, ij = jp.sharded_search(js, jnp.asarray(queries),
                               rq.SearchParams(**kw), jmesh, exact=True)
    dt, it = tp.sharded_search(ts, q, rt.SearchParams(select_reduce=False,
                                                      **kw), tmesh, exact=True)
    _assert_match((dt, it), (dj, ij))


# --- the service ------------------------------------------------------------


def test_engine_rerank_bf16_derives_the_copy_and_again_on_reload(built):
    """tests/test_service.py's engine case: the engine derives the copy,
    its requests carry rerank_bf16, a swap_index (what /admin/reload
    runs) derives the new index's copy; a store-tier engine ignores it."""
    base, queries, _, tidx = built
    eng = tserver.BatchingEngine(tidx, max_batch=8, rerank_bf16=True)
    try:
        assert eng.index.base_bf16 is not None
        assert eng._make_params(5, 8).rerank_bf16
        scores, ids = eng.submit(base[9], 5, 8)
        p = eng._make_params(5, 8)
        want_d, want_i = rt.search(eng.index, torch.from_numpy(base[9:10]), p)
        assert ids[0] == 9 and scores[0] < 1e-4
        np.testing.assert_array_equal(ids, want_i[0].numpy())
        other = rt.delete(tidx, [9])
        assert other.base_bf16 is None
        eng.swap_index(other)
        assert eng.index.base_bf16 is not None
        np.testing.assert_array_equal(
            _u16(eng.index.base_bf16), _u16(other.base.to(torch.bfloat16)))
        _, ids = eng.submit(base[9], 5, 8)
        assert 9 not in ids.tolist()
    finally:
        eng.close()
    store = tserver.BatchingEngine(dataclasses.replace(tidx, base=None),
                                   store=object(), rerank_bf16=True)
    try:
        assert not store.rerank_bf16 and store.index.base_bf16 is None
    finally:
        store.close()


# --- the CLI ----------------------------------------------------------------


def _cli_files(d, rng):
    """fvecs fixtures of 2,000 x 40 rows in 8 clusters, 16 queries and
    their top-5, and the path of an index directory the first run
    builds."""
    centers = rng.standard_normal((8, 40)).astype(np.float32)
    base = (centers[rng.integers(0, 8, 2000)]
            + 0.3 * rng.standard_normal((2000, 40))).astype(np.float32)
    queries = (base[:16] + 0.05 * rng.standard_normal((16, 40))).astype(
        np.float32)
    paths = {name: d / f"{name}.fvecs" for name in
             ("base", "centroids", "query", "truth")}
    for name, arr in (("base", base), ("centroids", centers),
                      ("query", queries),
                      ("truth", brute_force_topk(base, queries, 5))):
        write_matrix(paths[name], arr)
    paths["saved"] = d / "index"
    return paths


def test_cli_run_rerank_bf16_refine_matches_jax_cli(tmp_path, rng, caplog,
                                                   monkeypatch):
    """tests/test_cli.py's bf16 case with --rerank-refine 8: both CLIs on
    one JAX-built directory report the same recall, and the port's
    searches carry the flags on an index with its bf16 copy."""
    import logging

    paths = _cli_files(tmp_path, rng)
    argv = ["run", "-b", str(paths["base"]), "-c", str(paths["centroids"]),
            "-s", str(paths["saved"]), "-q", str(paths["query"]),
            "-t", str(paths["truth"]), "-p", "3", "-k", "5",
            "--rerank", "40", "--batch", "8", "--rerank-bf16",
            "--rerank-refine", "8", "--no-fold"]
    with caplog.at_level(logging.INFO):
        jax_cli(argv)
    want = [r.getMessage() for r in caplog.records
            if "recall: " in r.getMessage()][-1].split("recall: ")[1]
    seen = []
    search = tsearch.search_with_stats

    def spy(index, q, params, *a):
        seen.append((index.base_bf16 is not None, params))
        return search(index, q, params, *a)

    monkeypatch.setattr(tsearch, "search_with_stats", spy)
    got = port_cli(argv + ["--device", "cpu"])
    assert f"{got['recall']:.4f}" == want
    assert seen and all(has and p.rerank_bf16 and p.rerank_refine == 8
                        for has, p in seen)


# --- bf16 cluster ranking ---------------------------------------------------


def _bf16_round(x):
    """numpy round-to-nearest-even to bf16, kept in f32 (finite inputs)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.view(np.float32)


def _default_pass_model(x, c):
    """One MXU DEFAULT pass in numpy: bf16-rounded operands, exact
    products, sums in f64 then rounded to f32; f32 norms."""
    xc = (_bf16_round(x).astype(np.float64)
          @ _bf16_round(c).astype(np.float64).T).astype(np.float32)
    xx = (x * x).sum(-1, keepdims=True, dtype=np.float32)
    cc = (c * c).sum(-1, dtype=np.float32)
    return np.maximum(xx - 2.0 * xc + cc[None, :], 0.0)


def test_xla_cpu_ignores_precision_default():
    """Why JAX's CPU search is no oracle for rank_precision="default": on
    the CPU XLA computes Precision.DEFAULT exactly as HIGHEST."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((32, 128)).astype(np.float32)
    c = rng.standard_normal((64, 128)).astype(np.float32)
    lo = jpairwise(jnp.asarray(x), jnp.asarray(c),
                   precision=jax.lax.Precision.DEFAULT)
    hi = jpairwise(jnp.asarray(x), jnp.asarray(c))
    np.testing.assert_array_equal(np.asarray(lo), np.asarray(hi))


@pytest.mark.parametrize("d", [96, 1024])
def test_default_precision_is_one_bf16_pass(d):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((40, d)).astype(np.float32)
    c = rng.standard_normal((300, d)).astype(np.float32)
    got = pairwise_l2sq(torch.from_numpy(x), torch.from_numpy(c),
                        "default").numpy()
    want = _default_pass_model(x, c)
    scale = float((x * x).sum(-1).max() + (c * c).sum(-1).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)
    # ... which is not the fp32 product: bf16 operands move it by ~1e-3.
    hi = pairwise_l2sq(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    assert np.abs(got - hi).max() > 100 * np.abs(got - want).max()
    assert bf16_gemm_route(torch.device("cpu")).startswith("fp32 product")
    with pytest.raises(ValueError, match="precision"):
        pairwise_l2sq(torch.from_numpy(x), torch.from_numpy(c), "tf32")


def test_default_precision_ranks_the_scanned_clusters(built):
    """The scan probes the clusters of the bf16-pass ranking: its [B,
    probe] cluster starts equal those of a stable argsort of the numpy
    model's distances, but where the model ties two clusters to rtol
    1e-5."""
    _, queries, _, tidx = built
    p = rt.SearchParams(probe=8, topk=10, rerank=60, select_reduce=False,
                        rank_precision="default")
    q = torch.from_numpy(queries)
    y = rt.ops.rotate(tsearch._prep_queries(tidx, q), tidx.orthogonal)
    model = _default_pass_model(y.numpy(), tidx.centroids_rot.numpy())
    np.testing.assert_allclose(
        tsearch._rank_cdist(tidx, y, p).numpy(), model, rtol=RTOL,
        atol=RTOL * float(model.max()))
    order = np.argsort(model, axis=1, kind="stable")[:, :8]
    starts = tsearch.rough_scan(tidx, q, p).starts.numpy()
    want = tidx.offsets.numpy()[order]
    for b, j in zip(*np.nonzero(starts != want)):
        row = np.sort(model[b])
        assert np.isclose(row[j], row[j + 1], rtol=RTOL) or np.isclose(
            row[j], row[j - 1], rtol=RTOL), (b, j)
    hi = tsearch._rank_cdist(tidx, y, p._replace(rank_precision="highest"))
    assert not torch.equal(hi, tsearch._rank_cdist(tidx, y, p))


def test_certificate_bound_stays_fp32_under_bf16_ranking(rng):
    """tests/test_adaptive.py's case: the probed set comes from the bf16
    ranking, the annulus bound from fp32 distances; certified queries are
    exact."""
    base, centers = make_clustered_dataset(rng, n=2000, dim=32, k=16,
                                           spread=0.1)
    jidx = rq.build_index(base, centers, key=jax.random.key(1))
    tidx = rt.index_from_arrays(
        codes_pm1=np.asarray(jidx.codes_pm1),
        factors_tiled=np.asarray(jidx.factors_tiled),
        offsets=np.asarray(jidx.offsets), map_ids=np.asarray(jidx.map_ids),
        centroids_rot=np.asarray(jidx.centroids_rot),
        orthogonal=np.asarray(jidx.orthogonal),
        rand_bias=np.asarray(jidx.rand_bias), base=np.asarray(jidx.base),
        dim=jidx.dim, dim_orig=jidx.dim_orig, capacity=jidx.capacity,
        metric=jidx.metric, code_bits=jidx.code_bits,
        dedup_ids=jidx.dedup_ids, device="cpu")
    nq = 16
    queries = base[rng.choice(2000, nq, replace=False)] + (
        0.01 * rng.standard_normal((nq, 32)).astype(np.float32))
    truth = brute_force_topk(base, queries, 10)
    p = rt.SearchParams(probe=16, topk=10, rerank=2000,
                        rank_precision="default")
    q = torch.from_numpy(queries)
    _, ids, safe = tsearch._search_with_certificate(tidx, q, p)
    assert safe.all()
    rec = np.mean([rt.calculate_recall(t, i, 10)
                   for t, i in zip(truth, ids.numpy())])
    assert rec == 1.0
    _, ids2, _ = rt.search_adaptive(tidx, q, p._replace(probe=2))
    rec2 = np.mean([rt.calculate_recall(t, i, 10)
                    for t, i in zip(truth, ids2.numpy())])
    assert rec2 == 1.0
    # The split itself: probed set from the bf16 ranking, bound from fp32.
    y = rt.ops.rotate(tsearch._prep_queries(tidx, q), tidx.orthogonal)
    kth = torch.full((nq,), 0.5)
    got = tsearch._certificate_safe(tidx, y, 4, kth, p)
    cd_rank = pairwise_l2sq(y, tidx.centroids_rot, "default")
    cids = torch.sort(cd_rank, dim=-1, stable=True).indices[:, :4]
    bound = tsearch._annulus_bound(tidx, pairwise_l2sq(y, tidx.centroids_rot))
    bound = bound.scatter(1, cids, torch.inf)
    np.testing.assert_array_equal(
        got.numpy(), (kth <= bound.min(dim=-1).values).numpy())
