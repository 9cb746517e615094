"""The port's row filters (rabitq_tpu_torch.index.filter and the
``row_filter`` argument of search) against the JAX package's, case for
case with tests/test_filter.py (all but the store tier's, not ported).

Both packages search one JAX-built index (``port_of``) under the same
predicate: JAX with ``approx_select=False``, the port with its default
SearchParams (a filter forces the fold off). Ids equal except at
near-ties, distances to f32 rounding. The port's dense penalty equals
JAX's lane-tiled one read at ``dense_to_padded`` positions, and the scan
twin with a penalty equals JAX's jnp scan with JAX's penalty window added.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu_torch as rt
from conftest import make_clustered_dataset
from rabitq_tpu.index.filter import RowFilterContext as JContext
from rabitq_tpu_torch.index.filter import RowFilterContext, penalty_from_mask
from rabitq_tpu_torch.index.index import dense_to_padded
from rabitq_tpu_torch.ops import pack_query_nibbles, rough_scan_reference
from test_torch_mutate import assert_results_match, both_search, port_of

jsearch = importlib.import_module("rabitq_tpu.index.search")
tsearch = importlib.import_module("rabitq_tpu_torch.index.search")


def _brute_force_allowed(base, queries, allow, topk):
    """Exact top-k over only the allowed original ids (row index = id)."""
    allow = np.asarray(sorted(allow))
    sub = base[allow]
    d = ((queries[:, None, :] - sub[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d, axis=1)[:, :topk]
    return allow[order], np.take_along_axis(d, order, axis=1)


def _filters(jidx, tidx, **kw):
    return dict(jf=rq.make_row_filter(jidx, **kw),
                tf=rt.make_row_filter(tidx, **kw))


def _dense_jax_penalty(jidx, jrf):
    """JAX's lane-tiled penalty read at the dense rows' padded columns."""
    off = np.asarray(jidx.offsets)
    cols = dense_to_padded(off, np.arange(jidx.n))
    return np.asarray(jrf.penalty).reshape(-1)[cols]


def test_exhaustive_filtered_search_matches_allowed_brute_force(rng):
    base, centers = make_clustered_dataset(rng, n=1500, dim=48, k=12)
    jidx = rq.build_index(base, centers, key=jax.random.key(0))
    tidx = port_of(jidx)
    queries = base[:16] + 0.01 * rng.standard_normal((16, 48)).astype(
        np.float32
    )
    allow = rng.choice(1500, size=400, replace=False)
    f = _filters(jidx, tidx, allow_ids=allow)
    np.testing.assert_array_equal(f["tf"].penalty.numpy(),
                                  _dense_jax_penalty(jidx, f["jf"]))
    j, t = both_search(jidx, tidx, queries, 12, 10, 1500, **f)
    assert_results_match(j, t)
    ids, dists = t
    tids, tdists = _brute_force_allowed(base, queries, allow, 10)
    assert set(ids.ravel()) <= set(allow.tolist())
    np.testing.assert_array_equal(np.sort(ids, 1), np.sort(tids, 1))
    np.testing.assert_allclose(np.sort(dists, 1), np.sort(tdists, 1),
                               rtol=1e-3, atol=1e-4)


def test_denylist_is_complement_of_allowlist(rng):
    base, centers = make_clustered_dataset(rng, n=800, dim=32, k=8)
    jidx = rq.build_index(base, centers, key=jax.random.key(1))
    tidx = port_of(jidx)
    deny = rng.choice(800, size=300, replace=False)
    allow = np.setdiff1d(np.arange(800), deny)
    fa = _filters(jidx, tidx, allow_ids=allow)
    fd = _filters(jidx, tidx, deny_ids=deny)
    np.testing.assert_array_equal(fa["tf"].penalty.numpy(),
                                  fd["tf"].penalty.numpy())
    ja, ta = both_search(jidx, tidx, base[:8], 8, 5, 800, **fa)
    jd, td = both_search(jidx, tidx, base[:8], 8, 5, 800, **fd)
    assert_results_match(jd, td)
    np.testing.assert_array_equal(ta[0], td[0])
    assert not set(td[0].ravel()) & set(deny.tolist())


def test_all_masked_filter_returns_invalid_slots(rng):
    base, centers = make_clustered_dataset(rng, n=400, dim=32, k=4)
    jidx = rq.build_index(base, centers, key=jax.random.key(2))
    tidx = port_of(jidx)
    f = _filters(jidx, tidx, allow_ids=np.array([], dtype=np.int32))
    j, (ids, dists) = both_search(jidx, tidx, base[:4], 4, 5, 400, **f)
    np.testing.assert_array_equal(ids, j[0])
    assert (ids == -1).all() and np.isinf(dists).all()


def test_filter_composes_with_memtable_and_delete(rng):
    base, centers = make_clustered_dataset(rng, n=600, dim=32, k=6)
    jidx = rq.build_index(base, centers, key=jax.random.key(3))
    fresh = rng.standard_normal((4, 32)).astype(np.float32)
    tidx = rt.delete(rt.insert(port_of(jidx), fresh), [601])
    jidx = rq.delete(rq.insert(jidx, fresh), [601])  # memtable 600..603
    # Half the indexed rows plus memtable ids 600 and 601; 602/603 are
    # filtered, 601 is tombstoned: only 600 may surface.
    allow = np.concatenate([np.arange(0, 600, 2), [600, 601]])
    f = _filters(jidx, tidx, allow_ids=allow)
    np.testing.assert_array_equal(f["tf"].extra_penalty.numpy(),
                                  np.asarray(f["jf"].extra_penalty))
    j, t = both_search(jidx, tidx, fresh, 6, 3, 600, **f)
    assert_results_match(j, t)
    ids = t[0]
    assert ids[0, 0] == 600
    assert not {601, 602, 603} & set(ids.ravel())
    assert set(ids.ravel()) - {-1} <= set(allow.tolist())


def test_filter_with_spilled_duplicates(rng):
    """A filtered id never surfaces through either spilled copy, and the
    dedup holds under a filter."""
    base, centers = make_clustered_dataset(rng, n=1000, dim=32, k=10)
    jidx = rq.build_index(base, centers, key=jax.random.key(4), spill=0.3)
    tidx = port_of(jidx)
    assert tidx.dedup_ids
    allow = rng.choice(1000, size=250, replace=False)
    f = _filters(jidx, tidx, allow_ids=allow)
    j, t = both_search(jidx, tidx, base[:12], 10, 10, 1300, **f)
    assert_results_match(j, t)
    ids = t[0]
    assert set(ids.ravel()) - {-1} <= set(allow.tolist())
    for row in ids:
        live = row[row >= 0]
        assert len(set(live.tolist())) == len(live)
    tids, _ = _brute_force_allowed(base, base[:12], allow, 10)
    np.testing.assert_array_equal(np.sort(ids, 1), np.sort(tids, 1))


def test_row_filter_context_matches_direct_build(rng):
    """RowFilterContext gives the direct build's penalties bit for bit, in
    allow and deny modes, with spilled duplicates and memtable entries;
    and both equal JAX's."""
    base, centers = make_clustered_dataset(rng, n=1500, dim=32, k=12)
    jidx = rq.build_index(base, centers, key=jax.random.key(11), spill=0.25)
    fresh = rng.standard_normal((3, 32)).astype(np.float32)
    tidx = rt.insert(port_of(jidx), fresh)
    jidx = rq.insert(jidx, fresh)  # ids 1500..1502
    ctx, jctx = RowFilterContext(tidx), JContext(jidx)
    np.testing.assert_array_equal(ctx.sorted_ids, jctx.sorted_ids)
    for mode in ("allow", "deny"):
        ids = np.concatenate(
            [rng.choice(1500, size=400, replace=False), [1501]]
        )
        kw = {f"{mode}_ids": ids}
        a = rt.make_row_filter(tidx, **kw)
        b = rt.make_row_filter(tidx, ctx=ctx, **kw)
        np.testing.assert_array_equal(a.penalty.numpy(), b.penalty.numpy(),
                                      err_msg=mode)
        np.testing.assert_array_equal(a.extra_penalty.numpy(),
                                      b.extra_penalty.numpy())
        jf = rq.make_row_filter(jidx, ctx=jctx, **kw)
        np.testing.assert_array_equal(a.penalty.numpy(),
                                      _dense_jax_penalty(jidx, jf))
        np.testing.assert_array_equal(a.extra_penalty.numpy(),
                                      np.asarray(jf.extra_penalty))
        np.testing.assert_array_equal(
            np.sort(ctx.rows_of(ids)), np.sort(jctx.rows_of(ids))
        )


def test_make_row_filter_validates_args(rng):
    base, centers = make_clustered_dataset(rng, n=200, dim=32, k=2)
    tidx = port_of(rq.build_index(base, centers, key=jax.random.key(5)))
    with pytest.raises(ValueError, match="exactly one"):
        rt.make_row_filter(tidx)
    with pytest.raises(ValueError, match="exactly one"):
        rt.make_row_filter(tidx, allow_ids=[1], deny_ids=[2])
    np.testing.assert_array_equal(
        penalty_from_mask(np.array([True, False])), [0.0, np.inf])


def test_search_many_respects_filter(rng):
    """search_many applies the predicate as per-batch search does."""
    base, centers = make_clustered_dataset(rng, n=1200, dim=32, k=8)
    jidx = rq.build_index(base, centers, key=jax.random.key(7))
    tidx = port_of(jidx)
    queries = base[:32].reshape(2, 16, 32)
    allow = rng.choice(1200, size=300, replace=False)
    f = _filters(jidx, tidx, allow_ids=allow)
    params = rt.SearchParams(probe=8, topk=5, rerank=1200)
    d_m, i_m = rt.search_many(tidx, torch.from_numpy(queries), params,
                              f["tf"])
    dj, ij = jsearch.search_many(
        jidx, jnp.asarray(queries),
        rq.SearchParams(probe=8, topk=5, rerank=1200, approx_select=False),
        f["jf"],
    )
    for nb in range(2):
        d_1, i_1 = rt.search(tidx, torch.from_numpy(queries[nb]), params,
                             f["tf"])
        assert torch.equal(i_m[nb], i_1) and torch.equal(d_m[nb], d_1)
        assert_results_match((np.asarray(ij[nb]), np.asarray(dj[nb])),
                             (i_1.numpy(), d_1.numpy()))
    assert set(i_m.numpy().ravel()) - {-1} <= set(allow.tolist())


def test_search_adaptive_respects_filter(rng):
    """Adaptive escalation under a filter: only allowed ids, the JAX
    result and probe_used, and at full probe the allowed brute force."""
    base, centers = make_clustered_dataset(rng, n=1000, dim=32, k=10)
    jidx = rq.build_index(base, centers, key=jax.random.key(8))
    tidx = port_of(jidx)
    queries = base[:12]
    allow = rng.choice(1000, size=250, replace=False)
    f = _filters(jidx, tidx, allow_ids=allow)
    dj, ij, pj = jsearch.search_adaptive(
        jidx, jnp.asarray(queries),
        rq.SearchParams(probe=2, topk=10, rerank=1000, approx_select=False),
        row_filter=f["jf"],
    )
    params = rt.SearchParams(probe=2, topk=10, rerank=1000)
    dt, it, pt = rt.search_adaptive(tidx, torch.from_numpy(queries), params,
                                    row_filter=f["tf"])
    assert pt == pj
    assert_results_match((np.asarray(ij), np.asarray(dj)),
                         (it.numpy(), dt.numpy()))
    assert set(it.numpy().ravel()) - {-1} <= set(allow.tolist())
    _, i_full = rt.search(tidx, torch.from_numpy(queries),
                          params._replace(probe=tidx.k), f["tf"])
    tids, _ = _brute_force_allowed(base, queries, allow, 10)
    np.testing.assert_array_equal(np.sort(i_full.numpy(), 1),
                                  np.sort(tids, 1))


def test_filtered_partial_probe_subset_of_allowed(rng):
    """At partial probe with the default SearchParams (a filter turns the
    fold off): every returned id passes, and the result is JAX's."""
    base, centers = make_clustered_dataset(rng, n=4000, dim=64, k=32)
    jidx = rq.build_index(base, centers, key=jax.random.key(6))
    tidx = port_of(jidx)
    allow = rng.choice(4000, size=1000, replace=False)
    f = _filters(jidx, tidx, allow_ids=allow)
    _, ids = rt.search(tidx, torch.from_numpy(base[:32]),
                       rt.SearchParams(probe=8, topk=10, rerank=128), f["tf"])
    assert set(ids.numpy().ravel()) - {-1} <= set(allow.tolist())
    j, t = both_search(jidx, tidx, base[:32], 8, 10, 128, **f)
    np.testing.assert_array_equal(t[0], ids.numpy())
    assert_results_match(j, t)


def test_filtered_scan_matches_jax_jnp_scan(rng):
    """The port's filtered stage 1-3 output (the twin with the penalty
    operand) equals JAX's jnp scan plus JAX's penalty window, slot for
    slot."""
    base, centers = make_clustered_dataset(rng, n=1500, dim=64, k=8)
    jidx = rq.build_index(base, centers, key=jax.random.key(9), bits=4)
    tidx = port_of(jidx)
    allow = rng.choice(1500, size=500, replace=False)
    f = _filters(jidx, tidx, allow_ids=allow)
    queries = base[:6]
    js = jsearch.rough_scan(jidx, jnp.asarray(queries), rq.SearchParams(
        probe=4, topk=5, rerank=32, approx_select=False))
    cap = jidx.capacity
    cols = np.asarray(js.starts_pad)[..., None] + np.arange(cap)
    pen = np.asarray(f["jf"].penalty).reshape(-1)[cols].reshape(6, -1)
    want = np.asarray(js.rough) + pen
    got = tsearch.rough_scan(tidx, torch.from_numpy(queries),
                             rt.SearchParams(probe=4, topk=5, rerank=32),
                             penalty=f["tf"].penalty).rough.numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5,
                               atol=1e-6 * np.abs(want[fin]).max())


@pytest.mark.parametrize("fold", [0, 1, 2])
@pytest.mark.parametrize("qpack", [False, True])
def test_twin_penalty_equals_tombstoned_factors(rng, fold, qpack):
    """The twin's penalty operand, in every mode, gives bit for bit what a
    copy of the factors with cdsq = +inf at the filtered rows gives: the
    filtered rows estimate to +inf and drop out of the fold."""
    n, d, span = 900, 256, 384
    m = 15
    codes = torch.from_numpy((2 * rng.integers(0, m + 1, (n, d)) - m)
                             .astype(np.int8))
    factors = torch.from_numpy(rng.standard_normal((n, 4)).astype(np.float32))
    factors[:, 3] = factors[:, 3].abs()
    starts = torch.tensor([0, 300, n - span, 10], dtype=torch.int32)
    sizes = torch.tensor([span, 200, span, 0], dtype=torch.int32)
    q = torch.from_numpy(rng.integers(0, 16, (4, d)).astype(np.int8))
    scal = torch.from_numpy(rng.standard_normal((4, 4)).astype(np.float32))
    scal[:, 1] = scal[:, 1].abs() + 0.01
    scal[:, 3] = scal[:, 3].abs()
    allowed = rng.random(n) < 0.5
    penalty = torch.from_numpy(penalty_from_mask(allowed))
    tomb = factors.clone()
    tomb[~torch.from_numpy(allowed), 3] = torch.inf
    qv = pack_query_nibbles(q) if qpack else q
    got = rough_scan_reference(codes, factors, starts, sizes, qv, scal, span,
                               fold, qpack, penalty)
    want = rough_scan_reference(codes, tomb, starts, sizes, qv, scal, span,
                                fold, qpack)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    plain = rough_scan_reference(codes, factors, starts, sizes, qv, scal,
                                 span, fold, qpack)
    assert not torch.equal(got.view(torch.int32), plain.view(torch.int32))
