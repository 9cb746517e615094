"""The port's mutations (rabitq_tpu_torch.index.mutate) against the JAX
package's, case for case with tests/test_mutate.py.

A JAX-built index goes through ``port_of`` (``index_from_arrays`` with its
memtable). Each mutation runs in both packages on the same inputs: the
port's mutated index must hold exactly the arrays of the JAX-mutated one
carried across (tombstones as cdsq +inf and map_ids -1, the memtable rows
and ids), and both search it alike: JAX with ``approx_select=False``, the
port with ``select_reduce=False``; ids equal except at near-ties, distances
to f32 rounding. ``compact`` rebuilds in each package with the rotation
JAX's compaction drew, and ``reconstruct_corpus`` returns the same live
rows. Mutated dumps are byte-identical both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu_torch as rt
from conftest import make_clustered_dataset
from rabitq_tpu.index import mutate as jmut
from rabitq_tpu.index import serialize as jser
from rabitq_tpu_torch.index import mutate as tmut
from rabitq_tpu_torch.index import serialize as tser


def port_of(jidx):
    """The port's index holding exactly the arrays of a JAX index, its
    tombstones and memtable included."""
    has_mem = jidx.extra_base is not None and jidx.extra_base.shape[0] > 0
    return rt.index_from_arrays(
        codes_pm1=np.asarray(jidx.codes_pm1),
        factors_tiled=np.asarray(jidx.factors_tiled),
        offsets=np.asarray(jidx.offsets),
        map_ids=np.asarray(jidx.map_ids),
        centroids_rot=np.asarray(jidx.centroids_rot),
        orthogonal=np.asarray(jidx.orthogonal),
        rand_bias=np.asarray(jidx.rand_bias),
        base=None if jidx.base is None else np.asarray(jidx.base),
        dim=jidx.dim,
        dim_orig=jidx.dim_orig,
        capacity=jidx.capacity,
        metric=jidx.metric,
        code_bits=jidx.code_bits,
        dedup_ids=jidx.dedup_ids,
        extra_base=np.asarray(jidx.extra_base) if has_mem else None,
        extra_ids=np.asarray(jidx.extra_ids) if has_mem else None,
        device="cpu",
    )


def assert_same_index(got, want):
    """Two port indexes hold equal arrays (the memtable included)."""
    for f in ("codes", "factors", "offsets", "map_ids", "centroids_rot",
              "orthogonal", "rand_bias", "base", "extra_base", "extra_ids"):
        x, y = getattr(got, f), getattr(want, f)
        if y is None:
            assert x is None, f
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), f


def both_search(jidx, tidx, queries, probe, topk, rerank, **kw):
    """(JAX ids, dists), (port ids, dists) of one search of each, as numpy;
    ``kw`` holds row filters (``jf``, ``tf``)."""
    jp = rq.SearchParams(probe=probe, topk=topk, rerank=rerank,
                         approx_select=False)
    tp = rt.SearchParams(probe=probe, topk=topk, rerank=rerank,
                         select_reduce=False)
    dj, ij = rq.search(jidx, jnp.asarray(queries), jp, kw.get("jf"))
    dt, it = rt.search(tidx, torch.from_numpy(np.asarray(queries)), tp,
                       kw.get("tf"))
    return (np.asarray(ij), np.asarray(dj)), (it.numpy(), dt.numpy())


def assert_results_match(j, t):
    (ij, dj), (it, dt) = j, t
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-5)
    differ = it != ij
    # Where ids differ, the two candidates tie to f32 rounding.
    np.testing.assert_allclose(dt[differ], dj[differ], rtol=1e-5)
    assert differ.mean() <= 0.05


def _ids(res):
    return res[0]


def test_insert_appears_in_results(rng):
    base, centers = make_clustered_dataset(rng, n=500, dim=32, k=8)
    jidx = rq.build_index(base, centers, key=jax.random.key(1))
    new_vec = base[123] + 1e-4
    j2 = rq.insert(jidx, new_vec[None, :])
    t2 = rt.insert(port_of(jidx), new_vec[None, :])
    assert_same_index(t2, port_of(j2))
    j, t = both_search(j2, t2, new_vec[None, :], 8, 3, 50)
    assert_results_match(j, t)
    ids = _ids(t)[0].tolist()
    assert 500 in ids and 123 in ids  # new id = n


def test_delete_removes_from_results(rng):
    base, centers = make_clustered_dataset(rng, n=400, dim=32, k=8)
    jidx = rq.build_index(base, centers, key=jax.random.key(2))
    tidx = port_of(jidx)
    q = base[:4]
    before = _ids(both_search(jidx, tidx, q, 8, 5, 100)[1])
    assert (before[:, 0] == np.arange(4)).all()
    j2 = rq.delete(jidx, [0, 1, 2, 3])
    t2 = rt.delete(tidx, [0, 1, 2, 3])
    assert_same_index(t2, port_of(j2))
    j, t = both_search(j2, t2, q, 8, 5, 100)
    assert_results_match(j, t)
    assert not np.isin(_ids(t), [0, 1, 2, 3]).any()
    # Untouched queries unaffected.
    np.testing.assert_array_equal(
        _ids(both_search(jidx, tidx, base[10:12], 8, 5, 100)[1]),
        _ids(both_search(j2, t2, base[10:12], 8, 5, 100)[1]),
    )


def test_delete_inserted_vector(rng):
    base, centers = make_clustered_dataset(rng, n=300, dim=24, k=4)
    jidx = rq.build_index(base, centers, key=jax.random.key(3))
    v = rng.standard_normal(24).astype(np.float32)
    j2 = rq.insert(jidx, v[None, :], ids=[777])
    t2 = rt.insert(port_of(jidx), v[None, :], ids=[777])
    assert 777 in _ids(both_search(j2, t2, v[None, :], 4, 3, 30)[1])[0]
    j3, t3 = rq.delete(j2, [777]), rt.delete(t2, [777])
    assert_same_index(t3, port_of(j3))
    j, t = both_search(j3, t3, v[None, :], 4, 3, 30)
    assert_results_match(j, t)
    assert 777 not in _ids(t)[0]


def _compact_both(jidx, tidx):
    jnew, jlive = rq.compact(jidx)
    tnew, tlive = rt.compact(tidx, orthogonal=np.array(jnew.orthogonal))
    np.testing.assert_array_equal(tlive, jlive)
    return jnew, tnew


def test_compact_folds_memtable_and_tombstones(rng):
    base, centers = make_clustered_dataset(rng, n=400, dim=32, k=8)
    jidx0 = rq.build_index(base, centers, key=jax.random.key(4))
    extra = rng.standard_normal((10, 32)).astype(np.float32)
    jidx = rq.delete(rq.insert(jidx0, extra), [5, 6, 7])
    tidx = rt.delete(rt.insert(port_of(jidx0), extra), [5, 6, 7])
    assert_same_index(tidx, port_of(jidx))
    vj, ij = jmut.reconstruct_corpus(jidx)
    vt, it = tmut.reconstruct_corpus(tidx)
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(it, ij)

    jnew, tnew = _compact_both(jidx, tidx)
    assert tnew.extra_base is None and tnew.n == 400 + 10 - 3
    np.testing.assert_array_equal(tnew.map_ids.numpy(), np.asarray(jnew.map_ids))
    np.testing.assert_array_equal(tnew.offsets.numpy(), np.asarray(jnew.offsets))
    # Original ids survive the rebuild: the first inserted vector still
    # answers under id 400, deleted ids stay gone.
    j, t = both_search(jnew, tnew, extra[:1], 8, 3, 50)
    assert_results_match(j, t)
    assert 400 in _ids(t)[0]
    assert not np.isin(tnew.map_ids.numpy(), [5, 6, 7]).any()


def test_update_replaces_under_same_id(rng):
    """update(v, id) returns the new vector under the old id, drops the
    old vector, and survives compact; an absent id is inserted."""
    base, centers = make_clustered_dataset(rng, n=400, dim=32, k=8)
    jidx = rq.build_index(base, centers, key=jax.random.key(7))
    new_v = base[42] + np.float32(25.0)
    j2 = rq.update(jidx, new_v[None, :], ids=[42])
    t2 = rt.update(port_of(jidx), new_v[None, :], ids=[42])
    assert_same_index(t2, port_of(j2))
    assert _ids(both_search(j2, t2, new_v[None, :], 8, 3, 60)[1])[0, 0] == 42
    assert 42 not in _ids(both_search(j2, t2, base[42][None, :], 8, 3, 60)[1])

    v2 = rng.standard_normal(32).astype(np.float32)
    j3 = rq.update(j2, v2[None, :], ids=[9999])
    t3 = rt.update(t2, v2[None, :], ids=[9999])
    assert_same_index(t3, port_of(j3))
    assert 9999 in _ids(both_search(j3, t3, v2[None, :], 8, 3, 60)[1])

    j4, t4 = _compact_both(j3, t3)
    assert t4.extra_base is None
    for q, want_first in ((new_v, 42), (base[42], None), (v2, None)):
        j, t = both_search(j4, t4, q[None, :], 8, 3, 60)
        assert_results_match(j, t)
        if want_first is not None:
            assert _ids(t)[0, 0] == want_first
    assert 42 not in _ids(both_search(j4, t4, base[42][None, :], 8, 3, 60)[1])
    assert 9999 in _ids(both_search(j4, t4, v2[None, :], 8, 3, 60)[1])


def test_update_twice_single_live_copy(rng):
    base, centers = make_clustered_dataset(rng, n=300, dim=24, k=4)
    jidx = rq.build_index(base, centers, key=jax.random.key(8))
    v1 = base[7] + np.float32(10.0)
    v2 = base[7] - np.float32(10.0)
    tidx = port_of(jidx)
    for v in (v1, v2):
        jidx = rq.update(jidx, v[None, :], ids=[7])
        tidx = rt.update(tidx, v[None, :], ids=[7])
    assert_same_index(tidx, port_of(jidx))
    got = _ids(both_search(jidx, tidx, v2[None, :], 4, 5, 40)[1])[0].tolist()
    assert got[0] == 7 and got.count(7) == 1
    assert 7 not in _ids(both_search(jidx, tidx, v1[None, :], 4, 5, 40)[1])
    assert (tidx.extra_ids.numpy() == 7).sum() == 1
    with pytest.raises(ValueError, match="duplicate"):
        rt.update(tidx, np.stack([v1, v2]), ids=[3, 3])


def test_cosine_metric(rng):
    """A cosine index: the port's search of it recalls as JAX's does, and
    an insert is normalized in both packages alike."""
    base, centers = make_clustered_dataset(rng, n=1000, dim=48, k=8)
    jidx = rq.build_index(base, centers, key=jax.random.key(5),
                          metric="cosine")
    nq = 10
    queries = base[rng.choice(1000, nq, replace=False)] * rng.uniform(
        0.5, 2.0, (nq, 1)
    ).astype(np.float32)  # scaled: cosine must ignore magnitude
    bn = base / np.linalg.norm(base, axis=1, keepdims=True)
    qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
    truth = np.argsort(-(qn @ bn.T), axis=1)[:, :10]
    j, t = both_search(jidx, port_of(jidx), queries, 8, 10, 200)
    assert_results_match(j, t)
    rec = np.mean([rt.calculate_recall(truth[i], _ids(t)[i], 10)
                   for i in range(nq)])
    assert rec >= 0.95, rec
    extra = 3.0 * rng.standard_normal((4, 48)).astype(np.float32)
    assert_same_index(rt.insert(port_of(jidx), extra),
                      port_of(rq.insert(jidx, extra)))


@pytest.mark.parametrize("fmt", ["dir", "npz", "json"])
def test_mutated_index_serializes(tmp_path, rng, fmt):
    """A mutated index (tombstones and memtable): the port's dump equals
    JAX's byte for byte, each loads in the other package, and the loaded
    index searches as before."""
    base, centers = make_clustered_dataset(rng, n=200, dim=24, k=4)
    jidx = rq.build_index(base, centers, key=jax.random.key(6),
                          metric="cosine")
    extra = rng.standard_normal((5, 24)).astype(np.float32)
    jidx = rq.delete(rq.insert(jidx, extra), [3, 201])
    tidx = port_of(jidx)
    dump, load = {"dir": ("dump_to_dir", "load_from_dir"),
                  "npz": ("dump_to_npz", "load_from_npz"),
                  "json": ("dump_to_json", "load_from_json")}[fmt]
    suffix = {"dir": "", "npz": ".npz", "json": ".json"}[fmt]
    jpath, tpath = tmp_path / f"j{suffix}", tmp_path / f"t{suffix}"
    getattr(jser, dump)(jidx, jpath)
    getattr(tser, dump)(tidx, tpath)
    if fmt == "dir":
        names = sorted(p.name for p in jpath.iterdir())
        assert "extra_base.fvecs" in names and "extra_ids.ivecs" in names
        assert names == sorted(p.name for p in tpath.iterdir())
        for name in names:
            assert (jpath / name).read_bytes() == (tpath / name).read_bytes()
    elif fmt == "npz":
        with np.load(jpath) as zj, np.load(tpath) as zt:
            assert sorted(zj.files) == sorted(zt.files)
            for key in zj.files:
                np.testing.assert_array_equal(zt[key], zj[key])
    else:
        assert jpath.read_bytes() == tpath.read_bytes()
    loaded = getattr(tser, load)(jpath, device="cpu")
    assert_same_index(loaded, tidx)
    jback = getattr(jser, load)(tpath)
    assert_same_index(port_of(jback), tidx)
    j, t = both_search(jback, loaded, base[:3], 4, 5, 40)
    assert_results_match(j, t)
