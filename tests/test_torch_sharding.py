"""The port's sharded index (rabitq_tpu_torch.parallel.sharding) against
the JAX package's (rabitq_tpu.parallel.sharding), on the CPU.

JAX shards over the conftest's 8 virtual CPU devices (make_mesh(8)); the
port over an explicit mesh of 8 CPU entries. Both get the same index: a
JAX build, dumped with dump_to_dir and loaded by the port's load_from_dir
(mutations included). The shard plan, each shard's offsets, map_ids and
centroids must be equal; searches equal in ids except at near-ties, with
distances within rtol 1e-5 (the port's estimator sums in another order
than XLA's). JAX's CPU path never lane-folds, so the port's searches pass
select_reduce=False. The Lloyd step and the data-parallel build are held
to JAX's to f32 rounding; the direct-to-shard build to the port's
shard_index(build_index(...)) bit for bit, and to JAX's direct build with
the same rotation as the build parity tests hold the two builds.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu.parallel as jp
import rabitq_tpu_torch as rt
import rabitq_tpu_torch.parallel as tp
from conftest import make_clustered_dataset
from rabitq_tpu.index import serialize as jser
from rabitq_tpu.store import MmapStore as JMmapStore
from rabitq_tpu_torch.index import serialize as tser
from rabitq_tpu_torch.index.index import dense_to_padded
from rabitq_tpu_torch.parallel.sharding import Mesh
from rabitq_tpu_torch.store import MmapStore as TMmapStore
from torch_parity import random_orthogonal

S = 8
RTOL = 1e-5


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == S, "conftest must provide 8 CPU devices"
    return jp.make_mesh(S)


@pytest.fixture(scope="module")
def tmesh():
    return tp.make_mesh(devices=["cpu"] * S)


def port_copy(jidx, tmp_path, name="idx"):
    """The port's index loaded from a dump_to_dir of the JAX index."""
    jser.dump_to_dir(jidx, tmp_path / name, require_base=False)
    return tser.load_from_dir(tmp_path / name, device="cpu",
                              keep_base=jidx.base is not None)


def jparams(**kw):
    return rq.SearchParams(**kw)


def tparams(**kw):
    return rt.SearchParams(select_reduce=False, **kw)


def assert_near(label, ids, dists, ref_ids, ref_d):
    """Equal ids but at near-ties, every distance within RTOL of the
    reference's rank by rank, +inf slots (id -1) equal."""
    ids, dists = np.asarray(ids), np.asarray(dists)
    ref_ids, ref_d = np.asarray(ref_ids), np.asarray(ref_d)
    fin = np.isfinite(ref_d)
    assert np.array_equal(np.isfinite(dists), fin), label
    assert np.array_equal(ids[~fin], ref_ids[~fin]), label
    np.testing.assert_allclose(dists[fin], ref_d[fin], rtol=RTOL,
                               atol=RTOL * np.abs(ref_d[fin]).max(),
                               err_msg=label)
    same = ids == ref_ids
    # An id that differs must sit at a near-tie of its neighbour's value.
    for b, j in zip(*np.nonzero(~same)):
        row = ref_d[b]
        near = np.isclose(row, row[j], rtol=10 * RTOL)
        assert near.sum() > 1 or j == row.shape[0] - 1, (label, b, j)
    assert same.mean() >= 0.98, (label, same.mean())


def _queries(rng, base, nq=16, noise=0.02):
    q = base[rng.choice(base.shape[0], nq, replace=False)]
    return (q + noise * rng.standard_normal(q.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A spilled 4-bit JAX index and the port's copy of it."""
    rng = np.random.default_rng(11)
    base, centers = make_clustered_dataset(rng, n=3000, dim=64, k=32)
    jidx = rq.build_index(base, centers, key=jax.random.key(3), bits=4,
                          spill=0.2, balance=1.5)
    tidx = port_copy(jidx, tmp_path_factory.mktemp("built"))
    return base, jidx, tidx, _queries(rng, base)


def test_shard_plan_matches_jax(built, jmesh, tmesh):
    _, jidx, tidx, _ = built
    js, ts = jp.shard_index(jidx, jmesh), tp.shard_index(tidx, tmesh)
    assert ts.k_max == js.offsets.shape[1] - 1
    assert ts.rows_max == js.map_ids.shape[1]
    assert ts.tiles_max == js.blob.shape[1]
    ids = np.concatenate([ts.shards[si].map_ids.numpy() for si in range(S)])
    np.testing.assert_array_equal(np.sort(ids), np.sort(tidx.map_ids.numpy()))
    for si in range(S):
        sh = ts.shards[si]
        np.testing.assert_array_equal(sh.offsets.numpy(),
                                      np.asarray(js.offsets[si]))
        np.testing.assert_array_equal(sh.map_ids.numpy(),
                                      np.asarray(js.map_ids[si])[: sh.n])
        assert (np.asarray(js.map_ids[si])[sh.n :] == -1).all()
        np.testing.assert_array_equal(sh.centroids_rot.numpy(),
                                      np.asarray(js.centroids_rot[si]))
        np.testing.assert_array_equal(sh.base.numpy(),
                                      np.asarray(js.base[si])[: sh.n])
        assert sh.dedup_ids and sh.capacity == jidx.capacity
    np.testing.assert_array_equal(tp.shard_global_positions(tidx, S),
                                  jp.shard_global_positions(jidx, S))
    # The shards hold the unsharded rows: codes and factors by global
    # position.
    gpos = tp.shard_global_positions(tidx, S)
    for si in range(S):
        sh = ts.shards[si]
        g = torch.from_numpy(gpos[si][: sh.n]).long()
        assert torch.equal(sh.codes, tidx.codes[g])
        assert torch.equal(sh.factors, tidx.factors[g])


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("probe,rerank", [(12, 64), (32, 200)])
def test_sharded_search_matches_jax(built, jmesh, tmesh, exact, probe,
                                    rerank):
    _, jidx, tidx, q = built
    js, ts = jp.shard_index(jidx, jmesh), tp.shard_index(tidx, tmesh)
    kw = dict(probe=probe, topk=10, rerank=rerank)
    dj, ij = jp.sharded_search(js, jnp.asarray(q), jparams(**kw), jmesh,
                               exact=exact)
    dt, it = tp.sharded_search(ts, torch.from_numpy(q), tparams(**kw), tmesh,
                               exact=exact)
    assert it.dtype == torch.int64 and dt.shape == (q.shape[0], 10)
    assert_near(f"exact={exact}", it, dt, ij, dj)


def test_sharded_search_takes_numpy_queries(built, tmesh):
    _, _, tidx, q = built
    ts = tp.shard_index(tidx, tmesh)
    p = tparams(probe=12, topk=5, rerank=64)
    a = tp.sharded_search(ts, q, p, tmesh)
    b = tp.sharded_search(ts, torch.from_numpy(q), p, tmesh)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_sharded_search_with_memtable_and_tombstones(rng, jmesh, tmesh,
                                                     tmp_path):
    """Inserts (on shard 0) and deletes survive sharding in both packages;
    a spilled index dedups ids across shards."""
    base, centers = make_clustered_dataset(rng, n=1500, dim=32, k=16)
    jidx = rq.build_index(base, centers, key=jax.random.key(7), spill=0.2)
    fresh = rng.standard_normal((3, 32)).astype(np.float32)
    jidx = rq.delete(rq.insert(jidx, fresh, ids=[5555, 5556, 5557]),
                     [0, 1, 5556])
    tidx = port_copy(jidx, tmp_path)
    assert tidx.m == 3
    js, ts = jp.shard_index(jidx, jmesh), tp.shard_index(tidx, tmesh)
    assert ts.shards[0].m == 3 and all(
        ts.shards[si].m == 0 for si in range(1, S))
    q = np.concatenate([fresh, base[:5]])
    for exact in (False, True):
        kw = dict(probe=8, topk=5, rerank=100)
        dj, ij = jp.sharded_search(js, jnp.asarray(q), jparams(**kw), jmesh,
                                   exact=exact)
        dt, it = tp.sharded_search(ts, torch.from_numpy(q), tparams(**kw),
                                   tmesh, exact=exact)
        assert_near(f"mutated exact={exact}", it, dt, ij, dj)
        it = it.numpy()
        assert it[0, 0] == 5555 and it[2, 0] == 5557
        assert not np.isin(it, [0, 1, 5556]).any()
        for row in it:
            live = row[row >= 0]
            assert len(set(live.tolist())) == live.size  # deduplicated


@pytest.mark.parametrize("exact", [False, True])
def test_sharded_store_tier_matches_jax(rng, jmesh, tmesh, tmp_path, exact):
    """A base-less sharded index and one host store: the port's candidates
    are the JAX package's (but at near-ties), and the exact distances the
    same f32 numpy sums; with a memtable on shard 0."""
    base, centers = make_clustered_dataset(rng, n=2500, dim=64, k=32)
    full = rq.build_index(base, centers, key=jax.random.key(9), spill=0.1)
    jser.dump_to_dir(full, tmp_path / "full")
    fresh = rng.standard_normal((2, 64)).astype(np.float32)
    jidx = rq.insert(dataclasses.replace(full, base=None, base_bf16=None),
                     fresh, ids=[4444, 4445])
    tidx = port_copy(jidx, tmp_path)
    assert tidx.base is None and tidx.m == 2
    gpos = tp.shard_global_positions(tidx, S)
    np.testing.assert_array_equal(gpos, jp.shard_global_positions(jidx, S))
    js, ts = jp.shard_index(jidx, jmesh), tp.shard_index(tidx, tmesh)
    jstore = JMmapStore(tmp_path / "full" / "base.fvecs")
    tstore = TMmapStore(tmp_path / "full" / "base.fvecs")
    q = np.concatenate([fresh, _queries(rng, base, 14)])
    kw = dict(probe=12, topk=10, rerank=96)
    dj, ij = jp.sharded_search_with_store(js, q, jparams(**kw), jmesh,
                                          jstore, gpos, exact=exact)
    dt, it = tp.sharded_search_with_store(ts, q, tparams(**kw), tmesh,
                                          tstore, gpos, exact=exact)
    assert dt.dtype == np.float32 and it.dtype == np.int32
    assert_near("store tier", it, dt, ij, dj)
    assert it[0, 0] == 4444 and it[1, 0] == 4445
    # The same ids carry bit-equal distances (the same numpy sums).
    same = it == ij
    np.testing.assert_array_equal(dt[same], dj[same])
    # And the in-memory sharded search of the full index agrees.
    ts_full = tp.shard_index(port_copy(full, tmp_path, "full_t"), tmesh)
    df, i_f = tp.sharded_search(ts_full, torch.from_numpy(q[2:]),
                                tparams(**kw), tmesh, exact=exact)
    assert_near("store vs in-memory", it[2:], dt[2:], i_f, df)


def test_sharded_store_tier_one_copy_a_device(built, tmesh, tmp_path,
                                              monkeypatch):
    """Every shard's candidates (and the queries, given on a mesh device)
    reach the host in one copy a device (one here: all 8 shards share the
    CPU), and one get_rows a shard."""
    import rabitq_tpu_torch.store.vector_store as vs

    _, _, tidx, q = built
    lean = dataclasses.replace(tidx, base=None)
    ts = tp.shard_index(lean, tmesh)
    gpos = tp.shard_global_positions(lean, S)
    copies = []
    real = vs._to_host
    monkeypatch.setattr(vs, "_to_host",
                        lambda *t: copies.append(len(t)) or real(*t))

    class Store:
        dim = tidx.dim
        calls = 0

        def get_rows(self, pos):
            Store.calls += 1
            return tidx.base.numpy()[pos]

    p = tparams(probe=8, topk=5, rerank=32)
    a = tp.sharded_search_with_store(ts, q, p, tmesh, Store(), gpos)
    assert len(copies) == 1 and Store.calls == S
    # Queries on a mesh device ride in that device's one copy.
    b = tp.sharded_search_with_store(ts, torch.from_numpy(q), p, tmesh,
                                     Store(), gpos)
    assert len(copies) == 2 and Store.calls == 2 * S
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def test_sharded_row_filter_matches_jax(rng, jmesh, tmesh, tmp_path):
    """Each shard's penalty is the JAX shard penalty read in the dense row
    order; the memtable's on shard 0; filtered results agree."""
    base, centers = make_clustered_dataset(rng, n=2000, dim=48, k=16)
    jidx = rq.build_index(base, centers, key=jax.random.key(21))
    fresh = rng.standard_normal((2, 48)).astype(np.float32)
    jidx = rq.insert(jidx, fresh)  # ids 2000, 2001
    tidx = port_copy(jidx, tmp_path)
    js, ts = jp.shard_index(jidx, jmesh), tp.shard_index(tidx, tmesh)
    allow = np.concatenate([rng.choice(2000, 500, replace=False), [2001]])
    jf = jp.make_sharded_row_filter(js, jmesh, allow_ids=allow)
    tf = tp.make_sharded_row_filter(ts, tmesh, allow_ids=allow)
    jpen = np.asarray(jf.penalty)
    for si in range(S):
        sh = ts.shards[si]
        off = sh.offsets.numpy()
        want = jpen[si].reshape(-1)[dense_to_padded(off, np.arange(sh.n))]
        np.testing.assert_array_equal(tf[si].penalty.numpy(), want)
        if si == 0:
            np.testing.assert_array_equal(
                tf[0].extra_penalty.numpy(),
                np.asarray(jf.extra_penalty)[0])
        else:
            assert tf[si].extra_penalty is None
    q = np.concatenate([fresh, base[:10]])
    for exact in (False, True):
        kw = dict(probe=16, topk=10, rerank=512)
        dj, ij = jp.sharded_search(js, jnp.asarray(q), jparams(**kw), jmesh,
                                   exact=exact, row_filter=jf)
        dt, it = tp.sharded_search(ts, torch.from_numpy(q), tparams(**kw),
                                   tmesh, exact=exact, row_filter=tf)
        assert_near(f"filtered exact={exact}", it, dt, ij, dj)
        it = it.numpy()
        assert set(it.ravel().tolist()) - {-1} <= set(allow.tolist())
        assert 2000 not in it and it[1, 0] == 2001


def test_sharded_row_filter_reads_only_local_shards(built):
    """Rank 1 of a 2-process world holds shards 4-7 only: its filter is
    built from those shards' map_ids (the others are None), equal to the
    one-process filter's shards 4-7."""
    _, _, tidx, _ = built
    devs = tuple(torch.device("cpu") for _ in range(S))
    one = tp.shard_index(tidx, Mesh(devs))
    half = tp.shard_index(tidx, Mesh(devs, rank=1, world_size=2))
    assert half.mesh.local_shards == [4, 5, 6, 7]
    assert all(half.shards[si] is None for si in range(4))
    deny = np.arange(0, 3000, 7)
    f_one = tp.make_sharded_row_filter(one, one.mesh, deny_ids=deny)
    f_half = tp.make_sharded_row_filter(half, half.mesh, deny_ids=deny)
    assert all(f_half[si] is None for si in range(4))
    for si in range(4, S):
        assert torch.equal(f_half[si].penalty,
                           f_one[si].penalty)


def test_sharded_lloyd_step_matches_jax(rng, jmesh, tmesh):
    x, _ = make_clustered_dataset(rng, n=1027, dim=16, k=8)
    init = x[:8].copy()
    cj, costj = jp.sharded_lloyd_step(jnp.asarray(x[:1024]),
                                      jnp.asarray(init), jmesh)
    ct, costt = tp.sharded_lloyd_step(x[:1024], init, tmesh)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(costt), float(costj), rtol=1e-5)
    # Rows that do not split evenly: the padding counts in no cluster.
    c3, cost3 = tp.sharded_lloyd_step(x, init, tmesh)
    d = ((x[:, None, :] - init[None]) ** 2).sum(-1)
    lab = d.argmin(1)
    want = np.stack([x[lab == j].mean(0) for j in range(8)])
    np.testing.assert_allclose(c3.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(cost3), d.min(1).sum(), rtol=1e-4)


@pytest.mark.parametrize("bits", [1, 4])
def test_dp_build_chunk_matches_jax(rng, jmesh, tmesh, bits):
    from rabitq_tpu.ops import rotate as jrotate
    from rabitq_tpu_torch.index.serialize import codes_to_words

    base, centers = make_clustered_dataset(rng, n=256, dim=128, k=8)
    p = random_orthogonal(rng, 128)
    c_rot = np.asarray(jrotate(jnp.asarray(centers), jnp.asarray(p)))
    lj, cdj, coj, faj = jp.dp_build_chunk(jnp.asarray(base), jnp.asarray(p),
                                          jnp.asarray(c_rot), jmesh, bits)
    lt, cdt, cot, fat = tp.dp_build_chunk(base, p, c_rot, tmesh, bits)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(cdt.numpy(), np.asarray(cdj), rtol=1e-5)
    words = codes_to_words(cot, bits).numpy()
    rows = (words == np.asarray(coj)).all(axis=1)
    assert rows.mean() >= 0.99  # a grid pick at an f32 tie may differ
    np.testing.assert_allclose(fat.numpy()[rows][:, [0, 1, 3]],
                               np.asarray(faj)[rows][:, [0, 1, 3]],
                               rtol=1e-5, atol=1e-6)


_BUILDS = {
    "1bit": dict(bits=1),
    "4bit_spill": dict(bits=4, spill=0.2, balance=1.5),
    "cosine_soar": dict(bits=2, spill=0.1, spill_mode="soar",
                        metric="cosine"),
    "no_balance": dict(balance=None),
}


def _skewed(rng, n, dim):
    centers = rng.standard_normal((24, dim)).astype(np.float32)
    w = 1.0 / np.arange(1, 25) ** 1.5
    lab = rng.choice(24, size=n, p=w / w.sum())
    x = centers[lab] + 0.05 * rng.standard_normal((n, dim))
    return x.astype(np.float32), centers


def assert_shards_equal(a, b, fields=("codes", "factors", "offsets",
                                      "map_ids", "centroids_rot",
                                      "orthogonal", "rand_bias", "base")):
    assert (a.k_max, a.rows_max, a.tiles_max) == (b.k_max, b.rows_max,
                                                  b.tiles_max)
    for (si, x), (_, y) in zip(a.local(), b.local()):
        for f in ("dim", "dim_orig", "capacity", "metric", "code_bits",
                  "dedup_ids"):
            assert getattr(x, f) == getattr(y, f), (si, f)
        for f in fields:
            u, v = getattr(x, f), getattr(y, f)
            assert (u is None) == (v is None), (si, f)
            if u is not None:
                assert torch.equal(u, v), (si, f)


@pytest.mark.parametrize("name", [*_BUILDS, "skewed_split"])
def test_build_index_sharded_equals_shard_index_of_build(tmesh, name):
    rng = np.random.default_rng(5)
    if name == "skewed_split":
        base, centers = _skewed(rng, 3000, 48)
        kw = dict(bits=4, balance=1.5, spill=0.1)
    else:
        base, centers = make_clustered_dataset(rng, n=3000, dim=48, k=24)
        kw = _BUILDS[name]

    def gen():
        return torch.Generator().manual_seed(5)

    ref_index = rt.build_index(base, centers, generator=gen(), device="cpu",
                               **kw)
    if name == "skewed_split":
        assert ref_index.k > centers.shape[0]  # the split happened
    ref = tp.shard_index(ref_index, tmesh)
    new, gpos = tp.build_index_sharded(base, centers, tmesh,
                                       generator=gen(),
                                       return_global_pos=True, **kw)
    assert_shards_equal(new, ref)
    np.testing.assert_array_equal(
        gpos, tp.shard_global_positions(ref_index, S))
    lean = tp.build_index_sharded(base, centers, tmesh, generator=gen(),
                                  keep_base=False, **kw)
    assert not lean.has_base
    assert_shards_equal(lean, ref, fields=("codes", "factors", "map_ids"))
    q = torch.from_numpy(base[:12])
    p = rt.SearchParams(probe=12, topk=5, rerank=48)
    a, b = tp.sharded_search(new, q, p, tmesh), tp.sharded_search(ref, q, p,
                                                                  tmesh)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_build_index_sharded_matches_jax(jmesh, tmesh):
    """The port's direct-to-shard build against JAX's with the same
    rotation: the same shard plan, and per shard the same rows but at
    f32 ties (at most 0.1% of rows, as test_torch_build holds the two
    builds)."""
    rng = np.random.default_rng(9)
    base, centers = make_clustered_dataset(rng, n=3000, dim=64, k=16)
    p = random_orthogonal(rng, 128)
    kw = dict(orthogonal=p, bits=4, spill=0.2, balance=1.5)
    js = jp.build_index_sharded(base, centers, jmesh, key=jax.random.key(0),
                                **kw)
    ts = tp.build_index_sharded(base, centers, tmesh, **kw)
    assert ts.k_max == js.offsets.shape[1] - 1
    assert ts.capacity == js.capacity and ts.dedup_ids == js.dedup_ids
    n_rows = sum(sh.n for _, sh in ts.local())
    moved = 0
    for si, sh in ts.local():
        np.testing.assert_array_equal(sh.orthogonal.numpy(), p)
        joff = np.asarray(js.offsets[si])
        moved += np.abs(sh.offsets.numpy() - joff).max()
        jids = np.asarray(js.map_ids[si])
        moved += np.setdiff1d(sh.map_ids.numpy(), jids[jids >= 0]).size
        np.testing.assert_allclose(sh.centroids_rot.numpy(),
                                   np.asarray(js.centroids_rot[si]),
                                   rtol=1e-5, atol=1e-5)
    assert moved <= 1e-3 * n_rows, moved


def test_make_mesh_raises_with_fewer_devices():
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="CUDA device"):
        tp.make_mesh(visible + 1)
    m = tp.make_mesh(devices=["cpu", "cpu"])
    assert m.size == 2 and m.local_shards == [0, 1]
    with pytest.raises(ValueError):
        Mesh(tuple(torch.device("cpu") for _ in range(3)), world_size=2)


def test_init_distributed_single_process_is_a_no_op(monkeypatch):
    for v in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert tp.init_distributed() is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="rank"):
        tp.init_distributed("localhost:1", 2)


def test_sharded_search_rejects_an_unsharded_index(built, tmesh):
    _, _, tidx, q = built
    with pytest.raises(TypeError):
        tp.sharded_search(tidx, q, tparams(probe=4), tmesh)
    other = tp.make_mesh(devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="another mesh"):
        tp.sharded_search(tp.shard_index(tidx, other), q, tparams(probe=4),
                          tmesh)


def test_dryrun_multichip_on_a_cpu_mesh():
    from rabitq_tpu_torch.graft_entry import dryrun_multichip, entry

    line = dryrun_multichip(4, devices=["cpu"] * 4)
    assert "direct-to-shard build exact" in line
    fn, (q,) = entry("cpu")
    d, ids = fn(q)
    assert ids.shape == (16, 10) and (ids[:, 0] == torch.arange(16)).all()


# More shards than clusters holding rows: JAX pads each empty shard
# (rows_max rows of id -1, offsets all 0); so does the port.
@pytest.fixture(scope="module")
def sparse(tmp_path_factory):
    """A 4-bit JAX index of 4 clusters, to shard 8 ways, and the port's
    copy of it."""
    rng = np.random.default_rng(5)
    base, centers = make_clustered_dataset(rng, n=600, dim=32, k=4)
    jidx = rq.build_index(base, centers, key=jax.random.key(3), bits=4)
    tidx = port_copy(jidx, tmp_path_factory.mktemp("sparse"))
    assert (jidx.cluster_sizes > 0).sum() < S
    return base, centers, jidx, tidx, _queries(rng, base)


def _empty(sidx):
    return [si for si, sh in sidx.local() if int(sh.offsets[-1]) == 0]


def test_empty_shards_plan_matches_jax(sparse, jmesh, tmesh):
    _, _, jidx, tidx, _ = sparse
    js, ts = jp.shard_index(jidx, jmesh), tp.shard_index(tidx, tmesh)
    assert len(_empty(ts)) == S - 4
    assert ts.k_max == js.offsets.shape[1] - 1
    assert ts.rows_max == js.map_ids.shape[1] >= 8
    assert ts.tiles_max == js.blob.shape[1]
    for si, sh in ts.local():
        np.testing.assert_array_equal(sh.offsets.numpy(),
                                      np.asarray(js.offsets[si]))
        np.testing.assert_array_equal(sh.centroids_rot.numpy(),
                                      np.asarray(js.centroids_rot[si]))
        jids = np.asarray(js.map_ids[si])
        np.testing.assert_array_equal(sh.map_ids.numpy(), jids[: sh.n])
        if si in _empty(ts):  # padded as JAX pads: rows_max rows, id -1
            assert sh.n == ts.rows_max and (jids == -1).all()
            np.testing.assert_array_equal(sh.base.numpy(),
                                          np.asarray(js.base[si]))
    np.testing.assert_array_equal(tp.shard_global_positions(tidx, S),
                                  jp.shard_global_positions(jidx, S))


@pytest.mark.parametrize("exact", [False, True])
def test_empty_shards_search_matches_jax(sparse, jmesh, tmesh, exact):
    base, _, jidx, tidx, q = sparse
    js, ts = jp.shard_index(jidx, jmesh), tp.shard_index(tidx, tmesh)
    kw = dict(probe=4, topk=10, rerank=64)
    dj, ij = jp.sharded_search(js, jnp.asarray(q), jparams(**kw), jmesh,
                               exact=exact)
    dt, it = tp.sharded_search(ts, torch.from_numpy(q), tparams(**kw), tmesh,
                               exact=exact)
    assert_near(f"empty shards exact={exact}", it, dt, ij, dj)
    assert (it >= 0).all()  # the empty shards' +inf / -1 never win
    # And the unsharded search's answer.
    du, iu = rt.search(tidx, torch.from_numpy(q), tparams(**kw))
    assert_near("empty shards vs unsharded", it, dt, iu, du)
    # A filter over the padded shards, and the store tier.
    allow = np.arange(0, base.shape[0], 2)
    tf = tp.make_sharded_row_filter(ts, tmesh, allow_ids=allow)
    _, itf = tp.sharded_search(ts, torch.from_numpy(q), tparams(**kw),
                               tmesh, exact=exact, row_filter=tf)
    assert set(itf.numpy().ravel().tolist()) <= set(allow.tolist())


@pytest.mark.parametrize("direction,lean", [
    ("jax_to_port", False), ("jax_to_port", True), ("port_to_jax", True)])
def test_empty_shards_checkpoint_byte_identical(sparse, jmesh, tmesh,
                                                tmp_path, direction, lean):
    """Byte-identical both ways. Port to JAX runs base-less: the JAX
    loader reads an empty shard's base.fvecs as [0, 0] and asserts
    [0, dim] (rabitq_tpu/parallel/checkpoint.py:259), so it cannot load a
    checkpoint with a base and an empty shard, its own included."""
    from test_torch_shard_checkpoint import assert_same_bytes

    _, _, jidx, tidx, _ = sparse
    if lean:
        jidx = dataclasses.replace(jidx, base=None, base_bf16=None)
        tidx = dataclasses.replace(tidx, base=None)
    gpos = jp.shard_global_positions(jidx, S) if lean else None
    if direction == "jax_to_port":
        jp.dump_index_sharded(jp.shard_index(jidx, jmesh), tmp_path / "a",
                              global_pos=gpos)
        loaded = tp.load_index_sharded(tmp_path / "a", tmesh)
        assert len(_empty(loaded)) == S - 4
        tp.dump_index_sharded(loaded, tmp_path / "b",
                              global_pos=tp.load_global_positions(
                                  tmp_path / "a"))
    else:
        sidx = tp.shard_index(tidx, tmesh)
        tp.dump_index_sharded(sidx, tmp_path / "a", global_pos=gpos)
        jp.dump_index_sharded(jp.load_index_sharded(tmp_path / "a", jmesh),
                              tmp_path / "b",
                              global_pos=jp.load_global_positions(
                                  tmp_path / "a"))
        back = tp.load_index_sharded(tmp_path / "b", tmesh)
        assert_shards_equal(back, sidx,
                            fields=("codes", "factors", "offsets", "map_ids",
                                    "centroids_rot"))
    assert_same_bytes(tmp_path / "a", tmp_path / "b")


def test_empty_shards_build_index_sharded(sparse, jmesh, tmesh):
    """The direct build pads the empty shards as shard_index does (bit for
    bit), with JAX's direct build's plan."""
    base, centers, _, _, q = sparse
    kw = dict(bits=4, balance=1.5)
    ref_index = rt.build_index(base, centers, device="cpu",
                               generator=torch.Generator().manual_seed(2),
                               **kw)
    ref = tp.shard_index(ref_index, tmesh)
    new = tp.build_index_sharded(base, centers, tmesh,
                                 generator=torch.Generator().manual_seed(2),
                                 **kw)
    assert_shards_equal(new, ref)
    assert len(_empty(new)) == S - 4
    js = jp.build_index_sharded(base, centers, jmesh, key=jax.random.key(0),
                                orthogonal=new.first.orthogonal.numpy(), **kw)
    assert new.k_max == js.offsets.shape[1] - 1
    assert new.rows_max == js.map_ids.shape[1]
    for si in _empty(new):
        assert (np.asarray(js.map_ids[si]) == -1).all()
        assert (new.shards[si].map_ids == -1).all()
    p = tparams(probe=4, topk=5, rerank=32)
    a = tp.sharded_search(new, torch.from_numpy(q), p, tmesh)
    b = rt.search(ref_index, torch.from_numpy(q), p)
    assert torch.equal(a[1], b[1])
