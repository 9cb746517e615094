"""The port's index serialization against the JAX package's.

- A JAX ``dump_to_dir`` loads in the port and holds exactly the arrays of
  ``port_index_from_jax`` of the same index, so both search alike (equal
  results); the port's dump of that index is byte-identical to JAX's.
- A port dump loads in JAX: its JAX search (exact selection) gives the
  port's ids (``select_reduce=False``) but at near-ties.
- JSON and npz round trips, both ways.
- A directory without meta.json (the Rust reference's): capacity equal to
  JAX's, a non-dither search equal to JAX's; its dither comes from the
  ``generator=`` the port requires.
- A memtable directory and npz load with their memtable (before the
  port had mutations they were refused; the test keeps its name);
  ``keep_base=False`` then a search raises.

Cases at 128-d and at 960-d (padded to 1024, where the scan's qpack mode
is on).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu_torch as rt
from bench import make_dataset
from rabitq_tpu.index import serialize as jser
from rabitq_tpu_torch.index import serialize as tser
from torch_parity import gist_like_corpus, port_index_from_jax

_FILES = ("base.fvecs", "orthogonal.fvecs", "centroids.fvecs",
          "offsets_ids.ivecs", "factors.fvecs", "x_binary_vec.u64vecs",
          "meta.json")


def _centers(rng, base, k):
    pick = base[rng.choice(base.shape[0], k, replace=False)]
    return pick + 0.01 * rng.standard_normal(pick.shape).astype(np.float32)


@pytest.fixture(scope="module", params=["d128_bits1", "d128_bits4", "d960"])
def jax_case(request):
    """(JAX index, queries, topk, rerank, build arguments)."""
    if request.param == "d960":
        base, queries, centers, p = gist_like_corpus(n=2000, nq=8, k=16)
        kw = dict(orthogonal=p, bits=4, spill=0.2, balance=1.5)
        topk, rerank = 20, 60
    else:
        bits = 1 if request.param.endswith("1") else 4
        base, queries = make_dataset(3000, 100, 64, 16, seed=3)
        centers = _centers(np.random.default_rng(3), base, 20)
        kw = dict(bits=bits, spill=0.2 * (bits > 1), balance=1.5)
        topk, rerank = 10, 40
    jidx = rq.build_index(base, centers, key=jax.random.key(2), **kw)
    return jidx, queries, topk, rerank, dict(base=base, centroids=centers, **kw)


def _assert_same_index(a, b):
    for f in ("codes", "factors", "offsets", "map_ids", "centroids_rot",
              "orthogonal", "rand_bias", "base"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    for f in ("dim", "dim_orig", "capacity", "metric", "code_bits",
              "dedup_ids"):
        assert getattr(a, f) == getattr(b, f), f


def _search(index, queries, topk, rerank, **kw):
    return rt.search(index, torch.from_numpy(queries),
                     rt.SearchParams(probe=6, topk=topk, rerank=rerank, **kw))


def test_jax_dump_loads_in_port(tmp_path, jax_case):
    jidx, queries, topk, rerank, _ = jax_case
    jser.dump_to_dir(jidx, tmp_path / "j")
    loaded = tser.load_from_dir(tmp_path / "j", device="cpu")
    want = port_index_from_jax(jidx)
    _assert_same_index(loaded, want)
    for kw in ({}, {"dither": True}, {"select_reduce": False}):
        for got, exp in zip(_search(loaded, queries, topk, rerank, **kw),
                            _search(want, queries, topk, rerank, **kw)):
            assert torch.equal(got, exp)
    # The port's dump of the same index is the JAX dump, byte for byte.
    tser.dump_to_dir(loaded, tmp_path / "t")
    for name in _FILES:
        assert (tmp_path / "t" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes(), name


def test_port_dump_loads_in_jax(tmp_path, jax_case):
    """A port build (the JAX build's arguments) dumped by the port, loaded
    and searched by JAX with exact selection."""
    jidx, queries, topk, rerank, kw = jax_case
    pidx = rt.build_index(device="cpu", **kw)
    tser.dump_to_dir(pidx, tmp_path / "t")
    back = jser.load_from_dir(tmp_path / "t")
    assert back.capacity == pidx.capacity and back.code_bits == pidx.code_bits
    np.testing.assert_array_equal(np.asarray(back.codes),
                                  tser.codes_to_words(pidx.codes,
                                                      pidx.code_bits).numpy())
    dj, ij = rq.search(back, jnp.asarray(queries), rq.SearchParams(
        probe=6, topk=topk, rerank=rerank, select_mode="exact"))
    dt, it = _search(pidx, queries, topk, rerank, select_reduce=False)
    dj, ij, dt, it = map(np.asarray, (dj, ij, dt, it))
    np.testing.assert_allclose(dt, dj, rtol=1e-5, atol=1e-6)
    differ = it != ij
    assert differ.mean() <= 0.02
    np.testing.assert_allclose(dt[differ], dj[differ], rtol=1e-5)


def test_json_and_npz_round_trips(tmp_path, jax_case):
    """Both packages' dumps load in the port; the port's dumps load in
    both. JSON only at 128-d: it is for small indexes."""
    jidx = jax_case[0]
    want = port_index_from_jax(jidx)
    for fmt in ("npz",) if jidx.dim > 512 else ("json", "npz"):
        dump_t = getattr(tser, f"dump_to_{fmt}")
        load_t = getattr(tser, f"load_from_{fmt}")
        path_j, path_t = tmp_path / f"j.{fmt}", tmp_path / f"t.{fmt}"
        getattr(jser, f"dump_to_{fmt}")(jidx, path_j)
        _assert_same_index(load_t(path_j, device="cpu"), want)
        dump_t(want, path_t)
        _assert_same_index(load_t(path_t, device="cpu"), want)
        back = getattr(jser, f"load_from_{fmt}")(path_t)
        np.testing.assert_array_equal(np.asarray(back.codes),
                                      np.asarray(jidx.codes))
        np.testing.assert_array_equal(np.asarray(back.factors),
                                      np.asarray(jidx.factors))
        assert (back.capacity, back.dim_orig) == (jidx.capacity,
                                                  jidx.dim_orig)


def test_codes_words_round_trip(rng):
    for bits in (1, 2, 4, 7):
        m = (1 << bits) - 1
        codes = torch.from_numpy(
            (2 * rng.integers(0, m + 1, (33, 192)) - m).astype(np.int8))
        words = tser.codes_to_words(codes, bits)
        assert words.dtype == torch.uint32 and words.shape == (33, 6 * bits)
        assert torch.equal(tser.words_to_codes(words, 192, bits), codes)
    # Plane p holds bit p of u = (v + m) / 2, dim i at word i // 32, bit i % 32.
    codes = torch.full((1, 64), -15, dtype=torch.int8)
    codes[0, 33] = 15  # u = 15: bits 0..3
    codes[0, 2] = -13  # u = 1: bit 0
    words = tser.codes_to_words(codes, 4).numpy()[0]
    assert words.tolist() == [4, 2, 0, 2, 0, 2, 0, 2]


def test_metaless_directory(tmp_path):
    """A reference-style directory: capacity equal to JAX's, non-dither
    search equal to JAX's; the dither comes from the generator."""
    base, queries = make_dataset(3000, 100, 64, 16, seed=4)
    centers = _centers(np.random.default_rng(4), base, 20)
    jidx = rq.build_index(base, centers, key=jax.random.key(1), bits=1,
                          balance=None, split=False)
    jser.dump_to_dir(jidx, tmp_path)
    (tmp_path / "meta.json").unlink()
    with pytest.raises(ValueError, match="generator"):
        tser.load_from_dir(tmp_path, device="cpu")
    gen = torch.Generator().manual_seed(5)
    pidx = tser.load_from_dir(tmp_path, generator=gen)
    jback = jser.load_from_dir(tmp_path)
    assert pidx.capacity == jback.capacity
    assert (pidx.dim_orig, pidx.code_bits, pidx.dedup_ids) == (
        jback.dim_orig, 1, False)
    assert torch.equal(pidx.rand_bias,
                       torch.rand(pidx.dim, generator=torch.Generator()
                                  .manual_seed(5)))
    dj, ij = rq.search(jback, jnp.asarray(queries), rq.SearchParams(
        probe=6, topk=10, rerank=40, select_mode="exact"))
    dt, it = _search(pidx, queries, 10, 40, select_reduce=False)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-5)


def test_memtable_refused_and_baseless_search_raises(tmp_path):
    base, queries = make_dataset(1500, 64, 32, 4, seed=6)
    centers = _centers(np.random.default_rng(6), base, 8)
    jidx = rq.build_index(base, centers, key=jax.random.key(0))
    mem = rq.insert(jidx, base[:5] + 0.5)
    jser.dump_to_dir(mem, tmp_path / "mem")
    jser.dump_to_npz(mem, tmp_path / "mem.npz")
    for got in (tser.load_from_dir(tmp_path / "mem", device="cpu"),
                tser.load_from_npz(tmp_path / "mem.npz", device="cpu")):
        np.testing.assert_array_equal(got.extra_base.numpy(),
                                      np.asarray(mem.extra_base))
        np.testing.assert_array_equal(got.extra_ids.numpy(),
                                      np.asarray(mem.extra_ids))

    jser.dump_to_dir(jidx, tmp_path / "plain")
    idx = tser.load_from_dir(tmp_path / "plain", keep_base=False,
                             device="cpu")
    assert idx.base is None
    with pytest.raises(ValueError, match="store tier"):
        rt.search(idx, torch.from_numpy(queries),
                  rt.SearchParams(probe=4, topk=5, rerank=20))
    with pytest.raises(ValueError, match="base"):
        tser.dump_to_dir(idx, tmp_path / "again")
    tser.dump_to_dir(idx, tmp_path / "again", require_base=False)
    assert not (tmp_path / "again" / "base.fvecs").exists()
    meta = json.loads((tmp_path / "again" / "meta.json").read_text())
    assert meta["capacity"] == jidx.capacity
