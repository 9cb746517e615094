"""The port's store tier (rabitq_tpu_torch.store) against the JAX
package's (rabitq_tpu.store), case for case with tests/test_store.py.

A JAX-built index is dumped and loaded base-less in both packages. Each
store kind (device, mmap, block cache with and without SQLite, HTTP range
reads against a 206 server and against a server that answers 200 with the
whole object) serves the rerank of one ``search_with_store`` call in each
package: JAX with ``approx_select=False``, the port with
``select_reduce=False``. Both compute the exact distances in f32 numpy over
the same rows, so the ids must be equal and the distances bit-equal. Also:
mutated (memtable and tombstones), cosine and filtered indexes; the block
cache's single flight, batched SQLite commits, retries and metadata
bootstrap; the /metrics wording; and that no port module imports JAX.
"""

import functools
import http.server
import re
import threading
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu_torch as rt
from conftest import make_clustered_dataset
from rabitq_tpu import metrics as jmetrics
from rabitq_tpu import store as jstore
from rabitq_tpu.index import serialize as jser
from rabitq_tpu_torch import metrics as tmetrics
from rabitq_tpu_torch import store as tstore
from rabitq_tpu_torch.index import serialize as tser
from test_torch_mutate import port_of

REPO = Path(__file__).resolve().parents[1]
N, DIM, K = 3000, 32, 16


class RangeHandler(http.server.SimpleHTTPRequestHandler):
    """Serves a directory, honouring ``Range: bytes=a-b`` with a 206 (an
    object store's behaviour); plain GETs and HEADs as the base class."""

    def do_GET(self):
        rng_hdr = self.headers.get("Range")
        if not rng_hdr:
            return super().do_GET()
        data = Path(self.translate_path(self.path)).read_bytes()
        a, b = rng_hdr[len("bytes="):].split("-")
        lo, hi = int(a), min(int(b), len(data) - 1)
        body = data[lo : hi + 1]
        self.send_response(206)
        self.send_header("Content-Range", f"bytes {lo}-{hi}/{len(data)}")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *a):
        pass


class FullBodyHandler(http.server.SimpleHTTPRequestHandler):
    """Ignores Range: every GET answers 200 with the whole file."""

    def log_message(self, *a):
        pass


def serve_dir(handler, directory):
    """A ThreadingHTTPServer over ``directory`` on 127.0.0.1; returns it
    and its URL prefix."""
    httpd = ThreadingHTTPServer(
        ("127.0.0.1", 0), functools.partial(handler, directory=str(directory))
    )
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, f"http://127.0.0.1:{httpd.server_port}"


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(21)
    base, centers = make_clustered_dataset(rng, n=N, dim=DIM, k=K)
    queries = base[rng.choice(N, 24, replace=False)] + np.float32(0.01)
    return base, centers, queries


@pytest.fixture(scope="module", params=[1, 4], ids=["bits1", "bits4"])
def case(request, corpus, tmp_path_factory):
    """A spilled JAX build (bits 1 or 4) dumped, and the dump loaded
    base-less in both packages, with HTTP servers over the directory."""
    base, centers, queries = corpus
    jidx = rq.build_index(base, centers, key=jax.random.key(3),
                          bits=request.param, spill=0.2)
    d = tmp_path_factory.mktemp(f"store_bits{request.param}") / "index"
    jser.dump_to_dir(jidx, d)
    range_srv, range_url = serve_dir(RangeHandler, d)
    full_srv, full_url = serve_dir(FullBodyHandler, d)
    yield dict(
        jidx=jidx, dir=d, queries=queries,
        jlean=jser.load_from_dir(d, keep_base=False),
        tlean=tser.load_from_dir(d, keep_base=False, device="cpu"),
        tfull=tser.load_from_dir(d, device="cpu"),
        range_url=range_url, full_url=full_url,
    )
    for srv in (range_srv, full_srv):
        srv.shutdown()
        srv.server_close()


def make_stores(kind, c, tmp_path):
    """The (JAX, port) stores of one kind over the case's directory."""
    fvecs, dim = c["dir"] / "base.fvecs", c["tlean"].dim
    if kind == "device":
        return (jstore.DeviceStore(c["jidx"].base),
                tstore.DeviceStore(c["tfull"].base))
    if kind == "mmap":
        return jstore.MmapStore(fvecs), tstore.MmapStore(fvecs)
    if kind in ("blockcache", "blockcache_sqlite"):
        sql = kind == "blockcache_sqlite"
        return tuple(
            mod.BlockCachedStore(
                mod.FileBlockSource(fvecs), dim,
                sqlite_path=tmp_path / f"{name}.db" if sql else None)
            for name, mod in (("jax", jstore), ("port", tstore)))
    url = c["range_url" if kind == "http206" else "full_url"] + "/base.fvecs"
    return tuple(mod.BlockCachedStore(mod.HttpRangeSource(url), dim)
                 for mod in (jstore, tstore))


def both_with_store(jidx, tidx, queries, jst, tst, probe=6, topk=10,
                    rerank=40, jf=None, tf=None):
    """One search_with_store of each package: (JAX dists, ids), (port
    dists, ids)."""
    jp = rq.SearchParams(probe=probe, topk=topk, rerank=rerank,
                         approx_select=False)
    tp = rt.SearchParams(probe=probe, topk=topk, rerank=rerank,
                         select_reduce=False)
    j = jstore.search_with_store(jidx, queries, jp, jst, row_filter=jf)
    t = tstore.search_with_store(tidx, queries, tp, tst, row_filter=tf)
    return j, t


def assert_bit_equal(j, t):
    (dj, ij), (dt, it) = j, t
    assert dt.dtype == np.float32 and it.dtype == np.int32
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(dt.view(np.uint32), dj.view(np.uint32))


STORE_KINDS = ["device", "mmap", "blockcache", "blockcache_sqlite",
               "http206", "http200"]


@pytest.mark.parametrize("kind", STORE_KINDS)
def test_search_with_store_matches_jax(case, kind, tmp_path):
    jst, tst = make_stores(kind, case, tmp_path)
    j, t = both_with_store(case["jlean"], case["tlean"], case["queries"],
                           jst, tst)
    assert_bit_equal(j, t)
    assert (t[1][:, 0] >= 0).all()
    if kind.startswith(("blockcache", "http")):
        assert tst.cache_backend == "native"


def test_search_with_store_takes_device_queries_and_counts(case):
    """Queries given as a tensor on the index's device give the same
    result as numpy ones; the counters move as the JAX package's do."""
    q = case["queries"]
    tp = rt.SearchParams(probe=6, topk=10, rerank=40, select_reduce=False)
    jp = rq.SearchParams(probe=6, topk=10, rerank=40, approx_select=False)
    store = tstore.DeviceStore(case["tfull"].base)
    counts = []
    for mod, idx, st, p, qq in (
        (jmetrics, case["jlean"], jstore.DeviceStore(case["jidx"].base), jp,
         q),
        (tmetrics, case["tlean"], store, tp, torch.from_numpy(q)),
    ):
        mod.METRICS.reset()
        out = (jstore if mod is jmetrics else tstore).search_with_store(
            idx, qq, p, st)
        m = mod.METRICS
        counts.append(((m.query, m.rough, m.precise, m.miss), out))
    (jc, jout), (tc, tout) = counts
    assert tc == jc and tc[0] == len(q) and tc[1] > 0 and tc[2] > 0
    assert_bit_equal(jout, tout)


def test_block_cache_rows_and_misses_match_jax(case):
    """get_rows (grouped by block with one argsort) returns the JAX
    store's rows for unsorted, repeated positions across blocks, and the
    same blocks miss: a cold pass fetches each distinct block once, a warm
    pass none, an LRU of one block refetches."""
    n, dim = case["tfull"].n, case["tfull"].dim
    fvecs = case["dir"] / "base.fvecs"
    pos = np.random.default_rng(0).integers(0, n, 700)
    pos[:3] = [n - 1, 0, n - 1]
    want = tstore.MmapStore(fvecs).get_rows(pos)
    jst = jstore.BlockCachedStore(jstore.FileBlockSource(fvecs), dim)
    tst = tstore.BlockCachedStore(tstore.FileBlockSource(fvecs), dim)
    blocks = len(np.unique(pos // tst.num_per_block))
    assert blocks >= 3
    for mod, st in ((jmetrics, jst), (tmetrics, tst)):
        mod.METRICS.reset()
        np.testing.assert_array_equal(st.get_rows(pos), want)
        assert mod.METRICS.miss == blocks
        np.testing.assert_array_equal(st.get_rows(pos), want)
        assert mod.METRICS.miss == blocks
    assert tst.get_rows(np.array([], np.int64)).shape == (0, dim)
    tiny = tstore.BlockCachedStore(tstore.FileBlockSource(fvecs), dim,
                                   max_cached_blocks=1)
    tmetrics.METRICS.reset()
    for p in (0, tiny.num_per_block, 0):
        tiny.get_rows(np.array([p]))
    assert tmetrics.METRICS.miss == 3


def test_dict_fallback_when_native_is_unavailable(case, monkeypatch, caplog):
    """A failed native build falls back to the dict LRU, visibly: a
    warning and cache_backend "dict"; the rows are the same."""
    import rabitq_tpu_torch.native as tnative

    def unavailable(*a, **k):
        raise tnative.NativeUnavailable("no compiler here")

    monkeypatch.setattr(tnative, "get_lib", unavailable)
    fvecs = case["dir"] / "base.fvecs"
    with caplog.at_level("WARNING"):
        st = tstore.BlockCachedStore(tstore.FileBlockSource(fvecs),
                                     case["tfull"].dim, max_cached_blocks=2)
    assert st.cache_backend == "dict"
    assert "dict LRU" in caplog.text
    pos = np.arange(0, case["tfull"].n, 97)
    np.testing.assert_array_equal(
        st.get_rows(pos), tstore.MmapStore(fvecs).get_rows(pos))


def test_mutated_and_filtered_index_matches_jax(case):
    """A memtable (inserts, one of them deleted) and tombstones, carried
    across as test_torch_mutate.port_of does, searched through the store
    with and without an allowlist filter (its memtable penalty included)."""
    jidx, q = case["jidx"], case["queries"]
    rng = np.random.default_rng(8)
    jm = rq.insert(jidx, q[:6] + np.float32(0.002))
    new_ids = np.asarray(jm.extra_ids)
    jm = rq.delete(jm, np.r_[rng.choice(N, 40, replace=False), new_ids[:1]])
    tm = port_of(jm)
    allow = np.r_[rng.choice(N, N // 3, replace=False), new_ids[2:4]]
    jf = rq.make_row_filter(jm, allow_ids=allow)
    tf = rt.make_row_filter(tm, allow_ids=allow)
    jst, tst = jstore.DeviceStore(jm.base), tstore.DeviceStore(tm.base)
    plain = both_with_store(jm, tm, q, jst, tst)
    assert_bit_equal(*plain)
    assert np.isin(new_ids[1:6], plain[1][1]).all()
    filt = both_with_store(jm, tm, q, jst, tst, probe=10, rerank=120,
                           jf=jf, tf=tf)
    assert_bit_equal(*filt)
    got = filt[1][1]
    assert np.isin(got[got >= 0], allow).all()


def test_cosine_index_matches_jax(corpus, tmp_path):
    base, centers, _ = corpus
    jidx = rq.build_index(base[:1200], centers, key=jax.random.key(4),
                          metric="cosine")
    jser.dump_to_dir(jidx, tmp_path / "cos")
    tl = tser.load_from_dir(tmp_path / "cos", keep_base=False, device="cpu")
    jl = jser.load_from_dir(tmp_path / "cos", keep_base=False)
    q = np.float32(3.7) * base[:8]  # non-unit queries
    fvecs = tmp_path / "cos" / "base.fvecs"
    j, t = both_with_store(jl, tl, q, jstore.MmapStore(fvecs),
                           tstore.MmapStore(fvecs), probe=8, topk=5,
                           rerank=60)
    assert_bit_equal(j, t)
    np.testing.assert_array_equal(t[1][:, 0], np.arange(8))


class CountingSource:
    """Range source that counts fetches and can stall to widen races."""

    def __init__(self, inner, delay=0.0):
        self.inner, self.size, self.delay = inner, inner.size, delay
        self.calls = 0
        self._lock = threading.Lock()

    def read_range(self, start, length):
        import time

        with self._lock:
            self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        return self.inner.read_range(start, length)


def test_single_flight_block_fetch(case):
    """8 threads missing on the same blocks trigger one range read per
    block."""
    fvecs = case["dir"] / "base.fvecs"
    src = CountingSource(tstore.FileBlockSource(fvecs), delay=0.01)
    store = tstore.BlockCachedStore(src, case["tfull"].dim)
    pos = np.arange(0, case["tfull"].n, store.num_per_block // 2)
    n_blocks = len(np.unique(pos // store.num_per_block))
    assert n_blocks >= 2
    want = tstore.MmapStore(fvecs).get_rows(pos)
    results, barrier = [], threading.Barrier(8)

    def worker():
        barrier.wait()
        results.append(store.get_rows(pos))

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    assert src.calls == n_blocks and len(results) == 8
    for r in results:
        np.testing.assert_array_equal(r, want)


def test_sqlite_commits_are_batched_and_persist(case, tmp_path):
    """Commits happen every _sql_commit_every inserts; flush() forces the
    tail out; a second store on the same file fetches nothing."""
    import sqlite3

    fvecs = case["dir"] / "base.fvecs"
    db = tmp_path / "cache.db"
    dim = case["tfull"].dim
    store = tstore.BlockCachedStore(tstore.FileBlockSource(fvecs), dim,
                                    sqlite_path=db)
    store._sql_commit_every = 2
    n_blocks = (case["tfull"].n - 1) // store.num_per_block + 1
    want = min(n_blocks, 3)  # > one commit batch, with a pending tail
    assert want == 3
    pos = np.arange(want, dtype=np.int64) * store.num_per_block
    for p in pos:  # one block at a time: get_rows' own flush comes after
        store._get_block(int(p) // store.num_per_block)
    other = sqlite3.connect(db)
    assert other.execute("SELECT COUNT(*) FROM blocks").fetchone()[0] == 2
    store.flush()
    assert other.execute("SELECT COUNT(*) FROM blocks").fetchone()[0] == 3
    other.close()
    src = CountingSource(tstore.FileBlockSource(fvecs))
    again = tstore.BlockCachedStore(src, dim, sqlite_path=db)
    np.testing.assert_array_equal(again.get_rows(pos),
                                  tstore.MmapStore(fvecs).get_rows(pos))
    assert src.calls == 0


def flaky_server(path, fail, truncate):
    """A 206 server over one file that answers the next ``fail["n"]``
    GETs with a 500 and the next ``truncate["n"]`` with half the body;
    counts GETs in ``fail["gets"]``."""

    class Flaky(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            fail["gets"] += 1
            if fail["n"] > 0:
                fail["n"] -= 1
                self.send_response(500)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            data = path.read_bytes()
            a, b = self.headers["Range"][len("bytes="):].split("-")
            lo, hi = int(a), min(int(b), len(data) - 1)
            body = data[lo : hi + 1]
            if truncate["n"] > 0:
                truncate["n"] -= 1
                body = body[: len(body) // 2]
            self.send_response(206)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_HEAD(self):
            self.send_response(200)
            self.send_header("Content-Length", str(path.stat().st_size))
            self.end_headers()

        def log_message(self, *a):
            pass

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Flaky)
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def test_transient_failures_are_retried(case):
    """A 500 costs one extra GET and never fails the read; a truncated
    206 is retried; exhausted retries raise one OSError."""
    fvecs = case["dir"] / "base.fvecs"
    want = tstore.MmapStore(fvecs).get_rows(np.array([0, 1]))
    fail, truncate = {"n": 0, "gets": 0}, {"n": 0}
    httpd = flaky_server(fvecs, fail, truncate)
    url = f"http://127.0.0.1:{httpd.server_port}/base.fvecs"
    dim = case["tfull"].dim
    try:
        store = tstore.BlockCachedStore(
            tstore.HttpRangeSource(url, backoff=0.001), dim)
        fail["n"] = 1
        np.testing.assert_array_equal(store.get_rows(np.array([0, 1])), want)
        assert fail["gets"] == 2
        store = tstore.BlockCachedStore(
            tstore.HttpRangeSource(url, backoff=0.001), dim)
        truncate["n"], fail["gets"] = 1, 0
        np.testing.assert_array_equal(store.get_rows(np.array([0, 1])), want)
        assert fail["gets"] == 2
        fail["n"] = 99
        store = tstore.BlockCachedStore(
            tstore.HttpRangeSource(url, retries=2, backoff=0.001), dim)
        with pytest.raises(OSError, match="2 attempts failed"):
            store.get_rows(np.array([0]))
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_download_meta_bootstrap(case, tmp_path):
    """The metadata files come from an HTTP prefix (base.fvecs stays
    remote), a second call fetches nothing, and the bootstrapped index
    searched through an HTTP block cache equals JAX's."""
    local = tmp_path / "local"
    tstore.download_meta(case["range_url"], local)
    for name in tstore.vector_store.META_FILES + ("meta.json",):
        assert (local / name).read_bytes() == (case["dir"] / name).read_bytes()
    assert not (local / "base.fvecs").exists()
    tstore.download_meta(case["range_url"], local)  # idempotent
    tl = tser.load_from_dir(local, keep_base=False, device="cpu")
    url = case["range_url"] + "/base.fvecs"
    tmetrics.METRICS.reset()
    j, t = both_with_store(
        case["jlean"], tl, case["queries"],
        jstore.BlockCachedStore(jstore.HttpRangeSource(url), tl.dim),
        tstore.BlockCachedStore(tstore.HttpRangeSource(url), tl.dim))
    assert_bit_equal(j, t)
    assert tmetrics.METRICS.miss > 0


@pytest.mark.parametrize("ops", [
    [],
    [("query", 3), ("rough", 1000), ("precise", 37), ("miss", 2)],
    [("rough", 5), ("query", 1), ("reset", 0), ("query", 2), ("miss", 9),
     ("precise", 3), ("rough", 10)],
])
def test_metrics_wording_matches_jax(ops):
    """/metrics text: the same adds give the same to_str in both
    packages, ", cache miss: N" included."""
    mets = (jmetrics.Metrics(), tmetrics.Metrics())
    for name, n in ops:
        for m in mets:
            if name == "reset":
                m.reset()
            else:
                getattr(m, f"add_{name}_count")(n)
    assert mets[1].to_str() == mets[0].to_str()
    assert mets[1].to_str().endswith(f", cache miss: {mets[0].miss}")


def test_baseless_search_names_the_store_tier(case):
    with pytest.raises(ValueError, match="search_with_store"):
        rt.search(case["tlean"], torch.from_numpy(case["queries"]),
                  rt.SearchParams(probe=4, topk=5, rerank=20))


IMPORT_OF_JAX = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|rabitq_tpu)(?:[.\s]|$)", re.M)


def test_no_port_module_imports_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (the machine with the card has no JAX)."""
    files = sorted((REPO / "rabitq_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 30
    for entry in ("tools/bench.py", "examples/quickstart.py",
                  "examples/mutations.py", "examples/disk_tier.py",
                  "examples/distributed.py"):
        assert REPO / "rabitq_tpu_torch" / entry in files, entry
    bad = [str(f.relative_to(REPO)) for f in files
           if IMPORT_OF_JAX.search(f.read_text())]
    assert not bad, bad
