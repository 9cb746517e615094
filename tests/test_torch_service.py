"""The port's HTTP service (rabitq_tpu_torch.service) against the JAX
package's (rabitq_tpu.service), on the CPU.

A JAX-built index and the port's copy of its arrays (port_index_from_jax)
each sit behind a BatchingEngine and make_handler of their own package.
Both servers get the request sequence of tests/test_service.py: health,
metrics, the three query protocols, bad sizes and bodies, clamping, the
per-request rerank, named filters, multi-index routing, reload gating, a
reload, and a store-backed engine (409 on reload). The status codes and
the shapes of the responses must be equal, and every id the port's server
returns must equal the port's in-process ``search`` of the same rows at
the engine's params. Mesh engines of both packages (8 shards) answer the
same requests, reload a sharded checkpoint, and the port's refuses with a
400 what it cannot serve. ``main`` hands ``--rerank-bf16`` to the engine
(which serves with the index's bf16 copy), serves a saved
directory through the block cache until SIGTERM, boots a sharded
checkpoint and ``--shards 2`` over CPU entries, shards from a CPU-loaded
index, and exits 2 on a sharded checkpoint with a local store.
"""

import dataclasses
import json
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu.parallel as jp
import rabitq_tpu_torch as rt
import rabitq_tpu_torch.parallel as tp
from conftest import make_clustered_dataset
from rabitq_tpu.index import serialize as jser
from rabitq_tpu.service import server as jserver
from rabitq_tpu.store import MmapStore as JMmapStore
from rabitq_tpu_torch.index import serialize as tser
from rabitq_tpu_torch.service import server as tserver
from rabitq_tpu_torch.service.client import query_batch_bin, query_once_bin
from rabitq_tpu_torch.store import MmapStore as TMmapStore
from torch_parity import port_index_from_jax

REPO = Path(__file__).resolve().parents[1]
ALLOW = list(range(0, 1500, 3))


def call(url, path, body=None, ctype="application/json"):
    """(status, content type, raw body) of one request (POST with a body)."""
    data = body if body is None or isinstance(body, bytes) else (
        json.dumps(body).encode())
    req = urllib.request.Request(url + path, data=data,
                                 headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def shape_of(obj):
    """The structure of a JSON value: keys, list lengths, leaf types."""
    if isinstance(obj, dict):
        return {k: shape_of(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [len(obj)] + [shape_of(v) for v in obj[:1]]
    return type(obj).__name__


def describe(status, ctype, raw):
    """What must agree between the two servers: the status, and the
    response's shape (JSON structure; binary length and header words;
    plain text with its numbers masked)."""
    if ctype == "application/json":
        return status, shape_of(json.loads(raw))
    if ctype == "application/octet-stream":
        return status, len(raw), np.frombuffer(raw[:8], np.uint32).tolist()
    return status, re.sub(rb"[0-9.]+", b"#", raw)


def bin_body(q, top_k, probe):
    return np.array([top_k, probe, q.shape[0]], np.uint32).tobytes() + (
        q.astype(np.float32).tobytes())


def sequence(url, base, base_b):
    """The request sequence of tests/test_service.py: [(name, (status,
    content type, raw body))]."""
    q = lambda i, **kw: dict(query=base[i].tolist(), **kw)  # noqa: E731
    out = [
        ("root", call(url, "/")),
        ("health", call(url, "/health")),
        ("metrics", call(url, "/metrics")),
        ("get 404", call(url, "/nope")),
        ("json", call(url, "/query", q(7, top_k=5, probe=8))),
        ("json batch", call(url, "/query", dict(
            query=base[:12].tolist(), top_k=5, probe=8))),
        ("bin", call(url, "/query_bin", bin_body(base[5], 5, 8),
                     "application/octet-stream")),
        ("bin batch", call(url, "/query_bin_batch", np.array(
            [4, 8, 32, 32], np.uint32).tobytes() + base[20:52].tobytes(),
            "application/octet-stream")),
    ]
    for i, body in enumerate((b"", b"\x00" * 11, b"\x00" * 2048)):
        out.append((f"bin bad size {i}", call(url, "/query_bin", body)))
    for i, body in enumerate((b"", b"\x00" * 16, b"\x01" + b"\x00" * 19)):
        out.append((f"bin batch bad size {i}",
                    call(url, "/query_bin_batch", body)))
    out += [
        ("missing query", call(url, "/query", dict(top_k=5))),
        ("not json", call(url, "/query", b"not json")),
        ("post 404", call(url, "/nope", {})),
        ("clamped", call(url, "/query", q(0, top_k=10**6, probe=10**6))),
        ("top_k 0", call(url, "/query", q(0, top_k=0))),
        ("probe < 0", call(url, "/query", q(0, probe=-3))),
        ("rerank 400", call(url, "/query", q(5, top_k=5, probe=8,
                                              rerank=400))),
        ("rerank huge", call(url, "/query", q(5, top_k=5, probe=8,
                                               rerank=10**9))),
        ("rerank 0", call(url, "/query", q(5, top_k=5, probe=8, rerank=0))),
        ("filter register", call(url, "/filters", dict(
            name="tenant-a", allow_ids=ALLOW))),
        ("filter append", call(url, "/filters", dict(
            name="tenant-b", deny_ids=[1, 2], append=True))),
        ("filter append mode", call(url, "/filters", dict(
            name="tenant-b", allow_ids=[3], append=True))),
        ("filters", call(url, "/filters")),
        ("filtered", call(url, "/query", q(7, top_k=10, probe=8,
                                            rerank=1500, filter="tenant-a"))),
        ("unknown filter", call(url, "/query", q(0, top_k=5, filter="nope"))),
        ("filter no ids", call(url, "/filters", dict(name="bad"))),
        ("filter both", call(url, "/filters", dict(
            name="bad", allow_ids=[1], deny_ids=[2]))),
        ("filter bad index", call(url, "/filters", dict(
            name="x", allow_ids=[1], index="ghost"))),
        ("reload disabled", call(url, "/admin/reload", {})),
        ("indexes", call(url, "/indexes")),
        ("path route", call(url, "/index/beta/query",
                            dict(query=base_b[3].tolist()))),
        ("json route", call(url, "/query", dict(query=base_b[5].tolist(),
                                                index="beta"))),
        ("json route 404", call(url, "/query", dict(
            query=base[0].tolist(), index="nope"))),
        ("path route 404", call(url, "/index/nope/query", {})),
        ("path route bin", call(url, "/index/beta/query_bin",
                                bin_body(base_b[9], 5, 8),
                                "application/octet-stream")),
    ]
    return out


@pytest.fixture(scope="module")
def servers():
    """The JAX and the port's server over the same index (and a second,
    named "beta", of another dim and bits 4)."""
    rng = np.random.default_rng(11)
    base, centers = make_clustered_dataset(rng, n=1500, dim=32, k=8)
    base_b, centers_b = make_clustered_dataset(rng, n=700, dim=40, k=8)
    jmain = rq.build_index(base, centers, key=jax.random.key(12))
    jbeta = rq.build_index(base_b, centers_b, key=jax.random.key(2), bits=4)
    made = {}
    for name, mod, main, beta in (
        ("jax", jserver, jmain, jbeta),
        ("port", tserver, port_index_from_jax(jmain),
         port_index_from_jax(jbeta)),
    ):
        eng = mod.BatchingEngine(main, max_batch=16, window_ms=5.0)
        eng_b = mod.BatchingEngine(beta, max_batch=16, window_ms=5.0)
        srv = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(
            eng, default_probe=8, default_topk=10,
            engines={"main": eng, "beta": eng_b}))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        made[name] = dict(url=f"http://127.0.0.1:{srv.server_port}",
                          engine=eng, beta=eng_b, index=main, beta_index=beta)
        made[name]["_srv"] = srv
    yield made, base, base_b
    for m in made.values():
        m["_srv"].shutdown()
        m["_srv"].server_close()
        m["engine"].close()
        m["beta"].close()


def in_process(entry, q, top_k, probe, rerank=None, row_filter=None,
               beta=False):
    """The port's in-process search of rows ``q`` at the engine's params."""
    eng = entry["beta" if beta else "engine"]
    params = eng._make_params(top_k, probe, rerank)
    index = entry["beta_index" if beta else "index"]
    d, i = rt.search(index, torch.from_numpy(np.asarray(q, np.float32)),
                     params, row_filter)
    return i.numpy()


def test_request_sequence_matches_jax(servers):
    made, base, base_b = servers
    seqs = {name: sequence(m["url"], base, base_b)
            for name, m in made.items()}
    for (name, j), (_, t) in zip(seqs["jax"], seqs["port"]):
        assert describe(*t) == describe(*j), name
    got = dict(seqs["port"])
    port = made["port"]
    ids = lambda step: json.loads(got[step][2])["ids"]  # noqa: E731
    assert ids("json") == in_process(port, base[7:8], 5, 8)[0].tolist()
    assert ids("json")[0] == 7
    assert ids("json batch") == in_process(port, base[:12], 5, 8).tolist()
    raw = np.frombuffer(got["bin"][2], np.uint32)
    assert raw[1::2].tolist() == in_process(port, base[5:6], 5, 8)[0].tolist()
    raw = np.frombuffer(got["bin batch"][2], np.uint32)[2:].reshape(32, 4, 2)
    want = np.concatenate([in_process(port, base[a : a + 16], 4, 8)
                           for a in (20, 36)])
    np.testing.assert_array_equal(raw[:, :, 0], want)
    assert ids("rerank 400") == in_process(port, base[5:6], 5, 8, 400)[0]\
        .tolist()
    assert len(ids("clamped")) <= tserver.MAX_TOPK
    rf = rt.make_row_filter(port["index"], allow_ids=ALLOW)
    assert ids("filtered") == in_process(port, base[7:8], 10, 8, 1500,
                                         rf)[0].tolist()
    assert set(ids("filtered")) <= set(ALLOW)
    assert ids("path route") == in_process(port, base_b[3:4], 10, 8,
                                           beta=True)[0].tolist()
    assert ids("json route")[0] == 5
    assert json.loads(got["filters"][2])["tenant-a"] == dict(
        mode="allow", size=len(ALLOW))
    listing = json.loads(got["indexes"][2])
    assert listing["beta"] == dict(n=700, dim=40, code_bits=4, shards=1)
    assert got["health"][2] == b"OK"


def test_client_helpers_and_concurrency(servers):
    """The port's client helpers against its server, 24 concurrent
    queries micro-batched, and /metrics counting every query."""
    made, base, _ = servers
    port = made["port"]
    url = port["url"]
    ids, scores, _ = query_once_bin(url, base[5], top_k=5, probe=8)
    assert ids[0] == 5 and scores[0] < 1e-5
    ids, scores, _ = query_batch_bin(url, base[20:52], top_k=4, probe=8)
    np.testing.assert_array_equal(ids[:, 0], np.arange(20, 52))
    rt.METRICS.reset()
    results, errors = {}, []

    def worker(i):
        st, _, raw = call(url, "/query", dict(query=base[i].tolist(),
                                              top_k=10, probe=8))
        if st != 200:
            errors.append((i, st, raw))
        else:
            results[i] = json.loads(raw)["ids"]

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(24)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert not errors and all(results[i][0] == i for i in range(24))
    text = call(url, "/metrics")[2].decode()
    assert text.startswith("query: 24, ") and ", cache miss: 0" in text
    assert rt.METRICS.rough > 0 and rt.METRICS.precise > 0


def reload_and_store_servers(mod, ser, idx1, v1_dir, device_kw, store_cls):
    """A reload-enabled server over idx1, and a store-backed one over the
    saved v1 directory (base-less index plus an mmap store)."""
    eng = mod.BatchingEngine(idx1, max_batch=8, window_ms=2.0)
    lean = ser.load_from_dir(v1_dir, keep_base=False, **device_kw)
    seng = mod.BatchingEngine(lean, store=store_cls(v1_dir / "base.fvecs"),
                              max_batch=4, window_ms=2.0)
    out = []
    for e, probe in ((eng, 8), (seng, 8)):
        srv = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(
            e, default_probe=probe, default_topk=3, allow_reload=True))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        out.append((srv, e, f"http://127.0.0.1:{srv.server_port}"))
    return out


def test_reload_and_store_engine_match_jax(tmp_path):
    """A reload over HTTP swaps a dumped corpus in (its rows answer after
    it), a missing "dir" is a 400, and a store-backed engine answers its
    queries through the store but refuses a reload with a 409; the port
    answers each request as the JAX server does."""
    rng = np.random.default_rng(31)
    base1, centers1 = make_clustered_dataset(rng, n=600, dim=24, k=8)
    base2 = base1[::-1].copy() + 10.0
    idx1 = rq.build_index(base1, centers1, key=jax.random.key(1))
    idx2 = rq.build_index(base2, centers1 + 10.0, key=jax.random.key(2))
    jser.dump_to_dir(idx1, tmp_path / "v1")
    jser.dump_to_dir(idx2, tmp_path / "v2")
    runs = {}
    for name, mod, ser, idx, kw, store_cls in (
        ("jax", jserver, jser, idx1, {}, JMmapStore),
        ("port", tserver, tser, port_index_from_jax(idx1),
         dict(device="cpu"), TMmapStore),
    ):
        (srv, eng, url), (ssrv, seng, surl) = reload_and_store_servers(
            mod, ser, idx, tmp_path / "v1", kw, store_cls)
        try:
            steps = [
                call(url, "/query", dict(query=base1[5].tolist())),
                call(url, "/admin/reload", dict(dir=str(tmp_path / "v2"))),
                call(url, "/query", dict(query=base2[7].tolist())),
                call(url, "/admin/reload", dict(nodir=1)),
                call(surl, "/query", dict(query=base1[11].tolist(),
                                          top_k=3)),
                call(surl, "/query_bin", bin_body(base1[12], 3, 8),
                     "application/octet-stream"),
                call(surl, "/admin/reload", dict(dir=str(tmp_path / "v1"))),
            ]
        finally:
            for s, e in ((srv, eng), (ssrv, seng)):
                s.shutdown()
                s.server_close()
                e.close()
        runs[name] = steps
    for j, t in zip(runs["jax"], runs["port"]):
        assert describe(*t) == describe(*j)
    t = runs["port"]
    assert [s[0] for s in t] == [200, 200, 200, 400, 200, 200, 409]
    assert json.loads(t[0][2])["ids"][0] == 5
    assert json.loads(t[1][2]) == dict(ok=True, n=600)
    assert json.loads(t[2][2])["ids"][0] == 7
    assert json.loads(t[4][2])["ids"][0] == 11
    assert np.frombuffer(t[5][2], np.uint32)[1] == 12


def test_engine_rules(tmp_path):
    """The default rerank follows code_bits as in JAX; swap_index refuses
    another dim; an unknown filter fails on the caller's thread."""
    rng = np.random.default_rng(13)
    base, centers = make_clustered_dataset(rng, n=800, dim=32, k=8)
    for bits, want in ((1, 128), (4, 48)):
        idx = port_index_from_jax(
            rq.build_index(base, centers, key=jax.random.key(12), bits=bits))
        eng = tserver.BatchingEngine(idx, max_batch=4, window_ms=1.0)
        try:
            assert eng.default_rerank == want
            p = eng._make_params(100, 10**6)
            assert (p.topk, p.probe, p.rerank) == (100, 8, max(want, 150))
            assert eng._make_params(5, 8, 1).rerank == 5
            with pytest.raises(ValueError):
                eng.submit(base[0], 5, 8, filter_name="nope")
            other = rt.build_index(base[:, :24], centers[:, :24], device="cpu",
                                   generator=torch.Generator().manual_seed(0))
            with pytest.raises(ValueError, match="query dim"):
                eng.swap_index(other)
        finally:
            eng.close()


def test_service_server_queues_32_connections_made_at_once():
    """ServiceHTTPServer's listen backlog holds 32 clients that connect
    before its accept loop takes any (the stdlib's backlog of 5 leaves
    the rest waiting for a SYN retry a second later); each then gets its
    answer."""
    rng = np.random.default_rng(17)
    base, centers = make_clustered_dataset(rng, n=400, dim=16, k=4)
    idx = rt.build_index(base, centers, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    eng = tserver.BatchingEngine(idx, max_batch=4, window_ms=1.0)
    srv = tserver.ServiceHTTPServer(("127.0.0.1", 0), tserver.make_handler(
        eng, default_probe=4, default_topk=5))
    socks = []
    loop = threading.Thread(target=srv.serve_forever, daemon=True)
    try:
        for _ in range(32):
            s = socket.create_connection(("127.0.0.1", srv.server_port),
                                         timeout=0.5)
            socks.append(s)
        loop.start()
        for s in socks:
            s.settimeout(30)
            s.sendall(b"GET /health HTTP/1.0\r\n\r\n")
        for s in socks:
            assert s.makefile("rb").readline().split()[1] == b"200"
    finally:
        for s in socks:
            s.close()
        if loop.is_alive():
            srv.shutdown()
        srv.server_close()
        eng.close()


@pytest.mark.parametrize("flag", [["--rerank-bf16"]])
def test_main_accepts_rerank_bf16(flag, tmp_path, monkeypatch):
    """``--rerank-bf16`` reaches serve(), whose engine derives the bf16
    copy and puts rerank_bf16 into every request's SearchParams, as the
    JAX service does."""
    rng = np.random.default_rng(6)
    base, centers = make_clustered_dataset(rng, n=400, dim=24, k=4)
    tser.dump_to_dir(rt.build_index(base, centers, device="cpu"),
                     tmp_path / "idx")
    served = {}
    monkeypatch.setattr(tserver, "serve",
                        lambda index, **kw: served.update(index=index, **kw))
    tserver.main(["--dir", str(tmp_path / "idx"), "--device", "cpu", *flag])
    assert served["rerank_bf16"] is True and served["store"] is None
    eng = tserver.BatchingEngine(served["index"], max_batch=8,
                                 rerank_bf16=served["rerank_bf16"])
    try:
        assert eng.index.base_bf16 is not None
        assert eng._make_params(5, 4).rerank_bf16
        _, ids = eng.submit(base[7], 5, 4)
        assert ids[0] == 7
    finally:
        eng.close()


def _mesh_servers(jidx, tidx, jmesh, tmesh):
    """A reload-enabled mesh engine of each package over its sharded copy
    of the same index, exact mode, behind its own handler."""
    made = {}
    for name, mod, sidx, mesh in (
        ("jax", jserver, jp.shard_index(jidx, jmesh), jmesh),
        ("port", tserver, tp.shard_index(tidx, tmesh), tmesh),
    ):
        eng = mod.BatchingEngine(sidx, mesh=mesh, sharded_exact=True,
                                 max_batch=16, window_ms=2.0)
        srv = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(
            eng, default_probe=8, default_topk=5, engines={"main": eng},
            allow_reload=True))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        made[name] = (srv, eng, f"http://127.0.0.1:{srv.server_port}")
    return made


def test_mesh_engine_matches_jax(tmp_path):
    """Mesh engines of both packages (8 shards; the port's on CPU entries)
    answer the same requests with the same statuses and shapes: queries
    by each protocol, a named filter, /indexes with the shard count, and
    a reload of a sharded checkpoint (written by the JAX package, loaded
    by both). The port's ids equal its in-process sharded_search at the
    engine's params."""
    rng = np.random.default_rng(41)
    base, centers = make_clustered_dataset(rng, n=1200, dim=32, k=16)
    jidx = rq.build_index(base, centers, key=jax.random.key(4), spill=0.1)
    jmesh, tmesh = jp.make_mesh(8), tp.make_mesh(devices=["cpu"] * 8)
    base2 = base + 5.0
    jidx2 = rq.build_index(base2, centers + 5.0, key=jax.random.key(5))
    jp.dump_index_sharded(jp.shard_index(jidx2, jmesh), tmp_path / "v2")
    made = _mesh_servers(jidx, port_index_from_jax(jidx), jmesh, tmesh)
    allow = list(range(0, 1200, 4))
    runs = {}
    try:
        for name, (_, _, url) in made.items():
            runs[name] = [
                call(url, "/query", dict(query=base[7].tolist(), top_k=5)),
                call(url, "/query_bin_batch", np.array(
                    [5, 8, 32, 16], np.uint32).tobytes() + base[:16].tobytes(),
                    "application/octet-stream"),
                call(url, "/filters", dict(name="quarter", allow_ids=allow)),
                call(url, "/query", dict(query=base[9].tolist(), top_k=5,
                                         filter="quarter")),
                call(url, "/indexes"),
                call(url, "/admin/reload", dict(dir=str(tmp_path / "v2"))),
                call(url, "/query", dict(query=base2[11].tolist(), top_k=5)),
            ]
        eng = made["port"][1]
        params = eng._make_params(5, 8)
        q = torch.from_numpy(base[:16])
        _, want = tp.sharded_search(tp.shard_index(
            port_index_from_jax(jidx), tmesh), q, params, tmesh, exact=True)
    finally:
        for srv, e, _ in made.values():
            srv.shutdown()
            srv.server_close()
            e.close()
    for j, t in zip(runs["jax"], runs["port"]):
        assert describe(*t) == describe(*j)
    t = runs["port"]
    assert [r[0] for r in t] == [200] * 7
    assert json.loads(t[0][2])["ids"][0] == 7
    frame = np.frombuffer(t[1][2], np.uint32)[2:].reshape(16, 5, 2)
    np.testing.assert_array_equal(frame[:, :, 0].astype(np.int64),
                                  want.numpy().astype(np.uint32))
    ids = json.loads(t[3][2])["ids"]
    assert set(ids) <= set(allow)
    assert json.loads(t[4][2])["main"]["shards"] == 8
    assert json.loads(t[5][2]) == dict(ok=True, n=1200)
    assert json.loads(t[6][2])["ids"][0] == 11


def test_mesh_engine_reload_refuses_what_it_cannot_serve(tmp_path):
    """/admin/reload of a directory a mesh engine cannot serve answers a
    JSON 400 and keeps the served index: a base-less checkpoint (no store
    serves its rerank), a plain directory, another shard count; the
    engine itself refuses a sharded index on another mesh or without a
    mesh."""
    rng = np.random.default_rng(42)
    base, centers = make_clustered_dataset(rng, n=800, dim=32, k=16)
    tidx = rt.build_index(base, centers, device="cpu")
    tmesh = tp.make_mesh(devices=["cpu"] * 4)
    lean = dataclasses.replace(tidx, base=None)
    tp.dump_index_sharded(tp.shard_index(lean, tmesh), tmp_path / "lean",
                          global_pos=tp.shard_global_positions(lean, 4))
    tser.dump_to_dir(tidx, tmp_path / "plain")
    tp.dump_index_sharded(
        tp.shard_index(tidx, tp.make_mesh(devices=["cpu"] * 2)),
        tmp_path / "two")
    eng = tserver.BatchingEngine(tp.shard_index(tidx, tmesh), mesh=tmesh,
                                 max_batch=8)
    srv = ThreadingHTTPServer(("127.0.0.1", 0), tserver.make_handler(
        eng, default_probe=8, default_topk=3, allow_reload=True))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}"
    try:
        for name, needle in (("lean", "no base"), ("plain", "not a sharded"),
                             ("two", "2 shards")):
            st, ctype, raw = call(url, "/admin/reload",
                                  dict(dir=str(tmp_path / name)))
            assert (st, ctype) == (400, "application/json"), (name, raw)
            assert needle in json.loads(raw)["error"], raw
        st, _, raw = call(url, "/query", dict(query=base[3].tolist()))
        assert st == 200 and json.loads(raw)["ids"][0] == 3
        with pytest.raises(ValueError, match="mesh engine"):
            tserver.BatchingEngine(tp.shard_index(tidx, tmesh))
        with pytest.raises(ValueError, match="on its mesh"):
            eng.swap_index(tp.shard_index(
                tidx, tp.make_mesh(devices=["cpu"] * 2)))
        with pytest.raises(ValueError, match="global_pos"):
            eng.swap_index(tp.shard_index(lean, tmesh), store=object())
    finally:
        srv.shutdown()
        srv.server_close()
        eng.close()


def _serve_main(args, tmp_path, probe_query, want_id, shards):
    """``python -m rabitq_tpu_torch.service.server ARGS`` on the CPU until
    it answers ``probe_query`` with ``want_id`` first and lists ``shards``
    shards; then SIGTERM and a clean exit."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "rabitq_tpu_torch.service.server",
         "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         *args],
        env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.communicate()[1]
            try:
                if call(url, "/health")[2] == b"OK":
                    break
            except urllib.error.URLError:
                pass
            assert time.time() < deadline, "the server never came up"
            time.sleep(0.2)
        st, _, raw = call(url, "/query", dict(query=probe_query.tolist(),
                                              top_k=3, probe=4))
        assert st == 200 and json.loads(raw)["ids"][0] == want_id
        st, _, raw = call(url, "/indexes")
        assert json.loads(raw)["default"]["shards"] == shards
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    return err


def test_main_boots_a_sharded_checkpoint(tmp_path):
    """A dump_index_sharded directory boots a mesh engine (its shard count
    from meta.json, the shards on CPU entries with --device cpu)."""
    rng = np.random.default_rng(6)
    base, centers = make_clustered_dataset(rng, n=500, dim=24, k=8)
    idx = rt.build_index(base, centers, device="cpu")
    tp.dump_index_sharded(
        tp.shard_index(idx, tp.make_mesh(devices=["cpu"] * 3)),
        tmp_path / "ckpt")
    err = _serve_main(["--dir", str(tmp_path / "ckpt"), "--sharded-exact"],
                      tmp_path, base[9], 9, 3)
    assert "loaded shard 2" in err


def test_main_shards_a_directory_over_a_cpu_mesh(tmp_path):
    """--shards 2 shards a saved directory over two CPU entries; a
    base-less store tier (--store mmap) serves through the global
    positions."""
    rng = np.random.default_rng(7)
    base, centers = make_clustered_dataset(rng, n=500, dim=24, k=8)
    tser.dump_to_dir(rt.build_index(base, centers, device="cpu"),
                     tmp_path / "idx")
    for extra in ([], ["--store", "mmap"]):
        _serve_main(["--dir", str(tmp_path / "idx"), "--shards", "2",
                     *extra], tmp_path, base[12], 12, 2)


def test_main_sharded_checkpoint_with_a_local_store_exits_2(tmp_path,
                                                            capsys):
    """--store mmap|blockcache on a sharded checkpoint exits 2 at once,
    naming the global base.fvecs it would need."""
    rng = np.random.default_rng(8)
    base, centers = make_clustered_dataset(rng, n=300, dim=24, k=8)
    idx = rt.build_index(base, centers, device="cpu")
    tp.dump_index_sharded(
        tp.shard_index(idx, tp.make_mesh(devices=["cpu"] * 2)),
        tmp_path / "ckpt")
    for store in ("mmap", "blockcache"):
        with pytest.raises(SystemExit) as ei:
            tserver.main(["--dir", str(tmp_path / "ckpt"), "--device", "cpu",
                          "--store", store])
        assert ei.value.code == 2
        err = capsys.readouterr().err
        assert str(tmp_path / "ckpt" / "base.fvecs") in err


def test_main_shards_from_a_cpu_loaded_index(tmp_path, monkeypatch):
    """--shards loads the directory onto the CPU and shards from there,
    whatever --device says: no full-size copy ever reaches a card."""
    import rabitq_tpu_torch.index.serialize as ser
    import rabitq_tpu_torch.parallel as par

    rng = np.random.default_rng(9)
    base, centers = make_clustered_dataset(rng, n=300, dim=24, k=8)
    tser.dump_to_dir(rt.build_index(base, centers, device="cpu"),
                     tmp_path / "idx")
    loads, served = [], {}
    real_load = ser.load_from_dir
    monkeypatch.setattr(ser, "load_from_dir", lambda path, **kw: (
        loads.append(kw.get("device")) or real_load(path, **kw)))
    # A CPU stand-in for the card mesh make_mesh(2) would give.
    real_mesh = par.make_mesh
    monkeypatch.setattr(par, "make_mesh",
                        lambda n=None, devices=None: real_mesh(
                            devices=devices or ["cpu"] * n))
    monkeypatch.setattr(tserver, "serve",
                        lambda index, **kw: served.update(index=index, **kw))
    tserver.main(["--dir", str(tmp_path / "idx"), "--shards", "2",
                  "--device", "cuda"])
    assert loads == ["cpu"]
    assert served["mesh"].size == 2 and served["index"].mesh.size == 2


def test_main_serves_a_saved_directory_until_sigterm(tmp_path):
    """``python -m rabitq_tpu_torch.service.server`` on the CPU: a saved
    directory served through the block cache (SQLite under tmp_path),
    --rerank-kernel accepted, a query answered, and a clean exit on
    SIGTERM."""
    rng = np.random.default_rng(5)
    base, centers = make_clustered_dataset(rng, n=500, dim=24, k=4)
    jser.dump_to_dir(rq.build_index(base, centers, key=jax.random.key(5)),
                     tmp_path / "idx")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "rabitq_tpu_torch.service.server",
         "--dir", str(tmp_path / "idx"), "--host", "127.0.0.1",
         "--port", str(port), "--store", "blockcache", "--cache-db",
         str(tmp_path / "cache.db"), "--device", "cpu", "--rerank-kernel"],
        env=dict(os.environ, PYTHONPATH=str(REPO)), cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    url = f"http://127.0.0.1:{port}"
    try:
        deadline = time.time() + 120
        while True:
            assert proc.poll() is None, proc.communicate()[1]
            try:
                if call(url, "/health")[2] == b"OK":
                    break
            except urllib.error.URLError:
                pass
            assert time.time() < deadline, "the server never came up"
            time.sleep(0.2)
        st, _, raw = call(url, "/query", dict(query=base[9].tolist(),
                                              top_k=3, probe=4))
        assert st == 200 and json.loads(raw)["ids"][0] == 9
    finally:
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err
    assert "serving 1 index(es)" in err
