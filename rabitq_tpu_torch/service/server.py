"""HTTP query service (port of rabitq_tpu.service.server).

    python -m rabitq_tpu_torch.service.server --dir index_dir --port 9000 \\
        [--store device|mmap|blockcache|http] [--device cuda] \\
        [--shards N] [--sharded-exact]

Endpoints: ``GET /``, ``/health``, ``/metrics``, ``/indexes`` and
``/filters``; ``POST /query`` with JSON ``{query, top_k, probe}`` (one row
or a list of rows; optional ``index``, ``rerank`` and ``filter``) ->
``{ids, scores}``; ``POST /query_bin`` and ``/query_bin_batch`` (binary
frames); ``POST /index/<name>/...`` (the same endpoints on a named index);
``POST /filters``; ``POST /admin/reload`` (off unless ``--allow-reload``).

Concurrency: requests are **micro-batched**. A dispatcher thread drains
the request queue every ``window_ms`` (or as soon as ``max_batch`` rows
wait) and issues one search call for the batch, grouped by (params,
filter): the kernels launch from the dispatcher thread, on its current
stream. Each group searches exactly its rows (the JAX package pads a
group to a power-of-two bucket to bound XLA's compile cache; torch
compiles nothing per shape).

Named row filters: ``POST /filters`` registers an allow or deny id
predicate on an engine; queries carrying ``"filter": name`` return only
ids passing it (index/filter.py). Specs are kept by original id and
survive ``/admin/reload``; the penalty on the device is rebuilt lazily
for each index generation.

Not-found contract (fewer than top_k reachable vectors): invalid slots
never appear as results. Variable-length endpoints (JSON ``/query``,
counted ``/query_bin``) return fewer entries; the fixed-stride
``/query_bin_batch`` frame marks them id ``0xFFFFFFFF`` / score ``+inf``.

Mesh serving: an engine given a ``mesh`` serves a sharded index
(parallel/sharding.py): every batch runs sharded_search over the mesh, or
sharded_search_with_store with a store and the global positions. ``main``
boots a dump_index_sharded checkpoint directory directly, and ``--shards
N`` shards a plain directory loaded on the CPU (so that no full copy ever
sits on a card). The mesh is one shard per card (make_mesh, which raises
on a host with fewer cards), or with ``--device cpu`` N entries of the
CPU.

``--rerank-bf16`` (``BatchingEngine(rerank_bf16=True)``) serves with the
two-level rerank: the engine derives the index's bf16 copy
(with_bf16_base) at boot and again on every ``swap_index``, and its
requests carry ``SearchParams.rerank_bf16``; a store-tier engine ignores
it, as the JAX service does. ``--rerank-kernel`` is accepted and changes
nothing, since the port always reranks with its gather_l2 kernel.
"""

from __future__ import annotations

import argparse
import json
import logging
import queue
import signal
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import torch

from rabitq_tpu_torch.index.index import SearchParams, with_bf16_base
from rabitq_tpu_torch.metrics import METRICS

logger = logging.getLogger(__name__)


@dataclass
class _Request:
    query: np.ndarray  # [m, dim] — one or more rows
    params: SearchParams
    done: threading.Event = field(default_factory=threading.Event)
    ids: np.ndarray | None = None
    scores: np.ndarray | None = None
    error: str | None = None
    # Named predicate (BatchingEngine.register_filter); requests
    # micro-batch only with requests carrying the SAME filter (one search
    # call carries one penalty array).
    filter_name: str | None = None


# Server-side caps on client-supplied knobs: rerank scales device memory,
# so unclamped values let an untrusted client grow it without bound.
MAX_TOPK = 1024
MAX_PROBE = 4096
MAX_RERANK = 8192


class BatchingEngine:
    """Groups concurrent queries into single batched search calls, on the
    index's device (the in-memory tier) or, with a ``store``, through the
    store tier (store/vector_store.py search_with_store).

    ``mesh`` serves a sharded index (shard_index, build_index_sharded,
    load_index_sharded) over that mesh: sharded_search, or with a store
    sharded_search_with_store, which needs ``global_pos``
    (shard_global_positions, load_global_positions). ``sharded_exact``
    selects the exact-mode budgets (recall at least the unsharded
    index's, about S times the scan work). ``rerank_bf16`` serves with the
    two-level rerank on the index's bf16 copy, derived here and on every
    swap_index (ignored when a store serves the rerank)."""

    def __init__(
        self,
        index,
        store=None,
        *,
        max_batch: int = 64,
        window_ms: float = 2.0,
        default_rerank: int | None = None,
        mesh=None,
        global_pos=None,
        sharded_exact: bool = False,
        rerank_bf16: bool = False,
    ):
        self._mesh = mesh
        self._sharded_exact = sharded_exact
        self._check_serves(index, store, global_pos)
        self.rerank_bf16 = rerank_bf16 and store is None
        if self.rerank_bf16:
            index = with_bf16_base(index)  # one copy a shard on a mesh
        if default_rerank is None:
            # Multi-bit indexes rank candidates near-exactly, so the
            # default budget only covers fold/selection collisions; 1-bit
            # needs ~10x topk. The JAX service's defaults.
            default_rerank = 48 if index.code_bits >= 3 else 128
        # (index, store, generation, global positions) live in ONE
        # attribute so a concurrent swap_index can never be observed torn
        # by the dispatcher.
        self._istate = (index, store, 0, global_pos)
        # Named row filters: specs live as original-id sets (independent
        # of the index's row order); built RowFilters are position-based
        # and cached per index generation, so swap_index invalidates
        # them. The lock guards registry mutation and the build-cache fill.
        self._filters: dict[str, tuple[str, np.ndarray]] = {}
        self._filters_built: dict[str, tuple[int, object]] = {}
        # Per-generation RowFilterContext: hoists the id sort out of each
        # tenant's build, so a reload rebuilds T tenant filters in
        # O(n log n + sum_t m_t log n).
        self._fctx: tuple[int, object] | None = None
        self._flock = threading.Lock()
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self.default_rerank = default_rerank
        self._q: queue.Queue[_Request] = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @property
    def index(self):
        return self._istate[0]

    @property
    def store(self):
        return self._istate[1]

    @property
    def mesh(self):
        return self._mesh

    @property
    def device(self) -> torch.device:
        if self._mesh is not None:
            return self._mesh.home
        return self.index.codes.device

    @property
    def n_rows(self) -> int:
        """Indexed row count (spill copies included, like index.n). On a
        mesh engine, the rows with an id over the shards, as the JAX
        service counts them (tombstones excluded)."""
        if self._mesh is not None:
            return self.index.live_rows()
        return self.index.n

    def _check_serves(self, index, store, global_pos) -> None:
        """ValueError unless this engine can serve ``index``: a plain
        index, or for a mesh engine a sharded index on its mesh with a
        base on the devices unless a store (and the global positions)
        serves the rerank."""
        from rabitq_tpu_torch.parallel import ShardedIndex

        sharded = isinstance(index, ShardedIndex)
        if self._mesh is None:
            if sharded:
                raise ValueError("a sharded index needs a mesh engine")
            return
        if not sharded or index.mesh != self._mesh:
            raise ValueError("a mesh engine serves a sharded index on its "
                             "mesh (shard_index, build_index_sharded, "
                             "load_index_sharded)")
        if store is None and not index.has_base:
            raise ValueError("the sharded index has no base and no store "
                             "serves its rerank")
        if store is not None and global_pos is None:
            raise ValueError("sharded store-tier serving needs global_pos "
                             "(shard_global_positions, "
                             "load_global_positions)")

    def swap_index(self, index, store=None, global_pos=None) -> None:
        """Atomically replace the served index (online reindex: build or
        ``compact`` elsewhere, then swap — in-flight batches finish on
        the old index, later batches see the new one; no restart, no
        dropped requests). The store pairs with the index, so both move
        in one assignment. A mesh engine takes a sharded index on its
        mesh (with ``global_pos`` when store-tiered). Raises ValueError
        when the engine cannot serve ``index``."""
        if index.dim_orig != self.index.dim_orig:
            raise ValueError(
                "swap_index requires the query dim to stay fixed "
                f"({index.dim_orig} != {self.index.dim_orig})"
            )
        self._check_serves(index, store, global_pos)
        if self.rerank_bf16 and store is None:
            index = with_bf16_base(index)
        # The generation rides in the same tuple as the index so the
        # dispatcher's snapshot can never pair an index with another
        # generation's filter cache.
        self._istate = (index, store, self._istate[2] + 1, global_pos)
        # Built filters are position-based; the new index's row order
        # differs. Specs survive and rebuild lazily on next use.
        self._filters_built.clear()

    def register_filter(
        self, name: str, allow_ids=None, deny_ids=None, append: bool = False
    ) -> int:
        """Register (or replace) a named id predicate for ``submit(...,
        filter_name=)`` / the JSON ``"filter"`` field. The spec is kept
        by original ids and survives ``swap_index``. Returns the spec
        size. ``append=True`` extends an existing same-mode spec's id set
        instead of replacing it (id lists larger than one request body)."""
        if (allow_ids is None) == (deny_ids is None):
            raise ValueError("pass exactly one of allow_ids / deny_ids")
        mode = "allow" if allow_ids is not None else "deny"
        ids = np.asarray(
            allow_ids if allow_ids is not None else deny_ids, dtype=np.int64
        ).ravel()
        with self._flock:
            if append:
                prev = self._filters.get(name)
                if prev is not None:
                    if prev[0] != mode:
                        raise ValueError(
                            f"append mode mismatch: {name!r} is "
                            f"{prev[0]!r}, got {mode!r}"
                        )
                    ids = np.concatenate([prev[1], ids])
            self._filters[name] = (mode, ids)
            self._filters_built.pop(name, None)
        return int(ids.size)

    def filter_specs(self) -> dict[str, tuple[str, int]]:
        """{name: (mode, spec size)} for the /filters listing."""
        with self._flock:
            items = list(self._filters.items())
        return {n: (m, int(i.size)) for n, (m, i) in items}

    def has_filter(self, name: str) -> bool:
        with self._flock:
            return name in self._filters

    def _resolve_filter(self, name: str | None, index, gen: int):
        """Name -> RowFilter on the index's device (one a shard on a mesh
        engine), built for this index generation."""
        if name is None:
            return None
        from rabitq_tpu_torch.index.filter import (
            RowFilterContext,
            make_row_filter,
        )
        from rabitq_tpu_torch.parallel import make_sharded_row_filter

        spec = self._filters.get(name)
        if spec is None:
            raise ValueError(f"unknown filter {name!r}")
        built = self._filters_built.get(name)
        if built is not None and built[0] == gen:
            return built[1]
        mode, ids = spec
        kw = dict(allow_ids=ids if mode == "allow" else None,
                  deny_ids=ids if mode == "deny" else None)
        if self._mesh is not None:
            # Each local shard's penalty from its own map_ids.
            rf = make_sharded_row_filter(index, self._mesh, **kw)
        else:
            fctx = self._fctx
            if fctx is None or fctx[0] != gen:
                fctx = (gen, RowFilterContext(index))
                self._fctx = fctx
            rf = make_row_filter(index, ctx=fctx[1], **kw)
        with self._flock:
            # Cache only while the spec we built from is still current: a
            # concurrent re-register must not be shadowed by a stale
            # build. The stale RowFilter still serves THIS batch — it
            # matched the spec when the batch formed.
            if self._filters.get(name) is spec:
                self._filters_built[name] = (gen, rf)
        return rf

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)

    def _make_params(
        self, top_k: int, probe: int, rerank: int | None = None
    ) -> SearchParams:
        if top_k <= 0 or probe <= 0:
            raise ValueError("top_k and probe must be positive")
        if rerank is not None and rerank <= 0:
            raise ValueError("rerank must be positive")
        top_k = min(int(top_k), MAX_TOPK)
        # A sharded index's k counts every shard's k_max slots, a bound on
        # its clusters (sharded_search caps the probe a shard anyway).
        probe = min(int(probe), MAX_PROBE, self.index.k)
        rerank = (
            # 1.5x topk is the measured budget floor at large topk;
            # default_rerank keeps the 2x margin for small requests.
            max(self.default_rerank, top_k * 3 // 2)
            if rerank is None
            else min(max(int(rerank), top_k), MAX_RERANK)
        )
        return SearchParams(probe=probe, topk=top_k, rerank=rerank,
                            rerank_bf16=self.rerank_bf16)

    def submit(
        self,
        query,
        top_k: int,
        probe: int,
        timeout_s: float = 120.0,
        rerank: int | None = None,
        filter_name: str | None = None,
    ):
        scores, ids = self.submit_many(
            np.asarray(query, dtype=np.float32)[None, :],
            top_k,
            probe,
            timeout_s=timeout_s,
            rerank=rerank,
            filter_name=filter_name,
        )
        return scores[0], ids[0]

    def submit_many(
        self,
        queries,
        top_k: int,
        probe: int,
        timeout_s: float = 120.0,
        rerank: int | None = None,
        filter_name: str | None = None,
    ):
        """Batch entry point: [m, dim] queries in one request. Requests
        wider than ``max_batch`` are split and pipelined through
        consecutive search calls."""
        params = self._make_params(top_k, probe, rerank)
        if filter_name is not None and not self.has_filter(filter_name):
            # Fail fast on the caller's thread — an unknown name is a
            # request error, not a batch error shared with co-batched
            # requests.
            raise ValueError(f"unknown filter {filter_name!r}")
        queries = np.asarray(queries, dtype=np.float32)
        if queries.ndim != 2:
            raise ValueError(f"queries must be [m, dim], got {queries.shape}")
        reqs = [
            _Request(
                queries[s : s + self.max_batch],
                params,
                filter_name=filter_name,
            )
            for s in range(0, queries.shape[0], self.max_batch)
        ]
        for r in reqs:
            self._q.put(r)
        for r in reqs:
            if not r.done.wait(timeout_s):
                raise TimeoutError("query timed out")
            if r.error:
                raise RuntimeError(r.error)
        return (
            np.concatenate([r.scores for r in reqs]),
            np.concatenate([r.ids for r in reqs]),
        )

    # -- dispatcher ----------------------------------------------------------

    def _drain(self) -> list[_Request]:
        batch: list[_Request] = []
        try:
            batch.append(self._q.get(timeout=0.1))
        except queue.Empty:
            return batch
        rows = batch[0].query.shape[0]
        t0 = time.perf_counter()
        while rows < self.max_batch:
            remaining = self.window_s - (time.perf_counter() - t0)
            if remaining <= 0:
                break
            try:
                r = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            batch.append(r)
            rows += r.query.shape[0]
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._drain()
            if not batch:
                continue
            groups: dict[tuple, list[_Request]] = {}
            for r in batch:
                groups.setdefault((r.params, r.filter_name), []).append(r)
            for (params, _), reqs in groups.items():
                self._run_group(params, reqs)

    def _run_group(self, params: SearchParams, reqs: list[_Request]) -> None:
        from rabitq_tpu_torch.index.search import search_with_stats
        from rabitq_tpu_torch.metrics import record_search_stats
        from rabitq_tpu_torch.parallel import (
            sharded_search,
            sharded_search_with_store,
        )
        from rabitq_tpu_torch.store import search_with_store

        try:
            # One snapshot per group: a concurrent swap_index must not
            # split a batch across two indexes (or pair a store with
            # another index; the filter-cache generation and the global
            # positions ride along).
            index, store, gen, gpos = self._istate
            row_filter = self._resolve_filter(
                reqs[0].filter_name, index, gen
            )
            q = np.concatenate([r.query for r in reqs])
            b = q.shape[0]
            mesh = self._mesh
            if mesh is not None and store is not None:
                scores, ids = sharded_search_with_store(
                    index, q, params, mesh, store, gpos,
                    exact=self._sharded_exact, row_filter=row_filter,
                )
            elif mesh is not None:
                scores, ids = sharded_search(
                    index, q, params, mesh, exact=self._sharded_exact,
                    row_filter=row_filter,
                )
                scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
                METRICS.add_query_count(b)
            elif store is not None:
                scores, ids = search_with_store(
                    index, q, params, store, row_filter=row_filter,
                )
            else:
                scores, ids, stats = search_with_stats(
                    index, torch.from_numpy(q).to(index.codes.device),
                    params, row_filter,
                )
                scores, ids = scores.cpu().numpy(), ids.cpu().numpy()
                METRICS.add_query_count(b)
                record_search_stats(stats)
            at = 0
            for r in reqs:
                m = r.query.shape[0]
                r.scores = scores[at : at + m]
                r.ids = ids[at : at + m]
                at += m
                r.done.set()
        except Exception as e:  # surface errors to all waiters
            logger.exception("batch failed")
            for r in reqs:
                r.error = f"{type(e).__name__}: {e}"
                r.done.set()


class ServiceHTTPServer(ThreadingHTTPServer):
    """The stdlib threaded server with a listen backlog of 128: its
    default of 5 drops connection attempts when tens of clients connect
    at once, which they then retry a second later."""

    request_queue_size = 128


# Reject bodies beyond this size (64k dims of f32 is far above any real
# embedding; a missing bound lets one request exhaust host memory).
MAX_BODY_BYTES = 1 << 20
# Filter registration carries tenant id lists, which legitimately run to
# millions of ids — a separate, larger cap (~64 MiB JSON is ~6M ids);
# beyond it, register incrementally with {"append": true}.
MAX_FILTER_BODY_BYTES = 64 << 20


def make_handler(
    engine: BatchingEngine,
    default_probe: int,
    default_topk: int,
    engines: dict[str, BatchingEngine] | None = None,
    allow_reload: bool = False,
):
    """Request handler over one default engine plus an optional named
    registry (multi-index routing). Routing, uniform across all three
    query protocols:

    - ``POST /query`` (+ ``/query_bin``, ``/query_bin_batch``) — the
      default engine; JSON requests may override with ``"index": name``.
    - ``POST /index/<name>/query`` (same suffixes) — engine ``name``.
    - ``GET /indexes`` — the registry (name, n, dim, code_bits, shards).
    """
    registry: dict[str, BatchingEngine] = dict(engines or {})

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route to logging, not stderr
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _send(self, code: int, body: str, ctype="text/plain"):
            data = body.encode()
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _send_json(self, code: int, obj):
            self._send(code, json.dumps(obj), "application/json")

        def _send_bytes(self, data: bytes):
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _route(self):
            """Resolve (engine, endpoint) from the URL path; None engine
            means an unknown index name (404 already sent)."""
            path = self.path
            if path.startswith("/index/"):
                rest = path[len("/index/"):]
                name, sep, endpoint = rest.partition("/")
                if not sep or name not in registry:
                    self._send(404, "unknown index")
                    return None, None
                return registry[name], "/" + endpoint
            return engine, path

        def _engine_named(self, name):
            """The default engine for None, else a registered one; None
            (after a 404) for an unknown name."""
            eng = engine if name is None else registry.get(name)
            if eng is None:
                self._send_json(404, dict(error=f"unknown index {name!r}"))
            return eng

        def do_GET(self):
            if self.path == "/":
                self._send(200, "rabitq-tpu service")
            elif self.path == "/health":
                self._send(200, "OK")
            elif self.path == "/metrics":
                self._send(200, METRICS.to_str())
            elif self.path == "/indexes":
                self._send_json(200, {
                    name: dict(
                        n=int(eng.n_rows),
                        dim=int(eng.index.dim_orig),
                        code_bits=int(eng.index.code_bits),
                        shards=1 if eng.mesh is None else eng.mesh.size,
                    )
                    for name, eng in registry.items()
                })
            elif self.path == "/filters":
                self._send_json(200, {
                    name: dict(mode=mode, size=size)
                    for name, (mode, size) in engine.filter_specs().items()
                })
            else:
                self._send(404, "not found")

        def _register_filter(self):
            """POST /filters {"name", "allow_ids"|"deny_ids"[, "index"]
            [, "append"]} — register a named id predicate on the engine;
            queries then pass ``"filter": name``."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_FILTER_BODY_BYTES:
                    self._send_json(413, dict(error="body too large"))
                    return
                payload = json.loads(self.rfile.read(length))
                eng = self._engine_named(payload.get("index"))
                if eng is None:
                    return
                fname = payload["name"]
                if not isinstance(fname, str) or not fname:
                    raise ValueError("'name' must be a non-empty string")
                size = eng.register_filter(
                    fname,
                    allow_ids=payload.get("allow_ids"),
                    deny_ids=payload.get("deny_ids"),
                    append=bool(payload.get("append", False)),
                )
                self._send_json(200, dict(ok=True, name=fname, size=size))
            except (KeyError, TypeError, ValueError,
                    json.JSONDecodeError) as e:
                self._send_json(400, dict(error=str(e)))
            except Exception as e:
                logger.exception("filter registration failed")
                self._send_json(500, dict(error=str(e)))

        def _admin_reload(self):
            """POST /admin/reload {"dir": path[, "index": name]} — load a
            freshly built or compacted index directory onto the engine's
            device (a mesh engine: a dump_index_sharded checkpoint onto
            its mesh) and swap it in without dropping requests
            (engine.swap_index). A directory the engine cannot serve (the
            other kind, another shard count, no base) answers 400. Gated
            behind --allow-reload: it reads server-side paths."""
            from rabitq_tpu_torch.index.serialize import load_from_dir
            from rabitq_tpu_torch.parallel import load_index_sharded
            from rabitq_tpu_torch.parallel.checkpoint import (
                is_sharded_checkpoint,
            )

            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._send(413, "body too large")
                    return
                payload = json.loads(self.rfile.read(length))
                eng = self._engine_named(payload.get("index"))
                if eng is None:
                    return
                if eng.store is not None:
                    # Reloading would silently flip a store-tier engine to
                    # device mode (load_from_dir keeps the base while the
                    # old store pairs with the OLD row order). Restart
                    # with the new dir and store config instead.
                    self._send_json(409, dict(
                        error="reload unsupported on store-tier engines"))
                    return
                path = payload["dir"]
                if is_sharded_checkpoint(path) != (eng.mesh is not None):
                    raise ValueError(
                        f"{path} is {'' if eng.mesh is None else 'not '}a "
                        "sharded checkpoint; this engine serves "
                        f"{'one' if eng.mesh is not None else 'no'} mesh")
                if eng.mesh is not None:
                    new_index = load_index_sharded(path, eng.mesh)
                else:
                    new_index = load_from_dir(path, device=eng.device)
                eng.swap_index(new_index)
                self._send_json(200, dict(ok=True, n=int(eng.n_rows)))
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._send_json(400, dict(error=str(e)))
            except Exception as e:
                logger.exception("reload failed")
                self._send_json(500, dict(error=str(e)))

        def do_POST(self):
            if self.path == "/admin/reload":
                if not allow_reload:
                    self._send(403, "reload disabled")
                    return
                self._admin_reload()
                return
            if self.path == "/filters":
                self._register_filter()
                return
            eng, endpoint = self._route()
            if eng is None:
                return
            if endpoint == "/query_bin":
                self._query_bin(eng)
            elif endpoint == "/query_bin_batch":
                self._query_bin_batch(eng)
            elif endpoint == "/query":
                self._query_json(eng)
            else:
                self._send(404, "not found")

        def _query_json(self, eng):
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES:
                    self._send_json(413, dict(error="body too large"))
                    return
                payload = json.loads(self.rfile.read(length))
                if "query" not in payload:
                    raise ValueError("missing required field 'query'")
                if payload.get("index") is not None:
                    eng = self._engine_named(payload["index"])
                    if eng is None:
                        return
                query = payload["query"]
                top_k = int(payload.get("top_k", default_topk))
                probe = int(payload.get("probe", default_probe))
                # Optional per-request rerank budget (clamped server-side).
                rerank = payload.get("rerank")
                rerank = None if rerank is None else int(rerank)
                # Optional named predicate (registered via POST /filters);
                # results then contain only ids passing it.
                fname = payload.get("filter")
                if fname is not None and not eng.has_filter(fname):
                    self._send_json(
                        404, dict(error=f"unknown filter {fname!r}"))
                    return
                if query and isinstance(query[0], (list, tuple)):
                    # Multi-query request: one POST carries a whole batch.
                    scores, ids = eng.submit_many(
                        np.asarray(query, dtype=np.float32), top_k, probe,
                        rerank=rerank, filter_name=fname,
                    )
                    self._send_json(200, dict(
                        ids=[row[row >= 0].tolist() for row in ids],
                        scores=[s[i >= 0].astype(float).tolist()
                                for s, i in zip(scores, ids)],
                    ))
                    return
                scores, ids = eng.submit(
                    query, top_k, probe, rerank=rerank, filter_name=fname
                )
                keep = ids >= 0
                self._send_json(200, dict(
                    ids=ids[keep].tolist(),
                    scores=[float(s) for s in scores[keep]],
                ))
            except (KeyError, ValueError, json.JSONDecodeError) as e:
                self._send_json(400, dict(error=str(e)))
            except Exception as e:
                logger.exception("query failed")
                self._send_json(500, dict(error=str(e)))

        def _query_bin(self, eng):
            """Binary protocol: request body = u32 top_k, u32 probe, u32
            dim, dim x f32 query (little-endian); response = u32 count,
            then count x (u32 id, f32 score)."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES or length < 12:
                    self._send(
                        413 if length > MAX_BODY_BYTES else 400, "bad size"
                    )
                    return
                raw = self.rfile.read(length)
                top_k, probe, dim = np.frombuffer(raw[:12], np.uint32)
                if len(raw) != 12 + 4 * int(dim):
                    self._send(400, "length mismatch")
                    return
                query = np.frombuffer(raw[12:], np.float32)
                scores, ids = eng.submit(query, int(top_k), int(probe))
                keep = ids >= 0
                out = np.empty(1 + 2 * int(keep.sum()), np.uint32)
                out[0] = keep.sum()
                out[1::2] = ids[keep].astype(np.uint32)
                out[2::2] = scores[keep].astype(np.float32).view(np.uint32)
                self._send_bytes(out.tobytes())
            except Exception as e:
                logger.exception("binary query failed")
                self._send(500, str(e))

        def _query_bin_batch(self, eng):
            """Binary multi-query frame: request = u32 top_k, u32 probe,
            u32 dim, u32 count, then count x dim f32 rows (little-endian);
            response = u32 count, u32 top_k, then count x top_k pairs of
            (u32 id — 0xFFFFFFFF for an invalid slot, f32 score)."""
            try:
                length = int(self.headers.get("Content-Length", 0))
                if length > MAX_BODY_BYTES or length < 16:
                    self._send(
                        413 if length > MAX_BODY_BYTES else 400, "bad size"
                    )
                    return
                raw = self.rfile.read(length)
                top_k, probe, dim, count = np.frombuffer(raw[:16], np.uint32)
                if len(raw) != 16 + 4 * int(dim) * int(count) or count == 0:
                    self._send(400, "length mismatch")
                    return
                queries = np.frombuffer(raw[16:], np.float32).reshape(
                    int(count), int(dim)
                )
                scores, ids = eng.submit_many(
                    queries, int(top_k), int(probe)
                )
                tk = ids.shape[1]
                out = np.empty(2 + 2 * int(count) * tk, np.uint32)
                out[0], out[1] = count, tk
                body = out[2:].reshape(int(count), tk, 2)
                body[:, :, 0] = ids.astype(np.int64).astype(np.uint32)
                body[:, :, 1] = scores.astype(np.float32).view(np.uint32)
                self._send_bytes(out.tobytes())
            except Exception as e:
                logger.exception("binary batch query failed")
                self._send(500, str(e))

    return Handler


def serve(
    index,
    *,
    host="0.0.0.0",
    port=9000,
    store=None,
    max_batch=64,
    window_ms=2.0,
    default_probe=100,
    default_topk=10,
    extra_indexes: dict[str, object] | None = None,
    default_name: str = "default",
    allow_reload: bool = False,
    mesh=None,
    global_pos=None,
    sharded_exact: bool = False,
    rerank_bf16: bool = False,
):
    """Serve one default index (optionally store-tiered, optionally
    sharded over ``mesh``) plus any number of named extras on their own
    devices (multi-index routing: POST /index/<name>/query..., the JSON
    "index" field, GET /indexes). Warms every engine with one query at
    the default params before accepting traffic, and shuts down on SIGINT
    or SIGTERM."""
    engine = BatchingEngine(
        index, store, max_batch=max_batch, window_ms=window_ms, mesh=mesh,
        global_pos=global_pos, sharded_exact=sharded_exact,
        rerank_bf16=rerank_bf16,
    )
    engines = {default_name: engine}
    for name, idx in (extra_indexes or {}).items():
        if name in engines:
            raise ValueError(f"duplicate index name {name!r}")
        engines[name] = BatchingEngine(
            idx, max_batch=max_batch, window_ms=window_ms
        )
    logger.info("warming up (first kernel builds and launches)...")
    for eng in engines.values():
        # Generous timeout: the first call builds the kernels (nvcc).
        eng.submit(
            np.zeros(eng.index.dim_orig, np.float32),
            default_topk,
            default_probe,
            timeout_s=1800.0,
        )
    logger.info("warm")
    handler = make_handler(
        engine,
        default_probe,
        default_topk,
        engines=engines,
        allow_reload=allow_reload,
    )
    server = ServiceHTTPServer((host, port), handler)

    def shutdown(*_):
        logger.info("shutting down")
        threading.Thread(target=server.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGINT, shutdown)
        signal.signal(signal.SIGTERM, shutdown)
    except ValueError:
        pass  # not the main thread (tests)
    logger.info(
        "serving %d index(es) on %s:%d", len(engines), host, port
    )
    try:
        server.serve_forever()
    finally:
        for eng in engines.values():
            eng.close()
        server.server_close()
    return server


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser(prog="rabitq-tpu-torch-service")
    ap.add_argument(
        "-d",
        "--dir",
        required=True,
        action="append",
        help="index directory; repeatable as NAME=PATH to serve several "
        "indexes (the first is the default; the rest are held on the "
        "device and reachable via POST /index/NAME/query..., the JSON "
        "'index' field, and GET /indexes)",
    )
    ap.add_argument("-p", "--port", type=int, default=9000)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument(
        "--store",
        choices=["device", "mmap", "blockcache", "http"],
        default="device",
        help="rerank vector source (mmap/blockcache keep the base off the "
        "device; http streams base.fvecs from --url-prefix through the "
        "block cache)",
    )
    ap.add_argument(
        "--url-prefix",
        default=None,
        help="object-store URL prefix holding the index files; metadata "
        "files missing from --dir are downloaded from it at boot and, "
        "with --store http, base.fvecs is range-read from it on rerank "
        "misses. An s3://bucket/prefix URL signs every request with "
        "SigV4 from the standard env/profile credential chain "
        "(AWS_ACCESS_KEY_ID/..., AWS_REGION, AWS_ENDPOINT_URL for "
        "S3-compatible stores)",
    )
    ap.add_argument(
        "--store-header",
        action="append",
        default=None,
        metavar="NAME: VALUE",
        help="static HTTP header sent with every http(s) object-store "
        "request (repeatable), e.g. 'Authorization: Bearer ...'; s3:// "
        "prefixes sign natively instead (SigV4, store/sigv4.py)",
    )
    ap.add_argument("--cache-db", default=None, help="sqlite block cache path")
    ap.add_argument(
        "--shards",
        type=int,
        default=0,
        help="serve the index sharded over N devices: one shard per card "
        "(fails on a host with fewer), or with --device cpu N entries of "
        "the CPU; a dump_index_sharded checkpoint boots sharded without it",
    )
    ap.add_argument(
        "--sharded-exact",
        action="store_true",
        help="exact-mode shard budgets: every shard probes min(probe, "
        "k_max) clusters with the full rerank (recall at least the "
        "unsharded index's, about S times the scan work)",
    )
    ap.add_argument(
        "--allow-reload",
        action="store_true",
        help="enable POST /admin/reload {dir[, index]}: hot-swap a newly "
        "built/compacted index dir into a running engine (reads "
        "server-side paths; keep off on untrusted networks)",
    )
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument(
        "--rerank-bf16",
        action="store_true",
        help="two-level rerank: bf16 candidate distances from a bf16 copy "
        "of the base (+50%% base memory), the best max(4*top_k, 32) "
        "re-verified in f32 (ignored with a --store other than device)",
    )
    ap.add_argument(
        "--rerank-kernel",
        action="store_true",
        help="accepted for the JAX service's sake and changes nothing: the "
        "port always reranks through its gather_l2 kernel "
        "(csrc/gather_l2.cu) on the card",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="torch device to serve on (default cuda; raises without a "
        "card, never falls back to the CPU)",
    )
    args = ap.parse_args(argv)

    from rabitq_tpu_torch.index.serialize import load_from_dir
    from rabitq_tpu_torch.parallel import (
        load_global_positions,
        load_index_sharded,
        make_mesh,
        shard_global_positions,
        shard_index,
    )
    from rabitq_tpu_torch.parallel.checkpoint import is_sharded_checkpoint
    from rabitq_tpu_torch.store import (
        BlockCachedStore,
        FileBlockSource,
        HttpRangeSource,
        MmapStore,
        download_meta,
    )

    store_headers = None
    if args.store_header:
        store_headers = {}
        for h in args.store_header:
            name, sep, value = h.partition(":")
            if not sep or not name.strip():
                ap.error(f"--store-header must be 'Name: value', got {h!r}")
            store_headers[name.strip()] = value.strip()

    # Multi-index parsing: the first -d is the default (and the only one
    # the store/url-prefix options apply to); extras must be NAME=PATH.
    dirs = args.dir
    default_name, _, default_dir = dirs[0].rpartition("=")
    default_name = default_name or "default"
    extra_specs: dict[str, str] = {}
    for spec in dirs[1:]:
        name, sep, path = spec.partition("=")
        if not sep or not name or name == default_name:
            ap.error(
                f"extra --dir must be a unique NAME=PATH, got {spec!r}"
            )
        extra_specs[name] = path
    if args.store == "http" and not args.url_prefix:
        ap.error("--store http requires --url-prefix")
    keep_base = args.store == "device"
    sharded_ckpt = is_sharded_checkpoint(default_dir)
    if sharded_ckpt and args.store in ("mmap", "blockcache"):
        # A sharded checkpoint has per-shard directories and no global
        # base: the store would read a file that never exists there.
        ap.error(
            f"--store {args.store} on a sharded checkpoint would read "
            f"{Path(default_dir) / 'base.fvecs'}, the global cluster-sorted "
            "base, which dump_index_sharded never writes: serve it with "
            "--store device, or --store http with --url-prefix holding "
            "that global base.fvecs")
    if args.url_prefix and not sharded_ckpt:
        download_meta(args.url_prefix, default_dir, headers=store_headers)

    def mesh_of(n):
        # One shard per card (raising on a host with fewer), or CPU entries.
        if torch.device(args.device).type == "cpu":
            return make_mesh(devices=["cpu"] * n)
        return make_mesh(n)

    mesh = global_pos = None
    if sharded_ckpt:
        n_sh = json.loads((Path(default_dir) / "meta.json").read_text())[
            "shards"]
        if args.shards and args.shards != n_sh:
            ap.error(f"the checkpoint has {n_sh} shards, --shards "
                     f"{args.shards} (re-shard offline)")
        mesh = mesh_of(n_sh)
        index = load_index_sharded(default_dir, mesh, keep_base=keep_base)
        global_pos = load_global_positions(default_dir)
    elif args.shards:
        # Shard from a CPU-loaded index: only the shards reach the cards.
        mesh = mesh_of(args.shards)
        cpu_index = load_from_dir(default_dir, keep_base=keep_base,
                                  device="cpu")
        if not keep_base:
            global_pos = shard_global_positions(cpu_index, args.shards)
        index = shard_index(cpu_index, mesh)
        del cpu_index
    else:
        index = load_from_dir(
            default_dir, keep_base=keep_base, device=args.device
        )
    extra_indexes = {
        name: load_from_dir(path, device=args.device)
        for name, path in extra_specs.items()
    }
    base_path = Path(default_dir) / "base.fvecs"
    store = None
    if args.store == "mmap":
        store = MmapStore(base_path)
    elif args.store == "blockcache":
        store = BlockCachedStore(
            FileBlockSource(base_path), index.dim, sqlite_path=args.cache_db
        )
    elif args.store == "http":
        base_url = args.url_prefix.rstrip("/") + "/base.fvecs"
        if base_url.startswith("s3://"):
            from rabitq_tpu_torch.store import S3RangeSource

            source = S3RangeSource(base_url)
        else:
            source = HttpRangeSource(base_url, headers=store_headers)
        store = BlockCachedStore(
            source, index.dim, sqlite_path=args.cache_db
        )
    serve(
        index,
        host=args.host,
        port=args.port,
        store=store,
        max_batch=args.max_batch,
        window_ms=args.window_ms,
        extra_indexes=extra_indexes,
        default_name=default_name,
        allow_reload=args.allow_reload,
        mesh=mesh,
        global_pos=global_pos,
        sharded_exact=args.sharded_exact,
        rerank_bf16=args.rerank_bf16,
    )


if __name__ == "__main__":
    main()
