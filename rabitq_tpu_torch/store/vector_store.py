"""Full-precision vector stores for the rerank stage, and the store-tier
search (port of rabitq_tpu.store.vector_store).

The codes and factors stay on the card and the estimator always runs
there; only the rows of the rerank candidates come from a store:

- DeviceStore      — the base on the card (the in-memory tier); its rows
                     are gathered there and only they cross to the host.
- MmapStore        — the base host-resident through an fvecs mmap; the
                     OS page cache is the block cache. For corpora larger
                     than the card's memory.
- BlockCachedStore — the base behind a range-read byte source (a local
                     file, an HTTP object store, or S3 through
                     store/sigv4.py), fetched in 512 KiB fvecs blocks and
                     cached: an in-process LRU (the C++ cache of
                     rabitq_tpu_torch/native, or a dict when it cannot be
                     built) and optional SQLite persistence.

Stores index rows by *cluster-sorted position* (the order dump_to_dir
writes base.fvecs in), so estimate_candidates output feeds them directly.
``search_with_store`` is the store tier's search: the estimate on the
index's device, one copy of the candidates to the host, the exact
distances in f32 numpy as the JAX package computes them.
"""

from __future__ import annotations

import logging
import os
import sqlite3
import threading
import time
from pathlib import Path
from typing import Protocol

import numpy as np
import torch

from rabitq_tpu_torch.metrics import METRICS

logger = logging.getLogger(__name__)

# The reference disk tier's block size (512 KiB).
BLOCK_BYTE_LIMIT = 1 << 19

# HTTP statuses worth retrying: throttles and transient server/gateway
# failures. Client errors (403/404/416) fail fast — retrying them only
# delays the real error.
TRANSIENT_HTTP = frozenset({408, 429, 500, 502, 503, 504})

# Bytes of the [b, rows, D] f32 difference a host exact-distance step may
# hold at once; queries are chunked to stay under it.
EXACT_CHUNK_BYTES = 256 << 20


def retry_range_read(
    fetch,
    *,
    what: str,
    attempts: int = 4,
    backoff: float = 0.05,
    sleep=time.sleep,
):
    """Run ``fetch()`` with bounded exponential backoff on TRANSIENT
    failures (connection errors, truncated bodies, 5xx/429 statuses).

    One flaky GET must not fail a micro-batch, so every range source
    wraps its fetch here. Non-transient HTTP errors (auth, not-found, bad
    range) raise immediately.
    """
    import http.client
    import urllib.error

    last: Exception | None = None
    for i in range(max(1, attempts)):
        if i:
            sleep(backoff * (1 << (i - 1)))
        try:
            return fetch()
        except urllib.error.HTTPError as e:
            if e.code not in TRANSIENT_HTTP:
                raise
            last = e
        except (
            urllib.error.URLError,
            http.client.HTTPException,
            ConnectionError,
            TimeoutError,
            OSError,
        ) as e:
            last = e
        logger.warning(
            "transient failure reading %s (attempt %d/%d): %s",
            what,
            i + 1,
            attempts,
            last,
        )
    raise OSError(
        f"range read {what}: {attempts} attempts failed"
    ) from last


class VectorStore(Protocol):
    dim: int  # padded dim of stored rows

    def get_rows(self, pos: np.ndarray) -> np.ndarray:
        """Gather rows by cluster-sorted position -> [m, dim] float32."""
        ...


class DeviceStore:
    """Rerank against a base matrix held on the card (or the CPU)."""

    def __init__(self, base: torch.Tensor) -> None:
        self._base = base
        self.dim = int(base.shape[1])

    def get_rows(self, pos: np.ndarray) -> np.ndarray:
        """Gathers the rows on the base's device and copies only them (the
        positions go up from pinned memory without a host sync; the rows
        come down in one copy)."""
        idx = _to_device(np.asarray(pos, dtype=np.int64), self._base.device)
        return self._base[idx].cpu().numpy()


class MmapStore:
    """Host-resident vectors via a zero-copy fvecs mmap."""

    def __init__(self, fvecs_path: str | Path) -> None:
        from rabitq_tpu_torch.io.vecs import mmap_fvecs_matrix

        self._mat = mmap_fvecs_matrix(fvecs_path)
        self.dim = int(self._mat.shape[1])

    def get_rows(self, pos: np.ndarray) -> np.ndarray:
        return np.asarray(self._mat[pos], dtype=np.float32)


class FileBlockSource:
    """Range reads over a local file (stands in for an object store)."""

    def __init__(self, path: str | Path) -> None:
        self._path = Path(path)
        self.size = os.path.getsize(path)

    def read_range(self, start: int, length: int) -> bytes:
        with open(self._path, "rb") as f:
            f.seek(start)
            return f.read(length)


class HttpRangeSource:
    """HTTP Range-GET source (S3-compatible presigned URLs, any object
    store). Auth is (a) a presigned or public URL or (b) static
    ``headers`` (``{"Authorization": "Bearer ..."}``); S3 with per-request
    SigV4 signatures is store/sigv4.py's S3RangeSource.
    """

    def __init__(
        self,
        url: str,
        size: int | None = None,
        headers: dict[str, str] | None = None,
        *,
        retries: int = 4,
        backoff: float = 0.05,
    ) -> None:
        import urllib.request

        self._url = url
        self._urllib = urllib.request
        self._headers = dict(headers or {})
        self._retries = retries
        self._backoff = backoff
        if size is None:
            req = self._urllib.Request(
                url, method="HEAD", headers=self._headers
            )
            with self._urllib.urlopen(req) as resp:
                size = int(resp.headers["Content-Length"])
        self.size = size

    def read_range(self, start: int, length: int) -> bytes:
        return retry_range_read(
            lambda: self._read_once(start, length),
            what=f"{start}+{length} of {self._url}",
            attempts=self._retries,
            backoff=self._backoff,
        )

    def _read_once(self, start: int, length: int) -> bytes:
        req = self._urllib.Request(
            self._url,
            headers={
                **self._headers,
                "Range": f"bytes={start}-{start + length - 1}",
            },
        )
        with self._urllib.urlopen(req) as resp:
            body = resp.read()
            if resp.status == 206:
                # A truncated 206 body (a connection cut mid-transfer
                # without an exception) would parse as a short block and
                # corrupt rerank rows: retry it.
                if len(body) != length:
                    raise ConnectionError(
                        f"range read {start}+{length} of {self._url}: "
                        f"206 with {len(body)} bytes"
                    )
                return body
        # The server ignored Range and sent the whole object (plain HTTP
        # servers, some proxies). Slice locally: returning the full body
        # would make every cache block parse as block 0 (valid fvecs
        # headers, wrong rows, no error).
        if resp.status == 200 and len(body) >= start + length:
            return body[start : start + length]
        raise OSError(
            f"range read {start}+{length} of {self._url}: got status "
            f"{resp.status} with {len(body)} bytes"
        )


class BlockCachedStore:
    """Block-granular cached store over a range-read source.

    The backing object is a uniform fvecs file ([u32 dim][dim f32]
    records). A miss fetches the enclosing block of ``num_per_block``
    records (512 KiB / record size), parses every row in it and caches
    it; neighbours (clusters are contiguous in position space) then hit.
    Cache layers: the in-process LRU (``cache_backend``: "native", the
    C++ cache, or "dict" when it cannot be built, with a warning) and
    optional SQLite persistence across processes.
    """

    def __init__(
        self,
        source,
        dim: int,
        *,
        sqlite_path: str | Path | None = None,
        max_cached_blocks: int = 1024,
    ) -> None:
        self.source = source
        self.dim = int(dim)
        self._rec_bytes = 4 * (self.dim + 1)
        self.num_per_block = max(1, BLOCK_BYTE_LIMIT // self._rec_bytes)
        self._block_bytes = self.num_per_block * self._rec_bytes
        self._lock = threading.Lock()
        self._max_blocks = max_cached_blocks
        self._lru: dict[int, np.ndarray] = {}  # block_id -> [num, dim]
        # Single-flight latches: block_id -> Event set once the block is
        # cached. Concurrent misses on one block wait for the first fetch
        # instead of issuing duplicate range reads.
        self._inflight: dict[int, threading.Event] = {}
        self._native = _try_native_cache(
            max_cached_blocks, self.num_per_block * self.dim, self.dim
        )
        self.cache_backend = "dict" if self._native is None else "native"
        self._sql = None
        self._sql_pending = 0
        self._sql_commit_every = 16  # batch commits (fsync per block is slow)
        if sqlite_path is not None:
            self._sql = sqlite3.connect(str(sqlite_path), check_same_thread=False)
            self._sql.execute(
                "CREATE TABLE IF NOT EXISTS blocks"
                " (id INTEGER PRIMARY KEY, data BLOB)"
            )
            self._sql.commit()

    # -- block layer -------------------------------------------------------

    def _parse_block(self, raw: bytes, block_id: int) -> np.ndarray:
        words = np.frombuffer(raw, dtype=np.uint32)
        n_rec = words.size // (self.dim + 1)
        mat = words[: n_rec * (self.dim + 1)].reshape(n_rec, self.dim + 1)
        if not np.all(mat[:, 0] == self.dim):
            raise ValueError(f"corrupt fvecs block {block_id}")
        return np.ascontiguousarray(mat[:, 1:]).view(np.float32)

    def _fetch_block(self, block_id: int) -> np.ndarray:
        start = block_id * self._block_bytes
        length = min(self._block_bytes, self.source.size - start)
        raw = self.source.read_range(start, length)
        METRICS.add_miss_count(1)
        return self._parse_block(raw, block_id)

    def _lookup_locked(self, block_id: int):
        """Cache lookup (memory, then SQLite). Caller holds the lock."""
        if self._native is not None:
            hit = self._native.get(block_id)
            if hit is not None:
                return hit
        elif block_id in self._lru:
            self._lru[block_id] = self._lru.pop(block_id)  # refresh
            return self._lru[block_id]
        if self._sql is not None:
            row = self._sql.execute(
                "SELECT data FROM blocks WHERE id = ?", (block_id,)
            ).fetchone()
            if row is not None:
                blk = (
                    np.frombuffer(row[0], dtype=np.float32)
                    .reshape(-1, self.dim)
                    .copy()
                )
                self._insert_mem(block_id, blk)
                return blk
        return None

    def _get_block(self, block_id: int) -> np.ndarray:
        while True:
            with self._lock:
                blk = self._lookup_locked(block_id)
                if blk is not None:
                    return blk
                latch = self._inflight.get(block_id)
                if latch is None:  # we are the single flight
                    self._inflight[block_id] = threading.Event()
                    break
            latch.wait()  # another thread is fetching this block
        try:
            blk = self._fetch_block(block_id)
            with self._lock:
                self._insert_mem(block_id, blk)
                if self._sql is not None:
                    self._sql.execute(
                        "INSERT OR REPLACE INTO blocks (id, data)"
                        " VALUES (?, ?)",
                        (block_id, blk.tobytes()),
                    )
                    self._sql_pending += 1
                    if self._sql_pending >= self._sql_commit_every:
                        self._sql.commit()
                        self._sql_pending = 0
            return blk
        finally:
            with self._lock:
                self._inflight.pop(block_id).set()

    def flush(self) -> None:
        """Commit any batched SQLite inserts (durability point)."""
        with self._lock:
            if self._sql is not None and self._sql_pending:
                self._sql.commit()
                self._sql_pending = 0

    def _insert_mem(self, block_id: int, blk: np.ndarray) -> None:
        if self._native is not None:
            self._native.put(block_id, blk)
            return
        self._lru[block_id] = blk
        while len(self._lru) > self._max_blocks:
            self._lru.pop(next(iter(self._lru)))

    # -- row layer ----------------------------------------------------------

    def get_rows(self, pos: np.ndarray) -> np.ndarray:
        """Rows of ``pos``, each distinct block looked up once, in
        ascending block order (the JAX package's order, so the same
        blocks miss): the positions are grouped by block with one stable
        argsort instead of a mask over all positions per block."""
        pos = np.asarray(pos, dtype=np.int64).reshape(-1)
        out = np.empty((pos.shape[0], self.dim), dtype=np.float32)
        block_ids = pos // self.num_per_block
        order = np.argsort(block_ids, kind="stable")
        sorted_ids = block_ids[order]
        cuts = np.flatnonzero(sorted_ids[1:] != sorted_ids[:-1]) + 1
        groups = np.split(order, cuts) if pos.size else []
        for sel in groups:
            b = int(block_ids[sel[0]])
            blk = self._get_block(b)
            out[sel] = blk[pos[sel] - b * self.num_per_block]
        # One commit per rerank batch instead of one per block.
        self.flush()
        return out


# The index-directory metadata files (everything except base.fvecs, which
# stays remote behind the block cache): the reference's bootstrap list;
# meta.json and the memtable files are this framework's and may be absent.
META_FILES = (
    "orthogonal.fvecs",
    "centroids.fvecs",
    "offsets_ids.ivecs",
    "factors.fvecs",
    "x_binary_vec.u64vecs",
)
OPTIONAL_META_FILES = ("meta.json", "extra_base.fvecs", "extra_ids.ivecs")


def download_meta(
    url_prefix: str,
    dest_dir: str | Path,
    headers: dict[str, str] | None = None,
) -> Path:
    """Bootstrap a local index directory from an object store.

    Fetches the index metadata files from ``{url_prefix}/{name}`` into
    ``dest_dir``, skipping files that already exist locally. base.fvecs
    is NOT downloaded: raw vectors stay remote and stream through the
    block cache on rerank misses.

    Auth: an ``s3://bucket/prefix`` url_prefix signs each GET with SigV4
    from the standard env/profile credential chain (store/sigv4.py); an
    http(s) prefix uses ``headers`` for static auth (presigned URLs,
    bearer tokens).
    """
    import urllib.error
    import urllib.request

    dest = Path(dest_dir)
    dest.mkdir(parents=True, exist_ok=True)
    prefix = url_prefix.rstrip("/")
    is_s3 = prefix.startswith("s3://")
    for name in META_FILES + OPTIONAL_META_FILES:
        target = dest / name
        if target.exists():
            logger.debug("bootstrap: %s exists, skipping", name)
            continue
        url = f"{prefix}/{name}"
        if is_s3:
            from rabitq_tpu_torch.store.sigv4 import s3_get_object

            data = s3_get_object(url)
            if data is None:
                if name in OPTIONAL_META_FILES:
                    continue
                raise FileNotFoundError(f"bootstrap: {url} not found")
        else:
            try:
                req = urllib.request.Request(url, headers=dict(headers or {}))
                with urllib.request.urlopen(req) as resp:
                    data = resp.read()
            except urllib.error.HTTPError as e:
                if name in OPTIONAL_META_FILES and e.code == 404:
                    continue
                raise
        target.write_bytes(data)
        logger.info("bootstrap: fetched %s (%d bytes)", name, len(data))
    for name in META_FILES:
        if not (dest / name).exists():
            raise FileNotFoundError(f"bootstrap incomplete: missing {name}")
    return dest


def _try_native_cache(max_blocks: int, floats_per_block: int, dim: int):
    """The C++ LRU block cache, or None (the dict LRU) with a warning
    when its library cannot be built or loaded."""
    from rabitq_tpu_torch.native import NativeBlockCache, NativeUnavailable

    try:
        return NativeBlockCache(max_blocks, floats_per_block, dim)
    except (NativeUnavailable, OSError) as e:
        logger.warning(
            "native block cache unavailable, using the dict LRU: %s", e
        )
        return None


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``; to a card through pinned memory and
    without a host sync (the caching host allocator keeps the staging
    buffer until the copy has run)."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _to_host(*tensors: torch.Tensor) -> list[np.ndarray]:
    """Copy tensors of one device to host numpy arrays in ONE transfer:
    their bytes are concatenated on the device first, so the copy is a
    single device-to-host synchronization whatever their count."""
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])
    raw = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        nbytes = t.numel() * t.element_size()
        dtype = torch.empty((), dtype=t.dtype).numpy().dtype
        out.append(raw[at : at + nbytes].view(dtype).reshape(tuple(t.shape)))
        at += nbytes
    return out


def _sq_dist_chunked(q: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``((rows - q[:, None, :]) ** 2).sum(-1)`` in f32 numpy, as the JAX
    package computes it, chunked over queries so the [b, m, D] transient
    stays under EXACT_CHUNK_BYTES. ``rows`` is [B, m, D] or [m, D] (the
    same rows for every query). Each element's sum is the same whatever
    the chunking."""
    b, d = q.shape
    m = rows.shape[-2]
    per_query = max(1, m * d * 4)
    step = max(1, EXACT_CHUNK_BYTES // per_query)
    out = np.empty((b, m), dtype=np.float32)
    for a in range(0, b, step):
        r = rows[a : a + step] if rows.ndim == 3 else rows[None, :, :]
        out[a : a + step] = ((r - q[a : a + step, None, :]) ** 2).sum(-1)
    return out


def search_with_store(
    index,
    queries,
    params,
    store: VectorStore,
    *,
    row_filter=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Store-tier search: the estimate on the index's device, the exact
    distances from a host store. Returns numpy (dists f32 [B, topk], ids
    int32 [B, topk]; -1 where the distance is not finite).

    ``queries`` is [B, dim_orig] f32: numpy, or a tensor on the index's
    device. Stages:

    1. ``estimate_candidates`` (the quantize and rough-scan kernels on the
       card); a ``row_filter`` applies its penalty there, as on the
       in-memory path, so filtered rows reach the host with a +inf bound.
    2. ``map_ids[pos]`` on the device, then the positions, the bounds,
       the ids, the scanned-row total (and the queries, when given on the
       device, and the memtable) copied to the host in one transfer.
    3. ``store.get_rows`` of the [B * R] positions and the exact squared
       L2 in f32 numpy, +inf where the bound is not finite, the query
       L2-normalized on a cosine index; the memtable's rows merged by the
       same formula (deleted rows +inf, the filter's memtable penalty
       added); then the spill dedup, the top-k and the ``rough``,
       ``precise`` and ``query`` counters, each as in the JAX package.
    """
    from rabitq_tpu_torch.index.search import estimate_candidates
    from rabitq_tpu_torch.utils import pad_last_dim

    dev = index.codes.device
    on_device = isinstance(queries, torch.Tensor)
    if on_device:
        q_dev = queries.to(device=dev, dtype=torch.float32)
    else:
        q_host = np.asarray(queries, dtype=np.float32)
        q_dev = _to_device(q_host, dev)
    cand = estimate_candidates(index, q_dev, params, row_filter)
    to_copy = [cand.pos, cand.lower_bound, index.map_ids[cand.pos],
               cand.n_scanned.sum(dtype=torch.int64)]
    if on_device:
        to_copy.append(q_dev)
    has_mem = index.m > 0
    extra_pen = (row_filter.extra_penalty
                 if row_filter is not None and has_mem else None)
    if has_mem:
        to_copy += [index.extra_base, index.extra_ids]
        if extra_pen is not None:
            to_copy.append(extra_pen)
    host = _to_host(*to_copy)
    pos, lb, cand_ids, n_scanned = host[:4]
    rest = host[4:]
    if on_device:
        q_host, rest = rest[0], rest[1:]
    b, r = pos.shape

    rows = store.get_rows(pos.reshape(-1)).reshape(b, r, store.dim)
    qpad = pad_last_dim(q_host, store.dim)
    if index.metric == "cosine":
        # The device path's _prep_queries normalization: stored rows are
        # unit vectors, so scores agree across tiers.
        norms = np.linalg.norm(qpad, axis=-1, keepdims=True)
        qpad = qpad / np.maximum(norms, 1e-30)
    finite = np.isfinite(lb)
    exact = np.where(finite, _sq_dist_chunked(qpad, rows), np.inf)
    METRICS.add_precise_count(int(finite.sum()))
    METRICS.add_rough_count(int(n_scanned))

    METRICS.add_query_count(b)
    return merge_exact(exact, cand_ids, qpad, rest if has_mem else None,
                       index.dedup_ids, params.topk)


def merge_exact(
    exact: np.ndarray,
    cand_ids: np.ndarray,
    qpad: np.ndarray,
    memtable,
    dedup: bool,
    topk: int,
) -> tuple[np.ndarray, np.ndarray]:
    """The store tier's host merge of [B, W] exact candidate distances and
    their ids, as the JAX package's: the memtable joins once (``memtable``
    = (extra_base, extra_ids[, the filter's memtable penalty]) or None;
    deleted rows +inf), a spilled index keeps each id's best candidate,
    then the top-k (ids -1 where the distance is not finite). Returns
    (dists f32 [B, topk], ids int32 [B, topk])."""
    if memtable:
        ex_base, ex_ids = memtable[0], memtable[1]
        ex_d = _sq_dist_chunked(qpad, ex_base)
        ex_d = np.where(ex_ids[None, :] >= 0, ex_d, np.inf)
        if len(memtable) > 2:
            ex_d = ex_d + memtable[2][None, :]
        exact = np.concatenate([exact, ex_d], axis=1)
        cand_ids = np.concatenate(
            [cand_ids, np.broadcast_to(ex_ids[None, :], ex_d.shape)], axis=1
        )

    if dedup:
        # Spilled builds index an id twice. Keep each id's best candidate:
        # stable-sort by distance, then by id ((id, distance)
        # lexicographic), and suppress all but the first of each id run.
        o1 = np.argsort(exact, axis=1, kind="stable")
        exact = np.take_along_axis(exact, o1, axis=1)
        cand_ids = np.take_along_axis(cand_ids, o1, axis=1)
        o2 = np.argsort(cand_ids, axis=1, kind="stable")
        exact = np.take_along_axis(exact, o2, axis=1)
        cand_ids = np.take_along_axis(cand_ids, o2, axis=1)
        dup = cand_ids[:, 1:] == cand_ids[:, :-1]
        exact[:, 1:][dup] = np.inf
    sel = np.argsort(exact, axis=1)[:, :topk]
    dists = np.take_along_axis(exact, sel, axis=1)
    ids = np.take_along_axis(cand_ids, sel, axis=1)
    ids = np.where(np.isfinite(dists), ids, -1)
    return dists.astype(np.float32), ids.astype(np.int32)
