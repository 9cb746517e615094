"""HTTP benchmark client (port of rabitq_tpu.service.client).

Serial, thread-pool-concurrent or batched POSTs to the service
(service/server.py), reporting mean recall and latency percentiles.
stdlib only (urllib) besides numpy.

    python -m rabitq_tpu_torch.service.client --url http://127.0.0.1:9000 \
        -q query.fvecs -t truth.ivecs -k 10 -p 28 [-c 16 | --batch 512]
"""

from __future__ import annotations

import argparse
import json
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def query_once_bin(url: str, vec, top_k: int, probe: int):
    """Binary-protocol query (see server._query_bin): ~10x less host CPU
    than JSON for encode/decode."""
    vec = np.asarray(vec, dtype=np.float32)
    body = (
        np.array([top_k, probe, vec.shape[0]], np.uint32).tobytes()
        + vec.tobytes()
    )
    req = urllib.request.Request(
        url + "/query_bin",
        data=body,
        headers={"Content-Type": "application/octet-stream"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req) as resp:
        raw = np.frombuffer(resp.read(), np.uint32)
    n = int(raw[0])
    ids = raw[1 : 1 + 2 * n : 2].astype(np.int64)
    scores = raw[2 : 2 + 2 * n : 2].view(np.float32)
    return ids, scores, time.perf_counter() - t0


def query_batch_bin(url: str, queries, top_k: int, probe: int):
    """Binary multi-query frame (/query_bin_batch): one POST carries a
    whole batch, amortizing the per-request network round-trip."""
    queries = np.asarray(queries, dtype=np.float32)
    count, dim = queries.shape
    body = (
        np.array([top_k, probe, dim, count], np.uint32).tobytes()
        + queries.tobytes()
    )
    req = urllib.request.Request(
        url + "/query_bin_batch",
        data=body,
        headers={"Content-Type": "application/octet-stream"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req) as resp:
        raw = np.frombuffer(resp.read(), np.uint32)
    n, tk = int(raw[0]), int(raw[1])
    body_arr = raw[2:].reshape(n, tk, 2)
    ids = body_arr[:, :, 0].astype(np.int64)
    ids[ids == 0xFFFFFFFF] = -1
    scores = body_arr[:, :, 1].copy().view(np.float32)
    return ids, scores, time.perf_counter() - t0


def run_batched(url, queries, truth, top_k, probe, batch=64):
    """Batched throughput mode: the whole query set in `batch`-row POSTs."""
    from rabitq_tpu_torch.utils import calculate_recall

    recalls, lats = [], []
    t0 = time.perf_counter()
    for s in range(0, len(queries), batch):
        ids, _, dt = query_batch_bin(
            url, queries[s : s + batch], top_k, probe
        )
        lats.append(dt)
        for i, row in enumerate(ids):
            recalls.append(calculate_recall(truth[s + i], row, top_k))
    wall = time.perf_counter() - t0
    _report(f"batched x{batch}", recalls, lats)
    print(f"throughput: {len(queries) / wall:.1f} QPS")
    return recalls, lats


def query_once(url: str, vec, top_k: int, probe: int):
    payload = json.dumps(
        dict(query=np.asarray(vec, dtype=float).tolist(), top_k=top_k, probe=probe)
    ).encode()
    req = urllib.request.Request(
        url + "/query", data=payload, headers={"Content-Type": "application/json"}
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req) as resp:
        body = json.loads(resp.read())
    return body["ids"], time.perf_counter() - t0


def _report(name, recalls, latencies):
    lat = np.asarray(latencies) * 1e3
    print(
        f"{name}: recall={np.mean(recalls):.4f} "
        f"p50={np.percentile(lat, 50):.2f}ms "
        f"p99={np.percentile(lat, 99):.2f}ms mean={lat.mean():.2f}ms"
    )


def run_serial(url, queries, truth, top_k, probe):
    from rabitq_tpu_torch.utils import calculate_recall

    recalls, lats = [], []
    for i, q in enumerate(queries):
        ids, dt = query_once(url, q, top_k, probe)
        recalls.append(calculate_recall(truth[i], np.asarray(ids), top_k))
        lats.append(dt)
    _report("serial", recalls, lats)
    return recalls, lats


def run_concurrent(url, queries, truth, top_k, probe, workers=8, binary=False):
    from rabitq_tpu_torch.utils import calculate_recall

    def one(i):
        last = None
        for _ in range(3):  # the stdlib threaded server drops connections
            try:                   # occasionally under heavy concurrency
                if binary:
                    ids, _, dt = query_once_bin(url, queries[i], top_k, probe)
                else:
                    ids, dt = query_once(url, queries[i], top_k, probe)
                return calculate_recall(truth[i], np.asarray(ids), top_k), dt
            except (ConnectionError, OSError) as e:
                last = e
        raise last

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        results = list(pool.map(one, range(len(queries))))
    wall = time.perf_counter() - t0
    recalls = [r for r, _ in results]
    lats = [d for _, d in results]
    _report(f"concurrent x{workers}", recalls, lats)
    print(f"throughput: {len(queries) / wall:.1f} QPS")
    return recalls, lats


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rabitq-tpu-torch-client")
    ap.add_argument("--url", default="http://127.0.0.1:9000")
    ap.add_argument("-q", "--query", required=True, help="query fvecs")
    ap.add_argument("-t", "--truth", required=True, help="truth ivecs")
    ap.add_argument("-k", "--topk", type=int, default=100)
    ap.add_argument("-p", "--probe", type=int, default=300)
    ap.add_argument("-n", "--num", type=int, default=None)
    ap.add_argument("-c", "--concurrency", type=int, default=0)
    ap.add_argument(
        "--binary", action="store_true", help="use the binary /query_bin protocol"
    )
    ap.add_argument(
        "--batch",
        type=int,
        default=0,
        help="send BATCH queries per POST via /query_bin_batch (amortizes "
        "the network round-trip; the biggest lever through a high-RTT link)",
    )
    args = ap.parse_args(argv)

    from rabitq_tpu_torch.io import read_matrix

    queries = read_matrix(args.query)
    truth = read_matrix(args.truth, np.int32)
    if args.num:
        queries, truth = queries[: args.num], truth[: args.num]
    if args.batch:
        run_batched(
            args.url, queries, truth, args.topk, args.probe, args.batch
        )
    elif args.concurrency:
        run_concurrent(
            args.url,
            queries,
            truth,
            args.topk,
            args.probe,
            args.concurrency,
            binary=args.binary,
        )
    else:
        run_serial(args.url, queries, truth, args.topk, args.probe)


if __name__ == "__main__":
    main()
