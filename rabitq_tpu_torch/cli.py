"""Command-line interface (port of rabitq_tpu.cli).

    python -m rabitq_tpu_torch.cli train -i sample.fvecs -o centroids.fvecs -k 4096
    python -m rabitq_tpu_torch.cli build -b base.fvecs -c centroids.fvecs -s index_dir
    python -m rabitq_tpu_torch.cli run -b base.fvecs -c centroids.fvecs -s index_dir \\
        -q query.fvecs -t truth.ivecs -p 28 --rerank 32 -k 10 --batch 2048
    python -m rabitq_tpu_torch.cli run ... --autotune 0.95   (or --adaptive)

``run`` loads the index directory (or builds it from -b/-c and saves it
there) and evaluates recall and QPS over the queries; ``build`` builds and
saves without evaluating; ``train`` runs k-means. The flags and defaults
are the JAX CLI's; ``--device`` (default cuda) picks where everything
runs, and without a card ``cuda`` raises, never falling back to the CPU.
Flags of features the port does not have exit non-zero with the ROADMAP
item that will serve them. Logging via the RABITQ_LOG env var.
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import os
import time
from pathlib import Path

import numpy as np
import torch

_EXACT = (
    "not ported: the JAX package's approximate selection and bf16 rerank "
    "are on ROADMAP's do-not-port list (the port's selection and rerank are "
    "always exact f32)"
)


def _setup_logging() -> None:
    level = os.environ.get("RABITQ_LOG", "info").upper()
    logging.basicConfig(
        level=getattr(logging, level, logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )


def _generator(args) -> torch.Generator:
    """A generator seeded with --seed on --device (raising on "cuda"
    without a card)."""
    from rabitq_tpu_torch.utils import resolve_device

    return torch.Generator(device=resolve_device(args.device)).manual_seed(
        args.seed
    )


def _load_or_build(args):
    from rabitq_tpu_torch.index.build import build_index
    from rabitq_tpu_torch.index.serialize import dump_to_dir, load_from_dir
    from rabitq_tpu_torch.io import read_matrix

    log = logging.getLogger("rabitq_tpu_torch.cli")
    saved = Path(args.saved)
    if saved.is_dir():
        log.info("loading index from %s", saved)
        # The seed draws the query dither only for a directory without
        # meta.json (one the Rust reference wrote).
        return load_from_dir(saved, generator=_generator(args),
                             device=args.device)
    log.info("building index from %s", args.base)
    index = build_index(
        read_matrix(args.base),
        read_matrix(args.centroids),
        generator=_generator(args),
        bits=args.bits,
        spill=args.spill,
        spill_mode=args.spill_mode,
        device=args.device,
    )
    log.info("saving index to %s", saved)
    dump_to_dir(index, saved)
    return index


def _host_rerank(index, queries, truth, params, args):
    """Per query: the full rough scan (fold off), then the reference's
    dynamic-pruning reranker on the host. Returns (seconds, recall sum)."""
    import importlib

    from rabitq_tpu_torch.metrics import METRICS
    from rabitq_tpu_torch.rerank import new_re_ranker
    from rabitq_tpu_torch.utils import calculate_recall

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    base_np = index.base.cpu().numpy()
    map_ids = index.map_ids.cpu().numpy()
    d = queries.shape[1]
    total_time = recall = 0.0
    for i in range(queries.shape[0]):
        q = queries[i : i + 1]
        start = time.perf_counter()
        scan = tsearch.rough_scan(
            index, torch.from_numpy(q).to(args.device), params, fold=0
        )
        rough = scan.rough[0].cpu().numpy()
        starts = scan.starts[0].cpu().numpy()
        span = rough.shape[0] // starts.shape[0]
        pos = (starts[:, None] + np.arange(span)[None, :]).reshape(-1)
        keep = np.isfinite(rough)
        qpad = np.zeros(index.dim, np.float32)
        qpad[:d] = q[0]

        def dist_fn(p, _qp=qpad):
            return float(((base_np[p] - _qp) ** 2).sum())

        rr = new_re_ranker(args.topk, dist_fn, args.rerank_mode == "heuristic")
        rr.rank_batch(rough[keep], pos[keep], map_ids)
        ids = np.array([i for _, i in rr.get_result()], dtype=np.int32)
        total_time += time.perf_counter() - start
        recall += calculate_recall(truth[i], ids, args.topk)
        METRICS.add_query_count(1)
    return total_time, recall


def _autotuned(index, queries, params, args):
    """--autotune: (probe, rerank) picked on the first 512 queries against
    exact ground truth, every other knob kept from the flags."""
    from rabitq_tpu_torch.autotune import autotune

    log = logging.getLogger("rabitq_tpu_torch.cli")
    tuned, curve = autotune(index, queries[:512], target_recall=args.autotune,
                            topk=args.topk, base_params=params)
    log.info("autotune(target=%.3f): probe=%d rerank=%d (curve: %s)",
             args.autotune, tuned.probe, tuned.rerank,
             ", ".join(f"p{c.probe}={c.recall:.4f}" for c in curve))
    return tuned


def cmd_run(args) -> dict:
    """Evaluate; returns {"qps", "recall"} (also logged)."""
    from rabitq_tpu_torch.index.index import SearchParams
    from rabitq_tpu_torch.index.search import (
        search_adaptive,
        search_with_stats,
    )
    from rabitq_tpu_torch.io import read_matrix
    from rabitq_tpu_torch.metrics import METRICS, record_search_stats
    from rabitq_tpu_torch.profiling import TIMER, device_trace
    from rabitq_tpu_torch.utils import calculate_recall

    log = logging.getLogger("rabitq_tpu_torch.cli")
    with TIMER.phase("load_or_build"):
        index = _load_or_build(args)
    queries = read_matrix(args.query)
    truth = read_matrix(args.truth, np.int32)
    params = SearchParams(probe=args.probe, topk=args.topk, rerank=args.rerank)
    if args.no_fold:
        params = params._replace(select_reduce=False)
    if args.probe_rank:
        params = params._replace(probe_rank=args.probe_rank)
    if args.autotune is not None:
        with TIMER.phase("autotune"):
            params = _autotuned(index, queries, params, args)
    nq = queries.shape[0]

    if args.rerank_mode in ("heap", "heuristic"):
        total_time, recall = _host_rerank(index, queries, truth, params, args)
    else:
        batch = max(1, args.batch)
        pad = (-nq) % batch
        qdev = torch.from_numpy(np.pad(queries, ((0, pad), (0, 0)))).to(
            args.device
        )
        def run_batch(qb):
            """(ids, stats); adaptive search keeps no stats, and reads its
            certificate on the host once a level."""
            if args.adaptive:
                return search_adaptive(index, qb, params)[1], None
            return search_with_stats(index, qb, params)[1:]

        with TIMER.phase("warmup"):
            run_batch(qdev[:batch])
        trace = device_trace(args.trace) if args.trace else contextlib.nullcontext()
        # Batches are enqueued back to back; results come to the host once,
        # after the loop's synchronize.
        start = time.perf_counter()
        with trace, TIMER.phase("search"):
            outs = [run_batch(qdev[s : s + batch])
                    for s in range(0, nq + pad, batch)]
        total_time = time.perf_counter() - start
        with TIMER.phase("recall"):
            all_ids = torch.cat([ids for ids, _ in outs]).cpu().numpy()
            for bi, (_, stats) in enumerate(outs):
                valid = min(batch, nq - bi * batch)
                METRICS.add_query_count(valid)
                if stats is not None:
                    record_search_stats(stats, valid)
            recall = sum(calculate_recall(truth[i], all_ids[i], args.topk)
                         for i in range(nq))

    qps, recall = nq / total_time, recall / nq
    log.info("QPS: %.1f, recall: %.4f", qps, recall)
    log.info("Metrics [%s]", METRICS.to_str())
    if args.profile:
        print(TIMER.report())
    return dict(qps=qps, recall=recall)


def cmd_build(args) -> None:
    _load_or_build(args)


def cmd_train(args) -> None:
    from rabitq_tpu_torch.io import read_matrix, write_matrix
    from rabitq_tpu_torch.kmeans import kmeans

    log = logging.getLogger("rabitq_tpu_torch.cli")
    x = read_matrix(args.input)
    start = time.perf_counter()
    c = kmeans(x, args.k, iters=args.iters, generator=_generator(args),
               device=args.device)
    log.info("trained %d centroids in %.1fs", c.shape[0],
             time.perf_counter() - start)
    write_matrix(args.output, c.cpu().numpy())


def main(argv=None):
    """Parse ``argv`` and run the command; returns what it returns (the
    ``run`` command: {"qps", "recall"})."""
    _setup_logging()
    ap = argparse.ArgumentParser(prog="rabitq-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def add_device_arg(p):
        p.add_argument(
            "--device",
            default="cuda",
            help="torch device to build and search on (default cuda; "
            "raises without a card, never falls back to the CPU)",
        )

    def add_index_args(p):
        p.add_argument("-b", "--base", required=True, help="base fvecs path")
        p.add_argument("-c", "--centroids", required=True)
        p.add_argument("-s", "--saved", required=True, help="index dir")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument(
            "--bits",
            type=int,
            default=1,
            choices=range(1, 8),
            help="residual code bits/dim (1 = reference-compatible sign "
            "codes; >1 = extended grid codes, lower estimator error at the "
            "same scan cost)",
        )
        p.add_argument(
            "--spill",
            type=float,
            default=0.0,
            help="multi-assignment fraction: additionally index this "
            "fraction of the most boundary-ambiguous vectors in their "
            "runner-up cluster (queries dedup ids automatically)",
        )
        p.add_argument(
            "--spill-mode",
            choices=["dist", "soar"],
            default="dist",
            help="how a spilled vector ranks its candidate target clusters: "
            "dist = centroid distance; soar = ScaNN's SOAR objective",
        )
        add_device_arg(p)

    p_run = sub.add_parser("run", help="build-or-load index and evaluate")
    add_index_args(p_run)
    p_run.add_argument("-q", "--query", required=True)
    p_run.add_argument("-t", "--truth", required=True)
    p_run.add_argument("-p", "--probe", type=int, default=100)
    p_run.add_argument("-k", "--topk", type=int, default=10)
    p_run.add_argument("--rerank", type=int, default=128)
    p_run.add_argument("--batch", type=int, default=64)
    p_run.add_argument(
        "--rerank-mode",
        choices=["device", "heap", "heuristic"],
        default="device",
        help="device = batched top-R rerank; heap/heuristic = the "
        "reference's dynamic-pruning rerankers on the host over the full "
        "rough scan (slow, for parity checks)",
    )
    p_run.add_argument(
        "--no-fold",
        action="store_true",
        help="disable the kernel lane-fold pre-selection "
        "(SearchParams.select_reduce=False)",
    )
    p_run.add_argument(
        "--rerank-kernel",
        action="store_true",
        help="accepted for the JAX CLI's sake and changes nothing: the port "
        "always reranks through its gather_l2 kernel (csrc/gather_l2.cu) "
        "on the card",
    )
    p_run.add_argument(
        "--adaptive",
        action="store_true",
        help="early-stop search: double probe until the result is "
        "geometrically certified (probe flag = starting probe)",
    )
    p_run.add_argument(
        "--probe-rank",
        choices=["centroid", "annulus"],
        default=None,
        help="cluster probe ranking: centroid distance (default) or the "
        "annulus lower bound (better on skewed corpora with split "
        "oversized clusters)",
    )
    p_run.add_argument(
        "--autotune",
        type=float,
        default=None,
        metavar="RECALL",
        help="pick probe+rerank automatically for this target recall@topk "
        "on a query sample against exact ground truth (overrides -p and "
        "--rerank; other knobs are kept)",
    )
    p_run.add_argument(
        "--profile",
        action="store_true",
        help="print per-phase wall-clock totals at exit (PhaseTimer)",
    )
    p_run.add_argument(
        "--trace",
        default=None,
        metavar="DIR",
        help="write a torch.profiler Chrome trace of the query loop into DIR",
    )
    refused = {
        "--select-passes": (None, int, _EXACT),
        "--rerank-bf16": ("store_true", None, _EXACT),
        "--rerank-refine": (None, int, _EXACT),
    }
    for flag, (action, typ, why) in refused.items():
        kw = dict(action=action) if action else dict(type=typ, default=None)
        p_run.add_argument(flag, help=f"refused: {why}", **kw)
    p_run.set_defaults(fn=cmd_run)

    p_build = sub.add_parser("build", help="build and save an index")
    add_index_args(p_build)
    p_build.set_defaults(fn=cmd_build)

    p_train = sub.add_parser("train", help="train IVF centroids (k-means)")
    p_train.add_argument("-i", "--input", required=True)
    p_train.add_argument("-o", "--output", required=True)
    p_train.add_argument("-k", type=int, help="flat k-means centroid count")
    p_train.add_argument(
        "--tree",
        type=int,
        nargs=2,
        metavar=("T", "D"),
        help="refused: hierarchical k-means is not ported (ROADMAP queue 1 "
        "item 9, hierarchical_kmeans)",
    )
    p_train.add_argument("--iters", type=int, default=25)
    p_train.add_argument("--seed", type=int, default=0)
    add_device_arg(p_train)
    p_train.set_defaults(fn=cmd_train)

    args = ap.parse_args(argv)
    if args.cmd == "train":
        if args.tree is not None:
            ap.error("--tree: hierarchical k-means is not ported (ROADMAP "
                     "queue 1 item 9, hierarchical_kmeans)")
        if args.k is None:
            ap.error("train requires -k")
    if args.cmd == "run":
        for flag, (_, _, why) in refused.items():
            if getattr(args, flag[2:].replace("-", "_")) not in (None, False):
                ap.error(f"{flag}: {why}")
    return args.fn(args)


if __name__ == "__main__":
    main()
