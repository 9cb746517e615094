"""Recall and card time of a cell's traffic at other probes, for choosing
a cell's probe: per seed, the cell's set-up once, then at each probe the
whole query pool through the program's search as the cell calls it (its
row filter included), timed over two passes after one warm-up pass, and
its recall@topk against the cell's own reference.

    python3 -m benchmark.sweep --workload sift1m.filter10 \\
        --probes 48,64,96,128 --seeds 11,12

prints one JSON line a (seed, probe).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import harness, spec, truth


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def sweep(cell: spec.Cell, seed: int, probes: list, device) -> list:
    state = harness.setup(cell, seed, device, time.perf_counter())
    search = harness.program_search(state.row_filter)
    runs = []
    for probe in probes:
        params = state.params._replace(probe=probe)

        def one_pass():
            return [search(state.index, q, params)[1] for q in state.batches]

        one_pass()
        harness.sync(device)
        t = time.perf_counter()
        one_pass()
        ids = torch.cat(one_pass())
        harness.sync(device)
        ms = 1e3 * (time.perf_counter() - t) / (2 * state.batches.shape[0])
        runs.append((probe, ms, ids))
    state.index = state.row_filter = None
    base = harness.base_rows(state)
    queries = state.batches.reshape(-1, state.batches.shape[2])
    _, true_ids = truth.brute_force_topk(base, queries, cell.traffic["topk"],
                                         state.allowed)
    return [dict(cell=cell.name, seed=seed, probe=probe,
                 batch_ms=ms,
                 recall=float(truth.hits(ids, true_ids).sum()) / ids.numel())
            for probe, ms, ids in runs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.sweep")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--probes", type=_ints, required=True)
    ap.add_argument("--seeds", type=_ints, required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    cell = spec.load_cell(args.workload)
    for seed in args.seeds:
        for rec in sweep(cell, seed, args.probes, torch.device("cuda")):
            print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
