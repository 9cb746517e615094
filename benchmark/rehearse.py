"""The CPU rehearsal: each cell at a tiny size on the CPU, through the
kernels' plain versions, with the data, the reference, the window, the
traced batches, the metric readers and the result line of a real run.
It measures nothing: the settings below exist only here, and the measured
command (benchmark.run) still refuses to run without a card.

    python3 -m benchmark.rehearse [--workload sift1m.b16384] [--trace 1]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

from benchmark import spec

# Scale only: every width, topk, rerank, build, precision and filter
# setting stays the cell's own.
TINY_CONFIG = dict(rows=3000)
TINY_KMEANS = dict(k=32, iters=4, train_rows=3000)
TINY_TRAFFIC = dict(batch=32, pool=96, probe=16, trace_batches=3)
SECONDS = 0.3


def tiny(cell: spec.Cell) -> spec.Cell:
    config = {**cell.config, **TINY_CONFIG,
              "kmeans": {**cell.config["kmeans"], **TINY_KMEANS}}
    return dataclasses.replace(cell, config=config,
                               traffic={**cell.traffic, **TINY_TRAFFIC})


def rehearse(name: str, seed: int = 3, trace: bool = False,
             make_search=None) -> dict:
    from benchmark import harness

    return harness.run_cell(tiny(spec.load_cell(name)), seed, SECONDS, trace,
                            "cpu", time.perf_counter(), make_search)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.rehearse")
    ap.add_argument("--workload", action="append")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--seed", type=int, default=3)
    args = ap.parse_args(argv)
    if args.workload:
        names = args.workload
    else:
        with open(spec.ROOT / "BENCHMARK.json") as f:
            names = [w["name"] for w in json.load(f)["workloads"]]
    ok = True
    for name in names:
        line = rehearse(name, args.seed, bool(args.trace))
        print(json.dumps(line), flush=True)
        ok &= line["correct"]
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
