"""The control and the faults that ``correct`` must catch, and the tool
that reads the compared numbers of sound runs, the control and a fault on
the card, from which the limits in ``limits/<cell>.json`` are set.

- The control is the reference put in the program's place, computed one
  precision below the configuration's float32 with TF32 off: brute force
  whose product runs in TF32 (each operand rounded to 10 mantissa bits,
  the products summed in float32, as the tensor cores compute it), its
  distances returned as the answer; in a filtered cell over the allowed
  rows alone.
- ``half``: half of each batch left out (its queries answered with no
  ids).
- ``altered``: one answer altered where it is produced (the first id of
  each batch moved to the next row).
- ``unfiltered``, in a filtered cell only: the program's search called
  without the cell's row filter.

``half`` and ``altered`` break the program's search as the cell calls it,
with its row filter where it has one.

A step that returns its state unchanged, and the exchange between chips,
are faults this system cannot have: a search keeps no state from batch to
batch, and a cell runs on one card.

    python3 -m benchmark.control --workload sift1m.b16384 --seeds 1,2,3 \\
        --control-seeds 1,2,3 --fault-seeds 1,2,3 --seconds 2

(``--faults``, by default every fault the cell can have) prints one JSON
line a (seed, arm) and appends them to
``<out>/control-<cell>.jsonl`` (``--out``, by default ``build/control``
in the checkout).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

from benchmark import harness, spec, truth


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest
    even."""
    b = x.contiguous().view(torch.int32)
    b = b + (0xFFF + ((b >> 13) & 1))
    return (b & ~0x1FFF).view(torch.float32)


def control_search(state):
    """The control's search: the exact top-k of each batch over the
    benchmark's base (its allowed rows in a filtered cell), ranked and
    reported by TF32 distances."""
    base = tf32_round(harness.base_rows(state))
    allowed = state.allowed

    def search(index, queries, params):
        return truth.brute_force_topk(base, tf32_round(queries), params.topk,
                                      allowed)

    return search


def half_batch(state):
    """The program's search with the second half of each batch left out."""
    program = harness.program_search(state.row_filter)

    def search(index, queries, params):
        h = queries.shape[0] // 2
        d, i = program(index, queries[:h], params)
        pad_d = torch.full((queries.shape[0] - h, d.shape[1]), torch.inf,
                           device=d.device)
        return (torch.cat([d, pad_d]),
                torch.cat([i, torch.full_like(pad_d, -1, dtype=i.dtype)]))

    return search


def altered(state):
    """The program's search with one id of each batch altered."""
    program = harness.program_search(state.row_filter)

    n = state.config["rows"]

    def search(index, queries, params):
        d, i = program(index, queries, params)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % n
        return d, i

    return search


def unfiltered(state):
    """The program's search without the cell's row filter."""
    return harness.program_search()


FAULTS = {"half": half_batch, "altered": altered}
FILTER_FAULTS = {"unfiltered": unfiltered}


def faults(cell: spec.Cell) -> dict:
    """{name: fault} of the faults ``cell`` can have."""
    return {**FAULTS, **(FILTER_FAULTS if "filter" in cell.traffic else {})}


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--fault-seeds", type=_ints, default=[])
    ap.add_argument("--faults")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=str(spec.ROOT / "build" / "control"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    cell_faults = faults(cell)
    names = args.faults.split(",") if args.faults else list(cell_faults)
    torch.backends.cuda.matmul.allow_tf32 = False
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    dev = torch.device("cuda")
    seeds = sorted(set(args.seeds) | set(args.control_seeds)
                   | set(args.fault_seeds))
    with open(out / f"control-{cell.name}.jsonl", "a") as f:
        for seed in seeds:
            t = time.perf_counter()
            state = harness.setup(cell, seed, dev, t)
            arms = []
            if seed in args.seeds:
                arms.append(("program", None))
            if seed in args.control_seeds:
                arms.append(("control", control_search(state)))
            if seed in args.fault_seeds:
                arms += [(k, cell_faults[k](state)) for k in names]
            for arm, fn in arms:
                line = harness.measure(cell, state, args.seconds, False, t,
                                       fn, keep=True)
                rec = dict(cell=cell.name, seed=seed, arm=arm,
                           correct=line["correct"], failed=line["failed"],
                           checks={k: c["value"]
                                   for k, c in line["checks"].items()},
                           metrics={k: m["value"]
                                    for k, m in line["metrics"].items()},
                           stages=line["stages"])
                print(json.dumps(rec), flush=True)
                f.write(json.dumps(rec) + "\n")
                f.flush()
            del state
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
