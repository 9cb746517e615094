"""Run one cell of BENCHMARK.json once, on this machine's card.

    python3 -m benchmark.run --workload sift1m.b16384 --seed 7 --seconds 10 --trace 0

Prints progress to stderr, then the compared numbers beside their limits
as stderr's last lines, and the result as one JSON line, stdout's last.
Exits non-zero, printing no result, where there is no CUDA device or
fewer than the cell asks for, where the program is not beside it, or
where the process holds jax, jaxlib, flax or the JAX package once the
window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from benchmark import spec  # noqa: E402

# Every build and kernel cache stays at a fixed path inside the checkout
# (the program's own nvcc libraries go to its build/ directory).
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(spec.ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(spec.ROOT / "build" / "triton"))

# Top-level module names that must not be loaded in a run: JAX and the
# JAX package, which the port stands beside and must not lean on.
JAX_MODULES = frozenset({"jax", "jaxlib", "flax", "rabitq_tpu"})


def jax_loaded(modules=None) -> list:
    """The names of ``JAX_MODULES`` that ``modules`` (by default
    ``sys.modules``) holds, compared by whole top-level names."""
    names = {m.partition(".")[0] for m in (sys.modules if modules is None
                                           else modules)}
    return sorted(JAX_MODULES & names)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    try:
        import rabitq_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"benchmark: the program is not here ({e})", file=sys.stderr)
        return 3
    from benchmark import harness

    line = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                            "cuda", T_START)
    found = jax_loaded()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    harness.log(f"[card] {harness.nvidia_smi()}")
    for name, c in line["checks"].items():
        harness.log(f"[check] {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
