"""The quantize kernel timed against other sources of it on the card.

Builds csrc/quantize.cu as it is ("kernel") and each source given as
``--other NAME=PATH`` (an older or a trial quantize.cu with the same C
entry point, ``rabitq_quantize_residuals``; a diagnostic source that
skips part of the work may give other values). At the sift shape (B 2048,
probe 28, D 128) and the gist shape (B 1024, probe 80, D 1024, packed),
each is held against the plain twin with the dither off and on (values,
lo, delta and code_sum bit-equal or not), then timed by device time with
the L2 cold (a 256 MB read before each call), in the order given and then
reversed, and by the median host time of a launch (ctypes included;
LAUNCHES launches of each, in turns, fewer in all than the card's queue
holds). Run it from the root of a checkout on the card:

    python -m rabitq_tpu_torch.tools.quantize_ab [--other NAME=PATH ...]
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import functools
import re
import subprocess
import time
from pathlib import Path

import torch

from rabitq_tpu_torch.consts import SCALAR
from rabitq_tpu_torch.ops import _cuda
from rabitq_tpu_torch.ops.quantize import (
    _QMAX,
    _TINY,
    quantize_residuals_reference,
)

SHAPES = (("sift", 2048, 28, 128, False), ("gist", 1024, 80, 1024, True))
K = 4096
FLUSH_BYTES = 256 << 20
CALLS = 20
LAUNCHES = 150


def registers(ptxas: str) -> dict[str, int]:
    """Registers per kernel instance from ptxas -v output, the register
    path's instances named by their template arguments."""
    found = {}
    for chunk in ptxas.split("Compiling entry function")[1:]:
        m = re.search(r"quantize_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)E",
                      chunk)
        name = (f"{m[1]} lanes, {m[2]} units{', packed' * (m[3] == '1')}"
                f"{', dither' * (m[4] == '1')}" if m else "shared-memory path")
        used = re.search(r"Used (\d+) registers", chunk)
        found[name] = int(used[1]) if used else 0
    return found


def build(name: str, src: Path, out_dir: Path):
    """nvcc one source into out_dir; returns (name, C entry point, ptxas
    registers per instance)."""
    lib = out_dir / f"libquantize_{name}.so"
    proc = subprocess.run([_cuda.find_nvcc(), *_cuda.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc {name}:\n{proc.stdout}{proc.stderr}")
    regs = registers(proc.stdout + proc.stderr)
    fn = ctypes.CDLL(str(lib)).rabitq_quantize_residuals
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return name, fn, regs


def launcher(fn):
    def call(y, c, cids, bias, pack, out=None):
        s, d = cids.numel(), y.shape[1]
        if out is None:
            out = (torch.empty((s, d // 2 if pack else d), dtype=torch.int8,
                               device=y.device),
                   torch.empty((s, 4), dtype=torch.float32, device=y.device))
        q, scal = out
        err = fn(y.data_ptr(), c.data_ptr(), cids.data_ptr(),
                 None if bias is None else bias.data_ptr(), q.data_ptr(),
                 scal.data_ptr(), s, cids.shape[1], d, int(pack), SCALAR,
                 _TINY, float(_QMAX), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return q, scal
    return call


def operands(dev, b, probe, dim, seed):
    """As search makes them: y [B, D], centroids [K, D], [B, probe]
    distinct cluster ids a query, a dither [D] in [0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((b, dim), generator=gen, device=dev)
    c = torch.randn((K, dim), generator=gen, device=dev)
    cids = torch.rand((b, K), generator=gen, device=dev).argsort(dim=1)
    bias = torch.rand(dim, generator=gen, device=dev)
    return y, c, cids[:, :probe].contiguous(), bias


def cold_ms(fn, flush) -> float:
    """Mean device ms of fn()'s kernel, each of CALLS calls after a read
    of the flush buffer evicts the L2."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    kept = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if "quantize_kernel" in e.key and e.self_device_time_total > 0]
    return sum(t for t, _ in kept) / 1e3 / sum(c for _, c in kept)


def host_us(fns: dict) -> dict[str, float]:
    """Median host microseconds a launch of each of fns, LAUNCHES launches
    each, taken in turns so that every source meets the same load on the
    host (the median: the host is shared, and a launch now and then waits
    far longer than the rest)."""
    times = {name: [] for name in fns}
    torch.cuda.synchronize()
    for _ in range(LAUNCHES):
        for name, fn in fns.items():
            start = time.perf_counter()
            fn()
            times[name].append(time.perf_counter() - start)
    torch.cuda.synchronize()
    return {name: sorted(t)[LAUNCHES // 2] * 1e6 for name, t in times.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[],
                    metavar="NAME=PATH",
                    help="another quantize.cu with the same C entry point")
    args = ap.parse_args(argv)
    srcs = {"kernel": _cuda.CSRC / "quantize.cu"}
    for item in args.other:
        name, sep, path = item.partition("=")
        if not sep or not name or name in srcs:
            ap.error(f"--other wants a new NAME=PATH, got {item!r}")
        srcs[name] = Path(path)
    if not torch.cuda.is_available():
        print("no CUDA device")
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    out_dir = _cuda.BUILD_DIR / "quantize_ab"
    out_dir.mkdir(parents=True, exist_ok=True)
    with concurrent.futures.ThreadPoolExecutor(len(srcs)) as pool:
        built = list(pool.map(lambda kv: build(*kv, out_dir), srcs.items()))
    for name, _, regs in built:
        print(f"[quantize_ab build] {name}: registers per instance {regs}")
    calls = {name: launcher(fn) for name, fn, _ in built}
    flush = torch.ones(FLUSH_BYTES // 4, device=dev)
    for label, b, probe, dim, pack in SHAPES:
        y, c, cids, bias = operands(dev, b, probe, dim, seed=dim)
        for name, call in calls.items():
            equal = []
            for rb in (None, bias):
                (qg, sg), (qw, sw) = (call(y, c, cids, rb, pack),
                                      quantize_residuals_reference(
                                          y, c, cids, rb, pack))
                equal.append(torch.equal(qg, qw)
                             and torch.equal(sg[:, :3], sw[:, :3]))
            print(f"[quantize_ab {label}] {name}: bit-equal to the twin "
                  f"with the dither off, on: {equal}", flush=True)
        order = list(calls) + list(calls)[::-1]
        for name in order:
            for rb in (None, bias):
                ms = cold_ms(lambda: calls[name](y, c, cids, rb, pack), flush)
                print(f"[quantize_ab {label}] {name} dither "
                      f"{'on' if rb is not None else 'off'}: {ms:.5f} ms "
                      f"(device, L2 cold) [{smi}]", flush=True)
        outs = {name: calls[name](y, c, cids, None, pack) for name in calls}
        launches = {name: functools.partial(calls[name], y, c, cids, None,
                                            pack, outs[name])
                    for name in calls}
        for name, us in host_us(launches).items():
            print(f"[quantize_ab {label}] {name}: {us:.2f} us of host time "
                  f"a launch (median, ctypes included) [{smi}]", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
