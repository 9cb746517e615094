#!/usr/bin/env python3
"""The kernel table of the PyTorch/CUDA port (rabitq_tpu_torch) on one
NVIDIA GPU: each hand-written kernel against its plain version, its time
alone with the L2 cold, and its bound; then the main path at each
benchmark cell's shape, counting launches.

    python3 chip_smoke.py

Phases, one line each or more (a phase that fails raises; the exit code is
then non-zero and no result line is printed):

  1. [env]    torch/CUDA versions and the card's name and power limit;
  2. [build]  nvcc compiles the six kernel sources of
     rabitq_tpu_torch/csrc/ for sm_90a at once (time, ptxas usage);
  3. [kernel] each kernel against its plain PyTorch twin on the card,
     beside the kernel's bound (benchmark/roofline.py's peaks); kernels
     are timed by device time with the L2 cold (profile, a 256 MB read
     before each call), twins by CUDA events:
       quantize at the sift shape (B 2048, probe 28, D 128, unpacked) and
       the gist shape (B 1024, probe 80, D 1024, nibble-packed), dither
       off and on: values, lo, delta and code_sum bit-equal, ycd within
       rtol 1e-6; beside its launch plan and the bytes its design reads
       through L2 (by its own count, not measured);
       rough_scan, bit-equal, in each mode (fold 2, search's default, fold
       1 and the full output) at the sift shape (D 128, span 384, S 2048 x
       28) and the gist shape (D 1024, span 384, S 1024 x 80), on random
       operands (every task its own window, with edge cases) and on
       cluster-structured ones (tasks share windows, as in search), at
       the gist shape also on the nibble-packed query operand (qpack),
       equal to the unpacked kernel; five checked calls profiled, split
       into the kernel and its grouping glue; then on the cluster operands
       with the row-filter penalty (1% and 50% of the rows +inf), beside
       the same calls without it;
       gather_l2 at the gist shape (N 1.2M, D 1024, B 1024, R 150) and the
       sift shape (D 128, B 2048, R 32), also on cluster-local positions,
       to rtol 1e-5 / atol 1e-5 * max|out|, its bound counting each
       distinct row once; its bf16-row instance on the same operands with
       the base in bf16 (NaN exactly outside [0, N)), beside the f32
       instance;
       select at the sift cell's shape (B 8192, 28 x 256, R 32), the gist
       cell's (B 1024, 64 x 256, R 150) and a streamed one (B 1024, 384 x
       256, R 150): (lower bound, position) pairs equal to its plain
       version's, beside the plain version and the two torch.topk calls it
       replaced;
       probe_rank at the sift cell's shape (B 16384, K 4096, D 128, probe
       28), the gist cell's (B 8192, K 4096, D 1024 at the bf16 pass, probe
       64) and the blobs cell's (B 8192, K 5327 with 271 duplicated
       centroid rows, probe 384), fused and on the finished key: ids equal
       to its plain version's bit for bit, beside the plain version and
       the pairwise_l2sq + torch.sort pair it replaced (the GEMM's share
       beside);
  4. [int4]   rabitq_tpu_torch.tools.int4probe.run (int4_dot_direct and
     int4_dot_staged equal to the twin and numpy), then both kernels
     (device time, L2 cold), the twin and torch._int_mm on the unpacked
     int8 operands at the probe shape and a scan-window shape; then at
     each benchmark cell's shape (CELLS: sift1m.b16384, gist1m.b8192,
     blobs1m.b8192) quantize, rough_scan in search's mode (fold 2, qpack
     at gist) on cluster operands, gather_l2 on cluster-local positions
     and select, each checked and timed as in phase 3;
  5. [path]   for each cell, its index built as the benchmark builds it
     (benchmark/harness.py's set-up, seed 0) and search_many over two of
     its batches: each search kernel launches once a scan call (probe_rank
     at least once), and one batch runs under sync debug mode "error".

Then a JSON line of per-kernel results (the kernel table, with each
kernel's launches in phase 5, in all and by cell), the nvidia-smi
name/power-limit line, and last {"ok": true, "device": {...}}. Without a
CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch

from benchmark.roofline import (
    FP32_FLOPS_PER_S,
    HBM_BYTES_PER_S,
    INT8_OPS_PER_S,
    bound_s,
)

K = 4096  # the cells' clusters
KERNEL_SOURCES = ("rough_scan", "gather_l2", "int4_dot", "quantize", "select",
                  "probe_rank")
# Checked scan calls profiled a shape.
SCAN_PROFILED_CALLS = 5
SCAN_KERNEL = "rough_scan_kernel"  # within the profiler's demangled name
GATHER_KERNEL = "gather_l2_kernel"
SELECT_KERNEL = "select_kernel"
PROBE_RANK_KERNEL = "probe_rank_kernel"
# The gather_l2 instances' row types, template arguments in their names.
GATHER_BF16, GATHER_F32 = "Bf16Rows", "F32Rows"
INT4_KERNEL = "int4_dot_kernel"
QUANT_KERNEL = "quantize_kernel"
# ycd = sum r^2: the quantize kernel sums in another order than torch.sum.
YCD_RTOL = 1e-6
# Standalone kernel times are device times (profile) of calls that each
# find the 50 MB L2 cold, as search does: a read of this many bytes goes
# before every call. Back-to-back calls timed by CUDA events measure the
# wrapper's host time instead when the kernel is the shorter.
L2_FLUSH_BYTES = 256 << 20
COLD_CALLS = 20
# The scan's modes: fold depth -> name. Search folds at depth 2 by default.
SCAN_MODES = {2: "fold 2", 1: "fold 1", 0: "full"}
# Shares of the rows the penalty operand filters in the kernel checks.
PENALTY_DENSITIES = (0.01, 0.5)
# The benchmark's cells (benchmark/configs, benchmark/traffic) as their
# kernels see them: B, probe, D as the index pads it, clusters (the blobs
# build splits 4096 into ~5327), the scan span (the index's capacity), R,
# and whether search packs the scan's query operand (D a multiple of 256).
CELLS = {"sift1m.b16384": (16384, 28, 128, 4096, 384, 32, False),
         "gist1m.b8192": (8192, 64, 1024, 4096, 384, 150, True),
         "blobs1m.b8192": (8192, 384, 128, 5327, 512, 32, False)}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of fn() by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# The wait, in seconds, between a profile's start and its work: 0 until a
# profile loses device records, then raised by retry_lost_records and kept
# for the profiles after it (settled_profile).
PROFILE_SETTLE_S = [0.0]
PROFILE_SETTLE_MAX_S = 8.0
# The newest settled_profile and the host clock (ns) when its work began.
LAST_PROFILE = [None, 0]


@contextlib.contextmanager
def settled_profile(cpu=True):
    """torch.profiler over the CUDA activity (and the CPU's with ``cpu``),
    whose work starts PROFILE_SETTLE_S after the profile. Late in this
    script's process a profile has kept no device record of its first
    kernels (a gist batch's ranking GEMMs, probe_rank and quantize
    kernels), six profiles running, where a fresh process kept them all:
    a wait of 0.05-0.8 s inside the profile did not bring them back, one
    of 3.2-8 s did. profile_timing reads where the records start."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        if PROFILE_SETTLE_S[0]:
            time.sleep(PROFILE_SETTLE_S[0])
        LAST_PROFILE[:] = [prof, time.time_ns()]
        yield prof


def profile_timing(prof, work_ns):
    """Where a profile's records start, in ms from ``work_ns`` (the host
    clock when its work began): the first kernel launch, the first device
    record kept, and CUPTI's activity buffer requests."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()

    def first(pick):
        ts = [e.start_ns() for e in events if pick(e)]
        return f"{(min(ts) - work_ns) / 1e6:.3f}" if ts else "none"

    buffers = [f"{(e.start_ns() - work_ns) / 1e6:.3f}" for e in events
               if e.name() == "Activity Buffer Request"]
    return (f"first launch {first(lambda e: 'LaunchKernel' in e.name())} "
            f"ms, first device record "
            f"{first(lambda e: e.device_type() == cuda)} ms, buffer "
            f"requests at {buffers} ms")


def l2_flush():
    """A buffer of L2_FLUSH_BYTES whose sum() evicts the L2, and the keys
    of the device events that sum launches (to leave out of a profile)."""
    flush = torch.ones(L2_FLUSH_BYTES // 4, device="cuda")
    with settled_profile(cpu=False) as prof:
        flush.sum()
        torch.cuda.synchronize()
    return flush, {e.key for e in prof.key_averages()}


def cold_device_ms(fn, name=None, calls=COLD_CALLS):
    """Mean device ms of one call of fn() with the L2 cold: ``calls``
    calls under the profiler, each after a read of L2_FLUSH_BYTES. Counts
    the device events whose name holds ``name``, or with name None every
    device event that the flush does not launch; fn must launch one such
    kernel a call. CUPTI has been seen to drop a record or two of a run,
    so the mean is over the records kept; fewer than calls - 2 raise
    ProfileLostRecords."""
    flush, flush_keys = l2_flush()
    fn()
    torch.cuda.synchronize()
    with settled_profile(cpu=False) as prof:
        for _ in range(calls):
            flush.sum()
            fn()
        torch.cuda.synchronize()
    kept = [(e.self_device_time_total, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0
            and (name in e.key if name else e.key not in flush_keys)]
    count = sum(c for _, c in kept)
    if not calls - 2 <= count <= calls:
        raise ProfileLostRecords(f"{calls} cold calls of {name}: {count} "
                                 f"device records")
    return sum(t for t, _ in kept) / 1e3 / count


def _scan_values(gen, dev, n_rows, s, dim, bits):
    """Random codes (on the bits-bit grid) and factors of n_rows rows, and
    query values and scalars of s tasks."""
    m = (1 << bits) - 1

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    codes = (2 * randint(m + 1, (n_rows, dim)) - m).to(torch.int8)
    factors = torch.randn((n_rows, 4), generator=gen, device=dev)
    factors[:, 3] = factors[:, 3].abs()
    qvals = randint(16, (s, dim)).to(torch.int8)
    scal = torch.randn((s, 4), generator=gen, device=dev)
    scal[:, 1] = scal[:, 1].abs() + 0.01
    scal[:, 2] = qvals.sum(1, dtype=torch.int32).float()
    scal[:, 3] = scal[:, 3].abs()
    return codes, factors, qvals, scal


def scan_operands(dev, n_rows, s, span, dim, seed=0, bits=4):
    """Random kernel operands, every task at a random start (so no two
    tasks share a window), with edge cases: size 0, size == span, and
    clusters ending at the last row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    starts = torch.randint(0, n_rows - span + 1, (s,), generator=gen,
                           device=dev)
    sizes = torch.randint(0, span + 1, (s,), generator=gen, device=dev)
    sizes[0], sizes[1] = 0, span
    starts[2], sizes[2] = n_rows - span, span
    starts[3], sizes[3] = n_rows - 1, 1
    codes, factors, qvals, scal = _scan_values(gen, dev, n_rows, s, dim, bits)
    return (codes, factors, starts.int(), sizes.int(), qvals, scal)


def cluster_scan_operands(dev, n_clusters, b, probe, span, dim, seed=0,
                          bits=4, skew=0.5):
    """Kernel operands as search makes them: n_clusters clusters of random
    sizes in [span/2, span] laid end to end (one in 97 empty, so that it
    shares its start with its successor; the last one full, ending at row
    N-1), and for each of b queries ``probe`` distinct clusters drawn with
    weights (rank + 1)^-skew over a random ranking, so a few clusters are
    probed by many queries. Task 0 probes the last cluster."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    sizes = torch.randint(span // 2, span + 1, (n_clusters,), generator=gen,
                          device=dev)
    sizes[::97] = 0
    sizes[-1] = span
    offsets = torch.zeros(n_clusters + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(sizes, 0)
    rank = torch.randperm(n_clusters, generator=gen, device=dev)
    w = (rank + 1.0) ** -skew
    cids = torch.multinomial(w.expand(b, -1), probe, replacement=False,
                             generator=gen)
    cids[0, 0] = n_clusters - 1
    cids = cids.reshape(-1)
    starts = offsets[cids]
    t_sizes = offsets[cids + 1] - starts
    n_rows = int(offsets[-1])
    codes, factors, qvals, scal = _scan_values(gen, dev, n_rows, b * probe,
                                               dim, bits)
    return (codes, factors, starts.int(), t_sizes.int(), qvals, scal)


# Many-group scan cases (group_case_operands): for each, the sizes of the
# clusters laid end to end, how many tasks probe each, and how many times
# the pattern repeats (so that each of the card's resident blocks runs many
# groups).
GROUP_CASES = {
    # windows of 1-8 rows, probed by 1, 32, 33 or 5 tasks: groups of one
    # task and full groups, one stage each
    "tiny": ([1 + i % 8 for i in range(48)], [1, 32, 33, 5] * 12, 50),
    # empty clusters (sharing a start with their successor) between full
    # ones (size None: the span)
    "empty": ([0, None] * 20, [1 + (7 * i) % 40 for i in range(40)], 50),
    # a window of exactly the span and one of span - 1, the last ending at
    # row N-1
    "span_edges": ([None, -1, 5, None, -1], [20, 40, 3, 17, 33], 50),
    # three groups: fewer than the card's resident blocks
    "few_groups": ([200, 7, None], [32, 32, 5], 1),
}


def group_case_operands(dev, case, span, dim, seed=0, bits=4, reps=None):
    """Scan operands of one GROUP_CASES case: its clusters laid end to end
    (a size of None is ``span``, -1 is ``span - 1``), repeated ``reps``
    times (default: the case's own count), and its tasks in a random
    order."""
    sizes, probes, default_reps = GROUP_CASES[case]
    reps = default_reps if reps is None else reps
    sizes = [span if z is None else span - 1 if z == -1 else z
             for z in sizes] * reps
    gen = torch.Generator(device=dev).manual_seed(seed)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    cids = np.repeat(np.arange(len(sizes)), probes * reps)
    perm = torch.randperm(cids.size, generator=gen, device=dev).cpu().numpy()
    cids = cids[perm]
    starts = torch.as_tensor(offsets[cids], dtype=torch.int32, device=dev)
    t_sizes = torch.as_tensor(np.asarray(sizes)[cids], dtype=torch.int32,
                              device=dev)
    codes, factors, qvals, scal = _scan_values(
        gen, dev, int(offsets[-1]), cids.size, dim, bits)
    return (codes, factors, starts, t_sizes, qvals, scal)


def scan_bound(codes, starts, sizes, span, out_width, q_bytes=None,
               penalty=False):
    """The least time of one scan on these operands: each probed row's code
    and factors (and with ``penalty`` its 4-byte penalty) read once (the
    union of the tasks' windows), each task's
    query values (``q_bytes``: D, or D/2 nibble-packed), scalars, start
    and size read once, the [S, out_width] f32 output written once
    (out_width = span unfolded, depth * 128 folded); against 2 * D int8
    operations per scanned slot. Returns (bound ms, "bytes" or
    "operations", distinct rows, GB)."""
    n, dim = codes.shape
    s = starts.shape[0]
    q_bytes = dim if q_bytes is None else q_bytes
    sz = sizes.clamp(0, span).long()
    diff = torch.zeros(n + 1, dtype=torch.int32, device=codes.device)
    one = torch.ones(s, dtype=torch.int32, device=codes.device)
    diff.index_add_(0, starts.long(), one)
    diff.index_add_(0, starts.long() + sz, -one)
    rows = int((torch.cumsum(diff, 0)[:n] > 0).sum())
    nbytes = (rows * (dim + 16 + 4 * penalty) + s * (q_bytes + 16 + 8)
              + s * out_width * 4)
    ops = 2 * dim * int(sz.sum())
    t, by = bound_s(nbytes, ops, INT8_OPS_PER_S)
    return 1e3 * t, by, rows, nbytes / 1e9


def groups_per_cluster(codes, starts, sizes, span):
    """(max, mean) groups per window of the kernel's grouping: the groups
    of ``group_tasks`` counted by the (start, clamped size) key of their
    first task."""
    from rabitq_tpu_torch.ops.scan_kernel import group_tasks

    order, first = group_tasks(starts, sizes, codes.shape[0], span)
    n_groups = int((first < starts.shape[0]).sum())
    lead = order[first[:n_groups].long()]
    key = (starts[lead].long() << 32) | sizes[lead].clamp(0, span).long()
    _, counts = torch.unique(key, return_counts=True)
    return int(counts.max()), float(counts.float().mean())


def device_ops(prof):
    """(name, self device ms, count) of every device-side event of a
    profile. A CPU op such as aten::topk also reports the device time of
    the kernels it launched, so it is left out."""
    return [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]


class ProfileLostRecords(AssertionError):
    """A profile holds fewer device records than the calls it covered."""


def retry_lost_records(fn, label, attempts=6):
    """fn(), run again (up to ``attempts`` times in all, a second apart)
    while its profile lost device records; every other failure propagates
    at once. CUPTI has been seen to keep only one call's records of a
    profiled run, or none, three profiles in a row, and late in the
    process none of a profile's first kernels (settled_profile): each
    retry waits longer inside the profile (at least four times the last
    wait, up to PROFILE_SETTLE_MAX_S), and the later profiles keep it."""
    for attempt in range(1, attempts + 1):
        try:
            return fn()
        except ProfileLostRecords as e:
            prof, work_ns = LAST_PROFILE
            timing = profile_timing(prof, work_ns) if prof else "no profile"
            PROFILE_SETTLE_S[0] = min(PROFILE_SETTLE_MAX_S,
                                      max(0.05, 4 * PROFILE_SETTLE_S[0]))
            log(f"[profile {label}] attempt {attempt} lost records ({timing}; "
                f"the profiles now wait {PROFILE_SETTLE_S[0]:.3f} s): "
                f"{str(e)[:300]}")
            torch.cuda.synchronize()
            time.sleep(1.0)
    raise AssertionError(f"[profile {label}] lost records {attempts} times")


def split_scan_profile(prof, calls, exclude=()):
    """(kernel ms, glue ms) per call of a profile that holds ``calls``
    scan wrapper calls and nothing else but device events keyed in
    ``exclude`` (the L2 flush). Every device event must appear a
    multiple of ``calls`` times, the scan kernel exactly ``calls``
    times: a profile that lost records fails instead of reading low."""
    ops = [op for op in device_ops(prof) if op[0] not in exclude]
    launched = [c for k, _, c in ops if SCAN_KERNEL in k]
    if launched != [calls] or any(c % calls for _, _, c in ops):
        raise ProfileLostRecords(f"profile of {calls} scan calls holds "
                                 f"{[(k[:40], c) for k, _, c in ops]}")
    kernel = sum(t for k, t, _ in ops if SCAN_KERNEL in k)
    glue = sum(t for k, t, _ in ops if SCAN_KERNEL not in k)
    return kernel / calls, glue / calls



def quantize_operands(dev, b, probe, dim, k=K, seed=0):
    """Quantize operands as search makes them: y [B, D] rotated queries,
    centroids [K, D], [B, probe] distinct cluster ids a query, and a
    dither [D] in [0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    y = torch.randn((b, dim), generator=gen, device=dev)
    centroids = torch.randn((k, dim), generator=gen, device=dev)
    cids = torch.rand((b, k), generator=gen, device=dev).argsort(dim=1)
    bias = torch.rand(dim, generator=gen, device=dev)
    return y, centroids, cids[:, :probe].contiguous(), bias


def quantize_bound(y, centroids, cids, pack, dither):
    """The least time of one quantize call: y, each distinct probed
    centroid row, cids (and the dither) read once, the quantized values
    (D or D/2 bytes a task) and scal written once; against 9 f32
    operations a value (subtract, min, max, multiply and add for ycd;
    subtract, divide, round or floor and add, clamp). Returns (bound ms,
    "bytes" or "operations", GB)."""
    b, dim = y.shape
    s = cids.numel()
    rows = int(torch.unique(cids).numel())
    nbytes = (4 * b * dim + 4 * rows * dim + 8 * s + 4 * dim * dither
              + s * (dim // 2 if pack else dim) + 16 * s)
    t, by = bound_s(nbytes, 9 * s * dim, FP32_FLOPS_PER_S)
    return 1e3 * t, by, nbytes / 1e9


def quantize_l2_reads(s, probe, dim, pack, dither):
    """Bytes the quantize kernel reads through L2 in one call of s tasks as
    it is designed, and its launch plan: on the register path each task's
    centroid row, y[b] once for each query in a lane group's run of tasks,
    the dither once a group, and cids; on the shared-memory path a y row
    and a centroid row (and the dither) a task."""
    from rabitq_tpu_torch.ops.quantize import quantize_plan

    plan = quantize_plan(s, dim, pack, dither)
    row = 4 * dim
    if not plan.lanes:
        return s * row * (2 + dither) + 8 * s, plan
    starts = np.arange(0, s, plan.run)
    ends = np.minimum(starts + plan.run, s)
    y_rows = int(((ends - 1) // probe - starts // probe + 1).sum())
    return s * row + y_rows * row + len(starts) * row * dither + 8 * s, plan


def gather_operands(dev, n, dim, b, r, seed=0):
    """Random rerank operands with duplicate positions within a query and
    rows 0 and N-1."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    base = torch.randn((n, dim), generator=gen, device=dev)
    q = torch.randn((b, dim), generator=gen, device=dev)
    pos = torch.randint(0, n, (b, r), generator=gen, device=dev)
    pos[:, 0] = n - 1
    pos[:, 1] = 0
    pos[:, 2] = pos[:, 3]
    return base, pos, q


def cluster_gather_positions(dev, n, b, r, windows=28, width=300, seed=0):
    """[B, R] positions as search makes them: each query's R rows drawn
    from ``windows`` contiguous windows of ``width`` rows (its probed
    clusters) at random starts in [0, N - width]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    starts = torch.randint(0, n - width + 1, (b, windows), generator=gen,
                           device=dev)
    pick = torch.randint(0, windows, (b, r), generator=gen, device=dev)
    off = torch.randint(0, width, (b, r), generator=gen, device=dev)
    return torch.gather(starts, 1, pick) + off


def gather_bound(pos, n, dim, elem_bytes=4):
    """The least time of one gather_l2 call on these [B, R] positions into
    N rows of ``dim`` values of ``elem_bytes`` (4 for the f32 instance, 2
    for the bf16 one): each distinct row that a position in [0, N) names
    read once (however many positions name it), every position read and
    every output written once, the [B, D] f32 queries read once; against 3
    fp32 operations (subtract, multiply, add) an element of each valid
    position. Returns (bound ms, "bytes" or "operations", GB, distinct
    rows)."""
    b, r = pos.shape
    valid = pos[(pos >= 0) & (pos < n)]
    rows = int(torch.unique(valid).numel())
    nbytes = rows * dim * elem_bytes + b * r * (8 + 4) + b * dim * 4
    t, by = bound_s(nbytes, 3 * valid.numel() * dim, FP32_FLOPS_PER_S)
    return 1e3 * t, by, nbytes / 1e9, rows


def assert_gather_close(got, want):
    """rtol 1e-5, atol 1e-5 * max|want|: the kernel and the twin sum the
    same f32 squares in different orders. Returns max |got - want|."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    atol = 1e-5 * float(want.abs().max()) if want.numel() else 0.0
    if not torch.allclose(got, want, rtol=1e-5, atol=atol):
        raise AssertionError(f"gather_l2 kernel != twin: max |diff| {err}")
    return err


def build_kernels():
    from rabitq_tpu_torch.ops import _cuda

    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = list(pool.map(_cuda.build, KERNEL_SOURCES))
    for name, b in zip(KERNEL_SOURCES, builds):
        ptxas = " | ".join(
            ln.strip() for ln in b.log.splitlines()
            if ("ptxas" in ln or "spill" in ln) and "Compile time" not in ln
        )
        log(f"[build] {b.path.name} nvcc {b.seconds:.2f}s cached={b.cached} "
            f"| {ptxas}")
    log(f"[build] flags {' '.join(_cuda.NVCC_FLAGS)}")


def check_rough_scan(smi, label, ops, span, twin_iters, fold, edges=False,
                     qpack=False):
    """The scan kernel against its twin on ``ops`` in one mode (fold depth
    2, 1 or 0; with ``qpack`` on the nibble-packed query values, and then
    also against the unpacked kernel on the same values).
    SCAN_PROFILED_CALLS wrapper calls run under the profiler, each after
    a read that evicts the L2, and each output must equal the twin bit
    for bit (and, for scan_operands, the edge-case tasks 0-3 be right);
    their profile gives the kernel's device time and the grouping glue's.
    The twin is timed by CUDA events; the bound counts the query bytes
    and the output this mode writes."""
    from rabitq_tpu_torch.ops import (
        cuda_rough_scan,
        pack_query_nibbles,
        rough_scan_reference,
    )
    from rabitq_tpu_torch.ops.scan_kernel import effective_fold

    codes, _, starts, sizes = ops[:4]
    n_rows, dim = codes.shape
    s = starts.shape[0]
    f = effective_fold(span, fold)
    if f != fold:
        raise AssertionError(f"span {span} does not fold at depth {fold}")
    mode = ("qpack " if qpack else "") + SCAN_MODES[fold]
    args = list(ops)
    if qpack:
        args[4] = pack_query_nibbles(ops[4])
    want = rough_scan_reference(*args, span, fold, qpack)
    if qpack:
        unpacked = cuda_rough_scan(*ops, span, fold)
        torch.cuda.synchronize()
        if not torch.equal(unpacked.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"rough_scan unpacked kernel != packed twin, "
                                 f"{label} {mode}")
        del unpacked
    fin = torch.isfinite(want)
    cuda_rough_scan(*args, span, fold, qpack)  # warm-up: attribute, occupancy
    torch.cuda.synchronize()
    flush, flush_keys = l2_flush()
    max_abs_err = 0.0

    def profiled_checked_calls():
        nonlocal max_abs_err
        outs = []
        with settled_profile() as prof:
            for _ in range(SCAN_PROFILED_CALLS):
                flush.sum()
                outs.append(cuda_rough_scan(*args, span, fold, qpack))
            torch.cuda.synchronize()
        for got in outs:
            same_inf = torch.equal(torch.isinf(got), torch.isinf(want))
            err = float((got[fin] - want[fin]).abs().max())
            max_abs_err = max(max_abs_err, err)
            if not (same_inf and torch.equal(got.view(torch.int32),
                                             want.view(torch.int32))):
                raise AssertionError(
                    f"rough_scan kernel != twin, {label} {mode} D={dim}: "
                    f"same +inf slots {same_inf}, max |diff| {err}"
                )
            if edges and not (
                torch.isinf(got[0]).all() and torch.isfinite(got[1]).all()
                and torch.isfinite(got[2]).all()
            ):
                raise AssertionError("edge cases: size 0 / size == span "
                                     "slots wrong")
        return split_scan_profile(prof, SCAN_PROFILED_CALLS, flush_keys)

    kernel_ms, glue_ms = retry_lost_records(
        profiled_checked_calls, f"rough_scan {label} {mode}")
    del want, fin, flush
    twin_ms = cuda_ms(lambda: rough_scan_reference(*args, span, fold, qpack),
                      twin_iters)
    out_width = f * 128 if f else span
    bound_ms, bound_by, rows, gb = scan_bound(codes, starts, sizes, span,
                                              out_width, args[4].shape[1])
    g_max, g_mean = groups_per_cluster(codes, starts, sizes, span)
    log(f"[kernel rough_scan {label} {mode}] S={s} span={span} D={dim} "
        f"N={n_rows} query [S, {args[4].shape[1]}] out [S, {out_width}]: "
        f"{SCAN_PROFILED_CALLS} calls bit-equal to twin"
        + (" and to the unpacked kernel" if qpack else "")
        + f" (max |diff| {max_abs_err}, +inf slots equal); kernel "
        f"{kernel_ms:.4f} ms + grouping glue {glue_ms:.4f} ms of device time "
        f"(profile, L2 cold); twin {twin_ms:.4f} ms (CUDA events); bound "
        f"{bound_ms:.4f} ms by {bound_by} ({rows} distinct rows, {gb:.4f} "
        f"GB): kernel at {100 * bound_ms / kernel_ms:.1f}% of bound; groups "
        f"per cluster max {g_max} mean {g_mean:.2f} [{smi}]")
    return dict(max_abs_err=max_abs_err, ms=kernel_ms, plain_ms=twin_ms,
                kernel_ms=kernel_ms, glue_ms=glue_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def scan_penalty(dev, n_rows, density, seed=0):
    """A row filter's penalty operand: [n_rows] f32, +inf on a random
    ``density`` share of the rows, else 0."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    filtered = torch.rand(n_rows, generator=gen, device=dev) < density
    return torch.where(filtered, torch.inf, 0.0).to(torch.float32)


def check_scan_penalty(smi, label, ops, span, fold, qpack, density):
    """The scan kernel with the row-filter penalty operand against its twin
    in one mode (fold depth 2, 1 or 0; ``qpack`` on nibble-packed query
    values), ``density`` of the rows filtered: SCAN_PROFILED_CALLS calls
    with the penalty, each after an L2 flush, bit-equal to the twin, then
    as many without it on the same operands; the kernel's device time of
    each (profile, L2 cold). The twin is timed by CUDA events over the
    call that gives the reference; the bound adds 4 bytes a probed row."""
    from rabitq_tpu_torch.ops import (
        cuda_rough_scan,
        pack_query_nibbles,
        rough_scan_reference,
    )
    from rabitq_tpu_torch.ops.scan_kernel import effective_fold

    codes, _, starts, sizes = ops[:4]
    args = list(ops)
    if qpack:
        args[4] = pack_query_nibbles(ops[4])
    pen = scan_penalty(codes.device, codes.shape[0], density, seed=fold)
    mode = ("qpack " if qpack else "") + SCAN_MODES[fold]
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    ev0.record()
    want = rough_scan_reference(*args, span, fold, qpack, pen)
    ev1.record()
    torch.cuda.synchronize()
    twin_ms = ev0.elapsed_time(ev1)
    cuda_rough_scan(*args, span, fold, qpack, pen)  # warm-up
    torch.cuda.synchronize()
    flush, flush_keys = l2_flush()

    def profiled(penalty):
        outs = []
        with settled_profile() as prof:
            for _ in range(SCAN_PROFILED_CALLS):
                flush.sum()
                outs.append(cuda_rough_scan(*args, span, fold, qpack,
                                            penalty))
            torch.cuda.synchronize()
        if penalty is not None:
            for got in outs:
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(
                        f"rough_scan kernel with penalty != twin, {label} "
                        f"{mode} density {density}")
        return split_scan_profile(prof, SCAN_PROFILED_CALLS, flush_keys)

    tag = f"rough_scan {label} {mode} penalty {density}"
    kernel_ms, glue_ms = retry_lost_records(lambda: profiled(pen), tag)
    plain_kernel_ms, _ = retry_lost_records(lambda: profiled(None), tag)
    inf_share = float(torch.isinf(want).float().mean())
    del want, flush
    f = effective_fold(span, fold)
    bound_ms, bound_by, rows, gb = scan_bound(
        codes, starts, sizes, span, f * 128 if f else span,
        args[4].shape[1], penalty=True)
    log(f"[kernel rough_scan {label} {mode} penalty {100 * density:g}%] "
        f"S={starts.shape[0]} span={span} D={codes.shape[1]}: "
        f"{SCAN_PROFILED_CALLS} calls bit-equal to twin (+inf share of the "
        f"output {inf_share:.4f}); kernel {kernel_ms:.4f} ms with the "
        f"penalty, {plain_kernel_ms:.4f} ms without it on the same operands "
        f"({100 * (kernel_ms / plain_kernel_ms - 1):+.1f}%), grouping glue "
        f"{glue_ms:.4f} ms (profile, L2 cold); twin {twin_ms:.4f} ms (CUDA "
        f"events, one call); bound {bound_ms:.4f} ms by {bound_by} ({rows} "
        f"distinct rows, {gb:.4f} GB): kernel at "
        f"{100 * bound_ms / kernel_ms:.1f}% of bound [{smi}]")
    return dict(max_abs_err=0.0, ms=kernel_ms, plain_ms=twin_ms,
                kernel_ms=kernel_ms, no_penalty_ms=plain_kernel_ms,
                glue_ms=glue_ms, bound_ms=bound_ms, bound_by=bound_by)


def check_quantize(dev, smi, label, b, probe, dim, pack, k=K):
    """The fused quantize kernel against its twin at one path's shape, with
    the dither off (search's default) and on: quantized values, lo, delta
    and code_sum bit-equal, ycd within YCD_RTOL. Its time is the kernel's
    device time with the L2 cold (dither off), beside its bound and the
    twin's time (CUDA events)."""
    from rabitq_tpu_torch.ops import (
        cuda_quantize_residuals,
        quantize_residuals_reference,
    )

    y, centroids, cids, bias = quantize_operands(dev, b, probe, dim, k,
                                                 seed=dim)
    max_abs_err = max_rel = 0.0
    for rb in (None, bias):
        (qg, sg), (qw, sw) = (
            fn(y, centroids, cids, rb, pack)
            for fn in (cuda_quantize_residuals, quantize_residuals_reference))
        torch.cuda.synchronize()
        if not (torch.equal(qg, qw) and torch.equal(
                sg[:, :3].contiguous().view(torch.int32),
                sw[:, :3].contiguous().view(torch.int32))):
            raise AssertionError(f"quantize kernel != twin at {label} "
                                 f"(dither {rb is not None})")
        diff = (sg[:, 3] - sw[:, 3]).abs()
        max_abs_err = max(max_abs_err, float(diff.max()))
        max_rel = max(max_rel, float((diff / sw[:, 3].abs()).max()))
        if not torch.allclose(sg[:, 3], sw[:, 3], rtol=YCD_RTOL, atol=0):
            raise AssertionError(f"quantize ycd beyond rtol {YCD_RTOL} at "
                                 f"{label}: {max_rel}")
    kernel_ms = retry_lost_records(
        lambda: cold_device_ms(
            lambda: cuda_quantize_residuals(y, centroids, cids, None, pack),
            QUANT_KERNEL),
        f"quantize {label}")
    twin_ms = cuda_ms(
        lambda: quantize_residuals_reference(y, centroids, cids, None, pack),
        3)
    bound_ms, bound_by, gb = quantize_bound(y, centroids, cids, pack, False)
    s = cids.numel()
    l2_bytes, plan = quantize_l2_reads(s, probe, dim, pack, False)
    log(f"[kernel quantize {label}] B={b} probe={probe} D={dim} S={s} "
        f"{'packed [S, D/2]' if pack else 'unpacked [S, D]'}: dither off and "
        f"on, quantized values, lo, delta and code_sum bit-equal to the twin, "
        f"ycd max rel diff {max_rel:.3g} (rtol {YCD_RTOL}); kernel "
        f"{kernel_ms:.4f} ms (device, L2 cold), twin {twin_ms:.4f} ms; "
        f"{int(torch.unique(cids).numel())} distinct centroid rows, reads+"
        f"writes {gb:.4f} GB, bound {bound_ms:.4f} ms by {bound_by}, kernel "
        f"at {100 * bound_ms / kernel_ms:.1f}% of bound; plan {plan.lanes} "
        f"lanes a task, {plan.warps} warps a block, {plan.blocks} blocks, "
        f"runs of {plan.run} tasks; by the design's count (from the plan, "
        f"not measured) it reads {l2_bytes / 1e9:.4f} GB through L2 (each "
        f"task's centroid row, y once for each query of a run, cids), "
        f"{l2_bytes / kernel_ms / 1e9:.2f} TB/s at the kernel's time, "
        f"against {gb / kernel_ms:.2f} TB/s counted in bound "
        f"bytes [{smi}]")
    return dict(max_abs_err=max_abs_err, ms=kernel_ms, plain_ms=twin_ms,
                bound_ms=bound_ms, bound_by=bound_by)


def check_gather_l2(dev, smi, n, dim, b, r, positions="random", label="",
                    windows=28, width=300):
    """The rerank kernel against its twin on random rows, with uniform
    positions (duplicates, rows 0 and N-1) or cluster-local ones
    (cluster_gather_positions: ``windows`` probed clusters of ``width``
    rows a query), beside its bound (distinct rows). The
    kernel's time is its device time with the L2 cold (cold_device_ms).
    Its rate counting a row read at every position (what the kernel reads
    unless L2 catches a repeat) is logged beside it."""
    from rabitq_tpu_torch.ops import cuda_gather_l2, gather_l2_reference

    base, pos, q = gather_operands(dev, n, dim, b, r, seed=dim)
    if positions == "clusters":
        pos = cluster_gather_positions(dev, n, b, r, windows, width, seed=dim)
    got = cuda_gather_l2(base, pos, q)
    want = gather_l2_reference(base, pos, q)
    torch.cuda.synchronize()
    err = assert_gather_close(got, want)
    del got, want

    def call():
        return cuda_gather_l2(base, pos, q, check_pos=False)

    kernel_ms = retry_lost_records(
        lambda: cold_device_ms(call, GATHER_KERNEL), "gather_l2")
    twin_ms = cuda_ms(lambda: gather_l2_reference(base, pos, q), 3)
    bound_ms, bound_by, gb, rows = gather_bound(pos, n, dim)
    every_gb = (b * r * (4 * dim + 12) + 4 * b * dim) / 1e9
    log(f"[kernel gather_l2 {label}{positions}] N={n} D={dim} B={b} R={r}: "
        f"within rtol 1e-5 / atol 1e-5*max of twin (max |diff| {err:.3g}); "
        f"kernel "
        f"{kernel_ms:.4f} ms (device, L2 cold), twin {twin_ms:.4f} ms; "
        f"{rows} distinct rows of {b * r} positions, reads+writes {gb:.4f} "
        f"GB, bound {bound_ms:.4f} ms by {bound_by}, kernel at "
        f"{100 * bound_ms / kernel_ms:.1f}% of bound; counting a row at "
        f"every position {every_gb:.4f} GB, "
        f"{every_gb / kernel_ms:.3f} TB/s [{smi}]")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=twin_ms,
                bound_ms=bound_ms, bound_by=bound_by, rows=rows)


def check_gather_l2_bf16(dev, smi, shape, n, dim, b, r, positions="random"):
    """The gather_l2 kernel's bf16-row instance against its twin on the
    operands of check_gather_l2 with the base rounded to bf16, to the same
    tolerance (rows widen to f32 exactly; the sums run in other orders),
    NaN at a position outside [0, N) as the twin; beside its bound (each
    distinct row once, 2 D bytes) and the f32 instance on the f32 base at
    the same positions, both by device time with the L2 cold."""
    from rabitq_tpu_torch.ops import cuda_gather_l2, gather_l2_reference

    base, pos, q = gather_operands(dev, n, dim, b, r, seed=dim)
    if positions == "clusters":
        pos = cluster_gather_positions(dev, n, b, r, seed=dim)
    bf = base.to(torch.bfloat16)
    got = cuda_gather_l2(bf, pos, q)
    want = gather_l2_reference(bf, pos, q)
    torch.cuda.synchronize()
    err = assert_gather_close(got, want)
    edge = pos.clone()
    edge[0, 0], edge[-1, -1] = -1, n
    nan = cuda_gather_l2(bf, edge, q, check_pos=False).isnan()
    if int(nan.sum()) != 2 or not (nan[0, 0] and nan[-1, -1]):
        raise AssertionError("gather_l2 bf16: NaN not exactly at the two "
                             "positions outside [0, N)")
    del got, want, edge, nan

    kernel_ms = retry_lost_records(lambda: cold_device_ms(
        lambda: cuda_gather_l2(bf, pos, q, check_pos=False), GATHER_BF16),
        "gather_l2 bf16")
    f32_ms = retry_lost_records(lambda: cold_device_ms(
        lambda: cuda_gather_l2(base, pos, q, check_pos=False), GATHER_F32),
        "gather_l2 f32")
    twin_ms = cuda_ms(lambda: gather_l2_reference(bf, pos, q), 3)
    bound_ms, bound_by, gb, rows = gather_bound(pos, n, dim, elem_bytes=2)
    log(f"[kernel gather_l2 bf16 {shape} {positions}] N={n} D={dim} B={b} "
        f"R={r}: within rtol 1e-5 / atol 1e-5*max of twin (max |diff| "
        f"{err:.3g}), NaN exactly outside [0, N); kernel {kernel_ms:.4f} ms "
        f"(device, L2 cold), f32 instance on the f32 base {f32_ms:.4f} ms, "
        f"twin {twin_ms:.4f} ms; {rows} distinct rows of {b * r} "
        f"positions, reads+writes {gb:.4f} GB, bound {bound_ms:.4f} ms by "
        f"{bound_by}, kernel at {100 * bound_ms / kernel_ms:.1f}% of bound "
        f"[{smi}]")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=twin_ms,
                f32_ms=f32_ms, bound_ms=bound_ms, bound_by=bound_by,
                rows=rows)


def select_operands(dev, b, probe, width, slot_bits=9, finite=0.95, seed=0):
    """Rough values [B, probe * width] as the folded scan writes them:
    estimates in [1, 4) with a window slot below 300 in their low
    ``slot_bits`` mantissa bits, a share 1 - ``finite`` of +inf pads; and
    [B, probe] int32 cluster starts."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    v = 1.0 + 3.0 * torch.rand((b, probe * width), generator=gen, device=dev)
    slots = torch.randint(0, 300, v.shape, generator=gen, device=dev,
                          dtype=torch.int32)
    v = ((v.view(torch.int32) & ~((1 << slot_bits) - 1)) | slots).view(
        torch.float32)
    v[torch.rand(v.shape, generator=gen, device=dev) >= finite] = torch.inf
    starts = torch.randint(0, 999_000, (b, probe), generator=gen, device=dev,
                           dtype=torch.int32)
    return v, starts


def assert_same_candidates(got, want):
    """Equal (lower bound bits, position) multisets, row by row, of two
    (pos, lower_bound) selections: the kernel writes its candidates in
    flat order, the plain version in value order."""
    (pos_g, lb_g), (pos_w, lb_w) = (
        (p.cpu().numpy(), lb.cpu().numpy().view(np.int32)) for p, lb in
        (got, want))
    if pos_g.shape != pos_w.shape:
        raise AssertionError(f"shapes {pos_g.shape} != {pos_w.shape}")
    for a, b in ((pos_g, lb_g), (pos_w, lb_w)):
        order = np.lexsort((a, b), axis=1)
        a[...] = np.take_along_axis(a, order, 1)
        b[...] = np.take_along_axis(b, order, 1)
    np.testing.assert_array_equal(lb_g, lb_w)
    np.testing.assert_array_equal(pos_g, pos_w)


def topk_pair(rough, probe, width, r):
    """The two torch.topk calls the select stage made before its kernel:
    a per-task top-min(R, width), then a global top-R of the survivors
    (the kernel's library yardstick; the port no longer calls it)."""
    b, m = rough.shape[0], min(r, width)
    vt, _ = torch.topk(rough.reshape(b, probe, width), m, dim=-1,
                       largest=False)
    return torch.topk(vt.reshape(b, probe * m), r, dim=-1, largest=False)


def check_select(dev, smi, label, b, probe, width, r, slot_bits=9):
    """The select kernel against its plain version on folded rough values
    (select_operands): equal (lower bound, position) pairs; its device
    time with the L2 cold beside its bound (one read of the rough values
    and the starts, the [B, R] output), the plain version's time (CUDA
    events) and the two torch.topk calls it replaced (device, L2 cold)."""
    from rabitq_tpu_torch.ops import (
        cuda_select_candidates,
        select_candidates_reference,
    )

    rough, starts = select_operands(dev, b, probe, width, slot_bits)
    n_rows = 1_000_000

    def call():
        return cuda_select_candidates(rough, starts, width, r, slot_bits,
                                      n_rows)

    def plain():
        return select_candidates_reference(rough, starts, width, r,
                                           slot_bits, n_rows)

    before = cuda_select_candidates.launches_streamed
    got = call()
    streamed = cuda_select_candidates.launches_streamed - before
    assert_same_candidates(got, plain())
    del got
    kernel_ms = retry_lost_records(
        lambda: cold_device_ms(call, SELECT_KERNEL), f"select {label}")
    plain_ms = cuda_ms(plain, 3)
    library_ms = retry_lost_records(lambda: device_ms_by_kernel(
        lambda: topk_pair(rough, probe, width, r), cold=True)[0],
        f"select {label} topk")
    gb = (4 * rough.numel() + 4 * starts.numel() + 12 * b * r) / 1e9
    bound_ms = gb / HBM_BYTES_PER_S * 1e12
    log(f"[kernel select {label}] B={b} {probe} x {width} R={r} slot bits "
        f"{slot_bits} ({'streamed' if streamed else 'resident'}): (lb, "
        f"pos) pairs equal to the plain version's; kernel {kernel_ms:.4f} "
        f"ms (device, L2 cold), plain version {plain_ms:.4f} ms, the two "
        f"torch.topk calls {library_ms:.4f} ms (device, L2 cold); reads+"
        f"writes {gb:.4f} GB, bound {bound_ms:.4f} ms by bytes, kernel at "
        f"{100 * bound_ms / kernel_ms:.1f}% of bound [{smi}]")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by="bytes", streamed=streamed)


def probe_rank_operands(dev, b, k, dim, split=0, seed=0):
    """Rotated queries [B, D] near random centroids [K, D] (f32 normals,
    each query a centroid plus noise of a third its scale), ``split``
    centroid rows repeated in the row after them, as a split build's
    segments repeat their cluster's centroid."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = torch.randn((k, dim), generator=gen, device=dev)
    if split:
        at = torch.randperm(k - 1, generator=gen, device=dev)[:split]
        c[at + 1] = c[at]
    near = torch.randint(0, k, (b,), generator=gen, device=dev)
    y = c[near] + torch.randn((b, dim), generator=gen, device=dev) / 3
    return y, c


def check_probe_rank(dev, smi, label, b, k, dim, probe, precision, split=0):
    """The probe_rank kernel against its plain version on the terms of
    probe_rank_operands at ``precision``: ids equal bit for bit, from the
    terms (fused) and from the finished distance matrix; its device time
    with the L2 cold beside its bound (one read of the cross term, xx
    and cc, the [B, probe] ids written), the plain version's (the
    epilogue, the stable sort and the slice) and the replaced
    pairwise_l2sq + torch.sort pair's (device, L2 cold), with the terms'
    (norms and GEMM) beside."""
    from rabitq_tpu_torch.ops import (
        cuda_probe_rank,
        pairwise_l2sq,
        probe_rank_reference,
    )
    from rabitq_tpu_torch.ops.distances import l2sq_epilogue, pairwise_terms

    y, c = probe_rank_operands(dev, b, k, dim, split)
    xx, xc, cc = terms = pairwise_terms(y, c, precision)

    def call():
        return cuda_probe_rank(xc, probe, xx, cc)

    def plain():
        return probe_rank_reference(xc, probe, xx, cc)

    before = (cuda_probe_rank.launches_fused,
              cuda_probe_rank.launches_streamed)
    got = call()
    fused, streamed = (cuda_probe_rank.launches_fused - before[0],
                       cuda_probe_rank.launches_streamed - before[1])
    want = plain()
    if not (torch.equal(got, want) and torch.equal(
            cuda_probe_rank(l2sq_epilogue(terms), probe), want)):
        raise AssertionError(f"[kernel probe_rank {label}] ids differ from "
                             f"the plain version's")
    del got, want
    kernel_ms = retry_lost_records(
        lambda: cold_device_ms(call, PROBE_RANK_KERNEL),
        f"probe_rank {label}")
    plain_ms = retry_lost_records(
        lambda: device_ms_by_kernel(plain, cold=True)[0],
        f"probe_rank {label} plain")
    terms_ms = retry_lost_records(
        lambda: device_ms_by_kernel(
            lambda: pairwise_terms(y, c, precision), cold=True)[0],
        f"probe_rank {label} terms")
    library_ms = retry_lost_records(
        lambda: device_ms_by_kernel(lambda: torch.sort(
            pairwise_l2sq(y, c, precision), dim=-1, stable=True),
            cold=True)[0], f"probe_rank {label} pairwise_l2sq + sort")
    gb = (4 * b * k + 4 * b + 4 * k + 8 * b * probe) / 1e9
    bound_ms = gb / HBM_BYTES_PER_S * 1e12
    log(f"[kernel probe_rank {label}] B={b} K={k} D={dim} probe={probe} "
        f"{precision} ({split} duplicated centroids; "
        f"{'fused' if fused else 'not fused'}, "
        f"{'streamed' if streamed else 'resident'}): ids equal to the plain "
        f"version's, fused and finished; kernel {kernel_ms:.4f} ms (device, "
        f"L2 cold), plain version {plain_ms:.4f} ms, pairwise_l2sq + "
        f"torch.sort {library_ms:.4f} ms (of which the norms and GEMM "
        f"{terms_ms:.4f}; device, L2 cold); reads+writes {gb:.4f} GB, bound "
        f"{bound_ms:.4f} ms by bytes, kernel at "
        f"{100 * bound_ms / kernel_ms:.1f}% of bound [{smi}]")
    return dict(ms=kernel_ms, plain_ms=plain_ms, library_ms=library_ms,
                terms_ms=terms_ms, bound_ms=bound_ms, bound_by="bytes",
                streamed=streamed)


def int4_phase(dev, smi):
    """The int4 probe, then both kernels exactly against numpy at the
    probe shape and a scan-window shape: device time with the L2 cold
    (cold_device_ms) beside the bound, the twin,
    and torch._int_mm on the unpacked int8 operands (the same product at
    twice the A bytes; the port never calls it) as the library yardstick."""
    from rabitq_tpu_torch.ops import cuda_int4_dot, int4_dot_reference, pack_int4
    from rabitq_tpu_torch.tools import int4probe

    cuda_int4_dot.launches_direct = cuda_int4_dot.launches_staged = 0
    stages = int4probe.run(dev)
    torch.cuda.synchronize()
    launches = {"int4_dot_direct": cuda_int4_dot.launches_direct,
                "int4_dot_staged": cuda_int4_dot.launches_staged}
    if launches != {"int4_dot_direct": 1, "int4_dot_staged": 1}:
        raise AssertionError(f"int4 probe launches {launches}")
    log(f"[int4] probe {int4probe.M}x{int4probe.K} . {int4probe.N}x"
        f"{int4probe.K}^T seed 0: {stages}; launches {launches}")

    res = {name: {"launches": n, "max_abs_err": 0.0}
           for name, n in launches.items()}
    for label, (m, n, k) in (("probe", (int4probe.M, int4probe.N, int4probe.K)),
                             ("window", (65536, 64, 1024))):
        a8, b8, want = int4probe.operands(seed=1, m=m, n=n, k=k)
        a = pack_int4(torch.from_numpy(a8).to(dev))
        b = pack_int4(torch.from_numpy(b8).to(dev))
        a_i8 = torch.from_numpy(a8).to(dev)
        b_i8t = torch.from_numpy(b8).to(dev).t()
        want = torch.from_numpy(want).to(dev)
        twin = int4_dot_reference(a, b)
        if not torch.equal(twin, want):
            raise AssertionError(f"int4 twin != numpy at {label}")
        if not torch.equal(torch._int_mm(a_i8, b_i8t), want):
            raise AssertionError(f"torch._int_mm != numpy at {label}")
        twin_ms = cuda_ms(lambda: int4_dot_reference(a, b), 5)
        library_ms = retry_lost_records(
            lambda: cold_device_ms(lambda: torch._int_mm(a_i8, b_i8t)),
            "torch._int_mm")
        nbytes = (m + n) * k // 2 + m * n * 4
        t, bound_by = bound_s(nbytes, 2 * m * n * k, INT8_OPS_PER_S)
        bound_ms = 1e3 * t
        parts = [f"twin {twin_ms:.4f} ms",
                 f"torch._int_mm (int8 operands) {library_ms:.4f} ms"]
        for staged, name in ((False, "int4_dot_direct"), (True, "int4_dot_staged")):
            got = cuda_int4_dot(a, b, staged=staged)
            err = float((got - want).abs().max())
            if err:
                raise AssertionError(f"{name} != numpy at {label}: {err}")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)

            def call():
                return cuda_int4_dot(a, b, staged=staged)

            ms = retry_lost_records(
                lambda: cold_device_ms(call, INT4_KERNEL), name)
            parts.append(f"{name} {ms:.4f} ms (device, L2 cold; "
                         f"{100 * bound_ms / ms:.1f}% of bound)")
            res[name][label] = dict(ms=ms, plain_ms=twin_ms,
                                    bound_ms=bound_ms, bound_by=bound_by,
                                    library_ms=library_ms)
        log(f"[int4 {label}] [{m}x{k}] . [{n}x{k}]^T packed: exact; operands "
            f"{(m + n) * k / 2e6:.3f} MB packed ({(m + n) * k / 1e6:.3f} MB "
            f"as int8), {nbytes / 1e6:.3f} MB read+written, bound "
            f"{bound_ms:.4f} ms by {bound_by}: " + ", ".join(parts)
            + f" [{smi}]")
    return {name: {**r, **r["window"]} for name, r in res.items()}


def device_ms_by_kernel(fn, calls=10, cold=False):
    """fn() ``calls`` times back to back under the profiler (its inputs
    warm in the L2, as a search batch finds them; with ``cold`` each call
    after a read that evicts the L2, whose events are left out): the mean
    device ms of a call and {kernel name: ms a call}. CUPTI drops the
    records of a call or two: each kernel's time a launch is averaged over
    the records kept, times its launches a call (its records over the
    calls kept, read from the kernel with the fewest records); fewer than
    calls - 2 kept raise ProfileLostRecords."""
    flush, flush_keys = l2_flush() if cold else (None, set())
    fn()
    torch.cuda.synchronize()
    with settled_profile(cpu=False) as prof:
        for _ in range(calls):
            if cold:
                flush.sum()
            fn()
        torch.cuda.synchronize()
    ops = [(e.key, e.self_device_time_total / 1e3, e.count)
           for e in prof.key_averages()
           if e.self_device_time_total > 0 and e.key not in flush_keys]
    kept = min((c for _, _, c in ops), default=0)
    if kept < calls - 2:
        raise ProfileLostRecords(f"{calls} calls: "
                                 f"{[(k[:40], c) for k, _, c in ops]}")
    by_kernel = {k: t / c * round(c / kept) for k, t, c in ops}
    return sum(by_kernel.values()), by_kernel


def cell_kernels(dev, smi):
    """quantize, rough_scan (search's default mode, fold 2: on packed
    query values where the cell packs them), gather_l2 and select against
    their plain versions at each cell's shape (CELLS), on operands laid
    out as search makes them. Returns {kernel: {cell: result}}."""
    out = {"quantize": {}, "rough_scan": {}, "gather_l2": {}, "select": {}}
    for cell, (b, probe, dim, k, span, r, qpack) in CELLS.items():
        out["quantize"][cell] = check_quantize(dev, smi, cell, b, probe, dim,
                                               qpack, k)
        ops = cluster_scan_operands(dev, k + 1, b, probe, span, dim)
        out["rough_scan"][cell] = check_rough_scan(
            smi, f"{cell} clusters", ops, span, 1, 2, qpack=qpack)
        del ops
        torch.cuda.empty_cache()
        out["gather_l2"][cell] = check_gather_l2(
            dev, smi, 1_200_000, dim, b, r, "clusters", f"{cell} ", probe,
            span)
        out["select"][cell] = check_select(dev, smi, cell, b, probe, 256, r)
        torch.cuda.empty_cache()
    return out


def path_phase(dev, name):
    """One cell's index, built as the benchmark's set-up builds it
    (benchmark/harness.py, seed 0), and search_many over two of its
    batches: each search kernel launches once a scan call (probe_rank at
    least once; the scan in qpack mode where the index packs, with no
    penalty; no bf16 gather), and then one batch runs under sync debug
    mode "error", so a host sync fails it. Returns the launch counts."""
    import rabitq_tpu_torch as rt
    from benchmark import harness, spec
    from rabitq_tpu_torch.ops import rough_scan_counts
    from rabitq_tpu_torch.tools.bench import run_captured

    t0 = time.perf_counter()
    state = harness.setup(spec.load_cell(name), 0, dev, t0)
    index, params, qd = state.index, state.params, state.batches[:2]
    t1 = time.perf_counter()
    run0, pre0 = rough_scan_counts(dev)
    _, counts = run_captured(lambda: rt.search_many(index, qd, params))
    search_s = time.perf_counter() - t1
    run1, pre1 = rough_scan_counts(dev)
    counts["rough_scan groups"] = run1 - run0
    counts["rough_scan groups prefetched"] = pre1 - pre0
    calls = counts["rough_scan calls"]
    want = {key: calls for key in ("quantize", "rough_scan", "gather_l2",
                                   "select")}
    want.update({"rough_scan qpack": calls if index.dim % 256 == 0 else 0,
                 "rough_scan penalty": 0, "gather_l2 bf16": 0})
    if (calls != qd.shape[0] or counts["probe_rank"] < calls
            or counts["select streamed"] not in (0, calls)
            or any(counts[key] != v for key, v in want.items())):
        raise AssertionError(f"[path {name}] launches {counts}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rt.search(index, qd[1], params)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    b, probe, dim, k, span = CELLS[name][:5]
    log(f"[path {name}] set-up {t1 - t0:.1f}s (index k {index.k} capacity "
        f"{index.capacity} D {index.dim}; the kernel checks' shape: k {k} "
        f"span {span} D {dim}); search_many of {qd.shape[0]} batches of "
        f"{qd.shape[1]} at probe {params.probe}: {search_s:.2f}s, launches "
        f"{counts}: each kernel once a scan call; rough_scan groups "
        f"prefetched {100 * (pre1 - pre0) / max(1, run1 - run0):.2f}%; one "
        f"batch under sync debug mode 'error': no host sync")
    del state, index, qd
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. Environment.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} "
        f"capability {torch.cuda.get_device_capability(0)} "
        f"count {torch.cuda.device_count()} | nvidia-smi: {smi}")

    # 2. Build.
    build_kernels()

    # 3. Kernels against their twins at the paths' shapes: quantize, then
    # the scan in each mode, keyed (operands, mode), the gist shape's also
    # on packed query values (mode "qpack <mode>").
    quants = {"sift": check_quantize(dev, smi, "sift", 2048, 28, 128, False),
              "gist": check_quantize(dev, smi, "gist", 1024, 80, 1024, True)}
    scans, penalties = {}, {}
    t_kernels = time.perf_counter()
    for path, dim, b, probe, span, twin_iters in (
        ("sift", 128, 2048, 28, 384, 3), ("gist", 1024, 1024, 80, 384, 1),
    ):
        for operands in ("random", "clusters"):
            if operands == "random":
                ops = scan_operands(dev, 1_200_000, b * probe, span, dim)
            else:
                ops = cluster_scan_operands(dev, K + 1, b, probe, span, dim)
            for qpack in (False, True) if dim % 256 == 0 else (False,):
                for fold in SCAN_MODES:
                    mode = ("qpack " if qpack else "") + SCAN_MODES[fold]
                    scans[f"{path} {operands}", mode] = check_rough_scan(
                        smi, f"{path} {operands}", ops, span, twin_iters,
                        fold, edges=operands == "random", qpack=qpack)
                    if operands != "clusters":
                        continue
                    for density in PENALTY_DENSITIES:
                        penalties[path, mode, density] = check_scan_penalty(
                            smi, f"{path} {operands}", ops, span, fold,
                            qpack, density)
            del ops
    log(f"[kernel] scan checks {time.perf_counter() - t_kernels:.1f}s")
    gather_gist = check_gather_l2(dev, smi, 1_200_000, 1024, 1024, 150)
    gather_sift = check_gather_l2(dev, smi, 1_200_000, 128, 2048, 32)
    gather_sift_cl = check_gather_l2(dev, smi, 1_200_000, 128, 2048, 32,
                                     positions="clusters")
    gather_bf16 = {
        "gist random": check_gather_l2_bf16(dev, smi, "gist", 1_200_000,
                                            1024, 1024, 150),
        "sift random": check_gather_l2_bf16(dev, smi, "sift", 1_200_000,
                                            128, 2048, 32),
        "sift clusters": check_gather_l2_bf16(dev, smi, "sift", 1_200_000,
                                              128, 2048, 32,
                                              positions="clusters"),
    }
    selects = {label: check_select(dev, smi, label, *shape) for label, shape in
               (("sift", (8192, 28, 256, 32)), ("gist", (1024, 64, 256, 150)),
                ("blobs streamed", (1024, 384, 256, 150)))}
    probe_ranks = {label: check_probe_rank(dev, smi, label, *shape)
                   for label, shape in (
                       ("sift", (16384, 4096, 128, 28, "highest")),
                       ("gist", (8192, 4096, 1024, 64, "default")),
                       ("blobs", (8192, 5327, 128, 384, "highest", 271)))}
    torch.cuda.empty_cache()

    # 4. The int4 probe. It runs before the cells' rows: after them,
    # torch._int_mm's profile held two or three device records a call.
    int4 = int4_phase(dev, smi)
    cells = cell_kernels(dev, smi)

    # 5. The main path at each cell's shape.
    paths = {name: path_phase(dev, name) for name in CELLS}

    def launches(key):
        return {"launches": sum(c[key] for c in paths.values()),
                "launches_by_path": {p: c[key] for p, c in paths.items()}}

    main_mode = scans["sift clusters", SCAN_MODES[2]]
    modes = {}
    for (ops, mode), r in scans.items():
        modes.setdefault(mode, {})[ops] = {
            key: r[key] for key in ("ms", "kernel_ms", "glue_ms", "plain_ms",
                                    "bound_ms")}
    penalty_modes = {}
    for (path, mode, density), r in penalties.items():
        penalty_modes.setdefault(f"{mode} penalty {density}", {})[
            f"{path} clusters"] = {
            key: r[key] for key in ("ms", "no_penalty_ms", "glue_ms",
                                    "plain_ms", "bound_ms", "bound_by")}
    log(json.dumps({"kernels": [
        {"name": "rough_scan", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/rough_scan.cu",
         "replaces": "rabitq_tpu/ops/scan_kernel.py:621",
         **launches("rough_scan"),
         "launches_qpack": launches("rough_scan qpack"),
         "launches_penalty": launches("rough_scan penalty"),
         "groups": launches("rough_scan groups"),
         "groups_prefetched": launches("rough_scan groups prefetched"),
         "max_abs_err": max(r["max_abs_err"] for r in
                            (*scans.values(), *penalties.values(),
                             *cells["rough_scan"].values())),
         **{key: main_mode[key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "operands": "sift clusters, fold 2 (search's default mode); ms = "
                     "device time with the L2 cold",
         "modes": modes,
         "penalty_modes": penalty_modes,
         "cell_shapes": cells["rough_scan"]},
        {"name": "quantize_residuals", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/quantize.cu",
         "replaces": "rabitq_tpu/index/search.py:335 (an XLA fusion, with "
                     "the packing at :403; not a Pallas kernel)",
         **launches("quantize"),
         "max_abs_err": max(r["max_abs_err"] for r in
                            (*quants.values(), *cells["quantize"].values())),
         **{key: quants["gist"][key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "operands": "gist shape (B 1024, probe 80, D 1024, packed); ms = "
                     "device time with the L2 cold; max_abs_err is ycd's",
         "sift_shape": quants["sift"],
         "cell_shapes": cells["quantize"]},
        {"name": "gather_l2", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/gather_l2.cu",
         "replaces": "rabitq_tpu/ops/rerank_kernel.py:103",
         **launches("gather_l2"),
         "max_abs_err": max(r["max_abs_err"] for r in
                            (gather_gist, gather_sift, gather_sift_cl,
                             *cells["gather_l2"].values())),
         **{key: gather_gist[key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "operands": "gist shape (D 1024, B 1024, R 150); ms = device time "
                     "with the L2 cold; bound_ms counts distinct rows",
         "sift_shape": {"random": gather_sift, "clusters": gather_sift_cl},
         "cell_shapes": cells["gather_l2"]},
        {"name": "gather_l2_bf16", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/gather_l2.cu",
         "replaces": "rabitq_tpu/index/search.py:793 (the bf16 rerank's "
                     "XLA gather, _gather_l2(..., cast_f32=True) at :735; "
                     "not a Pallas kernel)",
         **launches("gather_l2 bf16"),
         "max_abs_err": max(r["max_abs_err"] for r in gather_bf16.values()),
         **{key: gather_bf16["gist random"][key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "f32_instance_ms": gather_bf16["gist random"]["f32_ms"],
         "operands": "gist shape (D 1024, B 1024, R 150), the base in bf16; "
                     "ms = device time with the L2 cold; bound_ms counts "
                     "distinct rows at 2 D bytes; f32_instance_ms the f32 "
                     "instance on the f32 base at the same positions",
         "sift_shape": {k: v for k, v in gather_bf16.items()
                        if k.startswith("sift")}},
        {"name": "select_candidates", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/select.cu",
         "replaces": "none: the select stage's two torch.topk calls and "
                     "slot decode (lax.top_k, _exact_two_stage in "
                     "rabitq_tpu/index/search.py)",
         **launches("select"),
         "launches_streamed": launches("select streamed"),
         **{key: selects["sift"][key] for key in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
         "operands": "sift cell shape (B 8192, 28 x 256, R 32, folded); ms "
                     "= device time with the L2 cold; library_ms = the two "
                     "torch.topk calls it replaced",
         "other_shapes": {k: v for k, v in selects.items() if k != "sift"},
         "cell_shapes": cells["select"]},
        {"name": "probe_rank", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/probe_rank.cu",
         "replaces": "none: the ranking stage's pairwise_l2sq epilogue and "
                     "stable torch.sort (lax.top_k over the centroid "
                     "distances in rabitq_tpu/index/search.py)",
         **launches("probe_rank"),
         **{key: probe_ranks["sift"][key] for key in (
             "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
         "operands": "sift cell shape (B 16384, K 4096, D 128, probe 28), "
                     "fused; ms = device time with the L2 cold; library_ms "
                     "= pairwise_l2sq and the stable torch.sort it "
                     "replaced, the GEMM included",
         "other_shapes": {k: v for k, v in probe_ranks.items()
                          if k != "sift"}},
        {"name": "int4_dot_direct", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/int4_dot.cu",
         "replaces": "tools/int4probe.py:64", **int4["int4_dot_direct"],
         "operands": "window shape (65,536 x 1024 . 64 x 1024); ms = device "
                     "time with the L2 cold; library_ms = torch._int_mm on "
                     "the unpacked int8 operands"},
        {"name": "int4_dot_staged", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/int4_dot.cu",
         "replaces": "tools/int4probe.py:84", **int4["int4_dot_staged"],
         "operands": "as int4_dot_direct"},
    ]}))
    log(f"[done] {time.perf_counter() - t_start:.1f}s in all")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
