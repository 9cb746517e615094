#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rabitq_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more (a phase that fails raises; the exit code is
then non-zero and no result line is printed):

  1. [env]    torch/CUDA versions and the card's name and power limit;
  2. [build]  nvcc compiles the six kernel sources of
     rabitq_tpu_torch/csrc/ for sm_90a at once (time, ptxas usage);
  3. [kernel] each kernel against its plain PyTorch twin on the card,
     beside the kernel's bound; kernels are timed by device time with the
     L2 cold (profile), twins by CUDA events:
       quantize (the fused residual quantization) at the sift shape
       (B=2048, probe 28, D=128, unpacked) and the gist shape (B=1024,
       probe 80, D=1024, nibble-packed), dither off and on: quantized
       values, lo, delta and code_sum bit-equal, ycd within rtol 1e-6;
       beside its bound, the kernel's launch plan and the bytes its design
       reads through L2 (each task's centroid row, y once for each query
       of a lane group's run, cids) with the rate they give;
       rough_scan, bit-equal, in each of its modes (the lane fold at depth
       2, search's default, and 1, and the full [S, span] output), at the
       sift shape (D=128, span=384, S=2048*28) and the gist shape (D=1024,
       span=384, S=1024*80), each on random operands (every task at its
       own random start, with edge cases) and on cluster-structured ones
       (4097 clusters laid end to end, [B, probe] distinct clusters a
       query drawn with skew), and at the gist shape in each mode on the
       nibble-packed query operand (qpack), also bit-equal to the unpacked
       kernel on the same values; five checked calls profiled, each after
       a read that evicts the L2, splitting their device time into the
       kernel and its grouping glue; the bound counts the query bytes and
       the output the mode writes; then on the cluster-structured operands
       in each mode with the row-filter penalty operand (1% and 50% of the
       rows +inf): five calls bit-equal to the twin, each after an L2
       flush, beside five calls without the penalty on the same operands
       (device time, profile);
       gather_l2 at the gist shape (N=1.2M, D=1024, B=1024, R=150) and
       the sift shape (D=128, B=2048, R=32), with duplicate positions and
       row N-1, and at the sift shape on cluster-local positions (each
       query's 32 rows from 28 windows of 300 rows), to rtol 1e-5 and atol
       1e-5 * max|out|; its time is the kernel's device time with the L2
       cold (profile), beside its bound from the run's positions (each
       distinct row once); then its bf16-row instance (the two-level
       rerank's first level) on the same operands with the base rounded
       to bf16, at the gist shape and the sift shape (random and
       cluster-local positions): to the same tolerance, NaN exactly at
       positions outside [0, N), its device time with the L2 cold beside
       its bound (distinct rows at 2 D bytes) and the f32 instance's time
       on the f32 base at the same positions;
       select (the exact top-R and slot decode of the select stage) at the
       sift cell's shape (B 8192, 28 x 256, R 32), the gist cell's (B
       1024, 64 x 256, R 150) and a streamed one (B 1024, 384 x 256, R
       150) on folded rough values: (lower bound, position) pairs equal to
       its plain version's, its device time with the L2 cold beside its
       byte bound, the plain version's time and the two torch.topk calls
       it replaced (device, L2 cold);
       probe_rank (the ranking stage's top-probe selection) at the sift
       cell's shape (B 16384, K 4096, D 128, probe 28), the gist cell's
       (B 8192, K 4096, D 1024 at the bf16 pass, probe 64) and the blobs
       cell's (B 8192, K 5327 with 271 duplicated centroid rows, probe
       384), from the GEMM's terms (fused) and from the finished distance:
       ids equal to its plain version's (the epilogue and a stable sort)
       bit for bit; its device time with the L2 cold beside its byte
       bound, the plain version's and the replaced pairwise_l2sq and
       torch.sort pair's (device, L2 cold; the GEMM's share beside);
  4. [int4]   rabitq_tpu_torch.tools.int4probe.run (int4_dot_direct and
     int4_dot_staged equal to the twin and numpy), then both kernels
     (device time, L2 cold), the twin and torch._int_mm on the unpacked
     int8 operands timed at the probe shape and a scan-window shape;
  5. [sift]   the SIFT-like main path at full size: 1M x 128 corpus,
     16,384 queries, k-means (k=4096, 260k sample, 15 iterations),
     build_index(bits=4, spill=0.2, balance=1.5), search_many at probe 28,
     rerank 32, topk 10, batch 2048; brute-force ground truth on the card;
     recall@10 >= 0.93, every rough_scan call launching each of the three
     search kernels once (the scan unpacked); 64 queries re-searched on
     the CPU path (the twins, the same params) must agree; then [sift
     rerank bf16]: the sift params at rerank 140 (the TPU measurement's
     budget), f32 against the two-level rerank at the auto refine (40):
     recall@10 >= 0.93, every distance its id's, the launches (the bf16
     instance and the f32 one once a batch), one batch under sync debug
     mode "error", device ms a batch, one profiled batch's busy ms and
     rerank stage; and [sift packed]: search_many_packed at 20 bits, its
     ids unpacked equal to search_many's, the bytes each copies;
  6. [sift filter] allowlists of 50%, 10% and 1% of the ids (numpy,
     seeded): filtered search_many of the 16,384 queries, every id allowed
     and every distance exact, recall@10 against brute force over the
     allowed rows on the card >= 0.90 / 0.84 / 0.60 (logged beside the
     JAX package's TPU figures, no target), device and host ms a batch,
     one profiled batch's device busy time beside the unfiltered fold-off
     run's, the scan launched with the penalty each batch; a deny-mode
     and a RowFilterContext build of the 10% filter give its penalty and
     ids; one filtered batch under sync debug mode "error";
  7. [sift adaptive] search_adaptive from probe 8, max_probe 256 (probe
     used, recall, ms a batch), with the centroid and the annulus
     ranking; the certificate checked against brute force on 256 queries
     and 256 base rows at two probes: no row closer than a certified
     query's k-th result lies outside its probed clusters; the same check
     on a corpus of well-separated clusters (200k x 128, 1024 centers,
     spread 0.6), where the certificate certifies;
  8. [sift autotune] autotune on 2,048 of the queries at target recall@10
     0.95: the curve and the pick;
  9. [saved]  the sift index dumped with dump_to_dir to a temporary
     directory and loaded back onto the card with load_from_dir;
     search_many of the 16,384 queries must return the in-memory index's
     ids and distances exactly (dump and load seconds logged);
  10. [sift store <kind>] the saved directory loaded base-less onto the
     card (load_from_dir(keep_base=False)) and searched with
     search_with_store over the 16,384 queries in batches of 2048 at the
     sift path's params, the exact distances from each store: device (the
     in-memory index's base), mmap, blockcache (a FileBlockSource: two
     batches at the default max_cached_blocks, which is below the file's
     blocks, so every batch misses on every block; then a cache of the
     whole file with SQLite under the work directory, a cold and a warm
     pass) and http (an HttpRangeSource against a Range-honouring
     http.server on 127.0.0.1 in a thread of this script, a cache of the
     whole file, cold). Each pass: ids equal to the in-memory index's
     fold-on run but at near-ties (every distance within rtol 1e-5),
     recall@10 within 0.0005 of it, one launch of quantize and rough_scan
     a batch and none of gather_l2; QPS, and a batch's span between CUDA
     events around the estimate, its host ms to get_rows (the estimate's
     enqueue and the one copy of the candidates), in get_rows and after
     it (exact distances, merge, top-k); misses, blocks and bytes read
     and the cache backend, which must be "native"; the host syncs of one
     batch under sync debug mode "warn"; one batch profiled (but on the
     cold pass): the device ms of the estimate's kernels, the call's
     device busy ms and the card's idle share of it. One batch's positions go through the
     block cache's get_rows and the JAX package's mask loop, timed, the
     rows equal;
  11. [sift service] BatchingEngine (max_batch 64, window 2 ms) and
     make_handler on a ServiceHTTPServer at 127.0.0.1:0 in a thread: the
     device-resident sift index as the default engine, a block-cache
     engine named "store" over the saved base. Through the port's client
     helpers: 2,048 queries as /query_bin_batch frames of 512 rows, 512
     single /query JSON requests and 256 /query_bin requests from 16
     threads, at probe 28 and top_k 10 (the engine's rerank 48): ids equal
     to search() at those params but at near-ties, recall@10 >= 0.93, one
     launch of each search kernel a device call, /metrics counting every
     query; 128 /query_bin requests to the store engine (cache misses
     above 0, no gather_l2); a 10% allowlist registered by POST /filters
     (every id returned allowed); /admin/reload of the saved directory
     while 8 threads keep querying (no request fails) and 409 from the
     store engine. QPS and p50/p99 latency per protocol, rows a device
     call;
  12. [cli]   python -m rabitq_tpu_torch.cli, in-process (main(argv)), on
     the sift data written as fvecs/ivecs: build (bits 4, spill 0.2), run
     (probe 28, rerank 32, topk 10, batch 2048) at recall@10 >= 0.93, run
     on the [saved] directory at the sift path's recall, run
     --rerank-mode heap over 64 queries, run --autotune 0.95 and run
     --adaptive on the saved directory over 2,048 queries, and train on
     the 260k sample (2 iterations); the temporary files are deleted
     after;
  13. [sift mutate] delete 10,000 ids (none comes back), insert 10,000
     rows (256 queries at inserted rows return their ids first, at
     distance 0 to f32 rounding), update 1,000 ids (the new vectors answer
     with them, the old ones no longer); recall@10 against brute force
     over the live corpus >= 0.93, also under a deny filter of 10% of the
     ids, every distance its id's live vector's; one filtered batch under
     sync debug mode "error"; dump_to_dir and load_from_dir give the same
     ids and distances; compact keeps the live ids at recall >= 0.93
     (seconds logged); device ms a batch with and without the memtable;
  14. [sift shard] the sift index sharded (shard_index, from its host
     copy) onto an explicit mesh of S entries of cuda:0, S = 1, 2, 4, with
     the seconds, the rows a shard and the peak device memory of the call
     (no more than the shards' own bytes: no full-size copy);
     sharded_search of the 16,384 queries in batches of 2048 at the sift
     params, in the heuristic mode and the exact one (S = 1 exact only):
     recall@10 >= 0.93, the exact mode's >= the unsharded run's - 0.0005,
     at S = 1 the unsharded ids but at near-ties, every distance its id's,
     each search kernel launched S times a batch, one batch under sync
     debug mode "error", QPS, device and host enqueue ms a batch; one
     shard a card where the host has S cards (else logged as skipped).
     Then [sift shard store]: the saved base-less index at S = 4 with an
     MmapStore over the saved base.fvecs and shard_global_positions: the
     ids of sharded_search but at near-ties, one copy to the host a device
     a batch, no gather_l2; [sift shard build]: build_index_sharded at
     S = 4 bit-equal to shard_index(build_index(...)) of the sift path,
     seconds of each; [sift shard ckpt]: dump_index_sharded and
     load_index_sharded at S = 4, bit-identical, the search equal, dump
     and load seconds; [sift shard service]: a mesh BatchingEngine on the
     S = 4 index behind a ServiceHTTPServer in a thread: /query_bin_batch
     frames and /query_bin requests from threads (ids of sharded_search at
     the engine's params but at near-ties, QPS, p50/p99), a 10% allowlist,
     /admin/reload of the checkpoint while 8 threads query (none fails);
  15. [multihost] rabitq_tpu_torch.tools.multihost_demo on the card: two
     processes in one torch.distributed world, backend gloo (NCCL needs
     one card a rank), each printing PARITY OK;
  16. [dryrun] rabitq_tpu_torch.graft_entry.dryrun_multichip(4, devices=
     [cuda:0] * 4);
  17. [kmeans tree] hierarchical_kmeans(T=64, D=64) on the sift sample,
     then the sift build and search with its centroids: recall@10 >= 0.90,
     seconds and recall beside flat k-means';
  18. [gist]  the GIST-like path at full width: 1M x 960 corpus, 4,096
     queries, k-means (k=4096, 260k sample, 15 iterations), the same
     build, search_many over 4 batches of 1024 at rerank 150, topk 100,
     probes 48/64/80/96; at probe 80 recall@100 >= 0.93, 4 rough_scan
     calls with 4 launches of each search kernel, the scan's all in qpack
     mode, and every returned distance equal to its id's exact distance.
     Slots without a distinct id (a spilled build can index an id twice)
     are counted and scored as misses. Then [gist filter]: a 1% allowlist
     at probe 80 over the 4 batches, every id allowed and every distance
     exact, the scan in qpack mode with the penalty; recall@100 against
     the allowed rows logged (no floor). Then [gist rerank bf16] at probe
     80: f32, the two-level rerank at the auto refine (400 >= R 150) and
     at refine 0 (bf16 distances reported, no f32 launch), and at rerank
     800 f32 against the auto refine (400 < R), each as [sift rerank
     bf16] checks it (refine 0's distances those of the ids' bf16 rows),
     with the bf16 copy's device memory; and [gist rank default]:
     rank_precision "default" (one bf16 pass) against "highest", the pass
     against the fp32 product of the bf16-rounded operands, the share of
     (query, probed cluster) choices that differ, the GEMM route, recall,
     device ms and the ranking stage's ms (ran highest, default, default,
     highest), one batch under sync debug mode "error".
  19. [bench gist|gist200k|blobs|service|deep10m] bench.py's other
     configurations at full size through the benchmark twin
     (rabitq_tpu_torch.tools.bench.run, as `python -m
     rabitq_tpu_torch.tools.bench --config <name>` runs them), each
     printing its JSON line: gist (1M x 960, recall@100, ranking clusters
     in one bf16 pass as bench.py's gist default), gist200k (200k x 960,
     recall@100) and blobs
     (1M x 128, Zipf-skewed blobs, balance 2.0) sweep probes until
     recall reaches 0.95 and time the chosen probe; service (200k x 128)
     drives an HTTP server in a thread with 32 concurrent binary clients
     and then the batched protocol; deep10m (10M x 96, k 8192) builds a
     base-less index, searches it through an mmap store, then through a
     block cache over a range server that answers 500 to every 50th GET
     (the ids must equal the mmap store's), and times row-filter builds
     at 10M rows. Each must reach recall >= 0.93 at its chosen probe
     (service on both protocols), deep10m must see faults injected, and
     every scan call must launch quantize, rough_scan and gather_l2 once
     (gist's and gist200k's scan in qpack mode; deep10m launches no
     gather_l2: its
     exact stage runs on the host).
  Every probe of the sift and gist paths runs four times, in turns with the default
  SearchParams (the lane fold on) and with select_reduce=False (the full
  scan output): on, off, off, on. A [<path> fold] line sets the two modes
  side by side: recall, device and host enqueue ms per batch, and from
  one profiled batch of each run the device ops launched, the selection
  stage (per-task and global top-k) and the rough-scan stage (the kernel
  and the grouping glue launched in its wrapper) beside the bound of that
  batch's operands (distinct probed rows, the output the mode writes),
  and the groups per cluster, the gather_l2 kernel's device time (one
  launch) beside the bound of that batch's positions (each distinct row
  once), the quantize kernel's device time and the elementwise kernels'
  share, and the batch's peak device memory above what was allocated
  before it, beside that of the same batch with the quantize stage's
  plain version (which materialises the [B, probe, D] f32 residual).
  At the checked probe every run is checked, and one batch of each
  mode runs under torch.cuda.set_sync_debug_mode("error"), so a host sync
  fails the run.

Then a JSON line of per-kernel results (the gather_l2 kernel's bf16
instance a row of its own, its launches those of the bf16 rerank runs),
the nvidia-smi name/power-limit line, and last {"ok": true, "device":
{...}}. Without a CUDA device the script exits 1 at once.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import importlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

# The benchmark twin's data generator (bench.py's numbers), launch counts
# and batch timing, shared with its [bench <config>] phases.
from rabitq_tpu_torch.tools.bench import (
    make_dataset,
    run_captured,
    timed_batches,
)

# every_id: every result slot must hold an id. Off at topk 100 with
# rerank 150 < 2 * topk, where the spill duplicates among a query's 150
# candidates can leave fewer than 100 distinct ids (-1, +inf slots).
# qpack: the index dim (padded to a multiple of 128) is a multiple of 256,
# so search quantizes into the scan's nibble-packed operand.
SIFT = dict(n=1_000_000, dim=128, n_centers=1024, nq=16384, probe=28,
            rerank=32, topk=10, batch=2048, every_id=True, qpack=False)
GIST = dict(n=1_000_000, dim=960, n_centers=1024, nq=4096, rerank=150,
            topk=100, batch=1024, every_id=False, qpack=True)
GIST_PROBES, GIST_CHECK_PROBE = (48, 64, 80, 96), 80
K, TRAIN_CAP, KMEANS_ITERS = 4096, 260_000, 15
MIN_RECALL = 0.93
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peaks
INT8_OPS_PER_S = 1.979e15  # dense int8 tensor-core operations
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
KERNEL_SOURCES = ("rough_scan", "gather_l2", "int4_dot", "quantize", "select",
                  "probe_rank")
# Checked scan calls profiled a shape, and the record_function labels that
# mark the scan wrapper's call and the selection in a profiled search batch.
SCAN_PROFILED_CALLS = 5
SCAN_STAGE = "chip_smoke: rough_scan stage"
SELECT_STAGE = "chip_smoke: selection stage"
ESTIMATE_STAGE = "chip_smoke: estimate stage"  # a store-tier batch's
SCAN_KERNEL = "rough_scan_kernel"  # within the profiler's demangled name
GATHER_KERNEL = "gather_l2_kernel"
SELECT_KERNEL = "select_kernel"
PROBE_RANK_KERNEL = "probe_rank_kernel"
# The gather_l2 instances' row types, template arguments in their names.
GATHER_BF16, GATHER_F32 = "Bf16Rows", "F32Rows"
RERANK_STAGE = "chip_smoke: rerank stage"
RANK_STAGE = "chip_smoke: ranking stage"  # the terms: norms and GEMM
STAGE_LABELS = (SCAN_STAGE, SELECT_STAGE, ESTIMATE_STAGE, RERANK_STAGE,
                RANK_STAGE)
INT4_KERNEL = "int4_dot_kernel"
QUANT_KERNEL = "quantize_kernel"
ELEMENTWISE = "elementwise_kernel"  # torch's pointwise kernels' names
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
# The store tier's exact distances are host numpy, the in-memory path's the
# gather_l2 kernel's: the two sum in other orders.
STORE_RTOL = 1e-5
STORE_RECALL_SLACK = 0.0005
# Batches of the default-size block cache's run (each ~1.8 s: it misses on
# every block of every batch).
DEFAULT_CACHE_BATCHES = 2
# [sift service]: the engines' micro-batching, and the traffic: frames of
# /query_bin_batch (512 x 128 f32 fits MAX_BODY_BYTES, 1 MiB; 2,048 rows
# would not), single JSON /query and /query_bin requests from threads.
SERVICE = dict(max_batch=64, window_ms=2.0, frames=4, frame=512, json=512,
               bin=256, store_bin=128, threads=16, reload_threads=8)


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
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
    by = "bytes" if t_bytes >= t_ops else "operations"
    return 1e3 * max(t_bytes, t_ops), by, rows, nbytes / 1e9


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
    the kernels it launched, and a record_function label its span on the
    device, so both are left out."""
    return [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
        and e.key not in STAGE_LABELS
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
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 9 * s * dim / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes / 1e9)


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
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 3 * valid.numel() * dim / FP32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes / 1e9, rows)


def assert_gather_close(got, want):
    """rtol 1e-5, atol 1e-5 * max|want|: the kernel and the twin sum the
    same f32 squares in different orders. Returns max |got - want|."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    atol = 1e-5 * float(want.abs().max()) if want.numel() else 0.0
    if not torch.allclose(got, want, rtol=1e-5, atol=atol):
        raise AssertionError(f"gather_l2 kernel != twin: max |diff| {err}")
    return err


def stage_kernels(event):
    """The device kernels launched under a profiled CPU event, its
    children's included, as (name, us)."""
    ks = [(k.name, k.duration) for k in event.kernels]
    for child in event.cpu_children:
        ks += stage_kernels(child)
    return ks


def stage_event(prof, label):
    """The one CPU event of a record_function range in a profile."""
    found = [e for e in prof.events() if e.name == label
             and e.device_type == torch.autograd.DeviceType.CPU]
    if len(found) != 1:
        raise AssertionError(f"profiled batch: {len(found)} '{label}' ranges")
    return found[0]


def profile_batch(rt, index, q, params, label, smi, row_filter=None):
    """Where one batch's device time goes (torch.profiler, CUPTI). The
    scan wrapper's call and the candidate selection run inside
    record_function ranges, so the kernels they launch are found by their
    CPU parents. Returns the rough-scan stage's kernel ms (rough_scan_kernel)
    and glue ms (the other kernels launched in the wrapper), the rerank's
    gather_l2 kernel ms (one launch), the quantize kernel ms (one launch),
    the ms and launches of torch's elementwise kernels, the selection
    stage's ms (its one select kernel, read by name: the profiler does not
    tie a kernel launched through ctypes to its range), the device ops of
    the batch and its device busy ms."""
    from torch.profiler import record_function

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    wrapper, select = tsearch.cuda_rough_scan, tsearch.cuda_select_candidates

    def staged(*args):
        with record_function(SCAN_STAGE):
            return wrapper(*args)

    def selecting(*args):
        with record_function(SELECT_STAGE):
            return select(*args)

    torch.cuda.synchronize()
    tsearch.cuda_rough_scan, tsearch.cuda_select_candidates = (staged,
                                                               selecting)
    try:
        with settled_profile() as prof:
            t0 = time.perf_counter()
            rt.search(index, q, params, row_filter)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tsearch.cuda_rough_scan, tsearch.cuda_select_candidates = (wrapper,
                                                                   select)
    dev_ops = device_ops(prof)
    busy_ms = sum(t for _, t, _ in dev_ops)
    top = sorted(dev_ops, key=lambda r: -r[1])[:8]
    host_ops = sorted(
        ((e.key, e.self_cpu_time_total / 1e3, e.count)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CPU),
        key=lambda r: -r[1])[:6]
    log(f"[profile {label}] one batch of {q.shape[0]}: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%); "
        f"{profile_timing(prof, LAST_PROFILE[1])}; top: "
        + "; ".join(f"{k[:60]} {t:.3f} ms x{c}" for k, t, c in top)
        + "; host (self CPU, under the profiler): "
        + "; ".join(f"{k[:40]} {t:.3f} ms x{c}" for k, t, c in host_ops)
        + f" [{smi}]")
    scan = [(t, c) for k, t, c in dev_ops if SCAN_KERNEL in k]
    if len(scan) != 1 or scan[0][1] != 1:
        raise ProfileLostRecords(f"profiled batch: scan kernel launches "
                                 f"{scan}")
    gather = [(t, c) for k, t, c in dev_ops if GATHER_KERNEL in k]
    if len(gather) != 1 or gather[0][1] != 1:
        raise ProfileLostRecords(f"profiled batch: gather_l2 kernel launches "
                                 f"{gather}")
    quant = [(t, c) for k, t, c in dev_ops if QUANT_KERNEL in k]
    if len(quant) != 1 or quant[0][1] != 1:
        raise ProfileLostRecords(f"profiled batch: quantize kernel launches "
                                 f"{quant}")
    elementwise = [(t, c) for k, t, c in dev_ops if ELEMENTWISE in k]
    glue = sum(us for k, us in stage_kernels(stage_event(prof, SCAN_STAGE))
               if SCAN_KERNEL not in k)
    if glue <= 0:
        raise ProfileLostRecords("profiled batch: no glue kernel under the "
                                 "stage")
    sel = stage_event(prof, SELECT_STAGE)
    if any(c.name == "aten::topk" for c in sel.cpu_children):
        raise AssertionError("selection stage holds a torch.topk call")
    select = [(t, c) for k, t, c in dev_ops if SELECT_KERNEL in k]
    if len(select) != 1 or select[0][1] != 1:
        raise ProfileLostRecords(f"profiled batch: select kernel launches "
                                 f"{select}")
    return dict(kernel_ms=scan[0][0], gather_ms=gather[0][0],
                quantize_ms=quant[0][0],
                elementwise_ms=sum(t for t, _ in elementwise),
                elementwise_launches=sum(c for _, c in elementwise),
                glue_ms=glue / 1e3,
                select_ms=select[0][0]
                + sum(us for _, us in stage_kernels(sel)) / 1e3,
                device_ops=sum(c for _, _, c in dev_ops), busy_ms=busy_ms)


def scan_in_search(rt, index, q, params):
    """The rough-scan operands of one search batch, captured at the
    wrapper: their bound (with the output the batch's mode writes),
    distinct rows and groups per cluster; and the (B, R, D) of the
    batch's gather_l2 call with the bound of its positions (distinct
    rows)."""
    from rabitq_tpu_torch.ops.scan_kernel import effective_fold

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    wrapper, gather = tsearch.cuda_rough_scan, tsearch.cuda_gather_l2
    seen, gathered = [], []

    def capture(*args):
        seen.append(args)
        return wrapper(*args)

    def capture_gather(base, pos, qp, **kwargs):
        gathered.append((pos, *base.shape))
        return gather(base, pos, qp, **kwargs)

    tsearch.cuda_rough_scan = capture
    tsearch.cuda_gather_l2 = capture_gather
    try:
        rt.search(index, q, params)
    finally:
        tsearch.cuda_rough_scan, tsearch.cuda_gather_l2 = wrapper, gather
    codes, _, starts, sizes, qvals, _, span, fold, qpack = seen[0][:9]
    pos, n, dim = gathered[0]
    g_bound_ms, _, _, g_rows = gather_bound(pos, n, dim)
    f = effective_fold(span, fold)
    bound_ms, bound_by, rows, gb = scan_bound(
        codes, starts, sizes, span, f * 128 if f else span, qvals.shape[1])
    g_max, g_mean = groups_per_cluster(codes, starts, sizes, span)
    return dict(bound_ms=bound_ms, bound_by=bound_by, rows=rows, gb=gb,
                groups_max=g_max, groups_mean=g_mean, tasks=starts.shape[0],
                fold=f, qpack=qpack, gather_shape=(*pos.shape, dim),
                gather_rows=g_rows, gather_bound_ms=g_bound_ms)


def check_no_host_sync(rt, index, q, params, label, row_filter=None):
    """One search batch under torch.cuda.set_sync_debug_mode("error"): any
    op that synchronizes with the host raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        rt.search(index, q, params, row_filter)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[{label} sync] one search batch ran under sync debug mode "
        f"'error': no host sync")


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


def check_quantize(dev, smi, label, b, probe, dim, pack):
    """The fused quantize kernel against its twin at one path's shape, with
    the dither off (search's default) and on: quantized values, lo, delta
    and code_sum bit-equal, ycd within YCD_RTOL. Its time is the kernel's
    device time with the L2 cold (dither off), beside its bound and the
    twin's time (CUDA events)."""
    from rabitq_tpu_torch.ops import (
        cuda_quantize_residuals,
        quantize_residuals_reference,
    )

    y, centroids, cids, bias = quantize_operands(dev, b, probe, dim,
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


def check_gather_l2(dev, smi, n, dim, b, r, positions="random"):
    """The rerank kernel against its twin on random rows, with uniform
    positions (duplicates, rows 0 and N-1) or cluster-local ones
    (cluster_gather_positions), beside its bound (distinct rows). The
    kernel's time is its device time with the L2 cold (cold_device_ms).
    Its rate counting a row read at every position (what the kernel reads
    unless L2 catches a repeat) is logged beside it."""
    from rabitq_tpu_torch.ops import cuda_gather_l2, gather_l2_reference

    base, pos, q = gather_operands(dev, n, dim, b, r, seed=dim)
    if positions == "clusters":
        pos = cluster_gather_positions(dev, n, b, r, seed=dim)
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
    log(f"[kernel gather_l2 {positions}] N={n} D={dim} B={b} R={r}: within "
        f"rtol 1e-5 / atol 1e-5*max of twin (max |diff| {err:.3g}); kernel "
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
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2 * m * n * k / INT8_OPS_PER_S
        bound_ms = 1e3 * max(t_bytes, t_ops)
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
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


# The largest max_memory_allocated() seen before batch_peak_mb reset it,
# since the path's own reset: peak_memory_gb() covers both.
_PEAK_SEEN = [0]


def reset_peak_memory():
    torch.cuda.reset_peak_memory_stats()
    _PEAK_SEEN[0] = 0


def peak_memory_gb():
    return max(_PEAK_SEEN[0], torch.cuda.max_memory_allocated()) / 1e9


def batch_peak_mb(fn):
    """Peak device memory of fn() (one search batch) above what was
    allocated before it, in MB."""
    torch.cuda.synchronize()
    _PEAK_SEEN[0] = max(_PEAK_SEEN[0], torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - before) / 1e6


def batch_peaks(rt, index, q, params):
    """(fused, plain) peak MB of one search batch: as search runs it, and
    with the quantize stage's plain version in place of the kernel (the
    [B, probe, D] f32 residual materialised)."""
    from rabitq_tpu_torch.ops import quantize_residuals_reference

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    fused = batch_peak_mb(lambda: rt.search(index, q, params))
    kernel = tsearch.cuda_quantize_residuals
    tsearch.cuda_quantize_residuals = quantize_residuals_reference
    try:
        plain = batch_peak_mb(lambda: rt.search(index, q, params))
    finally:
        tsearch.cuda_quantize_residuals = kernel
    return fused, plain


def run_search(rt, index, qd, truth, params, label, smi):
    """search_many of the whole query set once (after a warm-up batch):
    wall and device time, host enqueue time and launch counts, recall;
    then the counters, one batch's peak memory (fused and with the plain
    quantize stage), the scan's bound in one batch and one profiled
    batch. Returns a dict of what it measured, with ids and dists."""
    nb, batch, topk = qd.shape[0], qd.shape[1], params.topk
    res = timed_search_many(rt, index, qd, params)
    rt.METRICS.reset()
    for q in qd:  # counters (untimed)
        rt.metrics.record_search_stats(
            rt.search_with_stats(index, q, params)[2]
        )
    torch.cuda.synchronize()
    peak_gb = peak_memory_gb()
    res["batch_peak_mb"], res["plain_batch_peak_mb"] = batch_peaks(
        rt, index, qd[1], params)
    ids = res["ids"]
    res.update(recall=recall_of(ids, truth), no_id=int((ids < 0).sum()))
    scan = scan_in_search(rt, index, qd[1], params)
    scan.update(retry_lost_records(
        lambda: profile_batch(rt, index, qd[1], params, label, smi), label))
    scan["stage_ms"] = scan["kernel_ms"] + scan["glue_ms"]
    res["scan"] = scan
    log(f"[{label} search] {nb}x{batch} queries probe={params.probe} "
        f"rerank={params.rerank} topk={topk} select_reduce="
        f"{params.select_reduce} (scan fold {scan['fold']}): "
        f"{res['search_s']:.4f}s wall, {res['device_ms'] * nb:.3f} ms device "
        f"(CUDA events, {res['device_ms']:.3f} ms/batch; host enqueue "
        f"{res['enqueue_ms']:.3f} ms/batch), QPS {res['qps']:.1f}, "
        f"recall@{topk} {res['recall']:.4f}, slots without an id "
        f"{res['no_id']}, peak mem {peak_gb:.3f} GB (one batch: "
        f"{res['batch_peak_mb']:.1f} MB above its start; with the plain "
        f"quantize stage {res['plain_batch_peak_mb']:.1f} MB), "
        f"{rt.METRICS.to_str()}, "
        f"search_many: {res['counts']}; in one batch: rough_scan stage "
        f"{scan['stage_ms']:.4f} ms = kernel {scan['kernel_ms']:.4f} ms "
        f"+ grouping glue {scan['glue_ms']:.4f} ms (profile) vs bound "
        f"{scan['bound_ms']:.4f} ms by {scan['bound_by']} ({scan['rows']} "
        f"distinct probed rows, {scan['gb']:.4f} GB; stage at "
        f"{100 * scan['bound_ms'] / scan['stage_ms']:.1f}%, kernel at "
        f"{100 * scan['bound_ms'] / scan['kernel_ms']:.1f}% of bound), "
        f"selection stage {scan['select_ms']:.4f} ms (the select kernel), "
        f"{scan['device_ops']} device ops, {scan['tasks']} tasks, groups "
        f"per cluster max {scan['groups_max']} mean "
        f"{scan['groups_mean']:.2f}; gather_l2 kernel {scan['gather_ms']:.4f} "
        f"ms (profile, 1 launch) vs bound {scan['gather_bound_ms']:.4f} ms "
        f"(B, R, D = {scan['gather_shape']}, {scan['gather_rows']} distinct "
        f"rows; "
        f"{100 * scan['gather_bound_ms'] / scan['gather_ms']:.1f}% of bound); "
        f"quantize kernel {scan['quantize_ms']:.4f} ms (1 launch), "
        f"elementwise kernels {scan['elementwise_ms']:.4f} ms "
        f"({scan['elementwise_launches']} launches); scan qpack "
        f"{scan['qpack']} [{smi}]")
    return res


def log_fold_pair(label, probe, on, off, smi):
    """The fold-on and fold-off runs of one probe (lists, in the order they
    ran) side by side."""
    nb = on[0]["counts"]["rough_scan calls"]

    def pair(fmt, get):
        return " | ".join(", ".join(fmt.format(get(r)) for r in runs)
                          for runs in (on, off))

    log(f"[{label} fold] probe {probe}, fold on | off (select_reduce True | "
        f"False; {len(on)} runs each, ran on, off, off, on): recall "
        f"{pair('{:.4f}', lambda r: r['recall'])}; device "
        f"ms/batch {pair('{:.3f}', lambda r: r['device_ms'])}; host enqueue "
        f"ms/batch {pair('{:.3f}', lambda r: r['enqueue_ms'])}; QPS "
        f"{pair('{:.1f}', lambda r: r['qps'])}; in one profiled batch: "
        f"selection stage ms (the select kernel) "
        f"{pair('{:.4f}', lambda r: r['scan']['select_ms'])}; rough_scan "
        f"stage ms "
        f"{pair('{:.4f}', lambda r: r['scan']['stage_ms'])}, kernel ms "
        f"{pair('{:.4f}', lambda r: r['scan']['kernel_ms'])}, bound ms "
        f"{pair('{:.4f}', lambda r: r['scan']['bound_ms'])}; gather_l2 "
        f"kernel ms {pair('{:.4f}', lambda r: r['scan']['gather_ms'])} (bound "
        f"{on[0]['scan']['gather_bound_ms']:.4f}); quantize kernel ms "
        f"{pair('{:.4f}', lambda r: r['scan']['quantize_ms'])}; elementwise "
        f"ms {pair('{:.4f}', lambda r: r['scan']['elementwise_ms'])}; one "
        f"batch's peak MB (above its start) "
        f"{pair('{:.1f}', lambda r: r['batch_peak_mb'])}, with the plain "
        f"quantize stage {pair('{:.1f}', lambda r: r['plain_batch_peak_mb'])}"
        f"; device busy ms "
        f"{pair('{:.3f}', lambda r: r['scan']['busy_ms'])}; device ops "
        f"{pair('{}', lambda r: r['scan']['device_ops'])}; kernel launches "
        f"per batch quantize "
        f"{pair('{:g}', lambda r: r['counts']['quantize'] / nb)}, rough_scan "
        f"{pair('{:g}', lambda r: r['counts']['rough_scan'] / nb)} (qpack "
        f"{pair('{:g}', lambda r: r['counts']['rough_scan qpack'] / nb)}), "
        f"gather_l2 "
        f"{pair('{:g}', lambda r: r['counts']['gather_l2'] / nb)} [{smi}]")


def check_results(base, flat_q, res, cfg, label, nb, min_recall):
    """Shapes, ids against distances, every returned distance equal to its
    id's exact distance, recall, and one launch of each search kernel per
    batch, the scan's in qpack mode where the path packs."""
    ids, dists, topk = res["ids"], res["dists"], cfg["topk"]
    n = base.shape[0]
    if tuple(ids.shape) != (flat_q.shape[0], topk):
        raise AssertionError(f"ids shape {tuple(ids.shape)}")
    fin = torch.isfinite(dists)
    if not torch.equal(fin, ids >= 0) or (ids >= n).any():
        raise AssertionError("out-of-range ids or id/-1 not matching "
                             "finite/+inf distances")
    if cfg["every_id"] and res["no_id"]:
        raise AssertionError(f"{res['no_id']} result slots without an id")
    xb = torch.from_numpy(base).to(flat_q.device)
    for a in range(0, ids.shape[0], 256):
        i, d = ids[a : a + 256], dists[a : a + 256]
        diff = xb[i.clamp(min=0)] - flat_q[a : a + 256, None, :]
        exact = (diff * diff).sum(-1)
        f = torch.isfinite(d)
        if not f.any():
            continue
        atol = 1e-5 * float(exact[f].abs().max())
        if not torch.allclose(exact[f], d[f], rtol=1e-5, atol=atol):
            raise AssertionError(
                f"{label}: returned distances are not the ids' distances"
            )
    del xb
    if res["recall"] < min_recall:
        raise AssertionError(
            f"{label}: recall@{topk} {res['recall']:.4f} < {min_recall}")
    counts = res["counts"]
    if not (counts["quantize"] == counts["rough_scan"] == counts["gather_l2"]
            == counts["select"] == counts["rough_scan calls"] == nb
            and counts["rough_scan qpack"] == (nb if cfg["qpack"] else 0)):
        raise AssertionError(f"{label}: search_many of {nb} batches: {counts}")


def search_path(rt, dev, smi, label, cfg, probes, check_probe, min_recall):
    """Ground truth, k-means, build and search_many of one configuration
    at each probe, with the default SearchParams (the lane fold on) and
    with select_reduce=False; checks both runs at ``check_probe`` (and
    that a batch of each makes no host sync) and returns a dict of that
    probe: index, params, queries (qd [nb, batch, D] and flat_q), truth,
    base and centroids, and the fold-on and fold-off runs. The two modes
    run in the order on, off, off, on, so that a drift of the host's speed
    shows as a spread within each mode rather than as a gap between
    them."""
    n, dim, nq, topk, batch = (cfg[f] for f in ("n", "dim", "nq", "topk",
                                                "batch"))
    t0 = time.perf_counter()
    base, queries = make_dataset(n, dim, cfg["n_centers"], nq)
    log(f"[{label} data] {n}x{dim} corpus, {nq} queries in "
        f"{time.perf_counter() - t0:.1f}s (host numpy)")

    nb = nq // batch
    qd = torch.from_numpy(queries[: nb * batch]).to(dev).reshape(nb, batch, dim)
    flat_q = qd.reshape(-1, dim)
    del queries
    t0 = time.perf_counter()
    xb = torch.from_numpy(base).to(dev)
    truth = torch.cat([
        torch.topk(rt.ops.pairwise_l2sq(flat_q[a : a + 256], xb), topk,
                   largest=False).indices
        for a in range(0, flat_q.shape[0], 256)
    ])
    torch.cuda.synchronize()
    log(f"[{label} truth] brute-force top-{topk} of {flat_q.shape[0]} "
        f"queries: {time.perf_counter() - t0:.2f}s")
    # The peak memory covers k-means, the build and search alone.
    del xb
    torch.cuda.empty_cache()
    reset_peak_memory()

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    sample = base[rng.choice(n, TRAIN_CAP, replace=False)]
    centroids = rt.kmeans(
        sample, K, iters=KMEANS_ITERS, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1),
    )
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    log(f"[{label} kmeans] k={K} on {TRAIN_CAP} rows, {KMEANS_ITERS} iters: "
        f"{kmeans_s:.2f}s [{smi}]")
    del sample

    t0 = time.perf_counter()
    index = rt.build_index(
        base, centroids, bits=4, spill=0.2, balance=1.5, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2),
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[{label} build_index] n={index.n} (spilled {index.n - n}) "
        f"k={index.k} dim={index.dim} capacity={index.capacity}: "
        f"{build_s:.2f}s [{smi}]")

    checked = None
    for probe in probes:
        params = rt.SearchParams(probe=probe, topk=topk, rerank=cfg["rerank"])
        modes = {"fold on": params,
                 "fold off": params._replace(select_reduce=False)}
        runs = {mode: [] for mode in modes}
        for mode in ("fold on", "fold off", "fold off", "fold on"):
            runs[mode].append(run_search(
                rt, index, qd, truth, modes[mode],
                f"{label} probe {probe} {mode} #{len(runs[mode]) + 1}", smi))
        for mode, fold in (("fold on", 2), ("fold off", 0)):
            if any(r["scan"]["fold"] != fold for r in runs[mode]):
                raise AssertionError(f"{mode}: the scan did not fold at "
                                     f"depth {fold}")
        log_fold_pair(label, probe, runs["fold on"], runs["fold off"], smi)
        if probe != check_probe:
            continue
        for mode, p in modes.items():
            check_no_host_sync(rt, index, qd[1], p, f"{label} {mode}")
            for r in runs[mode]:
                check_results(base, flat_q, r, cfg, f"{label} {mode}", nb,
                              min_recall)
        checked = dict(index=index, params=params, qd=qd, flat_q=flat_q,
                       truth=truth, base=base, centroids=centroids,
                       on=runs["fold on"][0], off=runs["fold off"][0],
                       kmeans_s=kmeans_s, build_s=build_s)
        log(f"[{label} check] probe {probe}, fold on and off: shapes, finite "
            f"distances equal to exact, recall, launches ok")
    if checked is None:
        raise AssertionError(f"probe {check_probe} not among {probes}")
    return checked


def sift_cpu_agreement(rt, index, params, flat_q, ids, dists, topk):
    """The same 64 queries through the CPU path (the kernels' twins)."""
    d_cpu, i_cpu = rt.search(cpu_copy(index), flat_q[:64].cpu(), params)
    same = i_cpu == ids[:64].cpu()
    agree = float(same.float().mean())
    if agree < 0.98 or not torch.allclose(
        d_cpu[same], dists[:64].cpu()[same], rtol=1e-4, atol=1e-3
    ):
        raise AssertionError(f"CPU path agrees on only {agree:.4f} of ids")
    log(f"[sift check] CPU twin path agrees on {agree:.4f} of 64x{topk} ids")


def saved_phase(rt, dev, smi, sift, work):
    """The sift index dumped to ``work``/saved with dump_to_dir and loaded
    back onto the card; search_many of the whole query set must return
    the in-memory index's ids and distances (the fold-on run's). Returns
    the directory, which the CLI phase runs on."""
    from rabitq_tpu_torch.index.serialize import dump_to_dir, load_from_dir

    saved = work / "saved"
    t0 = time.perf_counter()
    dump_to_dir(sift["index"], saved)
    dump_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in saved.iterdir())
    t0 = time.perf_counter()
    loaded = load_from_dir(saved, device=dev)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    dists, ids = rt.search_many(loaded, sift["qd"], sift["params"])
    topk = sift["params"].topk
    same_ids = torch.equal(ids.reshape(-1, topk), sift["on"]["ids"])
    same_d = torch.equal(dists.reshape(-1, topk), sift["on"]["dists"])
    if not (same_ids and same_d):
        raise AssertionError(f"[saved] reloaded index: ids equal {same_ids}, "
                             f"distances equal {same_d}")
    del loaded
    log(f"[saved] sift index (n={sift['index'].n}, D={sift['index'].dim}) "
        f"dump_to_dir {dump_s:.2f}s ({nbytes / 1e9:.3f} GB, "
        f"{len(list(saved.iterdir()))} files), load_from_dir onto the card "
        f"{load_s:.2f}s; search_many of {ids.numel() // topk} queries: ids "
        f"and distances equal to the in-memory index's [{smi}]")
    return saved


class CountingSource:
    """A range source that counts the blocks and bytes read through it."""

    def __init__(self, inner):
        self.inner, self.size = inner, inner.size
        self.blocks = self.bytes = 0
        self._lock = threading.Lock()

    def read_range(self, start, length):
        raw = self.inner.read_range(start, length)
        with self._lock:
            self.blocks += 1
            self.bytes += len(raw)
        return raw


def range_server(directory):
    """A Range-honouring http.server over ``directory`` on 127.0.0.1, in a
    thread of this process: a GET with ``Range: bytes=a-b`` gets a 206 with
    those bytes. Returns the server and its URL."""
    import functools
    import http.server

    class Handler(http.server.SimpleHTTPRequestHandler):
        def do_GET(self):
            rng_hdr = self.headers.get("Range")
            if not rng_hdr:
                return super().do_GET()
            path = self.translate_path(self.path)
            size = os.path.getsize(path)
            a, b = rng_hdr[len("bytes="):].split("-")
            lo, hi = int(a), min(int(b), size - 1)
            with open(path, "rb") as f:
                f.seek(lo)
                body = f.read(hi - lo + 1)
            self.send_response(206)
            self.send_header("Content-Range", f"bytes {lo}-{hi}/{size}")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    from rabitq_tpu_torch.service.server import ServiceHTTPServer

    srv = ServiceHTTPServer(("127.0.0.1", 0), functools.partial(
        Handler, directory=str(directory)))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_port}"


def count_syncs(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): the number of
    host syncs it made (each warns once)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return sum("synchroniz" in str(w.message) for w in rec)


def assert_near_reference(label, ids, dists, ref_ids, ref_d):
    """Returned (ids, dists) against a reference run's, rank by rank:
    the distances within rtol 1e-5 (atol 1e-5 of the largest), so that an
    id that differs is a near-tie; returns the share of equal ids."""
    fin = np.isfinite(ref_d)
    if not np.array_equal(np.isfinite(dists), fin):
        raise AssertionError(f"{label}: +inf slots differ from the reference")
    atol = 1e-5 * float(np.abs(ref_d[fin]).max())
    if not np.allclose(dists[fin], ref_d[fin], rtol=STORE_RTOL, atol=atol):
        bad = ~np.isclose(dists, ref_d, rtol=STORE_RTOL, atol=atol) & fin
        raise AssertionError(
            f"{label}: {int(bad.sum())} slots whose distance is not the "
            f"reference's (first at {np.argwhere(bad)[0].tolist()}: "
            f"{dists[bad][0]} vs {ref_d[bad][0]})")
    return float((ids == ref_ids).mean())


def profile_store_batch(lean, q, params, store, label, smi):
    """One search_with_store batch under torch.profiler (CUPTI), with
    estimate_candidates inside a record_function range: the device ms of
    the kernels launched there (quantize, scan, selection), the device
    busy ms of the whole call (kernels and copies), its wall ms under the
    profiler and the card's idle share of it, 1 - busy / wall."""
    from torch.profiler import record_function

    from rabitq_tpu_torch.store import search_with_store

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    estimate = tsearch.estimate_candidates

    def staged(*args, **kwargs):
        with record_function(ESTIMATE_STAGE):
            return estimate(*args, **kwargs)

    torch.cuda.synchronize()
    tsearch.estimate_candidates = staged
    try:
        with settled_profile() as prof:
            t0 = time.perf_counter()
            search_with_store(lean, q, params, store)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        tsearch.estimate_candidates = estimate
    dev_ops = device_ops(prof)
    for kernel in (QUANT_KERNEL, SCAN_KERNEL):
        launched = [c for k, _, c in dev_ops if kernel in k]
        if launched != [1]:
            raise ProfileLostRecords(f"[{label}] profiled batch: {kernel} "
                                     f"launches {launched}")
    busy_ms = sum(t for _, t, _ in dev_ops)
    est_ms = sum(us for _, us in stage_kernels(
        stage_event(prof, ESTIMATE_STAGE))) / 1e3
    top = sorted(dev_ops, key=lambda r: -r[1])[:5]
    log(f"[profile {label}] one batch of {q.shape[0]}: wall {wall_ms:.3f} ms "
        f"(under the profiler), device busy {busy_ms:.3f} ms, the card idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}% of the call; "
        f"estimate_candidates' kernels {est_ms:.3f} ms; top: "
        + "; ".join(f"{k[:50]} {t:.3f} ms x{c}" for k, t, c in top)
        + f" [{smi}]")
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, estimate_ms=est_ms,
                idle=1 - busy_ms / wall_ms)


def store_pass(rt, lean, store, sift, label, batches=None):
    """search_with_store of the sift queries (the first ``batches``
    batches, or all), batch by batch, at the sift path's params, with the
    stages of each batch timed: the span between CUDA events recorded
    around estimate_candidates (the card waits inside it for the host's
    enqueue, so this is not its device time: profile_store_batch reads
    that), the host ms from
    the call to get_rows (the estimate's enqueue and the one copy of the
    candidates), get_rows' host ms, and the host ms after it (the exact
    distances, the merge and the top-k); the launches (counted from 0);
    and the results checked against the in-memory index's fold-on run."""
    from rabitq_tpu_torch.store import search_with_store

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    estimate, get_rows = tsearch.estimate_candidates, store.get_rows
    qd, params = sift["qd"][:batches], sift["params"]
    events, stamps, per, misses = [], {}, [], []

    def timed_estimate(*args, **kwargs):
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        out = estimate(*args, **kwargs)
        ev[1].record()
        events.append(ev)
        return out

    def timed_rows(pos):
        t = time.perf_counter()
        out = get_rows(pos)
        stamps["rows"] = (t, time.perf_counter())
        return out

    def run():
        outs = []
        for q in qd:
            t0 = time.perf_counter()
            outs.append(search_with_store(lean, q, params, store))
            t1 = time.perf_counter()
            r0, r1 = stamps["rows"]
            per.append((t1 - t0, r0 - t0, r1 - r0, t1 - r1))
            misses.append(rt.METRICS.miss - sum(misses))
        return outs

    tsearch.estimate_candidates, store.get_rows = timed_estimate, timed_rows
    rt.METRICS.reset()
    try:
        t0 = time.perf_counter()
        outs, counts = run_captured(run)
        wall = time.perf_counter() - t0
    finally:
        tsearch.estimate_candidates = estimate
        del store.get_rows
    nb = qd.shape[0]
    if not (counts["rough_scan calls"] == counts["quantize"]
            == counts["rough_scan"] == counts["select"] == nb
            and counts["gather_l2"] == 0):
        raise AssertionError(f"[{label}] launches {counts}")
    dists = np.concatenate([d for d, _ in outs])
    ids = np.concatenate([i for _, i in outs])
    rows = ids.shape[0]
    ref_ids = sift["on"]["ids"][:rows]
    same = assert_near_reference(
        f"[{label}]", ids, dists, ref_ids.cpu().numpy(),
        sift["on"]["dists"][:rows].cpu().numpy())
    truth = sift["truth"][:rows]
    recall = recall_of(torch.from_numpy(ids).to(truth.device).long(), truth)
    ref_recall = recall_of(ref_ids, truth)
    if abs(recall - ref_recall) > STORE_RECALL_SLACK:
        raise AssertionError(f"[{label}] recall@{params.topk} {recall:.4f} "
                             f"against the sift path's {ref_recall:.4f} on "
                             f"the same queries")
    ms = np.asarray(per) * 1e3
    est = np.asarray([a.elapsed_time(b) for a, b in events])
    return dict(qps=ids.shape[0] / wall, wall_s=wall, counts=counts,
                batch=qd.shape[1], misses=misses,
                same=same, recall=recall, miss=rt.METRICS.miss,
                est_ms=est, total_ms=ms[:, 0], wait_ms=ms[:, 1],
                rows_ms=ms[:, 2], exact_ms=ms[:, 3], nb=nb)


def _spread(a):
    return f"{np.mean(a):.2f} ({np.min(a):.2f}-{np.max(a):.2f})"


def log_store_pass(label, r, smi, extra=""):
    nb = r["nb"]
    log(f"[{label}] {nb}x{r['batch']} queries probe={SIFT['probe']} "
        f"rerank={SIFT['rerank']} topk={SIFT['topk']}: QPS {r['qps']:.1f} "
        f"({r['wall_s']:.3f}s); ms a batch, mean (min-max): call "
        f"{_spread(r['total_ms'])} = to get_rows (estimate enqueue + the "
        f"one copy) {_spread(r['wait_ms'])} + get_rows {_spread(r['rows_ms'])}"
        f" + exact, merge and top-k {_spread(r['exact_ms'])} (host clock); "
        f"estimate event span {_spread(r['est_ms'])} (CUDA events, the "
        f"host's enqueue included); launches a "
        f"batch quantize {r['counts']['quantize'] / nb:g}, rough_scan "
        f"{r['counts']['rough_scan'] / nb:g}, gather_l2 "
        f"{r['counts']['gather_l2'] / nb:g}; ids equal to the in-memory "
        f"index's on {r['same']:.5f} of slots (the rest near-ties, every "
        f"distance within rtol {STORE_RTOL}); recall@{SIFT['topk']} "
        f"{r['recall']:.4f}; cache misses {r['miss']} (a batch: "
        f"{', '.join(map(str, r['misses']))}){extra} [{smi}]")


def jax_style_rows(store, pos):
    """The JAX package's BlockCachedStore.get_rows loop (a boolean mask
    over all positions for each distinct block), for timing against the
    port's argsort grouping on the same store."""
    out = np.empty((pos.shape[0], store.dim), dtype=np.float32)
    block_ids = pos // store.num_per_block
    for b in np.unique(block_ids):
        blk = store._get_block(int(b))
        sel = block_ids == b
        out[sel] = blk[pos[sel] - b * store.num_per_block]
    store.flush()
    return out


def store_phase(rt, dev, smi, sift, saved, work):
    """[sift store <kind>]: the saved sift index loaded base-less onto the
    card and searched with search_with_store through each store kind.
    Returns the launch counts summed over the passes, and the base-less
    index (the service phase's store engine serves it)."""
    from rabitq_tpu_torch.index.serialize import load_from_dir
    from rabitq_tpu_torch.store import (
        BlockCachedStore, DeviceStore, FileBlockSource, HttpRangeSource,
        MmapStore, search_with_store)

    t0 = time.perf_counter()
    lean = load_from_dir(saved, keep_base=False, device=dev)
    torch.cuda.synchronize()
    log(f"[sift store] load_from_dir(keep_base=False) onto the card "
        f"{time.perf_counter() - t0:.2f}s (base.fvecs "
        f"{(saved / 'base.fvecs').stat().st_size / 1e9:.3f} GB stays on disk)")
    fvecs = saved / "base.fvecs"
    q0, params = sift["qd"][0], sift["params"]
    runs, total = {}, {}

    def one(kind, store, batches=None):
        r = store_pass(rt, lean, store, sift, f"sift store {kind}", batches)
        extra = ""
        if batches is None:
            r["syncs"] = count_syncs(
                lambda: search_with_store(lean, q0, params, store))
            extra = f"; host syncs in one batch {r['syncs']}"
        if batches is None and kind != "blockcache cold":
            r["profile"] = retry_lost_records(
                lambda: profile_store_batch(lean, q0, params, store,
                                            f"sift store {kind}", smi),
                f"sift store {kind}")
        log_store_pass(f"sift store {kind}", r, smi, extra)
        for key, v in r["counts"].items():
            total[key] = total.get(key, 0) + v
        runs[kind] = r
        return r

    one("device", DeviceStore(sift["index"].base))
    one("mmap", MmapStore(fvecs))

    def cache_line(src, store):
        return (f"; blocks read {src.blocks} ({src.bytes / 1e9:.3f} GB), "
                f"cache_backend {store.cache_backend}, max_cached_blocks "
                f"{store._max_blocks}, {store.num_per_block} rows a block")

    # The default max_cached_blocks (1024) is below the file's blocks: each
    # batch sweeps nearly every block through the LRU, which then misses
    # on all of them. Two batches show it; the checked passes below use a
    # cache of the whole file.
    src = CountingSource(FileBlockSource(fvecs))
    default = BlockCachedStore(src, lean.dim)
    n_blocks = -(-lean.n // default.num_per_block)
    r = one("blockcache default", default, batches=DEFAULT_CACHE_BATCHES)
    log(f"[sift store blockcache default] the default size, no SQLite, "
        f"{DEFAULT_CACHE_BATCHES} batches: misses {r['misses']} a batch "
        f"against {n_blocks} blocks in the file" + cache_line(src, default))
    if n_blocks > default._max_blocks and min(r["misses"]) < default._max_blocks:
        raise AssertionError("[sift store blockcache default] a batch hit "
                             "the LRU")
    src = CountingSource(FileBlockSource(fvecs))
    whole = BlockCachedStore(src, lean.dim, sqlite_path=work / "cache.db",
                             max_cached_blocks=n_blocks)
    for temp in ("cold", "warm"):
        src.blocks = src.bytes = 0
        r = one(f"blockcache {temp}", whole)
        log(f"[sift store blockcache {temp}] a cache of all {n_blocks} "
            f"blocks, SQLite under the work directory: misses {r['miss']}"
            + cache_line(src, whole))
    if default.cache_backend != "native" or whole.cache_backend != "native":
        raise AssertionError("[sift store blockcache] cache_backend is not "
                             "native")
    if runs["blockcache warm"]["miss"] or src.blocks:
        raise AssertionError("[sift store blockcache warm] a warm pass of a "
                             "cache holding the whole file missed")
    if not 0 < runs["blockcache cold"]["miss"] <= n_blocks:
        raise AssertionError("[sift store blockcache cold] misses "
                             f"{runs['blockcache cold']['miss']}: not each "
                             "block once")
    # One batch's candidate positions, as search_with_store hands them on.
    pos = rt.estimate_candidates(lean, q0, params).pos.reshape(-1).cpu()
    pos = pos.numpy()
    t0 = time.perf_counter()
    grouped = whole.get_rows(pos)
    grouped_ms = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    masked = jax_style_rows(whole, pos)
    masked_ms = 1e3 * (time.perf_counter() - t0)
    if not np.array_equal(grouped, masked):
        raise AssertionError("get_rows differs from the JAX-style loop")
    log(f"[sift store blockcache get_rows] one batch's {pos.size} positions "
        f"({len(np.unique(pos // whole.num_per_block))} distinct blocks) on "
        f"the warm whole-file cache: grouped by one argsort {grouped_ms:.2f} "
        f"ms, the JAX package's mask loop {masked_ms:.2f} ms, rows equal "
        f"[{smi}]")

    srv, url = range_server(saved)
    try:
        http_src = CountingSource(HttpRangeSource(url + "/base.fvecs"))
        http = BlockCachedStore(http_src, lean.dim, max_cached_blocks=n_blocks)
        r = one("http", http)
        log(f"[sift store http] HttpRangeSource against a Range-honouring "
            f"http.server on 127.0.0.1 (206s), a cache of all blocks, cold: "
            f"misses {r['miss']}" + cache_line(http_src, http))
        if http.cache_backend != "native" or not r["miss"]:
            raise AssertionError("[sift store http] cold pass: "
                                 f"{http.cache_backend}, misses {r['miss']}")
    finally:
        srv.shutdown()
        srv.server_close()
    return dict(runs=runs, counts=total, lean=lean,
                get_rows_ms=(grouped_ms, masked_ms))


def post_json_to(url, path, payload):
    """(status, JSON body) of a JSON POST."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def reload_under_load(url, q_host, topk, probe, n_threads, directory,
                      label):
    """POST /admin/reload of ``directory`` while ``n_threads`` threads keep
    sending /query_bin requests of ``q_host`` rows; raises if a request
    failed. Returns (status, body, reload seconds, requests sent)."""
    from rabitq_tpu_torch.service import client

    stop, failures, done = threading.Event(), [], [0]

    def hammer(k):
        j = k
        while not stop.is_set():
            try:
                client.query_once_bin(url, q_host[j % q_host.shape[0]],
                                      topk, probe)
                done[0] += 1
            except Exception as e:  # every failure is reported below
                failures.append(repr(e))
            j += n_threads

    threads = [threading.Thread(target=hammer, args=(k,))
               for k in range(n_threads)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    t0 = time.perf_counter()
    st, body = post_json_to(url, "/admin/reload", dict(dir=str(directory)))
    reload_s = time.perf_counter() - t0
    time.sleep(0.5)
    stop.set()
    for t in threads:
        t.join(timeout=60)
    if any(t.is_alive() for t in threads) or failures:
        raise AssertionError(f"[{label}] {failures[:3]}")
    return st, body, reload_s, done[0]


def percentiles(lat_s):
    ms = np.asarray(lat_s) * 1e3
    return f"p50 {np.percentile(ms, 50):.2f} ms, p99 {np.percentile(ms, 99):.2f} ms"


def service_phase(rt, dev, smi, sift, saved, lean):
    """[sift service]: BatchingEngine + make_handler on a ServiceHTTPServer
    at 127.0.0.1:0 in a thread; the default engine the device-resident sift
    index, "store" a block-cache engine over the saved base. Traffic
    through the port's client helpers; the checks of the module
    docstring. Returns the launch counts."""
    import concurrent.futures as cf
    import urllib.request

    from rabitq_tpu_torch.service import client
    from rabitq_tpu_torch.service.server import (
        BatchingEngine, ServiceHTTPServer, make_handler)
    from rabitq_tpu_torch.store import BlockCachedStore, FileBlockSource

    cfg = SERVICE
    probe, topk = SIFT["probe"], SIFT["topk"]
    engine = BatchingEngine(sift["index"], max_batch=cfg["max_batch"],
                            window_ms=cfg["window_ms"])
    store_engine = BatchingEngine(
        lean, BlockCachedStore(FileBlockSource(saved / "base.fvecs"),
                               lean.dim),
        max_batch=cfg["max_batch"], window_ms=cfg["window_ms"])
    srv = ServiceHTTPServer(("127.0.0.1", 0), make_handler(
        engine, default_probe=probe, default_topk=topk,
        engines={"default": engine, "store": store_engine},
        allow_reload=True))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}"

    def post_json(path, payload):
        return post_json_to(url, path, payload)

    def metrics():
        with urllib.request.urlopen(url + "/metrics") as resp:
            text = resp.read().decode()
        return {k: int(v) for k, v in
                re.findall(r"(query|rough|precise|cache miss): (\d+)", text)}

    n_b, n_j, n_q = cfg["frames"] * cfg["frame"], cfg["json"], cfg["bin"]
    n_s = cfg["store_bin"]
    rows = sift["flat_q"][: n_b + n_j + n_q]
    q_host = rows.cpu().numpy()
    truth = sift["truth"][: rows.shape[0]]
    ref_params = rt.SearchParams(probe=probe, topk=topk,
                                 rerank=engine.default_rerank)
    ref = [rt.search(sift["index"], rows[a : a + 256], ref_params)
           for a in range(0, rows.shape[0], 256)]
    ref_d = torch.cat([d for d, _ in ref]).cpu().numpy()
    ref_i = torch.cat([i for _, i in ref]).cpu().numpy()
    base = sift["base"]
    out = {}
    try:
        for u in (url, url + "/index/store"):  # first calls, untimed
            client.query_once_bin(u, q_host[0], topk, probe)

        def device_traffic():
            ids = np.empty((rows.shape[0], topk), np.int64)
            lat = {"bin_batch": [], "json": [], "bin": []}
            wall = {}
            t0 = time.perf_counter()
            for f in range(cfg["frames"]):
                a = f * cfg["frame"]
                i, _, dt = client.query_batch_bin(
                    url, q_host[a : a + cfg["frame"]], topk, probe)
                ids[a : a + cfg["frame"]] = i
                lat["bin_batch"].append(dt)
            wall["bin_batch"] = time.perf_counter() - t0

            def json_one(j):
                got, dt = client.query_once(url, q_host[n_b + j], topk, probe)
                return j, got, dt

            def bin_one(j):
                got, _, dt = client.query_once_bin(
                    url, q_host[n_b + n_j + j], topk, probe)
                return j, got, dt

            for name, fn, count, at in (("json", json_one, n_j, n_b),
                                        ("bin", bin_one, n_q, n_b + n_j)):
                t0 = time.perf_counter()
                with cf.ThreadPoolExecutor(cfg["threads"]) as pool:
                    for j, got, dt in pool.map(fn, range(count)):
                        if len(got) != topk:
                            raise AssertionError(f"[sift service] {name} "
                                                 f"query {j}: {len(got)} ids")
                        ids[at + j] = got
                        lat[name].append(dt)
                wall[name] = time.perf_counter() - t0
            return ids, lat, wall

        rt.METRICS.reset()
        (ids, lat, wall), counts = run_captured(device_traffic)
        sent = rows.shape[0]
        m = metrics()
        calls = counts["rough_scan calls"]
        if not (calls and counts["quantize"] == counts["rough_scan"]
                == counts["gather_l2"] == calls):
            raise AssertionError(f"[sift service] launches {counts}")
        if m["query"] != sent:
            raise AssertionError(f"[sift service] /metrics query {m['query']}"
                                 f" against {sent} sent")
        dists = ((base[ids] - q_host[:, None, :]) ** 2).sum(-1)
        same = assert_near_reference("[sift service]", ids, dists, ref_i,
                                     ref_d)
        recall = recall_of(torch.from_numpy(ids).to(truth.device), truth)
        if recall < MIN_RECALL:
            raise AssertionError(f"[sift service] recall@{topk} {recall:.4f}")
        out["counts"] = dict(counts)
        log(f"[sift service] {sent} queries to the device engine (max_batch "
            f"{cfg['max_batch']}, window {cfg['window_ms']} ms, rerank "
            f"{engine.default_rerank}): /query_bin_batch {cfg['frames']} "
            f"frames of {cfg['frame']} QPS {n_b / wall['bin_batch']:.1f} "
            f"(a frame {percentiles(lat['bin_batch'])}); /query JSON "
            f"{n_j} from {cfg['threads']} threads QPS "
            f"{n_j / wall['json']:.1f} ({percentiles(lat['json'])}); "
            f"/query_bin {n_q} from {cfg['threads']} threads QPS "
            f"{n_q / wall['bin']:.1f} ({percentiles(lat['bin'])}); "
            f"{calls} device calls, {sent / calls:.1f} rows a call, each "
            f"launching quantize, rough_scan and gather_l2 once; ids equal "
            f"to search() at the engine's params on {same:.5f} of slots "
            f"(the rest near-ties); recall@{topk} {recall:.4f}; /metrics "
            f"query {m['query']} = sent [{smi}]")

        def store_traffic():
            def one(j):
                got, _, dt = client.query_once_bin(
                    url + "/index/store", q_host[j], topk, probe)
                return got, dt

            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(cfg["threads"]) as pool:
                res = list(pool.map(one, range(n_s)))
            return res, time.perf_counter() - t0

        rt.METRICS.reset()
        (res, s_wall), s_counts = run_captured(store_traffic)
        m = metrics()
        s_calls = s_counts["rough_scan calls"]
        if not (s_calls and s_counts["quantize"] == s_counts["rough_scan"]
                == s_calls and s_counts["gather_l2"] == 0):
            raise AssertionError(f"[sift service store] launches {s_counts}")
        if m["cache miss"] <= 0 or m["query"] != n_s:
            raise AssertionError(f"[sift service store] /metrics {m}")
        s_ids = np.stack([g for g, _ in res])
        s_recall = recall_of(torch.from_numpy(s_ids).to(truth.device),
                             truth[:n_s])
        if s_recall < MIN_RECALL:
            raise AssertionError(f"[sift service store] recall {s_recall}")
        for key, v in s_counts.items():
            out["counts"][key] += v
        log(f"[sift service store] {n_s} /index/store/query_bin from "
            f"{cfg['threads']} threads (block cache, default size, cold): "
            f"QPS {n_s / s_wall:.1f} ({percentiles([dt for _, dt in res])}); "
            f"{s_calls} device calls ({n_s / s_calls:.1f} rows a call), "
            f"gather_l2 0; recall@{topk} {s_recall:.4f}; /metrics cache "
            f"miss {m['cache miss']} [{smi}]")

        n_ids = int(sift["index"].map_ids.max()) + 1
        allow = np.random.default_rng(4).choice(n_ids, n_ids // 10,
                                                replace=False)
        st, body = post_json("/filters", dict(name="tenth",
                                              allow_ids=allow.tolist()))
        if st != 200 or body["size"] != allow.size:
            raise AssertionError(f"[sift service filter] {st} {body}")
        t0 = time.perf_counter()
        st, body = post_json("/query", dict(
            query=q_host[:256].tolist(), top_k=topk, probe=probe,
            filter="tenth"))
        f_s = time.perf_counter() - t0
        got = np.concatenate([np.asarray(r, np.int64) for r in body["ids"]])
        if st != 200 or not np.isin(got, allow).all() or got.size == 0:
            raise AssertionError(f"[sift service filter] {st}: an id not "
                                 "allowed, or none")
        log(f"[sift service filter] a 10% allowlist ({allow.size} ids) by "
            f"POST /filters; one JSON POST of 256 rows with it "
            f"{f_s * 1e3:.1f} ms: {got.size} ids, every one allowed")

        st, body, reload_s, done = reload_under_load(
            url, q_host[:n_b], topk, probe, cfg["reload_threads"], saved,
            "sift service reload")
        if st != 200 or body != dict(ok=True, n=sift["index"].n):
            raise AssertionError(f"[sift service reload] {st} {body}")
        if engine.index is sift["index"]:
            raise AssertionError("[sift service reload] no swap")
        st409, _ = post_json("/admin/reload", dict(dir=str(saved),
                                                   index="store"))
        if st409 != 409:
            raise AssertionError(f"[sift service reload] store engine {st409}")
        log(f"[sift service reload] POST /admin/reload of the saved directory "
            f"took {reload_s:.2f}s while {cfg['reload_threads']} threads "
            f"sent {done} /query_bin requests: none failed; the store "
            f"engine answered 409 [{smi}]")
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
        store_engine.close()
    return out


def cli_phase(dev, smi, sift, saved, work, min_recall):
    """rabitq_tpu_torch.cli in-process: build, run on the built directory
    and on ``saved``, run --rerank-mode heap over 64 queries, train on the
    260k sample (2 iterations)."""
    from rabitq_tpu_torch.cli import main as cli
    from rabitq_tpu_torch.io import read_matrix, write_matrix

    base, qd, truth = sift["base"], sift["qd"], sift["truth"]
    params = sift["params"]
    t0 = time.perf_counter()
    files = {name: work / f"{name}.fvecs" for name in
             ("base", "centroids", "query", "query64", "query2048",
              "sample")}
    files.update(truth=work / "truth.ivecs", truth64=work / "truth64.ivecs",
                 truth2048=work / "truth2048.ivecs")
    queries = qd.reshape(-1, qd.shape[-1]).cpu().numpy()
    truth_np = truth.int().cpu().numpy()
    write_matrix(files["base"], base)
    write_matrix(files["centroids"], sift["centroids"].cpu().numpy())
    write_matrix(files["query"], queries)
    write_matrix(files["truth"], truth_np)
    write_matrix(files["query64"], queries[:64])
    write_matrix(files["truth64"], truth_np[:64])
    write_matrix(files["query2048"], queries[:2048])
    write_matrix(files["truth2048"], truth_np[:2048])
    rng = np.random.default_rng(1)
    write_matrix(files["sample"],
                 base[rng.choice(base.shape[0], TRAIN_CAP, replace=False)])
    log(f"[cli] wrote the sift files in {time.perf_counter() - t0:.1f}s")

    def index_args(saved_dir):
        return ["-b", str(files["base"]), "-c", str(files["centroids"]),
                "-s", str(saved_dir)]

    def run_args(saved_dir, query="query", truth_f="truth", *extra):
        return ["run", *index_args(saved_dir), "-q", str(files[query]),
                "-t", str(files[truth_f]), "-p", str(params.probe), "-k",
                str(params.topk), "--rerank", str(params.rerank), "--batch",
                str(qd.shape[1]), *extra]

    def timed(argv):
        t = time.perf_counter()
        out = cli(argv)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    built = work / "cli_index"
    _, build_s = timed(["build", *index_args(built), "--bits", "4",
                        "--spill", "0.2"])
    runs = {}
    for name, argv in (("built", run_args(built)),
                       ("saved", run_args(saved)),
                       ("heap", run_args(saved, "query64", "truth64",
                                         "--rerank-mode", "heap")),
                       ("autotune", run_args(saved, "query2048", "truth2048",
                                             "--autotune", "0.95")),
                       ("adaptive", run_args(saved, "query2048", "truth2048",
                                             "--adaptive"))):
        (out, seconds), counts = run_captured(lambda: timed(argv))
        runs[name] = dict(out, seconds=seconds, counts=counts)
    if runs["built"]["recall"] < min_recall:
        raise AssertionError(f"[cli] run recall@{params.topk} "
                             f"{runs['built']['recall']:.4f} < {min_recall}")
    # The same hits: the CLI averages in f64, the sift path in f32.
    slots = truth.shape[0] * params.topk
    if (round(runs["saved"]["recall"] * slots)
            != round(sift["on"]["recall"] * slots)):
        raise AssertionError(f"[cli] run on the saved index: recall "
                             f"{runs['saved']['recall']} != the sift path's "
                             f"{sift['on']['recall']}")
    nb = qd.shape[0]
    for name in ("built", "saved"):
        c = runs[name]["counts"]
        if not c["quantize"] == c["rough_scan"] == c["gather_l2"] == nb + 1:
            raise AssertionError(f"[cli] run {name}: launches {c} for "
                                 f"{nb} batches and a warm-up")
    for name in ("autotune", "adaptive"):
        assert_path_launches(runs[name]["counts"], f"[cli] run --{name}")
    _, train_s = timed(["train", "-i", str(files["sample"]), "-o",
                        str(work / "trained.fvecs"), "-k", str(K),
                        "--iters", "2"])
    trained = read_matrix(work / "trained.fvecs")
    if trained.shape != (K, base.shape[1]) or not np.isfinite(trained).all():
        raise AssertionError(f"[cli] train wrote {trained.shape}")
    log(f"[cli] build (bits 4, spill 0.2) {build_s:.2f}s; run "
        + "; ".join(
            f"{name}: recall@{params.topk} {r['recall']:.4f}, QPS "
            f"{r['qps']:.1f}, {r['seconds']:.2f}s, launches {r['counts']}"
            for name, r in runs.items())
        + f" (the sift path's recall {sift['on']['recall']:.4f}); train k={K} "
        f"on {TRAIN_CAP} rows, 2 iterations: {train_s:.2f}s [{smi}]")
    return runs


# Row filters on the sift index: allowed shares of the ids, each with its
# recall@10 floor against brute force over the allowed rows, and the JAX
# package's figure at that share (BASELINE.md:511-519, round 5; taken on a
# TPU v5e, logged beside the port's and no target here).
FILTER_FLOORS = {0.5: 0.90, 0.1: 0.84, 0.01: 0.60}
FILTER_JAX_TPU = {0.5: 0.9422, 0.1: 0.8887, 0.01: 0.6813}
GIST_FILTER_SHARE = 0.01
MUTATE_COUNTS = dict(delete=10_000, insert=10_000, update=1_000, probe=256)
ADAPTIVE_START, ADAPTIVE_MAX_PROBE, CERTIFY_QUERIES = 8, 256, 256
# A corpus whose clusters the annulus certificate can tell apart.
SEPARATED = dict(n=200_000, k=1024, spread=0.6)
AUTOTUNE_SAMPLE, AUTOTUNE_TARGET = 2048, 0.95


def brute_topk(xb, ids, flat_q, topk, chunk=512):
    """Exact top-k ids of every query over the rows ``xb`` (their ids
    ``ids``), on the card."""
    from rabitq_tpu_torch.ops import pairwise_l2sq

    return torch.cat([
        ids[torch.topk(pairwise_l2sq(flat_q[a : a + chunk], xb), topk,
                       largest=False).indices]
        for a in range(0, flat_q.shape[0], chunk)
    ])


def recall_of(ids, truth):
    topk = truth.shape[1]
    hits = (ids[:, :, None] == truth[:, None, :]).any(-1).sum(1)
    return float(hits.float().mean() / topk)


def assert_exact_distances(vec_of, flat_q, ids, dists, label):
    """Every finite returned distance is its id's exact squared distance
    (``vec_of[id]``, the id's live vector); -1 exactly at +inf."""
    fin = torch.isfinite(dists)
    if not torch.equal(fin, ids >= 0):
        raise AssertionError(f"{label}: ids -1 not matching +inf distances")
    for a in range(0, ids.shape[0], 256):
        i, d = ids[a : a + 256], dists[a : a + 256]
        diff = vec_of[i.clamp(min=0)] - flat_q[a : a + 256, None, :]
        exact = (diff * diff).sum(-1)
        f = torch.isfinite(d)
        if not f.any():
            continue
        atol = 1e-5 * float(exact[f].abs().max())
        if not torch.allclose(exact[f], d[f], rtol=1e-5, atol=atol):
            raise AssertionError(
                f"{label}: returned distances are not the ids' distances")


def timed_search_many(rt, index, qd, params, row_filter=None):
    """timed_batches of search_many over the query set."""
    return timed_batches(
        lambda: rt.search_many(index, qd, params, row_filter),
        lambda: rt.search(index, qd[0], params, row_filter), qd, params.topk)


def assert_path_launches(counts, label, penalty=False, qpack=None):
    """The search kernels each launched once a scan call in the run."""
    calls = counts["rough_scan calls"]
    want = {"quantize": calls, "rough_scan": calls, "gather_l2": calls,
            "select": calls}
    if penalty:
        want["rough_scan penalty"] = calls
    if qpack is not None:
        want["rough_scan qpack"] = calls if qpack else 0
    # probe_rank ranks once a scan call, and once more a certificate.
    if (not calls or any(counts[k] != v for k, v in want.items())
            or counts["probe_rank"] < calls):
        raise AssertionError(f"{label}: launches {counts}")


def filter_phase(rt, dev, smi, label, path, shares, floors, xb):
    """Filtered search_many of ``path``'s queries for allowlists of each
    share of the ids (drawn from a seeded numpy generator): every returned
    id allowed, every distance its id's exact one, recall@topk against
    brute force over the allowed rows on the card (at least ``floors``
    where given), the scan launched unfolded with the penalty. Returns
    the runs by share, each with its filter and allowed ids."""
    index, qd, flat_q, params = (path[k] for k in ("index", "qd", "flat_q",
                                                   "params"))
    n = xb.shape[0]
    rng = np.random.default_rng(3)
    runs = {}
    for share in shares:
        allow = np.sort(rng.choice(n, int(share * n), replace=False))
        t0 = time.perf_counter()
        rf = rt.make_row_filter(index, allow_ids=allow)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        allow_t = torch.from_numpy(allow).to(dev)
        t0 = time.perf_counter()
        truth = brute_topk(xb[allow_t], allow_t, flat_q, params.topk)
        torch.cuda.synchronize()
        truth_s = time.perf_counter() - t0
        r = timed_search_many(rt, index, qd, params, rf)
        ids, dists = r["ids"], r["dists"]
        assert_path_launches(r["counts"], f"{label} filter {share}",
                             penalty=True, qpack=index.dim % 256 == 0)
        live = ids[ids >= 0]
        if not torch.isin(live, allow_t).all():
            raise AssertionError(f"{label} filter {share}: a returned id is "
                                 f"not allowed")
        assert_exact_distances(xb, flat_q, ids, dists,
                               f"{label} filter {share}")
        r.update(recall=recall_of(ids, truth), filter=rf, allow=allow,
                 no_id=int((ids < 0).sum()), build_s=build_s,
                 truth_s=truth_s)
        floor = floors.get(share)
        if floor is not None and r["recall"] < floor:
            raise AssertionError(f"{label} filter {share}: recall@"
                                 f"{params.topk} {r['recall']:.4f} < {floor}")
        jax_tpu = FILTER_JAX_TPU.get(share) if label == "sift" else None
        log(f"[{label} filter] allowlist {100 * share:g}% ({allow.size} ids, "
            f"make_row_filter {build_s:.3f}s, allowed truth {truth_s:.2f}s): "
            f"probe {params.probe} rerank {params.rerank}: recall@"
            f"{params.topk} {r['recall']:.4f} against the allowed rows"
            + (f" (floor {floor}; the JAX package on a TPU v5e, BASELINE.md "
               f"round 5: {jax_tpu}, no target)" if floor else "")
            + f", slots without an id {r['no_id']}; every id allowed, every "
            f"distance exact; device {r['device_ms']:.3f} ms/batch (CUDA "
            f"events), host enqueue {r['enqueue_ms']:.3f} ms/batch; "
            f"launches {r['counts']} [{smi}]")
        runs[share] = r
    return runs


def sift_filter_phase(rt, dev, smi, sift):
    """The sift filters (filter_phase at 50%, 10% and 1%), a profiled
    filtered batch beside the unfiltered fold-off one, a deny-mode and a
    RowFilterContext build of the 10% filter against the direct one, and
    one filtered batch under sync debug mode "error"."""
    from rabitq_tpu_torch.index.filter import RowFilterContext

    t_phase = time.perf_counter()
    index, qd, params = sift["index"], sift["qd"], sift["params"]
    xb = torch.from_numpy(sift["base"]).to(dev)
    runs = filter_phase(rt, dev, smi, "sift", sift, tuple(FILTER_FLOORS),
                        FILTER_FLOORS, xb)
    del xb
    off = sift["off"]
    for share, r in runs.items():
        prof = retry_lost_records(
            lambda: profile_batch(rt, index, qd[1], params,
                                  f"sift filter {share}", smi, r["filter"]),
            f"sift filter {share}")
        r["busy_ms"], r["kernel_ms"] = prof["busy_ms"], prof["kernel_ms"]
    log("[sift filter] one profiled batch, filtered 50% / 10% / 1% | the "
        "unfiltered fold-off run's: device busy ms "
        + " / ".join(f"{r['busy_ms']:.3f}" for r in runs.values())
        + f" | {off['scan']['busy_ms']:.3f} ("
        + " / ".join(
            f"{100 * (r['busy_ms'] / off['scan']['busy_ms'] - 1):+.1f}%"
            for r in runs.values())
        + "); scan kernel ms "
        + " / ".join(f"{r['kernel_ms']:.4f}" for r in runs.values())
        + f" | {off['scan']['kernel_ms']:.4f}; device ms/batch (CUDA events) "
        + " / ".join(f"{r['device_ms']:.3f}" for r in runs.values())
        + f" | {off['device_ms']:.3f}; host enqueue ms/batch "
        + " / ".join(f"{r['enqueue_ms']:.3f}" for r in runs.values())
        + f" | {off['enqueue_ms']:.3f} [{smi}]")

    ten = runs[0.1]
    deny = np.setdiff1d(np.arange(sift["base"].shape[0]), ten["allow"])
    t0 = time.perf_counter()
    ctx = RowFilterContext(index)
    ctx_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    by_ctx = rt.make_row_filter(index, allow_ids=ten["allow"], ctx=ctx)
    torch.cuda.synchronize()
    ctx_build_s = time.perf_counter() - t0
    by_deny = rt.make_row_filter(index, deny_ids=deny)
    for name, rf in (("deny", by_deny), ("context", by_ctx)):
        if not torch.equal(rf.penalty, ten["filter"].penalty):
            raise AssertionError(f"[sift filter] {name} build's penalty "
                                 f"differs from the direct allow build's")
        _, ids = rt.search_many(index, qd, params, rf)
        if not torch.equal(ids.reshape(ten["ids"].shape), ten["ids"]):
            raise AssertionError(f"[sift filter] {name} build's ids differ")
    check_no_host_sync(rt, index, qd[1], params, "sift filter 10%",
                       ten["filter"])
    log(f"[sift filter] 10%: a deny-mode build ({deny.size} ids) and a "
        f"RowFilterContext build (context {ctx_s:.3f}s, then "
        f"{ctx_build_s:.4f}s against the direct build's "
        f"{ten['build_s']:.3f}s) give the direct build's penalty and ids; "
        f"phase {time.perf_counter() - t_phase:.1f}s [{smi}]")
    for r in runs.values():
        del r["ids"], r["dists"], r["filter"]
    return runs


def gist_filter_phase(rt, dev, smi, gist):
    """A 1% allowlist on the gist index at the checked probe, 4 batches:
    every id allowed, every distance exact, the scan in qpack mode with the
    penalty; recall@100 against the allowed rows is logged (no floor)."""
    t0 = time.perf_counter()
    xb = torch.from_numpy(gist["base"]).to(dev)
    runs = filter_phase(rt, dev, smi, "gist", gist, (GIST_FILTER_SHARE,),
                        {}, xb)
    del xb
    r = runs[GIST_FILTER_SHARE]
    log(f"[gist filter] phase {time.perf_counter() - t0:.1f}s")
    return {k: r[k] for k in ("recall", "device_ms", "enqueue_ms", "counts")}


def mutate_phase(rt, dev, smi, sift, work):
    """Deletes, inserts and updates on the sift index, then a filtered
    search, a dump and load, and a compaction; see the module docstring
    ([sift mutate])."""
    from rabitq_tpu_torch.index.mutate import reconstruct_corpus
    from rabitq_tpu_torch.index.serialize import dump_to_dir, load_from_dir

    t_phase = time.perf_counter()
    index, qd, flat_q, params = (sift[k] for k in ("index", "qd", "flat_q",
                                                   "params"))
    base = sift["base"]
    n, dim = base.shape
    c = MUTATE_COUNTS
    rng = np.random.default_rng(4)
    victims = rng.choice(n, c["delete"], replace=False)
    t0 = time.perf_counter()
    deleted = rt.delete(index, victims)
    torch.cuda.synchronize()
    delete_s = time.perf_counter() - t0
    r = timed_search_many(rt, deleted, qd, params)
    assert_path_launches(r["counts"], "sift mutate delete")
    victims_t = torch.from_numpy(victims).to(dev)
    if torch.isin(r["ids"], victims_t).any():
        raise AssertionError("[sift mutate] a deleted id came back")

    fresh = (base[rng.choice(n, c["insert"], replace=False)]
             + 0.1 * rng.standard_normal((c["insert"], dim))
             ).astype(np.float32)
    t0 = time.perf_counter()
    inserted = rt.insert(deleted, fresh)
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    q_new = torch.from_numpy(fresh[: c["probe"]]).to(dev)
    d_new, i_new = rt.search(inserted, q_new, params)
    want_new = torch.arange(n, n + c["probe"], device=dev)
    scale = (q_new * q_new).sum(1)
    if not (torch.equal(i_new[:, 0], want_new)
            and (d_new[:, 0] <= 1e-5 * scale).all()):
        raise AssertionError("[sift mutate] inserted rows do not return "
                             "their ids at distance 0")
    ins_d_max = float((d_new[:, 0] / scale).max())

    live_ids = np.setdiff1d(np.arange(n), victims)
    upd = rng.choice(live_ids, c["update"], replace=False)
    new_vecs = (base[rng.choice(n, c["update"], replace=False)]
                + 0.1 * rng.standard_normal((c["update"], dim))
                ).astype(np.float32)
    t0 = time.perf_counter()
    mutated = rt.update(inserted, new_vecs, upd)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    upd_t = torch.from_numpy(upd).to(dev)
    q_upd = torch.from_numpy(new_vecs[: c["probe"]]).to(dev)
    d_u, i_u = rt.search(mutated, q_upd, params)
    scale = (q_upd * q_upd).sum(1)
    if not (torch.equal(i_u[:, 0], upd_t[: c["probe"]])
            and (d_u[:, 0] <= 1e-5 * scale).all()):
        raise AssertionError("[sift mutate] updated ids do not answer at "
                             "their new vectors")
    upd_d_max = float((d_u[:, 0] / scale).max())
    _, i_old = rt.search(mutated, torch.from_numpy(
        base[upd[: c["probe"]]]).to(dev), params)
    if (i_old == upd_t[: c["probe"], None]).any():
        raise AssertionError("[sift mutate] an updated id answers at its "
                             "old vector")

    # The live corpus, its truth, and each id's live vector.
    vecs, ids = reconstruct_corpus(mutated)
    vecs_t = torch.from_numpy(vecs).to(dev)
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(dev)
    vec_of = torch.zeros((n + c["insert"], dim), device=dev)
    vec_of[ids_t] = vecs_t
    truth = brute_topk(vecs_t, ids_t, flat_q, params.topk)
    r = timed_search_many(rt, mutated, qd, params)
    assert_path_launches(r["counts"], "sift mutate")
    assert_exact_distances(vec_of, flat_q, r["ids"], r["dists"],
                           "sift mutate")
    recall = recall_of(r["ids"], truth)
    deny = rng.choice(ids, ids.shape[0] // 10, replace=False)
    rf = rt.make_row_filter(mutated, deny_ids=deny)
    keep = ~torch.isin(ids_t, torch.from_numpy(deny).to(dev))
    f_truth = brute_topk(vecs_t[keep], ids_t[keep], flat_q, params.topk)
    rf_run = timed_search_many(rt, mutated, qd, params, rf)
    assert_path_launches(rf_run["counts"], "sift mutate filter", penalty=True)
    assert_exact_distances(vec_of, flat_q, rf_run["ids"], rf_run["dists"],
                           "sift mutate filter")
    if torch.isin(rf_run["ids"], torch.from_numpy(deny).to(dev)).any():
        raise AssertionError("[sift mutate] a denied id came back")
    f_recall = recall_of(rf_run["ids"], f_truth)
    if min(recall, f_recall) < MIN_RECALL:
        raise AssertionError(f"[sift mutate] recall@{params.topk} "
                             f"{recall:.4f}, filtered {f_recall:.4f} < "
                             f"{MIN_RECALL}")
    check_no_host_sync(rt, mutated, qd[1], params, "sift mutate filter", rf)
    del f_truth, rf_run

    saved = work / "mutated"
    t0 = time.perf_counter()
    dump_to_dir(mutated, saved)
    loaded = load_from_dir(saved, device=dev)
    torch.cuda.synchronize()
    io_s = time.perf_counter() - t0
    dl, il = rt.search_many(loaded, qd, params)
    if not (torch.equal(il.reshape(r["ids"].shape), r["ids"])
            and torch.equal(dl.reshape(r["dists"].shape), r["dists"])):
        raise AssertionError("[sift mutate] the reloaded mutated index "
                             "searches differently")
    del loaded
    shutil.rmtree(saved)

    t0 = time.perf_counter()
    compacted, live = rt.compact(
        mutated, generator=torch.Generator(device=dev).manual_seed(5))
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    got_ids = compacted.map_ids.cpu().numpy()
    if not (live.shape == ids.shape
            and np.array_equal(np.unique(got_ids), np.unique(ids))
            and np.array_equal(np.sort(live), np.sort(ids))):
        raise AssertionError("[sift mutate] compact lost or gained ids")
    rc = timed_search_many(rt, compacted, qd, params)
    assert_path_launches(rc["counts"], "sift compacted")
    c_recall = recall_of(rc["ids"], truth)
    if c_recall < MIN_RECALL:
        raise AssertionError(f"[sift mutate] compacted recall "
                             f"{c_recall:.4f} < {MIN_RECALL}")
    # The memtable's share of a batch: the mutated index's device time
    # against the same index without its memtable rows.
    no_mem = dataclasses.replace(mutated, extra_base=None, extra_ids=None)
    r_nomem = timed_search_many(rt, no_mem, qd, params)
    busy = {}
    for name, idx in (("memtable", mutated), ("no memtable", no_mem)):
        busy[name] = retry_lost_records(
            lambda: profile_batch(rt, idx, qd[1], params,
                                  f"sift mutate {name}", smi),
            f"sift mutate {name}")["busy_ms"]
    log(f"[sift mutate] delete {c['delete']} ids {delete_s:.3f}s: none comes "
        f"back; insert {c['insert']} rows {insert_s:.3f}s: {c['probe']} "
        f"queries at inserted rows return their ids first (distance <= "
        f"{ins_d_max:.2e} x |q|^2); update {c['update']} ids "
        f"{update_s:.3f}s: new vectors answer with their ids (<= "
        f"{upd_d_max:.2e} x |q|^2), old ones no longer; live corpus "
        f"{ids.shape[0]} rows: recall@{params.topk} {recall:.4f}, with a "
        f"deny filter of {deny.size} ids {f_recall:.4f} (floor {MIN_RECALL}); "
        f"every distance exact; device {r['device_ms']:.3f} ms/batch with the "
        f"{mutated.m}-row memtable, {r_nomem['device_ms']:.3f} without it "
        f"(CUDA events; host enqueue {r['enqueue_ms']:.3f} and "
        f"{r_nomem['enqueue_ms']:.3f} ms/batch), device busy in one "
        f"profiled batch {busy['memtable']:.3f} and "
        f"{busy['no memtable']:.3f} ms; dump + "
        f"load {io_s:.2f}s: same ids and distances; compact {compact_s:.2f}s "
        f"(n {compacted.n}, capacity {compacted.capacity}): live ids kept, "
        f"recall@{params.topk} {c_recall:.4f}; launches {r['counts']}; "
        f"phase {time.perf_counter() - t_phase:.1f}s [{smi}]")
    return dict(recall=recall, filtered_recall=f_recall,
                compacted_recall=c_recall, compact_s=compact_s,
                device_ms=r["device_ms"], no_memtable_ms=r_nomem["device_ms"],
                busy_ms=busy, counts=r["counts"])


def certificate_violations(rt, index, q, params):
    """_search_with_certificate on ``q`` at ``params``: (certified share,
    rows of the index closer than a certified query's k-th result, by
    brute force, that lie outside its probed clusters). A row counts as
    closer below kth - 1e-5 (|q|^2 + kth), the rounding of the two
    distance computations."""
    from rabitq_tpu_torch.ops import pairwise_l2sq, rotate

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    dists, _, safe = tsearch._search_with_certificate(index, q, params)
    y = rotate(tsearch._prep_queries(index, q), index.orthogonal)
    cids = tsearch._rank_clusters(index, tsearch._rank_terms(index, y, params),
                                  params.probe, params)
    probed = torch.zeros((q.shape[0], index.k), dtype=torch.bool,
                         device=q.device).scatter_(1, cids, True)
    row_cluster = torch.searchsorted(
        index.offsets.long(), torch.arange(index.n, device=q.device),
        right=True) - 1
    live = index.map_ids >= 0
    kth = dists[:, -1]
    bad = 0
    for a in range(0, q.shape[0], 32):
        qa, ka = q[a : a + 32], kth[a : a + 32]
        closer = pairwise_l2sq(qa, index.base) < (
            ka - 1e-5 * ((qa * qa).sum(1) + ka))[:, None]
        outside = ~probed[a : a + 32][:, row_cluster]
        bad += int((closer & outside & live[None, :]
                    & safe[a : a + 32, None]).sum())
    return float(safe.float().mean()), bad


def separated_certificate(rt, dev, smi):
    """The certificate where it certifies: a corpus of well-separated
    clusters (SEPARATED: n rows about k standard-normal centers in 128-d,
    at ``spread``), queries near its rows; search_adaptive from probe 1,
    and the certificate against brute force at three probes."""
    t0 = time.perf_counter()
    n, k, spread = SEPARATED["n"], SEPARATED["k"], SEPARATED["spread"]
    rng = np.random.default_rng(6)
    centers = rng.standard_normal((k, 128)).astype(np.float32)
    base = (centers[rng.integers(0, k, n)]
            + spread * rng.standard_normal((n, 128))).astype(np.float32)
    index = rt.build_index(base, centers, bits=4, device=dev,
                           generator=torch.Generator(device=dev).manual_seed(6))
    q = torch.from_numpy(base[:CERTIFY_QUERIES] + 0.01 * rng.standard_normal(
        (CERTIFY_QUERIES, 128)).astype(np.float32)).to(dev)
    params = rt.SearchParams(probe=1, topk=10, rerank=32)
    _, _, used = rt.search_adaptive(index, q, params,
                                    max_probe=ADAPTIVE_MAX_PROBE)
    shares = {}
    for probe in (1, 4, used):
        share, bad = certificate_violations(rt, index, q,
                                            params._replace(probe=probe))
        if bad:
            raise AssertionError(f"[adaptive separated] certificate at probe "
                                 f"{probe}: {bad} closer rows outside the "
                                 f"probed clusters")
        shares[probe] = share
    log(f"[adaptive separated] {n} x 128 rows about {k} centers (spread "
        f"{spread}), {CERTIFY_QUERIES} queries near rows: search_adaptive "
        f"from probe 1 used probe {used}; certificate sound against brute "
        f"force, certified share "
        + ", ".join(f"at probe {p}: {v:.4f}" for p, v in shares.items())
        + f"; {time.perf_counter() - t0:.1f}s [{smi}]")
    if not any(shares.values()):
        raise AssertionError("[adaptive separated] nothing certified")
    return shares


def adaptive_phase(rt, dev, smi, sift):
    """search_adaptive from probe ADAPTIVE_START to ADAPTIVE_MAX_PROBE over
    the sift queries, with the centroid and the annulus ranking (probe
    used, recall, ms a batch), and the certificate against brute force on
    CERTIFY_QUERIES queries at two probes."""
    t_phase = time.perf_counter()
    index, qd, flat_q, params, truth = (sift[k] for k in (
        "index", "qd", "flat_q", "params", "truth"))
    out = {}
    for rank in ("centroid", "annulus"):
        p = params._replace(probe=ADAPTIVE_START, probe_rank=rank)
        rt.search_adaptive(index, qd[0], p, max_probe=ADAPTIVE_MAX_PROBE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, counts = run_captured(lambda: [
            rt.search_adaptive(index, q, p, max_probe=ADAPTIVE_MAX_PROBE)
            for q in qd])
        assert_path_launches(counts, f"sift adaptive {rank}")
        out[rank] = dict(
            probe_used=[pu for _, _, pu in res],
            recall=recall_of(torch.cat([i for _, i, _ in res]), truth),
            ms=1e3 * (time.perf_counter() - t0) / qd.shape[0], counts=counts)
    a, b = out["centroid"], out["annulus"]
    # Queries of the set, and base rows (near which a query certifies
    # early).
    on_rows = torch.from_numpy(sift["base"][:CERTIFY_QUERIES]).to(dev)
    certified = {}
    for name, q in (("queries", flat_q[:CERTIFY_QUERIES]),
                    ("base rows", on_rows)):
        for probe in (ADAPTIVE_START, max(a["probe_used"])):
            share, bad = certificate_violations(
                rt, index, q, params._replace(probe=probe))
            if bad:
                raise AssertionError(f"[sift adaptive] certificate of the "
                                     f"{name} at probe {probe}: {bad} closer "
                                     f"rows outside the probed clusters")
            certified[f"{name} at probe {probe}"] = share
    a["certified"] = certified
    log(f"[sift adaptive] search_adaptive from probe {ADAPTIVE_START}, "
        f"max_probe {ADAPTIVE_MAX_PROBE}, rerank {params.rerank}, "
        f"{qd.shape[0]} batches of {qd.shape[1]}: probe used "
        f"{a['probe_used']}, recall@{params.topk} {a['recall']:.4f}, "
        f"{a['ms']:.3f} ms a batch (host clock, one certificate read a "
        f"level); certificate sound against brute force on "
        f"{CERTIFY_QUERIES} queries and {CERTIFY_QUERIES} base rows "
        f"(certified share "
        + ", ".join(f"{k}: {v:.4f}" for k, v in certified.items())
        + f"); probe_rank annulus: probe used {b['probe_used']}, recall "
        f"{b['recall']:.4f}, {b['ms']:.3f} ms a batch; launches "
        f"{a['counts']}; phase {time.perf_counter() - t_phase:.1f}s [{smi}]")
    return out


def autotune_phase(rt, dev, smi, sift):
    """autotune on AUTOTUNE_SAMPLE of the sift queries at
    AUTOTUNE_TARGET: the curve, the pick and the seconds."""
    index, flat_q = sift["index"], sift["flat_q"]
    sample = flat_q[:AUTOTUNE_SAMPLE]
    t0 = time.perf_counter()
    (params, curve), counts = run_captured(
        lambda: rt.autotune(index, sample, AUTOTUNE_TARGET,
                            topk=sift["params"].topk))
    seconds = time.perf_counter() - t0
    assert_path_launches(counts, "sift autotune")
    if curve[-1].recall < AUTOTUNE_TARGET:
        raise AssertionError(f"[sift autotune] no rung reached "
                             f"{AUTOTUNE_TARGET}: {curve}")
    log(f"[sift autotune] {AUTOTUNE_SAMPLE} sample queries, target "
        f"recall@{sift['params'].topk} {AUTOTUNE_TARGET}: curve "
        + ", ".join(f"probe {c.probe} rerank {c.rerank}: {c.recall:.4f}"
                    for c in curve)
        + f"; pick probe {params.probe} rerank {params.rerank}; "
        f"{seconds:.2f}s (exact ground truth and one search a rung); "
        f"launches {counts} [{smi}]")
    return dict(probe=params.probe, rerank=params.rerank,
                curve=[tuple(c) for c in curve], seconds=seconds,
                counts=counts)


def cpu_copy(index):
    """The index with every tensor on the host."""
    return dataclasses.replace(index, **{
        f.name: getattr(index, f.name).cpu()
        for f in dataclasses.fields(index)
        if isinstance(getattr(index, f.name), torch.Tensor)
    })


def sharded_bytes(sidx):
    return sum(t.numel() * t.element_size() for _, sh in sidx.local()
               for t in (getattr(sh, f.name) for f in dataclasses.fields(sh))
               if isinstance(t, torch.Tensor))


def shard_timed(tp, index_cpu, mesh, label):
    """shard_index from the host copy, with its seconds and the peak device
    memory it allocated above what was allocated before it."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sidx = tp.shard_index(index_cpu, mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - before
    own = sharded_bytes(sidx)
    if peak > own + (64 << 20):
        raise AssertionError(f"[{label}] shard_index peaked {peak} bytes "
                             f"above its shards' {own}: a full-size copy?")
    rows = [sh.n for _, sh in sidx.local()]
    log(f"[{label}] shard_index from the host copy onto "
        f"{[str(d) for d in mesh.devices]}: {secs:.2f}s, rows a shard "
        f"{rows}, k_max {sidx.k_max}, peak device memory during the call "
        f"{peak / 1e9:.3f} GB above its start, the shards' own bytes "
        f"{own / 1e9:.3f} GB")
    return sidx


def sharded_run(tp, sidx, mesh, qd, params, exact):
    """timed_batches of sharded_search, a call a batch."""
    def one(q):
        return tp.sharded_search(sidx, q, params, mesh, exact=exact)

    def run_all():
        out = [one(q) for q in qd]
        return (torch.stack([d for d, _ in out]),
                torch.stack([i for _, i in out]))

    return timed_batches(run_all, lambda: one(qd[0]), qd, params.topk)


def assert_shard_launches(counts, s, nb, label, gather=True):
    """Each search kernel launched once a shard a batch (gather_l2 none on
    the store tier)."""
    want = {"rough_scan calls": s * nb, "quantize": s * nb,
            "rough_scan": s * nb, "probe_rank": s * nb,
            "gather_l2": s * nb if gather else 0}
    if any(counts[k] != v for k, v in want.items()):
        raise AssertionError(f"[{label}] launches {counts}, want {want}")


def profile_sharded_batch(tp, sidx, mesh, q, params, exact, label, smi):
    """One sharded_search batch under torch.profiler (CUPTI): the device
    busy ms (kernels and copies), the wall ms under the profiler and the
    card's idle share of it; each of the quantize and scan kernels must
    show S launches."""
    torch.cuda.synchronize()
    with settled_profile() as prof:
        t0 = time.perf_counter()
        tp.sharded_search(sidx, q, params, mesh, exact=exact)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_ops = device_ops(prof)
    for kernel in (QUANT_KERNEL, SCAN_KERNEL, GATHER_KERNEL):
        launched = sum(c for k, _, c in dev_ops if kernel in k)
        if launched != mesh.size:
            raise ProfileLostRecords(f"[{label}] profiled batch: {kernel} "
                                     f"launches {launched}")
    busy_ms = sum(t for _, t, _ in dev_ops)
    top = sorted(dev_ops, key=lambda r: -r[1])[:4]
    log(f"[profile {label}] one batch of {q.shape[0]}: wall {wall_ms:.3f} ms "
        f"(under the profiler), device busy {busy_ms:.3f} ms, the card idle "
        f"{100 * (1 - busy_ms / wall_ms):.1f}% of the call, "
        f"{sum(c for _, _, c in dev_ops)} device ops; top: "
        + "; ".join(f"{k[:50]} {t:.3f} ms x{c}" for k, t, c in top)
        + f" [{smi}]")
    return dict(busy_ms=busy_ms, wall_ms=wall_ms,
                idle=1 - busy_ms / wall_ms)


def check_sharded_batch_sync(tp, sidx, mesh, q, params, exact, label):
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tp.sharded_search(sidx, q, params, mesh, exact=exact)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[{label} sync] one sharded batch ran under sync debug mode "
        f"'error': no host sync")


def shard_phase(rt, tp, dev, smi, sift, sift_cpu):
    """[sift shard]: the sift index sharded from its host copy onto S
    shards of cuda:0 (S = 1, 2, 4), searched in both modes; the checks of
    the module docstring. Returns the S = 4 sharded index, its mesh, its
    heuristic run and the launch counts."""
    qd, params, truth = sift["qd"], sift["params"], sift["truth"]
    nb, topk = qd.shape[0], params.topk
    xb = torch.from_numpy(sift["base"]).to(dev)
    base_recall = sift["on"]["recall"]
    counts = {}
    kept = {}
    for s, modes in ((1, (True,)), (2, (False, True)), (4, (False, True))):
        label = f"sift shard S={s}"
        mesh = tp.make_mesh(devices=[dev] * s)
        sidx = shard_timed(tp, sift_cpu, mesh, label)
        for exact in modes:
            mode = "exact" if exact else "heuristic"
            r = sharded_run(tp, sidx, mesh, qd, params, exact)
            assert_shard_launches(r["counts"], s, nb, f"{label} {mode}")
            for k, v in r["counts"].items():
                counts[k] = counts.get(k, 0) + v
            assert_exact_distances(xb, sift["flat_q"], r["ids"], r["dists"],
                                   f"{label} {mode}")
            rec = recall_of(r["ids"], truth)
            if rec < MIN_RECALL:
                raise AssertionError(f"[{label} {mode}] recall {rec:.4f}")
            if exact and rec < base_recall - STORE_RECALL_SLACK:
                raise AssertionError(
                    f"[{label} exact] recall {rec:.4f} below the unsharded "
                    f"{base_recall:.4f} - {STORE_RECALL_SLACK}")
            extra = ""
            if s == 1:
                same = assert_near_reference(
                    f"{label} exact", r["ids"].cpu().numpy(),
                    r["dists"].cpu().numpy(),
                    sift["on"]["ids"].cpu().numpy(),
                    sift["on"]["dists"].cpu().numpy())
                extra = (f"; ids equal to the unsharded run's on {same:.5f} "
                         f"of slots (the rest near-ties)")
            check_sharded_batch_sync(tp, sidx, mesh, qd[1], params, exact,
                                     f"{label} {mode}")
            prof = retry_lost_records(lambda: profile_sharded_batch(
                tp, sidx, mesh, qd[1], params, exact, f"{label} {mode}",
                smi), f"{label} {mode}")
            lp = tp.sharding._local_params(params, s, sidx.k_max, exact)
            log(f"[{label} {mode}] {nb}x{qd.shape[1]} queries probe "
                f"{params.probe} rerank {params.rerank} topk {topk} (a shard: "
                f"probe {lp.probe} rerank {lp.rerank}): recall@{topk} "
                f"{rec:.4f} (unsharded {base_recall:.4f}), QPS "
                f"{r['qps']:.1f}, device {r['device_ms']:.3f} ms/batch (CUDA "
                f"events), host enqueue {r['enqueue_ms']:.3f} ms/batch, one "
                f"profiled batch busy {prof['busy_ms']:.3f} ms (the card "
                f"idle {100 * prof['idle']:.1f}% of it); "
                f"launches {r['counts']} = {s} a kernel a batch{extra}. "
                f"{s} shards on one card: S times the launches of one "
                f"search, not a scaling figure [{smi}]")
            if s == 4 and not exact:
                kept = dict(sidx=sidx, mesh=mesh, run=r)
        if torch.cuda.device_count() >= s > 1:
            mesh_c = tp.make_mesh(s)
            sidx_c = shard_timed(tp, sift_cpu, mesh_c, f"{label} a card each")
            r = sharded_run(tp, sidx_c, mesh_c, qd, params, False)
            assert_shard_launches(r["counts"], s, nb, f"{label} a card each")
            log(f"[{label} a card each] recall@{topk} "
                f"{recall_of(r['ids'].to(dev), truth):.4f}, QPS "
                f"{r['qps']:.1f} [{smi}]")
            del sidx_c
        elif s > 1:
            log(f"[{label} a card each] skipped: {torch.cuda.device_count()} "
                f"card(s) visible, one shard a card needs {s}")
        if s != 4:
            del sidx
        gc.collect()
        torch.cuda.empty_cache()
    del xb
    kept["counts"] = counts
    return kept


def shard_store_phase(tp, dev, smi, sift, saved, shard):
    """[sift shard store]: the saved base-less index sharded at S = 4, an
    MmapStore over the saved base.fvecs and shard_global_positions."""
    import rabitq_tpu_torch.store.vector_store as vs
    from rabitq_tpu_torch.index.serialize import load_from_dir
    from rabitq_tpu_torch.store import MmapStore

    mesh, ref = shard["mesh"], shard["run"]
    qd, params = sift["qd"], sift["params"]
    nb = qd.shape[0]
    lean = load_from_dir(saved, keep_base=False, device="cpu")
    sidx = tp.shard_index(lean, mesh)
    gpos = tp.shard_global_positions(lean, mesh.size)
    store = MmapStore(saved / "base.fvecs")
    copies = [0]
    real = vs._to_host

    def counted(*ts):
        copies[0] += 1
        return real(*ts)

    tp.sharded_search_with_store(sidx, qd[0], params, mesh, store, gpos)
    vs._to_host = counted
    try:
        copies[0] = 0
        t0 = time.perf_counter()
        out, counts = run_captured(lambda: [
            tp.sharded_search_with_store(sidx, q, params, mesh, store, gpos)
            for q in qd])
        wall = time.perf_counter() - t0
        n_copies = copies[0]
        syncs = count_syncs(lambda: tp.sharded_search_with_store(
            sidx, qd[1], params, mesh, store, gpos))
    finally:
        vs._to_host = real
    assert_shard_launches(counts, mesh.size, nb, "sift shard store",
                          gather=False)
    if n_copies != nb:
        raise AssertionError(f"[sift shard store] {n_copies} host copies for "
                             f"{nb} batches on one device")
    dists = np.concatenate([d for d, _ in out])
    ids = np.concatenate([i for _, i in out])
    same = assert_near_reference("sift shard store", ids, dists,
                                 ref["ids"].cpu().numpy(),
                                 ref["dists"].cpu().numpy())
    rec = recall_of(torch.from_numpy(ids.astype(np.int64)).to(dev),
                    sift["truth"])
    log(f"[sift shard store] S={mesh.size} base-less shards on cuda:0, one "
        f"MmapStore over the saved base.fvecs through "
        f"shard_global_positions: {nb} batches, QPS {nb * qd.shape[1] / wall:.1f}, "
        f"recall@{params.topk} {rec:.4f}; ids equal to sharded_search's on "
        f"{same:.5f} of slots (the rest near-ties); {n_copies} copies to the "
        f"host ({n_copies / nb:g} a batch, one device), {syncs} host syncs "
        f"in one batch (sync debug 'warn'); launches {counts} [{smi}]")
    del sidx, lean
    return counts


def shard_build_phase(tp, dev, smi, sift, shard):
    """[sift shard build]: build_index_sharded at S = 4 with the sift
    centroids and generator against shard_index(build_index(...)), bit for
    bit."""
    mesh, ref = shard["mesh"], shard["sidx"]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    new = tp.build_index_sharded(
        sift["base"], sift["centroids"], mesh, bits=4, spill=0.2,
        balance=1.5, generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if (new.k_max, new.rows_max, new.tiles_max) != (
            ref.k_max, ref.rows_max, ref.tiles_max):
        raise AssertionError("[sift shard build] padded shapes differ")
    for (si, a), (_, b) in zip(new.local(), ref.local()):
        for f in ("codes", "factors", "offsets", "map_ids", "centroids_rot",
                  "orthogonal", "rand_bias", "base"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"[sift shard build] shard {si} {f}")
    log(f"[sift shard build] build_index_sharded S={mesh.size} on cuda:0: "
        f"{secs:.2f}s; bit-equal (codes, factors, offsets, map_ids, "
        f"centroids, rotation, dither, base) to shard_index(build_index()) "
        f"of the sift path, whose build_index took {sift['build_s']:.2f}s "
        f"[{smi}]")
    del new


def shard_ckpt_phase(tp, smi, sift, shard, work):
    """[sift shard ckpt]: dump_index_sharded / load_index_sharded at S = 4;
    the round trip bit-identical, the search equal. Returns the directory
    and the launch counts."""
    mesh, sidx, ref = shard["mesh"], shard["sidx"], shard["run"]
    path = work / "shard_ckpt"
    t0 = time.perf_counter()
    tp.dump_index_sharded(sidx, path)
    dump_s = time.perf_counter() - t0
    nbytes = sum(f.stat().st_size for f in path.rglob("*") if f.is_file())
    t0 = time.perf_counter()
    loaded = tp.load_index_sharded(path, mesh)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for (si, a), (_, b) in zip(loaded.local(), sidx.local()):
        for f in dataclasses.fields(a):
            x, y = getattr(a, f.name), getattr(b, f.name)
            if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
                if x is None or y is None or not torch.equal(x, y):
                    raise AssertionError(f"[sift shard ckpt] shard {si} "
                                         f"{f.name}")
            elif x != y:
                raise AssertionError(f"[sift shard ckpt] shard {si} {f.name}")
    r = sharded_run(tp, loaded, mesh, sift["qd"], sift["params"], False)
    if not (torch.equal(r["ids"], ref["ids"])
            and torch.equal(r["dists"], ref["dists"])):
        raise AssertionError("[sift shard ckpt] search differs after the "
                             "round trip")
    log(f"[sift shard ckpt] dump_index_sharded S={mesh.size} {dump_s:.2f}s "
        f"({nbytes / 1e9:.3f} GB), load_index_sharded onto cuda:0 "
        f"{load_s:.2f}s; every shard bit-identical, sharded_search of the "
        f"{r['ids'].shape[0]} queries equal in ids and distances [{smi}]")
    del loaded
    return path, r["counts"]


def shard_service_phase(tp, dev, smi, sift, shard, ckpt):
    """[sift shard service]: a mesh BatchingEngine on the S = 4 index
    behind a ServiceHTTPServer in a thread: /query_bin_batch frames, single
    /query_bin requests from threads, a 10% allowlist, /admin/reload of the
    checkpoint under 8 querying threads. Returns the launch counts."""
    import concurrent.futures as cf

    from rabitq_tpu_torch.service import client
    from rabitq_tpu_torch.service.server import (
        BatchingEngine, ServiceHTTPServer, make_handler)

    cfg = SERVICE
    mesh, sidx = shard["mesh"], shard["sidx"]
    probe, topk = SIFT["probe"], SIFT["topk"]
    engine = BatchingEngine(sidx, mesh=mesh, max_batch=cfg["max_batch"],
                            window_ms=cfg["window_ms"])
    srv = ServiceHTTPServer(("127.0.0.1", 0), make_handler(
        engine, default_probe=probe, default_topk=topk, allow_reload=True))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_port}"

    def post_json(path, payload):
        return post_json_to(url, path, payload)

    n_b, n_q = cfg["frames"] * cfg["frame"], cfg["bin"]
    rows = sift["flat_q"][: n_b + n_q]
    q_host = rows.cpu().numpy()
    params = engine._make_params(topk, probe)
    ref = [tp.sharded_search(sidx, rows[a : a + 256], params, mesh)
           for a in range(0, rows.shape[0], 256)]
    ref_d = torch.cat([d for d, _ in ref]).cpu().numpy()
    ref_i = torch.cat([i for _, i in ref]).cpu().numpy()
    try:
        client.query_once_bin(url, q_host[0], topk, probe)  # untimed

        def traffic():
            ids = np.empty((rows.shape[0], topk), np.int64)
            lat = {"bin_batch": [], "bin": []}
            t0 = time.perf_counter()
            for f in range(cfg["frames"]):
                a = f * cfg["frame"]
                i, _, dt = client.query_batch_bin(
                    url, q_host[a : a + cfg["frame"]], topk, probe)
                ids[a : a + cfg["frame"]] = i
                lat["bin_batch"].append(dt)
            wall = {"bin_batch": time.perf_counter() - t0}

            def one(j):
                got, _, dt = client.query_once_bin(url, q_host[n_b + j],
                                                   topk, probe)
                return j, got, dt

            t0 = time.perf_counter()
            with cf.ThreadPoolExecutor(cfg["threads"]) as pool:
                for j, got, dt in pool.map(one, range(n_q)):
                    ids[n_b + j] = got
                    lat["bin"].append(dt)
            wall["bin"] = time.perf_counter() - t0
            return ids, lat, wall

        (ids, lat, wall), counts = run_captured(traffic)
        calls = counts["rough_scan calls"]
        if not (calls and calls % mesh.size == 0 and counts["quantize"]
                == counts["rough_scan"] == counts["gather_l2"] == calls):
            raise AssertionError(f"[sift shard service] launches {counts}")
        dists = ((sift["base"][ids] - q_host[:, None, :]) ** 2).sum(-1)
        same = assert_near_reference("sift shard service", ids, dists,
                                     ref_i, ref_d)
        rec = recall_of(torch.from_numpy(ids).to(dev),
                        sift["truth"][: rows.shape[0]])
        if rec < MIN_RECALL:
            raise AssertionError(f"[sift shard service] recall {rec:.4f}")
        log(f"[sift shard service] a mesh engine, S={mesh.size} on cuda:0 "
            f"(max_batch {cfg['max_batch']}, window {cfg['window_ms']} ms, "
            f"rerank {params.rerank}): /query_bin_batch {cfg['frames']} "
            f"frames of {cfg['frame']} QPS {n_b / wall['bin_batch']:.1f} (a "
            f"frame {percentiles(lat['bin_batch'])}); /query_bin {n_q} from "
            f"{cfg['threads']} threads QPS {n_q / wall['bin']:.1f} "
            f"({percentiles(lat['bin'])}); {calls // mesh.size} device "
            f"calls, each launching quantize, rough_scan and gather_l2 once "
            f"a shard; ids equal to sharded_search at the engine's params "
            f"on {same:.5f} of slots (the rest near-ties); recall@{topk} "
            f"{rec:.4f} [{smi}]")

        n_ids = int(sift["index"].map_ids.max()) + 1
        allow = np.random.default_rng(4).choice(n_ids, n_ids // 10,
                                                replace=False)
        st, body = post_json("/filters", dict(name="tenth",
                                              allow_ids=allow.tolist()))
        if st != 200:
            raise AssertionError(f"[sift shard service filter] {st} {body}")
        t0 = time.perf_counter()
        st, body = post_json("/query", dict(
            query=q_host[:256].tolist(), top_k=topk, probe=probe,
            filter="tenth"))
        f_s = time.perf_counter() - t0
        got = np.concatenate([np.asarray(r, np.int64) for r in body["ids"]])
        if st != 200 or got.size == 0 or not np.isin(got, allow).all():
            raise AssertionError("[sift shard service filter] an id not "
                                 "allowed, or none")
        log(f"[sift shard service filter] a 10% allowlist ({allow.size} ids;"
            f" each shard's penalty from its own map_ids); one JSON POST of "
            f"256 rows with it {f_s * 1e3:.1f} ms: {got.size} ids, every one "
            f"allowed")

        st, body, reload_s, done = reload_under_load(
            url, q_host[:n_b], topk, probe, cfg["reload_threads"], ckpt,
            "sift shard service reload")
        if st != 200 or engine.index is sidx:
            raise AssertionError(f"[sift shard service reload] {st} {body}")
        log(f"[sift shard service reload] POST /admin/reload of the sharded "
            f"checkpoint took {reload_s:.2f}s while "
            f"{cfg['reload_threads']} threads sent {done} /query_bin "
            f"requests: none failed; {body} [{smi}]")
    finally:
        srv.shutdown()
        srv.server_close()
        engine.close()
    return counts


def multihost_phase(smi):
    """[multihost]: the two-process world on the card (gloo)."""
    from rabitq_tpu_torch.tools import multihost_demo

    t0 = time.perf_counter()
    outs = multihost_demo.run(device="cuda", backend="gloo")
    secs = time.perf_counter() - t0
    if sum(o.count("PARITY OK") for o in outs) != multihost_demo.NPROC:
        raise AssertionError(f"[multihost] {outs}")
    log(f"[multihost] {multihost_demo.NPROC} processes, one torch.distributed "
        f"world (backend gloo, chosen explicitly: NCCL needs one card a rank "
        f"and both ranks share cuda:0 here), {multihost_demo.SHARDS} shards "
        f"on cuda:0, 2 a process: every process PARITY OK against the "
        f"one-process sharded search ({secs:.1f}s with both processes' "
        f"start-up) [{smi}]")


def dryrun_phase(dev, smi):
    """[dryrun]: graft_entry.dryrun_multichip(4, devices=[cuda:0] * 4).
    Returns the launch counts."""
    from rabitq_tpu_torch.graft_entry import dryrun_multichip

    t0 = time.perf_counter()
    line, counts = run_captured(lambda: dryrun_multichip(4, devices=[dev] * 4))
    log(f"[dryrun] {time.perf_counter() - t0:.1f}s: {line} [{smi}]")
    return counts


def kmeans_tree_phase(rt, dev, smi, sift):
    """[kmeans tree]: hierarchical_kmeans(T=64, D=64) on the sift sample,
    then the sift build and search with its centroids. Returns the launch
    counts."""
    from rabitq_tpu_torch.kmeans import hierarchical_kmeans

    base = sift["base"]
    rng = np.random.default_rng(1)
    sample = base[rng.choice(base.shape[0], TRAIN_CAP, replace=False)]
    t0 = time.perf_counter()
    cents = hierarchical_kmeans(
        sample, 64, 64, iters=KMEANS_ITERS, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    tree_s = time.perf_counter() - t0
    if tuple(cents.shape) != (K, base.shape[1]) or not torch.isfinite(
            cents).all():
        raise AssertionError(f"[kmeans tree] centroids {tuple(cents.shape)}")
    t0 = time.perf_counter()
    index = rt.build_index(
        base, cents, bits=4, spill=0.2, balance=1.5, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    res = timed_search_many(rt, index, sift["qd"], sift["params"])
    rec = recall_of(res["ids"], sift["truth"])
    if rec < 0.90:
        raise AssertionError(f"[kmeans tree] recall@10 {rec:.4f} < 0.90")
    log(f"[kmeans tree] hierarchical_kmeans T=64 x D=64 on {TRAIN_CAP} rows "
        f"({KMEANS_ITERS} iters): {tree_s:.2f}s (flat k-means k={K}: "
        f"{sift['kmeans_s']:.2f}s); build_index {build_s:.2f}s (n "
        f"{index.n}, k {index.k}, capacity {index.capacity}); search_many "
        f"at the sift params: recall@10 {rec:.4f} (flat k-means "
        f"{sift['on']['recall']:.4f}), QPS {res['qps']:.1f} [{smi}]")
    del index
    return res["counts"]


# The reduced-precision options. [gist rerank bf16] also runs at a rerank
# budget whose auto refine (max(4 topk, 32) = 400 at topk 100) keeps fewer
# rows than R; [sift rerank bf16] at the budget of the TPU measurement that
# found the option negative (DESIGN.md:364-373).
GIST_WIDE_RERANK = 800
SIFT_BF16_RERANK = 140
# [<path> rerank bf16]: (variant, SearchParams changes, launches a batch of
# the gather_l2 kernel's (bf16, f32) instances).
GIST_BF16_BUDGETS = (
    ("f32", {}, (0, 1)),
    ("bf16 auto refine", dict(rerank_bf16=True), (1, 1)),
    ("bf16 refine 0", dict(rerank_bf16=True, rerank_refine=0), (1, 0)),
    (f"rerank {GIST_WIDE_RERANK} f32", dict(rerank=GIST_WIDE_RERANK), (0, 1)),
    (f"rerank {GIST_WIDE_RERANK} bf16 auto refine",
     dict(rerank=GIST_WIDE_RERANK, rerank_bf16=True), (1, 1)),
)
SIFT_BF16_BUDGETS = (
    ("f32", dict(rerank=SIFT_BF16_RERANK), (0, 1)),
    ("bf16 auto refine", dict(rerank=SIFT_BF16_RERANK, rerank_bf16=True),
     (1, 1)),
)
# Bits a packed id: the sift corpus's ids are below its 1M rows.
SIFT_ID_BITS = 20


def profile_stages(rt, index, q, params, stages, label):
    """One search batch under the profiler, each function of the search
    module named in ``stages`` ({label: name}) inside a record_function
    range of its label. Returns the batch's device busy ms, each stage's
    device ms of torch's kernels launched under its range (the profiler
    does not tie a kernel launched through ctypes to its range: the
    package's kernels are read by name from the third value) and {kernel
    name: (ms, launches)} of the batch."""
    from torch.profiler import record_function

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    saved = {name: getattr(tsearch, name) for name in stages.values()}

    def ranged(lbl, fn):
        def call(*args, **kwargs):
            with record_function(lbl):
                return fn(*args, **kwargs)
        return call

    torch.cuda.synchronize()
    for lbl, name in stages.items():
        setattr(tsearch, name, ranged(lbl, saved[name]))
    try:
        with settled_profile() as prof:
            rt.search(index, q, params)
            torch.cuda.synchronize()
    finally:
        for name, fn in saved.items():
            setattr(tsearch, name, fn)
    ops = device_ops(prof)
    busy = sum(t for _, t, _ in ops)
    stage_ms = {lbl: sum(us for _, us in stage_kernels(stage_event(prof, lbl)))
                / 1e3 for lbl in stages}
    if busy <= 0 or min(stage_ms.values()) <= 0:
        raise ProfileLostRecords(f"[profile {label}] busy {busy}, stages "
                                 f"{stage_ms}")
    return busy, stage_ms, {k: (t, c) for k, t, c in ops}


def kernel_ms_of(kernels, part):
    return sum(t for k, (t, _) in kernels.items() if part in k)


def rerank_run(rt, index, path, params, label, launches):
    """search_many of the path's queries at ``params`` (timed_batches,
    launch counts from 0 just before it), recall, and one profiled batch:
    busy ms, the rerank stage's ms and its two gather_l2 instances'.
    ``launches`` = (bf16 instance, f32 instance) launches a batch, checked
    with one quantize and one scan launch a batch."""
    qd, nb = path["qd"], path["qd"].shape[0]
    res = timed_search_many(rt, index, qd, params)
    res["recall"] = recall_of(res["ids"], path["truth"])
    c = res["counts"]
    want = (nb * launches[0], nb * launches[1])
    if (c["rough_scan calls"] != nb or c["quantize"] != nb
            or c["rough_scan"] != nb
            or (c["gather_l2 bf16"], c["gather_l2"]) != want):
        raise AssertionError(f"[{label}] launches {c}, gather_l2 bf16 and "
                             f"f32 {want} wanted")
    busy, stage, kernels = retry_lost_records(lambda: profile_stages(
        rt, index, qd[1], params, {RERANK_STAGE: "_exact_rerank"}, label),
        label)
    bf16_ms = kernel_ms_of(kernels, GATHER_BF16)
    f32_ms = kernel_ms_of(kernels, GATHER_F32)
    # The stage: torch's kernels under its range and the gather kernels.
    res.update(busy_ms=busy, rerank_ms=stage[RERANK_STAGE] + bf16_ms + f32_ms,
               bf16_ms=bf16_ms, f32_ms=f32_ms)
    if (res["bf16_ms"] > 0) != bool(launches[0]) or (
            res["f32_ms"] > 0) != bool(launches[1]):
        raise ProfileLostRecords(f"[{label}] gather_l2 records: bf16 "
                                 f"{res['bf16_ms']} f32 {res['f32_ms']}")
    return res


def rerank_bf16_phase(rt, dev, smi, label, path, budgets):
    """The two-level rerank on ``path``'s index at its checked probe:
    f32 and the variants of ``budgets`` ([(variant, params changes,
    (bf16, f32) launches a batch)]). Every run: recall >= MIN_RECALL,
    every returned distance its id's (f32 rows; the bf16 rows at refine
    0), the launches; one batch of each bf16 variant under sync debug mode
    "error". Logs recall, device / busy ms a batch and the rerank stage's
    ms with its kernels', and the bf16 copy's device memory. Returns
    {variant: run} and the copy's GB."""
    from rabitq_tpu_torch.index.index import with_bf16_base

    t0 = time.perf_counter()
    index, p, qd = path["index"], path["params"], path["qd"]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    bf = with_bf16_base(index)
    torch.cuda.synchronize()
    copy_gb = (torch.cuda.memory_allocated() - before) / 1e9
    flat_q = path["flat_q"]
    xb = torch.from_numpy(path["base"]).to(dev)
    runs = {}
    for variant, change, launches in budgets:
        params = p._replace(**change)
        idx = bf if params.rerank_bf16 else index
        r = rerank_run(rt, idx, path, params, f"{label} {variant}", launches)
        rows = (xb.to(torch.bfloat16).to(torch.float32)
                if params.rerank_bf16 and params.rerank_refine == 0 else xb)
        assert_exact_distances(rows, flat_q, r["ids"], r["dists"],
                               f"{label} {variant}")
        del rows
        if r["recall"] < MIN_RECALL:
            raise AssertionError(f"[{label} {variant}] recall "
                                 f"{r['recall']:.4f} < {MIN_RECALL}")
        if params.rerank_bf16:
            check_no_host_sync(rt, idx, qd[1], params, f"{label} {variant}")
        runs[variant] = r
        log(f"[{label} {variant}] probe {params.probe} rerank "
            f"{params.rerank} topk {params.topk} rerank_bf16 "
            f"{params.rerank_bf16} refine {params.rerank_refine}: recall@"
            f"{params.topk} {r['recall']:.4f}, device {r['device_ms']:.4f} "
            f"ms/batch (CUDA events; enqueue {r['enqueue_ms']:.4f}), one "
            f"profiled batch busy {r['busy_ms']:.4f} ms, rerank stage "
            f"{r['rerank_ms']:.4f} ms (gather_l2 bf16 {r['bf16_ms']:.4f}, "
            f"f32 {r['f32_ms']:.4f} ms), launches {r['counts']} [{smi}]")
    del xb, bf
    f32 = runs["f32"]
    def against_f32(v, r):
        return (f"{v}: recall {r['recall']:.4f} "
                f"({r['recall'] - f32['recall']:+.4f}), busy "
                f"{r['busy_ms']:.4f} ms ({r['busy_ms'] - f32['busy_ms']:+.4f}"
                f"), rerank stage {r['rerank_ms']:.4f} ms")

    log(f"[{label}] the bf16 copy {copy_gb:.3f} GB of device memory; "
        + "; ".join(against_f32(v, r) for v, r in runs.items())
        + f"; phase {time.perf_counter() - t0:.1f}s [{smi}]")
    return runs, copy_gb


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


def profile_ranking(rt, index, q, params, label):
    """One profiled search batch (profile_stages) with _rank_terms inside
    RANK_STAGE: the batch's busy ms, its {kernel: (ms, launches)} and the
    ranking's device ms in it, the terms' kernels under the range plus
    the one probe_rank launch, read by name (ctypes)."""
    busy, stage, kernels = profile_stages(
        rt, index, q, params, {RANK_STAGE: "_rank_terms"}, label)
    ranked = [(t, c) for k, (t, c) in kernels.items()
              if PROBE_RANK_KERNEL in k]
    if len(ranked) != 1 or ranked[0][1] != 1:
        raise ProfileLostRecords(f"[profile {label}] probe_rank kernel "
                                 f"launches {ranked}")
    return busy, kernels, stage[RANK_STAGE] + ranked[0][0]


def gist_rank_default_phase(rt, dev, smi, gist):
    """rank_precision "default" (one bf16 pass) against "highest" at the
    gist path's checked probe: the pass on the card against the fp32
    product of the bf16-rounded operands, the share of (query, probed
    cluster) choices that differ, and per precision (run highest,
    default, default, highest) recall@100 >= MIN_RECALL, the launches,
    device ms a batch and one profiled batch's busy ms and ranking stage
    (the distance terms: norms and GEMM; the probe_rank kernel forms the
    key from them)."""
    from rabitq_tpu_torch.ops import pairwise_l2sq, rotate
    from rabitq_tpu_torch.ops.distances import bf16_gemm_route

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    t0 = time.perf_counter()
    index, p, qd = gist["index"], gist["params"], gist["qd"]
    lo = p._replace(rank_precision="default")
    route = bf16_gemm_route(dev)
    y = rotate(tsearch._prep_queries(index, gist["flat_q"]), index.orthogonal)
    c = index.centroids_rot
    got = pairwise_l2sq(y, index.centroids_rot, lo.rank_precision)
    yb, cb = (t.to(torch.bfloat16).to(torch.float32) for t in (y, c))
    xx, cc = (y * y).sum(1, keepdim=True), (c * c).sum(1)
    model = torch.clamp(xx - 2.0 * (yb @ cb.T) + cc[None, :], min=0.0)
    scale = float(xx.max() + cc.max())
    err = float((got - model).abs().max())
    if err > 1e-5 * scale:
        raise AssertionError(f"[gist rank default] the bf16 pass is off "
                             f"the model by {err} (scale {scale})")
    probe = p.probe
    chosen = []
    for params in (p, lo):
        cids = tsearch._rank_clusters(
            index, tsearch._rank_terms(index, y, params), probe, params)
        chosen.append(torch.zeros_like(got, dtype=torch.bool).scatter_(
            1, cids, True))
    differ = float((chosen[0] & ~chosen[1]).sum()) / (y.shape[0] * probe)
    del got, model, yb, cb, chosen
    y1 = y[: qd.shape[1]].contiguous()  # one batch's rotated queries
    runs = {"highest": [], "default": []}
    for prec in ("highest", "default", "default", "highest"):
        params = p._replace(rank_precision=prec)
        rank_ms, rank_kernels = retry_lost_records(
            lambda: device_ms_by_kernel(
                lambda: tsearch._rank_terms(index, y1, params)),
            f"gist rank {prec} stage")
        r = timed_search_many(rt, index, qd, params)
        r["recall"] = recall_of(r["ids"], gist["truth"])
        assert_path_launches(r["counts"], f"gist rank {prec}", qpack=True)
        if r["recall"] < MIN_RECALL:
            raise AssertionError(f"[gist rank {prec}] recall "
                                 f"{r['recall']:.4f} < {MIN_RECALL}")
        busy, kernels, ranked_ms = retry_lost_records(
            lambda: profile_ranking(rt, index, qd[1], params,
                                    f"gist rank {prec}"),
            f"gist rank {prec}")
        gemm = max(rank_kernels.items(), key=lambda kv: kv[1])
        r.update(busy_ms=busy, rank_ms=rank_ms, gemm=gemm, kernels=kernels,
                 ranked_ms=ranked_ms)
        runs[prec].append(r)
    check_no_host_sync(rt, index, qd[1], lo, "gist rank default")

    def pair(key, fmt="{:.4f}"):
        return " | ".join(", ".join(fmt.format(r[key]) for r in runs[k])
                          for k in ("highest", "default"))

    def mean_ms(prec):
        out = {}
        for r in runs[prec]:
            for k, (t, _) in r["kernels"].items():
                out[k] = out.get(k, 0.0) + t / len(runs[prec])
        return out

    hi_k, lo_k = mean_ms("highest"), mean_ms("default")
    moved = sorted(((k, lo_k.get(k, 0.0) - hi_k.get(k, 0.0))
                    for k in hi_k.keys() | lo_k.keys()),
                   key=lambda kv: -abs(kv[1]))[:6]

    log(f"[gist rank default] probe {probe}, highest | default (ran "
        f"highest, default, default, highest): recall@{p.topk} "
        f"{pair('recall')}; device ms/batch {pair('device_ms')}; busy ms "
        f"(one profiled batch) {pair('busy_ms')}, its ranking (terms and "
        f"probe_rank) {pair('ranked_ms')}; ranking stage ms "
        f"{pair('rank_ms')} (the stage alone on one batch's rotated "
        f"queries; its longest kernel: "
        + " | ".join(f"{runs[k][0]['gemm'][0][:70]} "
                     f"{runs[k][0]['gemm'][1]:.4f} ms"
                     for k in ("highest", "default"))
        + f"); {100 * differ:.3f}% of the (query, probed "
        f"cluster) choices differ; GEMM route: {route}; the pass within "
        f"{err:.3g} of the fp32 product of the bf16-rounded operands (scale "
        f"{scale:.1f}); the batch's kernels that moved most, default - "
        f"highest ms: " + "; ".join(f"{k[:60]} {d:+.4f}" for k, d in moved)
        + f"; phase {time.perf_counter() - t0:.1f}s [{smi}]")
    return dict(runs=runs, differ=differ, route=route, err=err)


def sift_packed_phase(rt, dev, smi, sift):
    """search_many_packed of the sift queries at the sift params: the
    unpacked ids equal search_many's exactly; the bytes each copies to the
    host (the port's int64 ids, and the int32 ids JAX returns), the copy
    and unpack times, launches (one of each search kernel a batch)."""
    from rabitq_tpu_torch.ops.idpack import unpack_ids

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    index, p, qd = sift["index"], sift["params"], sift["qd"]
    words, counts = run_captured(lambda: tsearch.search_many_packed(
        index, qd, p, SIFT_ID_BITS))
    assert_path_launches(counts, "sift packed", qpack=False)
    _, ids = rt.search_many(index, qd, p)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_words = words.cpu()
    words_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_ids = ids.cpu()
    ids_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = unpack_ids(host_words, SIFT_ID_BITS, ids.numel())
    unpack_s = time.perf_counter() - t0
    if not np.array_equal(out, host_ids.numpy().reshape(-1)):
        raise AssertionError("[sift packed] unpacked ids differ from "
                             "search_many's")
    packed_b, int32_b = host_words.numel() * 4, host_ids.numel() * 4
    log(f"[sift packed] {ids.numel()} ids at {SIFT_ID_BITS} bits: equal to "
        f"search_many's; packed {packed_b} bytes, the port's int64 ids "
        f"{2 * int32_b} bytes, as int32 (JAX's) {int32_b} bytes "
        f"({100 * (1 - packed_b / int32_b):.1f}% fewer); copy to the host "
        f"{1e3 * words_s:.3f} ms packed, {1e3 * ids_s:.3f} ms int64; unpack "
        f"{1e3 * unpack_s:.3f} ms (host numpy); launches {counts} [{smi}]")
    return dict(packed_bytes=packed_b, int64_bytes=2 * int32_b,
                counts=counts)


# bench.py's other configurations, each through the benchmark twin's
# runner at full size: whether the path packs the query operand (None: no
# gather_l2 either, the store tier reranks on the host).
BENCH_PHASES = {"gist": True, "gist200k": True, "blobs": False,
                "service": False, "deep10m": None}


def bench_phase(dev, smi, name):
    """``python -m rabitq_tpu_torch.tools.bench --config <name>`` in this
    process: its JSON line, then recall >= MIN_RECALL at the chosen probe
    (both protocols of the service), the block cache's faults injected and
    absorbed (deep10m: the runner raises when its ids differ from the mmap
    store's), and each search kernel launched once a scan call (no
    gather_l2 on the store tier). Returns the launch counts."""
    from rabitq_tpu_torch.tools import bench

    args = bench.parse_args(["--config", name])
    t0 = time.perf_counter()
    (line, _), counts = run_captured(lambda: bench.run(args, dev))
    seconds = time.perf_counter() - t0
    log(json.dumps(line))
    detail = line["detail"]
    recalls = [detail["recall"]]
    if name == "service":
        recalls.append(detail["recall_batched"])
    if min(recalls) < MIN_RECALL:
        raise AssertionError(f"[bench {name}] recall {recalls} < "
                             f"{MIN_RECALL}")
    qpack = BENCH_PHASES[name]
    if qpack is None:
        if detail["transients_injected"] <= 0:
            raise AssertionError(f"[bench {name}] no fault injected")
        calls = counts["rough_scan calls"]
        if not calls or counts["quantize"] != calls or (
                counts["rough_scan"] != calls or counts["gather_l2"]):
            raise AssertionError(f"[bench {name}]: launches {counts}")
    else:
        assert_path_launches(counts, f"bench {name}", qpack=qpack)
    log(f"[bench {name}] {line['metric']} = {line['value']} {line['unit']} "
        f"in {seconds:.1f}s (data, k-means, build, sweep and timing), "
        f"recall {recalls}, launches {counts} [{smi}]")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    import rabitq_tpu_torch as rt
    import rabitq_tpu_torch.parallel as tp

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

    # 4. The int4 probe.
    int4 = int4_phase(dev, smi)

    # 5. The sift main path.
    sift = search_path(rt, dev, smi, "sift", SIFT, (SIFT["probe"],),
                       SIFT["probe"], MIN_RECALL)
    sift_on, sift_off = sift["on"], sift["off"]
    sift_cpu_agreement(rt, sift["index"], sift["params"], sift["flat_q"],
                       sift_on["ids"], sift_on["dists"], SIFT["topk"])
    path_counts = {}
    # The two-level rerank at rerank 140, and the packed ids.
    sift_bf16, _ = rerank_bf16_phase(rt, dev, smi, "sift rerank bf16", sift,
                                     SIFT_BF16_BUDGETS)
    path_counts["sift rerank bf16"] = sift_bf16["bf16 auto refine"]["counts"]
    path_counts["sift packed"] = sift_packed_phase(rt, dev, smi,
                                                   sift)["counts"]
    gc.collect()
    torch.cuda.empty_cache()

    # 6-8. Filters, adaptive search and autotune on the sift index.
    sift_filter = sift_filter_phase(rt, dev, smi, sift)
    path_counts["sift filter"] = {
        key: sum(r["counts"][key] for r in sift_filter.values())
        for key in sift_on["counts"]}
    adaptive = adaptive_phase(rt, dev, smi, sift)
    path_counts["sift adaptive"] = adaptive["centroid"]["counts"]
    separated_certificate(rt, dev, smi)
    tuned = autotune_phase(rt, dev, smi, sift)
    path_counts["sift autotune"] = tuned["counts"]

    # 9-13. The sift index saved and loaded; the store tier and the
    # service on it; the CLI on the sift data; mutations.
    work = Path(tempfile.mkdtemp(prefix="rabitq_smoke_"))
    try:
        saved = saved_phase(rt, dev, smi, sift, work)
        store = store_phase(rt, dev, smi, sift, saved, work)
        path_counts["sift store"] = store["counts"]
        service = service_phase(rt, dev, smi, sift, saved, store.pop("lean"))
        path_counts["sift service"] = service["counts"]
        cli_runs = cli_phase(dev, smi, sift, saved, work, MIN_RECALL)
        mutate = mutate_phase(rt, dev, smi, sift, work)
        path_counts["sift mutate"] = mutate["counts"]

        # 14-17. The sift index sharded over S shards of the card; the
        # two-process world; the dry run; hierarchical k-means.
        t_shard = time.perf_counter()
        shard = shard_phase(rt, tp, dev, smi, sift, cpu_copy(sift["index"]))
        path_counts["sift shard"] = shard["counts"]
        path_counts["sift shard store"] = shard_store_phase(
            tp, dev, smi, sift, saved, shard)
        shard_build_phase(tp, dev, smi, sift, shard)
        ckpt, path_counts["sift shard ckpt"] = shard_ckpt_phase(
            tp, smi, sift, shard, work)
        path_counts["sift shard service"] = shard_service_phase(
            tp, dev, smi, sift, shard, ckpt)
        del shard
        gc.collect()
        torch.cuda.empty_cache()
        multihost_phase(smi)
        path_counts["dryrun"] = dryrun_phase(dev, smi)
        path_counts["kmeans tree"] = kmeans_tree_phase(rt, dev, smi, sift)
        log(f"[shard] phases 14-17 took {time.perf_counter() - t_shard:.1f}s")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    del sift, sift_on["ids"], sift_on["dists"]
    del sift_off["ids"], sift_off["dists"]
    gc.collect()
    torch.cuda.empty_cache()

    # 14. The gist path, and a filter on it.
    gist = search_path(rt, dev, smi, "gist", GIST, GIST_PROBES,
                       GIST_CHECK_PROBE, MIN_RECALL)
    gist_on, gist_off = gist["on"], gist["off"]
    gist_filter = gist_filter_phase(rt, dev, smi, gist)
    path_counts["gist filter"] = gist_filter["counts"]
    # The two-level rerank and the bf16 cluster ranking on the gist index.
    gist_bf16, bf16_copy_gb = rerank_bf16_phase(
        rt, dev, smi, "gist rerank bf16", gist, GIST_BF16_BUDGETS)
    for variant, r in gist_bf16.items():
        path_counts[f"gist rerank {variant}"] = r["counts"]
    rank_default = gist_rank_default_phase(rt, dev, smi, gist)
    path_counts["gist rank default"] = rank_default["runs"]["default"][0][
        "counts"]
    del gist
    gist_label = f"gist probe {GIST_CHECK_PROBE}"

    # 19. bench.py's other configurations through the benchmark twin.
    t_bench = time.perf_counter()
    for name in BENCH_PHASES:
        gc.collect()
        torch.cuda.empty_cache()
        path_counts[f"bench {name}"] = bench_phase(dev, smi, name)
    log(f"[bench] phase 19 took {time.perf_counter() - t_bench:.1f}s")

    def launches(name):
        """The main path's launches: the checked probes' default runs."""
        sift, gist = sift_on["counts"][name], gist_on["counts"][name]
        return {"launches": sift + gist,
                "launches_by_path": {
                    "sift": sift, "gist": gist,
                    **{p: c[name] for p, c in path_counts.items()}},
                "launches_fold_off": sift_off["counts"][name]
                + gist_off["counts"][name]}

    def in_search(run, keys=("stage_ms", "kernel_ms", "glue_ms", "bound_ms",
                             "select_ms",
                             "device_ops")):
        return {key: run["scan"][key] for key in keys}

    search_runs = [(f"{path} {mode}", run)
                   for path, runs in (("sift", (sift_on, sift_off)),
                                      (gist_label, (gist_on, gist_off)))
                   for mode, run in zip(("fold on", "fold off"), runs)]

    bf16_runs = [r for runs in (gist_bf16, sift_bf16) for r in runs.values()]
    if not sum(r["counts"]["gather_l2 bf16"] for r in bf16_runs):
        raise AssertionError("the bf16 rerank paths launched no gather_l2 "
                             "bf16 kernel")
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
         "max_abs_err": max(r["max_abs_err"] for r in
                            (*scans.values(), *penalties.values())),
         **{key: main_mode[key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "operands": "sift clusters, fold 2 (search's default mode); ms = "
                     "device time with the L2 cold",
         "modes": modes,
         "penalty_modes": penalty_modes,
         "in_search": {label: in_search(run) for label, run in search_runs}},
        {"name": "quantize_residuals", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/quantize.cu",
         "replaces": "rabitq_tpu/index/search.py:335 (an XLA fusion, with "
                     "the packing at :403; not a Pallas kernel)",
         **launches("quantize"),
         "max_abs_err": max(r["max_abs_err"] for r in quants.values()),
         **{key: quants["gist"][key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "operands": "gist shape (B 1024, probe 80, D 1024, packed); ms = "
                     "device time with the L2 cold; max_abs_err is ycd's",
         "sift_shape": quants["sift"],
         "in_search": {label: in_search(run, ("quantize_ms",
                                               "elementwise_ms"))
                       for label, run in search_runs}},
        {"name": "gather_l2", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/gather_l2.cu",
         "replaces": "rabitq_tpu/ops/rerank_kernel.py:103",
         **launches("gather_l2"),
         "max_abs_err": max(r["max_abs_err"] for r in
                            (gather_gist, gather_sift, gather_sift_cl)),
         **{key: gather_gist[key]
            for key in ("ms", "plain_ms", "bound_ms", "bound_by")},
         "library_ms": None,
         "operands": "gist shape (D 1024, B 1024, R 150); ms = device time "
                     "with the L2 cold; bound_ms counts distinct rows",
         "sift_shape": {"random": gather_sift, "clusters": gather_sift_cl},
         "in_search": {label: in_search(run, ("gather_ms", "gather_bound_ms",
                                               "gather_shape", "gather_rows"))
                       for label, run in search_runs}},
        {"name": "gather_l2_bf16", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/gather_l2.cu",
         "replaces": "rabitq_tpu/index/search.py:793 (the bf16 rerank's "
                     "XLA gather, _gather_l2(..., cast_f32=True) at :735; "
                     "not a Pallas kernel)",
         "launches": sum(r["counts"]["gather_l2 bf16"] for r in bf16_runs),
         "launches_by_path": {p: c["gather_l2 bf16"]
                              for p, c in path_counts.items()
                              if "gather_l2 bf16" in c},
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
                        if k.startswith("sift")},
         "copy_gb_gist": bf16_copy_gb,
         "in_search": {f"{path} {v}": {key: r[key] for key in (
             "bf16_ms", "f32_ms", "rerank_ms", "busy_ms", "recall")}
             for path, runs in (("gist p80", gist_bf16),
                                ("sift p28", sift_bf16))
             for v, r in runs.items()}},
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
         "in_search": {label: in_search(run, ("select_ms",))
                       for label, run in search_runs}},
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
