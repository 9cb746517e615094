#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rabitq_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each or more (a phase that fails raises; the exit code is
then non-zero and no result line is printed):

  1. [env]    torch/CUDA versions and the card's name and power limit;
  2. [build]  nvcc compiles the three kernel sources of
     rabitq_tpu_torch/csrc/ for sm_90a at once (time, ptxas usage);
  3. [kernel] each kernel against its plain PyTorch twin on the card, both
     timed with CUDA events:
       rough_scan at the sift shape (D=128, span=384, S=2048*28) and the
       gist shape (D=1024, span=512, S=1024*80), bit-equal;
       gather_l2 at the gist shape (N=1.2M, D=1024, B=1024, R=150) and
       the sift shape (D=128, B=2048, R=32), with duplicate positions and
       row N-1, to rtol 1e-5 and atol 1e-5 * max|out|;
  4. [int4]   rabitq_tpu_torch.tools.int4probe.run (int4_dot_direct and
     int4_dot_staged equal to the twin and numpy), then both kernels and
     the twin timed at the probe shape and a scan-window shape;
  5. [sift]   the SIFT-like main path at full size: 1M x 128 corpus,
     16,384 queries, k-means (k=4096, 260k sample, 15 iterations),
     build_index(bits=4, spill=0.2, balance=1.5), search_many at probe 28,
     rerank 32, topk 10, batch 2048; brute-force ground truth on the card;
     recall@10 >= 0.93, every rough_scan call launching both search
     kernels; 64 queries re-searched on the CPU path must agree;
  6. [gist]   the GIST-like path at full width: 1M x 960 corpus, 4,096
     queries, k-means (k=4096, 260k sample, 15 iterations), the same
     build, search_many over 4 batches of 1024 at rerank 150, topk 100,
     probes 48/64/80/96; at probe 80 recall@100 >= 0.93, 4 rough_scan
     calls with 4 launches of each search kernel, and every returned
     distance equal to its id's exact distance. Slots without a distinct
     id (a spilled build can index an id twice) are counted and scored
     as misses. One batch of each path is profiled.

Then a JSON line of per-kernel results, the nvidia-smi name/power-limit
line, and last {"ok": true, "device": {...}}. Without a CUDA device the
script exits 1 at once.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import gc
import importlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

# every_id: every result slot must hold an id. Off at topk 100 with
# rerank 150 < 2 * topk, where the spill duplicates among a query's 150
# candidates can leave fewer than 100 distinct ids (-1, +inf slots).
SIFT = dict(n=1_000_000, dim=128, n_centers=1024, nq=16384, probe=28,
            rerank=32, topk=10, batch=2048, every_id=True)
GIST = dict(n=1_000_000, dim=960, n_centers=1024, nq=4096, rerank=150,
            topk=100, batch=1024, every_id=False)
GIST_PROBES, GIST_CHECK_PROBE = (48, 64, 80, 96), 80
K, TRAIN_CAP, KMEANS_ITERS = 4096, 260_000, 15
MIN_RECALL = 0.93
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published peak
KERNEL_SOURCES = ("rough_scan", "gather_l2", "int4_dot")


def log(msg: str) -> None:
    print(msg, flush=True)


def make_dataset(n, dim, n_centers, nq, seed=0, chunk_rows=1 << 16):
    # Same generator as bench.py's make_dataset (a test checks they agree).
    # Low-intrinsic-dimension manifold (like real SIFT/GIST embeddings):
    # a Gaussian mixture in a d_int-dim latent space, linearly embedded in
    # `dim` dims plus small ambient noise. Cluster structure exists (IVF
    # helps) but neighborhoods straddle partition boundaries (probing
    # matters) — matching the nprobe behavior of real datasets.
    # The ambient noise is drawn and added in row chunks (one stream, in
    # order, so the same numbers). Of bench.py's float64 [n + nq, dim]
    # transients only the embedding z @ a remains: it stays one product,
    # as in bench.py, so its rounding cannot depend on a chunking.
    d_int = 16
    rng = np.random.default_rng(seed)
    centers_z = rng.standard_normal((n_centers, d_int)).astype(np.float32)
    lab = rng.integers(0, n_centers, n + nq)
    z = centers_z[lab] + 0.7 * rng.standard_normal((n + nq, d_int)).astype(
        np.float32
    )
    a = rng.standard_normal((d_int, dim)).astype(np.float32) / np.sqrt(d_int)
    za = z @ a
    x = np.empty((n + nq, dim), np.float32)
    for r in range(0, n + nq, chunk_rows):
        rows = slice(r, min(r + chunk_rows, n + nq))
        x[rows] = za[rows] + 0.1 * rng.standard_normal(
            (rows.stop - r, dim)
        ).astype(np.float32)
    return x[:n], x[n:]


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


def scan_operands(dev, n_rows, s, span, dim, seed=0, bits=4):
    """Random kernel operands (codes on the bits-bit grid), with edge cases:
    size 0, size == span, and clusters ending at the last row."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    m = (1 << bits) - 1

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=dev)

    codes = (2 * randint(m + 1, (n_rows, dim)) - m).to(torch.int8)
    factors = torch.randn((n_rows, 4), generator=gen, device=dev)
    factors[:, 3] = factors[:, 3].abs()
    starts = randint(n_rows - span + 1, (s,))
    sizes = randint(span + 1, (s,))
    sizes[0], sizes[1] = 0, span
    starts[2], sizes[2] = n_rows - span, span
    starts[3], sizes[3] = n_rows - 1, 1
    qvals = randint(16, (s, dim)).to(torch.int8)
    scal = torch.randn((s, 4), generator=gen, device=dev)
    scal[:, 1] = scal[:, 1].abs() + 0.01
    scal[:, 2] = qvals.sum(1, dtype=torch.int32).float()
    scal[:, 3] = scal[:, 3].abs()
    return (codes, factors, starts.int(), sizes.int(), qvals, scal)


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


def assert_gather_close(got, want):
    """rtol 1e-5, atol 1e-5 * max|want|: the kernel and the twin sum the
    same f32 squares in different orders. Returns max |got - want|."""
    err = float((got - want).abs().max()) if want.numel() else 0.0
    atol = 1e-5 * float(want.abs().max()) if want.numel() else 0.0
    if not torch.allclose(got, want, rtol=1e-5, atol=atol):
        raise AssertionError(f"gather_l2 kernel != twin: max |diff| {err}")
    return err


def run_captured(fn):
    """fn() with the number of calls it made to the search module's
    rough_scan stage, and the launches of both search kernels, all
    counted from 0 just before fn() and read just after its synchronize."""
    from rabitq_tpu_torch.ops import cuda_gather_l2, cuda_rough_scan

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    stage = tsearch.rough_scan
    calls = 0

    def counted(*args, **kwargs):
        nonlocal calls
        calls += 1
        return stage(*args, **kwargs)

    tsearch.rough_scan = counted
    try:
        cuda_rough_scan.launches = 0
        cuda_gather_l2.launches = 0
        out = fn()
        torch.cuda.synchronize()
    finally:
        tsearch.rough_scan = stage
    return out, {
        "rough_scan calls": calls,
        "rough_scan": cuda_rough_scan.launches,
        "gather_l2": cuda_gather_l2.launches,
    }


def profile_batch(rt, index, q, params, label, smi):
    """Where one batch's device time goes (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.search(index, q, params)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only: a CPU op such as aten::topk also reports the
    # device time of the kernels it launched.
    dev_ops = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
        and e.self_device_time_total > 0
    ]
    busy_ms = sum(t for _, t, _ in dev_ops)
    top = sorted(dev_ops, key=lambda r: -r[1])[:8]
    log(f"[profile {label}] one batch of {q.shape[0]}: wall {wall_ms:.3f} ms, "
        f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%); top: "
        + "; ".join(f"{k[:60]} {t:.3f} ms x{c}" for k, t, c in top)
        + f" [{smi}]")


def build_kernels():
    from rabitq_tpu_torch.ops import _cuda

    with concurrent.futures.ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        builds = list(pool.map(_cuda.build, KERNEL_SOURCES))
    for name, b in zip(KERNEL_SOURCES, builds):
        ptxas = " | ".join(
            ln.strip() for ln in b.log.splitlines() if "ptxas" in ln
        )
        log(f"[build] {b.path.name} nvcc {b.seconds:.2f}s cached={b.cached} "
            f"| {ptxas}")
    log(f"[build] flags {' '.join(_cuda.NVCC_FLAGS)}")


def check_rough_scan(dev, smi, n_rows, s, span, dim, twin_iters):
    from rabitq_tpu_torch.ops import cuda_rough_scan, rough_scan_reference

    ops = scan_operands(dev, n_rows, s, span, dim)
    got = cuda_rough_scan(*ops, span)
    want = rough_scan_reference(*ops, span)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    same_inf = torch.equal(torch.isinf(got), torch.isinf(want))
    max_abs_err = float((got[fin] - want[fin]).abs().max())
    if not (same_inf and torch.equal(got, want)):
        raise AssertionError(
            f"rough_scan kernel != twin at D={dim}: same +inf slots "
            f"{same_inf}, max |diff| {max_abs_err}"
        )
    if not (torch.isinf(got[0]).all() and torch.isfinite(got[1]).all()
            and torch.isfinite(got[2]).all()):
        raise AssertionError("edge cases: size 0 / size == span slots wrong")
    del got, want, fin
    kernel_ms = cuda_ms(lambda: cuda_rough_scan(*ops, span), 20)
    twin_ms = cuda_ms(lambda: rough_scan_reference(*ops, span), twin_iters)
    log(f"[kernel rough_scan] S={s} span={span} D={dim} N={n_rows}: "
        f"bit-equal to twin (max |diff| {max_abs_err}, +inf slots equal); "
        f"kernel {kernel_ms:.4f} ms, twin {twin_ms:.4f} ms per call [{smi}]")
    return dict(max_abs_err=max_abs_err, ms=kernel_ms, plain_ms=twin_ms)


def check_gather_l2(dev, smi, n, dim, b, r):
    from rabitq_tpu_torch.ops import cuda_gather_l2, gather_l2_reference

    base, pos, q = gather_operands(dev, n, dim, b, r, seed=dim)
    got = cuda_gather_l2(base, pos, q)
    want = gather_l2_reference(base, pos, q)
    torch.cuda.synchronize()
    err = assert_gather_close(got, want)
    del got, want
    # Timed as search calls it: without the range check's host sync.
    kernel_ms = cuda_ms(
        lambda: cuda_gather_l2(base, pos, q, check_pos=False), 20
    )
    twin_ms = cuda_ms(lambda: gather_l2_reference(base, pos, q), 3)
    nbytes = b * r * (dim * 4 + 8 + 4) + b * dim * 4
    share = nbytes / (kernel_ms * 1e-3) / HBM_BYTES_PER_S
    log(f"[kernel gather_l2] N={n} D={dim} B={b} R={r}: within rtol 1e-5 / "
        f"atol 1e-5*max of twin (max |diff| {err:.3g}); kernel "
        f"{kernel_ms:.4f} ms, twin {twin_ms:.4f} ms per call; reads+writes "
        f"{nbytes / 1e9:.4f} GB = {100 * share:.1f}% of 3.35 TB/s [{smi}]")
    return dict(max_abs_err=err, ms=kernel_ms, plain_ms=twin_ms)


def int4_phase(dev, smi):
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
        want = torch.from_numpy(want).to(dev)
        twin = int4_dot_reference(a, b)
        if not torch.equal(twin, want):
            raise AssertionError(f"int4 twin != numpy at {label}")
        twin_ms = cuda_ms(lambda: int4_dot_reference(a, b), 5)
        nbytes = (m + n) * k // 2 + m * n * 4
        parts = [f"twin {twin_ms:.4f} ms"]
        for staged, name in ((False, "int4_dot_direct"), (True, "int4_dot_staged")):
            got = cuda_int4_dot(a, b, staged=staged)
            err = float((got - want).abs().max())
            if err:
                raise AssertionError(f"{name} != numpy at {label}: {err}")
            res[name]["max_abs_err"] = max(res[name]["max_abs_err"], err)
            ms = cuda_ms(lambda: cuda_int4_dot(a, b, staged=staged), 20)
            parts.append(f"{name} {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s)")
            if label == "window":
                res[name].update(ms=ms, plain_ms=twin_ms)
        log(f"[int4 {label}] [{m}x{k}] . [{n}x{k}]^T packed: exact; operands "
            f"{(m + n) * k / 2e6:.3f} MB packed ({(m + n) * k / 1e6:.3f} MB "
            f"as int8), {nbytes / 1e6:.3f} MB read+written: "
            + ", ".join(parts) + f" [{smi}]")
    return res


def search_path(rt, dev, smi, label, cfg, probes, check_probe, min_recall):
    """Ground truth, k-means, build and search_many of one configuration
    at each probe; checks the results at ``check_probe`` and returns
    (index, params, queries, flat queries, ids, dists, launch counts)
    of that probe's run."""
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
    torch.cuda.reset_peak_memory_stats()

    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    sample = base[rng.choice(n, TRAIN_CAP, replace=False)]
    centroids = rt.kmeans(
        sample, K, iters=KMEANS_ITERS, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1),
    )
    torch.cuda.synchronize()
    log(f"[{label} kmeans] k={K} on {TRAIN_CAP} rows, {KMEANS_ITERS} iters: "
        f"{time.perf_counter() - t0:.2f}s [{smi}]")
    del sample

    t0 = time.perf_counter()
    index = rt.build_index(
        base, centroids, bits=4, spill=0.2, balance=1.5, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2),
    )
    torch.cuda.synchronize()
    log(f"[{label} build_index] n={index.n} (spilled {index.n - n}) "
        f"k={index.k} dim={index.dim} capacity={index.capacity}: "
        f"{time.perf_counter() - t0:.2f}s [{smi}]")

    checked = None
    for probe in probes:
        params = rt.SearchParams(probe=probe, topk=topk, rerank=cfg["rerank"])
        rt.search(index, qd[0], params)  # warm-up
        torch.cuda.synchronize()
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()

        def run():
            ev0.record()
            out = rt.search_many(index, qd, params)
            ev1.record()
            return out

        (dists, ids), counts = run_captured(run)
        search_s = time.perf_counter() - t0
        device_ms = ev0.elapsed_time(ev1)
        rt.METRICS.reset()
        for q in qd:  # counters (untimed)
            rt.metrics.record_search_stats(
                rt.search_with_stats(index, q, params)[2]
            )
        torch.cuda.synchronize()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ids = ids.reshape(-1, topk)
        dists = dists.reshape(-1, topk)
        hits = (ids[:, :, None] == truth[:, None, :]).any(-1).sum(1)
        recall = float(hits.float().mean() / topk)
        no_id = int((ids < 0).sum())
        log(f"[{label} search] {nb}x{batch} queries probe={probe} "
            f"rerank={cfg['rerank']} topk={topk}: {search_s:.4f}s wall, "
            f"{device_ms:.3f} ms device (CUDA events, "
            f"{device_ms / nb:.3f} ms/batch), QPS {nb * batch / search_s:.1f}, "
            f"recall@{topk} {recall:.4f}, slots without an id {no_id}, "
            f"peak mem {peak_gb:.3f} GB, {rt.METRICS.to_str()}, "
            f"search_many: {counts} [{smi}]")
        if probe != check_probe:
            continue

        # Checks on what came out.
        xb = torch.from_numpy(base).to(dev)
        if tuple(ids.shape) != (nb * batch, topk):
            raise AssertionError(f"ids shape {tuple(ids.shape)}")
        fin = torch.isfinite(dists)
        if not torch.equal(fin, ids >= 0) or (ids >= n).any():
            raise AssertionError("out-of-range ids or id/-1 not matching "
                                 "finite/+inf distances")
        if cfg["every_id"] and no_id:
            raise AssertionError(f"{no_id} result slots without an id")
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
                    "returned distances are not the ids' distances"
                )
        del xb
        if recall < min_recall:
            raise AssertionError(f"recall@{topk} {recall:.4f} < {min_recall}")
        if not (counts["rough_scan"] == counts["gather_l2"]
                == counts["rough_scan calls"] == nb):
            raise AssertionError(
                f"search_many of {nb} batches at probe {probe}: {counts}"
            )
        checked = (index, params, qd, flat_q, ids, dists, counts)
        log(f"[{label} check] probe {probe}: shapes, finite distances equal "
            f"to exact, recall, launches ok")
    if checked is None:
        raise AssertionError(f"probe {check_probe} not among {probes}")
    return checked


def sift_cpu_agreement(rt, index, params, flat_q, ids, dists, topk):
    """The same 64 queries through the CPU path (the kernels' twins)."""
    cpu_index = dataclasses.replace(
        index, **{
            f.name: getattr(index, f.name).cpu()
            for f in dataclasses.fields(index)
            if isinstance(getattr(index, f.name), torch.Tensor)
        },
    )
    d_cpu, i_cpu = rt.search(cpu_index, flat_q[:64].cpu(), params)
    same = i_cpu == ids[:64].cpu()
    agree = float(same.float().mean())
    if agree < 0.98 or not torch.allclose(
        d_cpu[same], dists[:64].cpu()[same], rtol=1e-4, atol=1e-3
    ):
        raise AssertionError(f"CPU path agrees on only {agree:.4f} of ids")
    log(f"[sift check] CPU twin path agrees on {agree:.4f} of 64x{topk} ids")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    import rabitq_tpu_torch as rt

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

    # 3. Kernels against their twins at the paths' shapes.
    scan_sift = check_rough_scan(dev, smi, 1_200_000, 2048 * 28, 384, 128, 3)
    scan_gist = check_rough_scan(dev, smi, 1_200_000, 1024 * 80, 512, 1024, 1)
    gather_gist = check_gather_l2(dev, smi, 1_200_000, 1024, 1024, 150)
    gather_sift = check_gather_l2(dev, smi, 1_200_000, 128, 2048, 32)
    torch.cuda.empty_cache()

    # 4. The int4 probe.
    int4 = int4_phase(dev, smi)

    # 5. The sift main path.
    index, params, qd, flat_q, ids, dists, sift_counts = search_path(
        rt, dev, smi, "sift", SIFT, (SIFT["probe"],), SIFT["probe"],
        MIN_RECALL,
    )
    sift_cpu_agreement(rt, index, params, flat_q, ids, dists, SIFT["topk"])
    profile_batch(rt, index, qd[1], params, "sift", smi)
    del index, qd, flat_q, ids, dists
    gc.collect()
    torch.cuda.empty_cache()

    # 6. The gist path.
    index, params, qd, _, _, _, gist_counts = search_path(
        rt, dev, smi, "gist", GIST, GIST_PROBES, GIST_CHECK_PROBE, MIN_RECALL,
    )
    profile_batch(rt, index, qd[1], params, "gist", smi)
    del index, qd

    def launches(name):
        return {"launches": sift_counts[name] + gist_counts[name],
                "launches_by_path": {"sift": sift_counts[name],
                                     "gist": gist_counts[name]}}

    log(json.dumps({"kernels": [
        {"name": "rough_scan", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/rough_scan.cu",
         "replaces": "rabitq_tpu/ops/scan_kernel.py:621",
         **launches("rough_scan"),
         "max_abs_err": max(scan_sift["max_abs_err"], scan_gist["max_abs_err"]),
         "ms": scan_sift["ms"], "plain_ms": scan_sift["plain_ms"],
         "ms_gist_shape": scan_gist["ms"],
         "plain_ms_gist_shape": scan_gist["plain_ms"]},
        {"name": "gather_l2", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/gather_l2.cu",
         "replaces": "rabitq_tpu/ops/rerank_kernel.py:103",
         **launches("gather_l2"),
         "max_abs_err": max(gather_gist["max_abs_err"],
                            gather_sift["max_abs_err"]),
         "ms": gather_gist["ms"], "plain_ms": gather_gist["plain_ms"],
         "ms_sift_shape": gather_sift["ms"],
         "plain_ms_sift_shape": gather_sift["plain_ms"]},
        {"name": "int4_dot_direct", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/int4_dot.cu",
         "replaces": "tools/int4probe.py:64", **int4["int4_dot_direct"]},
        {"name": "int4_dot_staged", "route": "cuda",
         "source": "rabitq_tpu_torch/csrc/int4_dot.cu",
         "replaces": "tools/int4probe.py:84", **int4["int4_dot_staged"]},
    ]}))
    log(f"[done] {time.perf_counter() - t_start:.1f}s in all")
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
