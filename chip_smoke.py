#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rabitq_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (a phase that fails raises; the exit code is then
non-zero and no result line is printed):

  1. environment: torch/CUDA versions and the card's name and power limit;
  2. build: nvcc compiles rabitq_tpu_torch/csrc/rough_scan.cu for sm_90a
     (time and ptxas resource usage);
  3. kernel vs twin: the rough-scan kernel against its plain PyTorch twin on
     the card at the main path's shapes (D=128, span=384, S=2048*28) plus
     edge cases, required bit-equal; both timed with CUDA events;
  4. main path at full size: the SIFT-like 1M x 128 corpus with 16,384
     queries, k-means (k=4096, 260k sample, 15 iterations),
     build_index(bits=4, spill=0.2, balance=1.5), search_many at probe 28,
     rerank 32, topk 10, batch 2048; brute-force ground truth on the card;
     recall@10 >= 0.93 and every rough_scan call launching the kernel;
     64 queries re-searched on the CPU path must agree.

Then a JSON line of per-kernel results, the nvidia-smi name/power-limit
line, and last {"ok": true, "device": {...}}. Without a CUDA device the
script exits 1 at once.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

N, DIM, N_CENTERS, NQ = 1_000_000, 128, 1024, 16384
K, TRAIN_CAP, KMEANS_ITERS = 4096, 260_000, 15
PROBE, RERANK, TOPK, BATCH = 28, 32, 10, 2048
MIN_RECALL = 0.93


def log(msg: str) -> None:
    print(msg, flush=True)


def make_dataset(n, dim, n_centers, nq, seed=0):
    # Same generator as bench.py's make_dataset (a test checks they agree).
    # Low-intrinsic-dimension manifold (like real SIFT/GIST embeddings):
    # a Gaussian mixture in a d_int-dim latent space, linearly embedded in
    # `dim` dims plus small ambient noise. Cluster structure exists (IVF
    # helps) but neighborhoods straddle partition boundaries (probing
    # matters) — matching the nprobe behavior of real datasets.
    d_int = 16
    rng = np.random.default_rng(seed)
    centers_z = rng.standard_normal((n_centers, d_int)).astype(np.float32)
    lab = rng.integers(0, n_centers, n + nq)
    z = centers_z[lab] + 0.7 * rng.standard_normal((n + nq, d_int)).astype(
        np.float32
    )
    a = rng.standard_normal((d_int, dim)).astype(np.float32) / np.sqrt(d_int)
    x = z @ a + 0.1 * rng.standard_normal((n + nq, dim)).astype(np.float32)
    return x.astype(np.float32)[:n], x.astype(np.float32)[n:]


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    import rabitq_tpu_torch as rt
    from rabitq_tpu_torch.ops import _cuda, cuda_rough_scan, rough_scan_reference

    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    dev = torch.device("cuda", 0)

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
    b = _cuda.build("rough_scan")
    ptxas = " | ".join(
        ln.strip() for ln in b.log.splitlines() if "ptxas" in ln
    )
    log(f"[build] {b.path.name} nvcc {b.seconds:.2f}s cached={b.cached} "
        f"flags {' '.join(_cuda.NVCC_FLAGS)} | {ptxas}")

    # 3. Kernel vs twin on the card at the main path's shapes.
    span, s = 384, BATCH * PROBE
    ops = scan_operands(dev, 1_200_000, s, span, DIM)
    got = cuda_rough_scan(*ops, span)
    want = rough_scan_reference(*ops, span)
    torch.cuda.synchronize()
    fin = torch.isfinite(want)
    same_inf = torch.equal(torch.isinf(got), torch.isinf(want))
    max_abs_err = float((got[fin] - want[fin]).abs().max())
    if not (same_inf and torch.equal(got, want)):
        raise AssertionError(
            f"kernel != twin: same +inf slots {same_inf}, "
            f"max |diff| {max_abs_err}"
        )
    if not (torch.isinf(got[0]).all() and torch.isfinite(got[1]).all()
            and torch.isfinite(got[2]).all()):
        raise AssertionError("edge cases: size 0 / size == span slots wrong")
    kernel_ms = cuda_ms(lambda: cuda_rough_scan(*ops, span), 20)
    twin_ms = cuda_ms(lambda: rough_scan_reference(*ops, span), 3)
    log(f"[kernel] rough_scan S={s} span={span} D={DIM} N=1200000: "
        f"bit-equal to twin (max |diff| {max_abs_err}, +inf slots equal); "
        f"kernel {kernel_ms:.4f} ms, twin {twin_ms:.4f} ms per call "
        f"[{smi}]")
    del ops, got, want, fin

    # 4. Main path at full size.
    t0 = time.perf_counter()
    base, queries = make_dataset(N, DIM, N_CENTERS, NQ)
    log(f"[data] {N}x{DIM} corpus, {NQ} queries in "
        f"{time.perf_counter() - t0:.1f}s (host numpy)")

    scan_calls = 0
    stage_rough_scan = tsearch.rough_scan

    def counted_rough_scan(*args, **kwargs):
        nonlocal scan_calls
        scan_calls += 1
        return stage_rough_scan(*args, **kwargs)

    tsearch.rough_scan = counted_rough_scan
    torch.cuda.reset_peak_memory_stats()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    sample = base[rng.choice(N, TRAIN_CAP, replace=False)]
    centroids = rt.kmeans(
        sample, K, iters=KMEANS_ITERS, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1),
    )
    torch.cuda.synchronize()
    kmeans_s = time.perf_counter() - t0
    log(f"[kmeans] k={K} on {TRAIN_CAP} rows, {KMEANS_ITERS} iters: "
        f"{kmeans_s:.2f}s [{smi}]")

    t0 = time.perf_counter()
    index = rt.build_index(
        base, centroids, bits=4, spill=0.2, balance=1.5, device=dev,
        generator=torch.Generator(device=dev).manual_seed(2),
    )
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"[build_index] n={index.n} (spilled {index.n - N}) k={index.k} "
        f"capacity={index.capacity}: {build_s:.2f}s [{smi}]")
    if index.capacity != span:
        log(f"[build_index] note: capacity {index.capacity} != {span} "
            "assumed by the kernel phase")

    params = rt.SearchParams(probe=PROBE, topk=TOPK, rerank=RERANK)
    nb = NQ // BATCH
    qd = torch.from_numpy(queries[: nb * BATCH]).to(dev).reshape(nb, BATCH, DIM)
    rt.search(index, qd[0], params)  # warm-up
    torch.cuda.synchronize()
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    # The counts cover search_many alone: set just before it, read just
    # after its synchronize.
    cuda_rough_scan.launches = 0
    scan_calls = 0
    t0 = time.perf_counter()
    ev0.record()
    dists, ids = rt.search_many(index, qd, params)
    ev1.record()
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    launches, main_scan_calls = cuda_rough_scan.launches, scan_calls
    tsearch.rough_scan = stage_rough_scan
    device_ms = ev0.elapsed_time(ev1)
    qps = nb * BATCH / search_s
    rt.METRICS.reset()
    for q in qd:  # counters (untimed)
        rt.metrics.record_search_stats(rt.search_with_stats(index, q, params)[2])
    torch.cuda.synchronize()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    xb = torch.from_numpy(base).to(dev)
    flat_q = qd.reshape(-1, DIM)
    truth = torch.cat([
        torch.topk(rt.ops.pairwise_l2sq(flat_q[a : a + 1024], xb), TOPK,
                   largest=False).indices
        for a in range(0, flat_q.shape[0], 1024)
    ])
    ids = ids.reshape(-1, TOPK)
    dists = dists.reshape(-1, TOPK)
    hits = (ids[:, :, None] == truth[:, None, :]).any(-1).sum(1)
    recall = float(hits.float().mean() / TOPK)
    log(f"[search] {nb}x{BATCH} queries probe={PROBE} rerank={RERANK} "
        f"topk={TOPK}: {search_s:.4f}s wall, {device_ms:.3f} ms device "
        f"(CUDA events), QPS {qps:.1f}, recall@{TOPK} {recall:.4f}, "
        f"peak mem {peak_gb:.3f} GB, {rt.METRICS.to_str()}, "
        f"search_many: rough_scan calls {main_scan_calls}, kernel launches "
        f"{launches} [{smi}]")

    # Checks on what came out.
    if tuple(ids.shape) != (nb * BATCH, TOPK):
        raise AssertionError(f"ids shape {tuple(ids.shape)}")
    if not torch.isfinite(dists).all() or (ids < 0).any() or (ids >= N).any():
        raise AssertionError("non-finite distances or out-of-range ids")
    exact = ((xb[ids] - flat_q[:, None, :]) ** 2).sum(-1)
    if not torch.allclose(exact, dists, rtol=1e-4, atol=1e-3):
        raise AssertionError("returned distances are not the ids' distances")
    if recall < MIN_RECALL:
        raise AssertionError(f"recall@{TOPK} {recall:.4f} < {MIN_RECALL}")
    if not launches == main_scan_calls == nb:
        raise AssertionError(
            f"search_many of {nb} batches: {launches} launches for "
            f"{main_scan_calls} rough_scan calls"
        )

    # The same 64 queries through the CPU path (the kernel's twin).
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
    log(f"[check] shapes, finite distances, recall, launches ok; "
        f"CPU twin path agrees on {agree:.4f} of 64x{TOPK} ids")

    # Where one batch's device time goes (torch.profiler, CUPTI).
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rt.search(index, qd[1], params)
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
    log(f"[profile] one batch of {BATCH}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%); top: "
        + "; ".join(f"{k[:60]} {t:.3f} ms x{c}" for k, t, c in top)
        + f" [{smi}]")

    log(json.dumps({"kernels": [{
        "name": "rough_scan",
        "route": "cuda",
        "source": "rabitq_tpu_torch/csrc/rough_scan.cu",
        "replaces": "rabitq_tpu/ops/scan_kernel.py:621",
        "launches": launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": twin_ms,
    }]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
