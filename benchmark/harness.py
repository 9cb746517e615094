"""One run of one cell: set-up, the measured window, the traced batches,
and the comparison that decides ``correct``.

Set-up (``setup_s``, from the process's start to the window's): the
corpus drawn on the device in the seed's order (data.py), ``kmeans`` on
its training rows, the base to the host and ``build_index``, and warm-up
batches of the window's own shape (the first run in a checkout builds
the CUDA kernels there).

A cell whose traffic holds ``"filter": {"allowed": <fraction>}`` draws
its allow-list with the corpus (data.py), builds the program's row filter
from it once in set-up (``filter_s``: ``make_row_filter`` through a
``RowFilterContext``, as a deployment builds its predicate once), and
passes it on every call of the program's search: the warm-up, the window,
the traced batches and the readers' own calls; the reference then ranks
the allowed rows alone.

The window is a closed loop over the query pool, batch after batch, with
at most ``in_flight`` batches in flight: the host enqueues batch n+1 while
batch n runs and waits for batch n's ids before it starts batch n+2. Each
batch's ids and distances are copied behind it to pinned host memory; a
query counts when its ids are on the host. The harness keeps batch n's
answer for the comparison only once batch n+2 is enqueued, so that its own
bookkeeping, which grows with batch and topk, never delays a call and so
never shortens a batch's latency by the host's speed. After ``seconds`` no
batch starts, and the window ends when the last one's ids are on the host.

With ``trace`` on, ``trace_batches`` more batches of the same loop run
under torch.profiler after the window; the per-layer readers take what
they need from that trace, the window's host clock and the set-up's.

After the window the device's peak memory is read, the program's state is
freed, and only then the reference runs (check.py).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import sys
import time
import types

import numpy as np
import torch

from benchmark import check, data, spec, truth
from benchmark.trace import TraceView

WARMUP_ROUNDS = 2  # loops of in_flight batches before the window


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class State:
    """What set-up hands to the window."""

    device: torch.device
    config: dict
    seed: int
    batches: torch.Tensor   # [nb, batch, dim] the query pool
    index: object
    params: object
    stages: dict            # set-up stage -> seconds
    allowed: torch.Tensor | None = None  # run ids a filtered cell allows
    row_filter: object = None            # the program's filter of them


def setup(cell: spec.Cell, seed: int, device, t_start: float) -> State:
    from rabitq_tpu_torch.index.build import build_index
    from rabitq_tpu_torch.index.index import SearchParams
    from rabitq_tpu_torch.kmeans import kmeans

    cfg, tr = cell.config, cell.traffic
    if tr["loop"] != "closed" or tr["pool"] % tr["batch"]:
        raise ValueError(f"{cell.name}: the harness runs a closed loop over "
                         f"a pool of whole batches")
    stages = {}

    @contextlib.contextmanager
    def stage(name):
        t = time.perf_counter()
        yield
        sync(device)
        stages[name] = time.perf_counter() - t
        peak = (torch.cuda.max_memory_allocated(device) / 1e9
                if device.type == "cuda" else 0.0)
        log(f"[setup] {name} {stages[name]:.3f} s, device peak so far "
            f"{peak:.3f} GB")

    stages["start"] = time.perf_counter() - t_start
    allowed = row_filter = None
    with stage("data"):
        base, queries, train = data.make(cfg, tr["pool"], seed, device)
        batches = queries.reshape(-1, tr["batch"], cfg["dim"])
        del queries
        if "filter" in tr:
            allowed = data.allowed_ids(cfg, tr["filter"]["allowed"], seed,
                                       device)
    km = cfg["kmeans"]
    with stage("kmeans_s"):
        centroids = kmeans(
            train, km["k"], iters=km["iters"], device=device,
            generator=data.generator(cfg["data"]["structure_seed"], 1,
                                     device))
        del train
    with stage("base_to_host"):
        base_host = base.cpu().numpy()
        del base  # the program holds its own copy; the reference makes one
    with stage("build_s"):
        index = build_index(base_host, centroids, device=device,
                            generator=data.generator(seed, 2, device),
                            **cfg["build"])
    del base_host, centroids
    if allowed is not None:
        from rabitq_tpu_torch.index.filter import (RowFilterContext,
                                                   make_row_filter)

        with stage("filter_s"):
            row_filter = make_row_filter(
                index, allow_ids=allowed.cpu().numpy(),
                ctx=RowFilterContext(index))
    params = SearchParams(probe=tr["probe"], topk=tr["topk"],
                          rerank=tr["rerank"],
                          rank_precision=cfg["rank_precision"])
    return State(device, cfg, seed, batches, index, params, stages, allowed,
                 row_filter)


def program_search(row_filter=None):
    """The program's search as a cell calls it: (index, queries, params)
    -> (dists, ids), with ``row_filter`` on every call where there is
    one."""
    from rabitq_tpu_torch.index.search import search

    if row_filter is None:
        return search
    return lambda index, queries, params: search(index, queries, params,
                                                 row_filter=row_filter)


def base_rows(state: State) -> torch.Tensor:
    """The base rows drawn again from the run's seed, for the reference
    and the control, once the query pool drawn with them is found equal
    to the one the run sent."""
    base, queries, _ = data.make(state.config, state.batches.shape[0]
                                 * state.batches.shape[1], state.seed,
                                 state.device)
    if not torch.equal(queries.reshape(state.batches.shape), state.batches):
        raise RuntimeError("the data drawn again differ from the run's")
    return base


class Loop:
    """The closed loop of the window (module docstring)."""

    def __init__(self, state: State, in_flight: int, search_fn):
        self.s = state
        self.in_flight = in_flight
        self.search = search_fn
        b, k = state.batches.shape[1], state.params.topk
        pin = state.device.type == "cuda"
        # One slot more than in flight: a batch's answer is read after the
        # next batch is enqueued, whose copy must not land on it.
        self.n_slots = in_flight + 1
        self.slots = [(torch.empty((b, k), dtype=torch.int64, pin_memory=pin),
                       torch.empty((b, k), dtype=torch.float32,
                                   pin_memory=pin))
                      for _ in range(self.n_slots)]
        self.events = [torch.cuda.Event() if pin else None
                       for _ in range(self.n_slots)]
        self.n = 0  # batches started so far, warm-up included

    def run(self, *, seconds=None, batches=None, answers=None, stamps=None):
        """Batches until ``seconds`` have passed or ``batches`` have
        started, then the drain. Returns (t0, t_end, per batch (pool
        slice, start, enqueued, seen), queries sent). With ``stamps`` (a
        list), the host's ranges ``search``, ``copy ids`` and ``wait`` are
        appended to it as (name, start, end) in ``time.time_ns()``, the
        profiler's clock."""
        s = self.s
        nb = s.batches.shape[0]
        now_ns = time.time_ns
        flight, done = [], []
        first = self.n
        t0 = time.perf_counter()
        deadline = None if seconds is None else t0 + seconds
        stop = False
        seen_slot = None  # (pool slice, slot) of the batch last seen, unread
        while True:
            while not stop and len(flight) < self.in_flight:
                n = self.n
                slot = n % self.n_slots
                a = now_ns()
                t = time.perf_counter()
                d, i = self.search(s.index, s.batches[n % nb], s.params)
                t1 = time.perf_counter()
                b = now_ns()
                ids_h, d_h = self.slots[slot]
                ids_h.copy_(i, non_blocking=True)
                d_h.copy_(d, non_blocking=True)
                if self.events[slot] is not None:
                    self.events[slot].record()
                if stamps is not None:
                    stamps += [("search", a, b), ("copy ids", b, now_ns())]
                flight.append((n, slot, t, t1))
                self.n += 1
                stop = batches is not None and self.n - first >= batches
            if seen_slot is not None:
                ids_h, d_h = self.slots[seen_slot[1]]
                answers.add(seen_slot[0], ids_h.numpy(), d_h.numpy())
                seen_slot = None
            if not flight:
                break
            n, slot, t, t1 = flight.pop(0)
            a = now_ns()
            if self.events[slot] is not None:
                self.events[slot].synchronize()
            seen = time.perf_counter()
            if stamps is not None:
                stamps.append(("wait", a, now_ns()))
            done.append((n % nb, t, t1, seen))
            if answers is not None:
                seen_slot = (n % nb, slot)
            if deadline is not None and seen >= deadline:
                stop = True
        sent = (self.n - first) * s.batches.shape[1]
        return t0, done[-1][3], done, sent


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, make_search=None) -> dict:
    """One run; returns the result line (a dict, ``checks`` last).
    ``make_search(state)`` gives a function (index, queries, params) ->
    (dists, ids) that stands in for the program's search: the control
    and the fault tests pass one."""
    device = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = setup(cell, seed, device, t_start)
    return measure(cell, state, seconds, trace, t_start,
                   make_search(state) if make_search else None)


def measure(cell: spec.Cell, state: State, seconds: float, trace: bool,
            t_start: float, search_fn=None, keep=False) -> dict:
    """Warm-up, the window, the traced batches with ``trace``, and the
    comparison, on a set-up ``state``; ``setup_s`` runs from ``t_start``
    to the window's start. The program's state is freed before the
    reference runs unless ``keep``."""
    tr, device = cell.traffic, state.device
    loop = Loop(state, tr["in_flight"],
                search_fn or program_search(state.row_filter))
    nb = state.batches.shape[0]
    t = time.perf_counter()
    loop.run(batches=WARMUP_ROUNDS * tr["in_flight"])
    sync(device)
    state.stages["warmup"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    log(f"[setup] total {setup_s:.3f} s")

    answers = check.Answers(nb)
    t0, t_end, done, sent = loop.run(seconds=seconds, answers=answers)
    window_s = t_end - t0
    answered = len(done) * state.batches.shape[1]
    lat_ms = [1e3 * (seen - t) for _, t, _, seen in done]
    enqueue_s = [t1 - t for _, t, t1, _ in done]
    log(f"[window] {len(done)} batches, {answered} queries in "
        f"{window_s:.3f} s")

    metrics, breakdown, dev_extra = {}, None, {}
    if trace:
        before = launch_counters()
        n_traced = tr["trace_batches"]
        first = loop.n
        # Only the device's operations are traced; the host's ranges are
        # the loop's own stamps. Recording every host op as well doubles
        # the time to read the trace.
        acts = [torch.profiler.ProfilerActivity.CUDA
                if device.type == "cuda" else
                torch.profiler.ProfilerActivity.CPU]
        stamps = []
        with torch.profiler.profile(activities=acts) as prof:
            sent += loop.run(batches=n_traced, answers=answers,
                             stamps=stamps)[3]
            sync(device)
        t = time.perf_counter()
        view = TraceView.of(prof, stamps)
        del prof
        log(f"[trace] read in {time.perf_counter() - t:.3f} s: "
            f"{len(view.device) if view else 0} device operations")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if trace:
        ctx = types.SimpleNamespace(
            trace=view,
            launches={k: v - before.get(k, 0)
                      for k, v in launch_counters().items()},
            spans={"search": enqueue_s},
            setup=dict(state.stages),
            work=types.SimpleNamespace(
                index=state.index, params=state.params,
                row_filter=state.row_filter, batches=state.batches,
                traced=[(first + j) % nb for j in range(n_traced)]),
            log=log,
        )
        for name in cell.per_layer:
            value = spec.load_reader(name)(ctx)
            if value is not None:
                metrics[name] = value
            log(f"[metric] {name} = {value}")
        if view is not None:
            dev_extra = dict(busy_s=view.busy_s(), window_s=view.window_s)
            breakdown = dict(device_ops=view.device_ops(),
                             idle_gaps=view.idle_gaps())
        ctx = view = None
    else:
        e2e = dict(qps=answered / window_s,
                   batch_p95_ms=float(np.percentile(lat_ms, 95)), setup_s=setup_s)
        metrics = {k: v for k, v in e2e.items() if k in cell.end_to_end}

    loop = None
    if not keep:  # the program's state goes before the reference runs
        state.index = state.row_filter = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
    t = time.perf_counter()
    base = base_rows(state)
    _, true_ids = truth.brute_force_topk(
        base, state.batches.reshape(-1, state.batches.shape[2]), tr["topk"],
        state.allowed)
    checks, correct, failed = check.compare(
        answers, base, state.batches, true_ids, tr["topk"], cell.limits,
        state.allowed)
    del base
    sync(device)
    log(f"[reference] {time.perf_counter() - t:.3f} s")
    if not trace and "recall" in cell.end_to_end:
        metrics["recall"] = 1.0 - checks["miss"]["value"]

    line = {
        "correct": bool(correct),
        "attempted": sent,
        "failed": failed,
        "metrics": {k: {"value": v, "unit": cell.units[k]}
                    for k, v in metrics.items()},
        "device": _device(device, peak, dev_extra),
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["stages"] = dict(state.stages)
    line["checks"] = checks
    return line


def launch_counters() -> dict:
    """{"<wrapper>.<counter>": count} of every launch counter the
    program's kernel wrappers keep: each integer attribute whose name
    starts with ``launches`` on a public callable of
    ``rabitq_tpu_torch.ops``."""
    from rabitq_tpu_torch import ops

    out = {}
    for name in dir(ops):
        fn = getattr(ops, name)
        if name.startswith("_") or not callable(fn):
            continue
        for attr, v in getattr(fn, "__dict__", {}).items():
            if attr.startswith("launches") and isinstance(v, int):
                out[f"{name}.{attr}"] = v
    return out


def _device(device, peak, extra):
    if device.type != "cuda":
        return dict(platform="cpu", kind="cpu", count=1,
                    memory_peak_bytes=0, **extra)
    return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                count=1, memory_peak_bytes=int(peak), **extra)


def nvidia_smi() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
