"""The program's search stages, for the readers of ``search.<stage>_ms``.

The traced batches run as the window does, with the program's spans off,
so what the other readers take from their trace is the program's plain
path. Once a run, the first of these readers runs the same batches again
through the harness's loop, under torch.profiler as the traced batches
ran, with the spans on (``rabitq_tpu_torch.profiling.enable()``) and the
cell's row filter where it has one; the readers read that pass. On the
card each span holds a pair of CUDA events, and a stage's time is the
time between them: the stage's work and the card's idle time inside the
stage. So each stage's share of the pass's busy time is logged beside
it, with the idle share and the host's time a ``search`` call of the
pass and of the traced batches. A program without the spans, or a run
without device operations (the CPU), gives nothing to read.
"""

from __future__ import annotations

import bisect
import collections
import statistics
import types

import torch

from benchmark import harness
from benchmark.trace import TraceView

STAGES = ("search.rank", "search.quantize", "search.scan", "search.select",
          "search.rerank", "search.topk")


def _profiling():
    try:
        from rabitq_tpu_torch import profiling
    except ImportError:
        return None
    if not hasattr(profiling, "SPANS") or not hasattr(profiling, "enable"):
        return None
    return profiling


def in_flight(view: TraceView) -> int:
    """The loop's batches in flight: its ``search`` stamps before its
    first ``wait``."""
    n = 0
    for name, _, _ in view.host:
        if name == "wait":
            break
        n += name == "search"
    return max(1, n)


def stage_pass(ctx):
    """The pass with the spans on (module docstring), made once a run and
    kept on ``ctx``: its ``view`` (a TraceView), ``spans`` and
    ``batches`` (per batch {span name: (host ns, device ms)}); None where
    there is nothing to read."""
    if not hasattr(ctx, "stage_pass"):
        ctx.stage_pass = _run_pass(ctx)
        if ctx.stage_pass is not None:
            _log(ctx, ctx.stage_pass)
    return ctx.stage_pass


def _run_pass(ctx):
    profiling = _profiling()
    t = ctx.trace
    if profiling is None or t is None or not t.device:
        return None
    w = ctx.work
    device = w.batches.device
    state = types.SimpleNamespace(batches=w.batches, params=w.params,
                                  index=w.index, device=device)
    loop = harness.Loop(state, in_flight(t), harness.program_search(
        getattr(w, "row_filter", None)))
    n = len(w.traced)
    acts = [torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
            else torch.profiler.ProfilerActivity.CPU]
    stamps = []
    profiling.enable()
    try:
        # One round first, so the trace holds no span's first event.
        loop.n = w.traced[0]
        loop.run(batches=loop.in_flight)
        loop.n = w.traced[0]
        with torch.profiler.profile(activities=acts) as prof:
            loop.run(batches=n, stamps=stamps)
            harness.sync(device)
    finally:
        profiling.disable()
    batches = profiling.SPANS.batches(last=n)
    if len(batches) != n or any(
            b.get(name, (0, None))[1] is None
            for b in batches for name in ("search",) + STAGES):
        return None
    return types.SimpleNamespace(view=TraceView.of(prof, stamps),
                                 spans=profiling.SPANS.spans(last=n),
                                 batches=batches)


def _enqueue_ms(view: TraceView) -> float:
    """The median host ms of the loop's ``search`` calls (the median, as
    the traced batches' first calls carry the profiler's start-up)."""
    return statistics.median(b - a for name, a, b in view.host
                             if name == "search") / 1e3


def _log(ctx, p) -> None:
    n = len(p.batches)
    dev = {s: statistics.fmean(b[s][1] for b in p.batches) for s in STAGES}
    host = {s: statistics.fmean(b[s][0] for b in p.batches) / 1e6
            for s in STAGES}
    total = sum(dev.values())
    busy = 1e3 * p.view.busy_s() / n
    window = 1e3 * p.view.window_s / n
    t = ctx.trace
    t_busy = 1e3 * t.busy_s() / len(ctx.work.traced)
    t_window = 1e3 * t.window_s / len(ctx.work.traced)
    ctx.log(f"[stages] ms a batch over {n} batches with the spans on, "
            "device (share of busy) / host: "
            + ", ".join(f"{s} {dev[s]:.4f} ({100 * dev[s] / busy:.1f}%) / "
                        f"{host[s]:.4f}" for s in STAGES)
            + f"; the six stages' device {total:.4f} = "
            f"{100 * total / busy:.1f}% of busy {busy:.4f}, window "
            f"{window:.4f} (idle {100 - 100 * busy / window:.2f}%); the "
            f"traced batches, spans off: busy {t_busy:.4f}, window "
            f"{t_window:.4f} (idle {100 - 100 * t_busy / t_window:.2f}%); "
            f"the loop's search calls, median, {_enqueue_ms(p.view):.4f} "
            f"with the spans on, {_enqueue_ms(t):.4f} off")


def read_stage(ctx, stage: str):
    """The mean device ms a batch of ``stage`` over the pass."""
    p = stage_pass(ctx)
    if p is None:
        return None
    return statistics.fmean(b[stage][1] for b in p.batches)


def idle_by_span(view: TraceView, spans) -> tuple[dict, float] | None:
    """The device-idle seconds of ``view``'s window by the program's span
    that holds each idle gap's midpoint (a stage, else ``search`` between
    stages, else the loop's host range, else "other"), and the
    alignment's error bound in us.

    The spans are on ``time.time_ns()`` and the trace in us from its
    start: the offset between them is the least (span start - stamp start)
    over the batches, each program ``search`` span lying inside the loop's
    ``search`` stamp of its batch. The offset errs late by at most the
    least (stamp end - span end) it leaves."""
    roots = [s for s in spans if s.name == "search" and s.parent is None]
    stamps = [h for h in view.host if h[0] == "search"]
    if not roots or len(roots) != len(stamps):
        return None
    off = min(s.start_ns / 1e3 - h[1] for s, h in zip(roots, stamps))
    err = min(h[2] - (s.end_ns / 1e3 - off) for s, h in zip(roots, stamps))

    def layer(items):
        items = sorted(items)
        return [a for a, _, _ in items], items

    layers = [
        layer((s.start_ns / 1e3 - off, s.end_ns / 1e3 - off, s.name)
              for s in spans if s.name in STAGES),
        layer((s.start_ns / 1e3 - off, s.end_ns / 1e3 - off, s.name)
              for s in roots),
        layer((a, b, name) for name, a, b in view.host),
    ]
    edges = [view.window[0]]
    for a, b in view.busy():
        edges += [a, b]
    edges.append(view.window[1])
    idle = collections.Counter()
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        name = "other"
        for starts, items in layers:
            j = bisect.bisect_right(starts, mid) - 1
            if j >= 0 and items[j][1] >= mid:
                name = items[j][2]
                break
        idle[name] += (b - a) / 1e6
    return dict(idle.most_common()), err
