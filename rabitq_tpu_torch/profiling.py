"""Tracing and phase timing (port of rabitq_tpu.profiling).

``device_trace`` captures a torch.profiler trace (host ops and, on a card,
CUDA kernels) and writes it as a Chrome trace; ``TIMER`` accumulates
wall-clock time per named phase, the CLI's ``--profile``. A phase that ran
work on the card ends with ``torch.cuda.synchronize()``, so its time
includes that work and not only its enqueue.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block (CPU, and CUDA when a card is present) and write
    ``log_dir/trace.json`` (chrome://tracing, Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_initialized():
            torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


class PhaseTimer:
    """Accumulates wall-clock per named phase."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name}: {total*1e3:.1f} ms total, {n} calls, "
                f"{total/n*1e3:.2f} ms/call"
            )
        return "\n".join(lines)

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


TIMER = PhaseTimer()
