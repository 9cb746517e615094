"""Tracing and timing (port of rabitq_tpu.profiling).

``device_trace`` captures a torch.profiler trace (host ops and, on a card,
CUDA kernels) and writes it as a Chrome trace, the CLI's ``--trace``.

``SPANS`` records named ranges inside the program (``span``): the search's
stages (index/search.py) and the CLI's phases (``TIMER.phase``). A span
records its name, the batch it belongs to, its parent, and its start and
end on ``time.time_ns()`` (the clock torch.profiler gives its events in,
so spans line up with a device trace; taken first on entry and last on
exit, so its host time holds its own cost). On a CUDA device it also
records a pair of timing events on the current stream, read only when
asked (``SpanRecorder.batches``), after they complete. Each span is also a
``torch.profiler.record_function`` range, so a trace shows the stages.

Spans are on after ``enable()`` (and inside ``device_trace``); off, a span
is one flag check and a shared null context: no event, no range, no
record. A torch.profiler session alone leaves them off, so a profiled
search runs the same host path as an unprofiled one.

A batch is one pass through the search's stages: a span opened with no
other span open (phases aside) starts one, and the spans opened inside it
join it. Phases are always recorded: a phase synchronizes the card at its
end, so its time includes the work it enqueued.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import logging
import os
import threading
import time

import torch

logger = logging.getLogger(__name__)

MAX_SPANS = 8192  # spans held; the oldest go first
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Profile the block (CPU, and CUDA when a card is present), with the
    spans on, and write ``log_dir/trace.json`` (chrome://tracing,
    Perfetto)."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    SPANS.enable()
    try:
        with profile(activities=activities) as prof:
            yield
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
    finally:
        SPANS.disable()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    logger.info("profiler trace written to %s", path)


class Span:
    """One recorded range; the context manager ``SpanRecorder.span``
    returns while spans are on, and ``SpanRecorder.phase`` always."""

    __slots__ = ("name", "id", "batch", "parent", "start_ns", "end_ns",
                 "phase", "_device", "_events", "_stream", "_range", "_rec")

    def __init__(self, rec, name, device, phase):
        self.name, self.phase = name, phase
        self.id = next(rec._ids)
        self.batch = self.parent = self.start_ns = self.end_ns = None
        self._device, self._rec = device, rec
        self._events = self._stream = None

    def __enter__(self):
        self.start_ns = time.time_ns()
        rec = self._rec
        stack = getattr(rec._local, "stack", None)
        if stack is None:
            stack = rec._local.stack = []
        if stack:
            self.parent = stack[-1].id
        if not self.phase:
            outer = next((s for s in stack if not s.phase), None)
            self.batch = (next(rec._batch_ids) if outer is None
                          else outer.batch)
            rec._held.append(self)
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        dev = self._device
        if dev is not None and dev.type == "cuda":
            # One stream lookup a span: it costs as much as an event.
            self._stream = torch.cuda.current_stream(dev)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record(self._stream)
        stack.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._stream)
            self._stream = None
        if self.phase and torch.cuda.is_initialized():
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._range = None
        self._rec._local.stack.pop()
        self.end_ns = time.time_ns()
        if self.phase:
            self._rec._phase_done(self)
        return False

    @property
    def host_ns(self) -> int:
        return self.end_ns - self.start_ns

    def device_ms(self) -> float | None:
        """Device milliseconds between the span's events (waits for them);
        None for a span off the card."""
        if self._events is None:
            return None
        a, b = self._events
        b.synchronize()
        return a.elapsed_time(b)


class SpanRecorder:
    """Spans kept in a bounded buffer, and the phases' running totals."""

    def __init__(self, max_spans: int = MAX_SPANS) -> None:
        self._held = collections.deque(maxlen=max_spans)
        self._ids = itertools.count()
        self._batch_ids = itertools.count()
        self._local = threading.local()
        self._forced = 0
        self._lock = threading.Lock()
        self.totals: dict[str, int] = collections.defaultdict(int)
        self.counts: dict[str, int] = collections.defaultdict(int)

    def enable(self) -> None:
        """Record spans until ``disable()``."""
        self._forced += 1

    def disable(self) -> None:
        self._forced = max(0, self._forced - 1)

    @property
    def on(self) -> bool:
        """Whether spans are recorded."""
        return bool(self._forced)

    def span(self, name: str, device: torch.device | None = None):
        """A range named ``name`` (see the module docstring); timed on the
        device too when ``device`` is a CUDA device."""
        if not self._forced:
            return _OFF
        return Span(self, name, device, False)

    def phase(self, name: str) -> Span:
        """A span outside every batch that synchronizes the card at its
        end, so its time includes the work it enqueued; its host time adds
        to ``totals[name]``."""
        return Span(self, name, None, True)

    def _phase_done(self, s: Span) -> None:
        with self._lock:
            self.totals[s.name] += s.host_ns
            self.counts[s.name] += 1

    def spans(self, last: int | None = None) -> list[Span]:
        """The ended spans of the ``last`` batches held (all without it),
        in the order they opened. The oldest batch may have lost spans to
        the buffer's bound."""
        done = [s for s in list(self._held) if s.end_ns is not None]
        ids = sorted({s.batch for s in done})
        if last is not None:
            ids = ids[-last:] if last > 0 else []
        keep = set(ids)
        return [s for s in done if s.batch in keep]

    def batches(self, last: int | None = None) -> list[dict]:
        """Per batch, oldest first: {span name: (host ns, device ms or
        None)}, summed over the batch's spans of that name. Reading device
        times waits for their events."""
        out = collections.OrderedDict()
        for s in self.spans(last):
            d = out.setdefault(s.batch, {})
            ms = s.device_ms()
            if s.name in d:
                host, dev = d[s.name]
                ms = None if ms is None or dev is None else dev + ms
                d[s.name] = (host + s.host_ns, ms)
            else:
                d[s.name] = (s.host_ns, ms)
        return list(out.values())

    def report(self) -> str:
        """The phases' totals, then each span's host and device totals over
        the batches held."""
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name}: {total / 1e6:.1f} ms total, {n} calls, "
                f"{total / n / 1e6:.2f} ms/call"
            )
        per_batch = self.batches()
        if per_batch:
            lines.append(f"spans over {len(per_batch)} batches "
                         "(host ms total, device ms total):")
            host: dict = collections.Counter()
            dev: dict = {}
            for b in per_batch:
                for name, (h, d) in b.items():
                    host[name] += h
                    sofar = dev.get(name, 0.0)
                    dev[name] = None if d is None or sofar is None else sofar + d
            for name in host:
                d = dev[name]
                lines.append(
                    f"  {name}: host {host[name] / 1e6:.2f} ms, device "
                    + ("not recorded" if d is None else f"{d:.2f} ms"))
        return "\n".join(lines)

    def clear(self) -> None:
        self._held.clear()
        with self._lock:
            self.totals.clear()
            self.counts.clear()


SPANS = SpanRecorder()
span = SPANS.span
enable = SPANS.enable
disable = SPANS.disable
TIMER = SPANS  # the CLI's phases: ``TIMER.phase(name)``
