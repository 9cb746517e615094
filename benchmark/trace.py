"""What a torch.profiler trace of the traced batches holds, reduced to
plain intervals: the device's operations from the trace, and the
benchmark's own host ranges (``search``, ``copy ids``, ``wait``) as the
loop stamped them with ``time.time_ns()``, the clock the profiler's
events are given in; both in microseconds from the trace's start."""

from __future__ import annotations

import collections
import dataclasses

import torch


@dataclasses.dataclass
class TraceView:
    device: list  # (name, start_us, end_us) of every device operation
    host: list    # (name, start_us, end_us) of the benchmark's ranges
    window: tuple  # (start_us, end_us): first search to last wait

    @classmethod
    def of(cls, prof, stamps) -> "TraceView | None":
        """The view of a profile ``prof`` and the loop's ``stamps``
        [(name, start_ns, end_ns)]; None without stamps."""
        if not stamps:
            return None
        start_ns = prof.profiler.kineto_results.trace_start_ns()
        host = [(n, (a - start_ns) / 1e3, (b - start_ns) / 1e3)
                for n, a, b in stamps]
        host.sort(key=lambda s: s[1])
        window = (min(s[1] for s in host if s[0] == "search"),
                  max(s[2] for s in host if s[0] == "wait"))
        cuda = torch.autograd.DeviceType.CUDA
        dev = [(e.name, e.time_range.start, e.time_range.end)
               for e in prof.events()
               if e.device_type == cuda
               and not getattr(e, "is_user_annotation", False)]
        dev = [s for s in dev if s[2] > window[0] and s[1] < window[1]]
        return cls(sorted(dev, key=lambda s: s[1]), host, window)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy(self) -> list:
        """The union of the device's operations inside the window, as
        sorted disjoint (start_us, end_us)."""
        out = []
        lo, hi = self.window
        for _, a, b in self.device:
            a, b = max(a, lo), min(b, hi)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            elif b > a:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy()) / 1e6

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the device operations that took most time,
        summed by name."""
        t = collections.Counter()
        for name, a, b in self.device:
            t[name] += (b - a) / 1e6
        return [[k, v] for k, v in t.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host range, seconds]]: the device's idle time inside the
        window, each gap named by the benchmark's host range that holds
        its midpoint ("other" where none does), summed by name."""
        edges = [self.window[0]]
        for a, b in self.busy():
            edges += [a, b]
        edges.append(self.window[1])
        t = collections.Counter()
        j = 0
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = (a + b) / 2
            while j < len(self.host) and self.host[j][2] < mid:
                j += 1
            name = "other"
            if j < len(self.host) and self.host[j][1] <= mid:
                name = self.host[j][0]
            t[name] += (b - a) / 1e6
        return [[k, v] for k, v in t.most_common(top)]
