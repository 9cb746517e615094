"""The port's span recorder (rabitq_tpu_torch.profiling) on the CPU.

Spans are off by default, and under a bare torch.profiler session, and
cost nothing then (no record, no CUDA event, no ``record_function``
range); they go on after ``enable()`` and inside ``device_trace``. Each
``search`` call is one batch holding the six stage spans, nested under its
``search`` span, with the ranking's sort span nested under
``search.rank``, and so is each ``estimate_candidates`` call and each
adaptive level; the buffer stays bounded; the search's results are the
same bits with spans on and off; a ``device_trace`` around a search holds
the stages' ranges. The benchmark's stage readers (benchmark/stages.py)
find nothing on the CPU, run their pass of the traced batches with the
spans on and off again after it, and split a trace's idle gaps by the
span holding each.
"""

import contextlib
import importlib
import json
import time
import types

import numpy as np
import pytest
import torch

import rabitq_tpu_torch as rt
from benchmark import stages
from benchmark.trace import TraceView
from rabitq_tpu_torch import profiling

STAGES = ["search.rank", "search.quantize", "search.scan", "search.select",
          "search.rerank", "search.topk"]
# A search batch's spans in the order they open: the ranking's sort has a
# span of its own inside ``search.rank``.
BATCH = (["search", "search.rank", "search.rank.sort"] + STAGES[1:])


@pytest.fixture
def spans():
    """The process's recorder, emptied, and left off and empty."""
    profiling.SPANS.clear()
    yield profiling.SPANS
    profiling.SPANS._forced = 0
    profiling.SPANS.clear()


def _index(dim, spill, seed=0, n=3000, k=16):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)).astype(np.float32)
    base = (centers[rng.integers(0, k, n)]
            + 0.3 * rng.standard_normal((n, dim))).astype(np.float32)
    idx = rt.build_index(base, centers, bits=4, spill=spill, device="cpu",
                         generator=torch.Generator().manual_seed(seed))
    return idx, torch.from_numpy(base[:48] + 0.05)


class FakeEvent:
    """A stand-in for torch.cuda.Event on the CPU: counts what is made."""

    made = 0

    def __init__(self, enable_timing=False):
        type(self).made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


@pytest.fixture
def counted(monkeypatch):
    """Counts CUDA events made and record_function ranges opened."""
    ranges = []
    real = torch.profiler.record_function

    def record_function(name, *a, **k):
        ranges.append(name)
        return real(name, *a, **k)

    FakeEvent.made = 0
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: None)
    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    return types.SimpleNamespace(ranges=ranges, events=lambda: FakeEvent.made)


@pytest.mark.parametrize("profiler", [False, True])
def test_spans_off_by_default_record_nothing(spans, counted, profiler):
    cuda = torch.device("cuda")
    acts = [torch.profiler.ProfilerActivity.CPU]
    with (torch.profiler.profile(activities=acts) if profiler
          else contextlib.nullcontext()):
        assert spans.span("search", cuda) is profiling._OFF
        with spans.span("search", cuda), spans.span("search.rank", cuda):
            pass
        idx, q = _index(64, 0.0)
        rt.search(idx, q, rt.SearchParams(probe=4, topk=5, rerank=20))
    assert not spans._held and not spans.batches() and not spans.totals
    assert counted.ranges == [] and counted.events() == 0


def test_spans_on_with_events_and_ranges(spans, counted):
    cuda = torch.device("cuda")
    spans.enable()
    with spans.span("search", cuda):
        with spans.span("search.rank", cuda):
            pass
    with spans.span("search", torch.device("cpu")):
        pass
    spans.disable()
    assert counted.ranges == ["search", "search.rank", "search"]
    assert counted.events() == 4
    first, second = spans.batches()
    assert set(first) == {"search", "search.rank"}
    host, dev = first["search"]
    assert host > 0 and dev is not None and dev >= first["search.rank"][1]
    assert second["search"][1] is None
    assert spans.span("search") is profiling._OFF


def test_spans_go_on_in_device_trace_and_off_after(spans, tmp_path):
    with profiling.device_trace(str(tmp_path)):
        s = spans.span("search")
        assert isinstance(s, profiling.Span)
        with s:
            pass
    assert spans.span("search") is profiling._OFF
    assert [b["search"][1] for b in spans.batches()] == [None]


def test_nesting_batch_ids_and_bounded_buffer():
    rec = profiling.SpanRecorder(max_spans=10)
    rec.enable()
    with rec.phase("load"):
        with rec.span("search") as root:
            with rec.span("search.rank") as rank:
                pass
            with rec.span("search.topk") as top:
                pass
        # A span opened with none open starts a batch of its own.
        with rec.span("search.rank") as lone:
            pass
        with rec.span("search.select") as sel:
            pass
    assert rank.parent == top.parent == root.id
    assert root.batch == rank.batch == top.batch
    assert len({root.batch, lone.batch, sel.batch}) == 3
    assert lone.parent is not None and root.parent == lone.parent
    assert rec.totals["load"] > 0 and rec.counts["load"] == 1
    assert [set(b) for b in rec.batches()] == [
        {"search", "search.rank", "search.topk"}, {"search.rank"},
        {"search.select"}]
    for _ in range(20):
        with rec.span("search"):
            with rec.span("search.scan"):
                pass
            with rec.span("search.scan"):  # a second scan joins the batch
                pass
    assert len(rec._held) == 10
    batches = rec.batches()
    assert len(rec.batches(last=2)) == 2 and rec.batches(last=0) == []
    # The oldest batch held lost its first spans to the bound.
    assert all(set(b) == {"search", "search.scan"} for b in batches[1:])
    assert rec.spans(last=1)[0].name == "search"
    assert "load: " in rec.report() and "search.scan: host" in rec.report()


@pytest.mark.parametrize("spill", [0.0, 0.2])
@pytest.mark.parametrize("dim", [128, 960])
def test_search_bit_identical_with_spans_on(spans, dim, spill):
    idx, q = _index(dim, spill, seed=dim)
    params = rt.SearchParams(probe=6, topk=10, rerank=40)
    d0, i0 = rt.search(idx, q, params)
    spans.enable()
    d1, i1 = rt.search(idx, q, params)
    spans.disable()
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    (batch,) = spans.batches()
    assert list(batch) == BATCH
    assert all(dev is None and host > 0 for host, dev in batch.values())
    by = {s.name: s for s in spans.spans()}
    assert {s.parent for s in by.values() if s.name in STAGES} == {
        by["search"].id}
    assert by["search.rank.sort"].parent == by["search.rank"].id


def test_rank_sort_span_nests_in_rank(spans, counted):
    """``search.rank.sort`` opens and closes inside ``search.rank`` of the
    same batch; with the spans off it records nothing, opens no range and
    makes no event."""
    idx, q = _index(64, 0.0)
    params = rt.SearchParams(probe=4, topk=5, rerank=20)
    rt.search(idx, q, params)
    assert not spans._held and counted.ranges == []
    assert counted.events() == 0
    spans.enable()
    rt.search(idx, q, params)
    spans.disable()
    by = {s.name: s for s in spans.spans()}
    rank, sort = by["search.rank"], by["search.rank.sort"]
    assert sort.parent == rank.id and sort.batch == rank.batch
    assert rank.start_ns <= sort.start_ns <= sort.end_ns <= rank.end_ns
    assert counted.ranges[:3] == ["search", "search.rank",
                                  "search.rank.sort"]


def test_search_adaptive_levels_are_batches(spans):
    idx, q = _index(64, 0.2)
    spans.enable()
    _, _, used = rt.search_adaptive(idx, q, rt.SearchParams(
        probe=2, topk=5, rerank=20), max_probe=8)
    spans.disable()
    levels = spans.batches()
    assert len(levels) >= 1 + (used > 2)
    assert all(list(b) == BATCH for b in levels)


def test_estimate_candidates_alone_is_a_batch(spans):
    idx, q = _index(64, 0.2)
    spans.enable()
    rt.estimate_candidates(idx, q, rt.SearchParams(probe=4, topk=5,
                                                   rerank=20))
    spans.disable()
    (batch,) = spans.batches()
    assert list(batch) == BATCH[:6]


def test_device_trace_holds_the_stage_ranges(spans, tmp_path):
    idx, q = _index(64, 0.0)
    with profiling.device_trace(str(tmp_path)):
        rt.search(idx, q, rt.SearchParams(probe=4, topk=5, rerank=20))
    with open(tmp_path / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"search", *STAGES} <= names
    assert len(spans.batches()) == 1


def test_stage_readers_find_nothing_on_the_cpu(spans):
    idx, q = _index(64, 0.0)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts):
        rt.search(idx, q, rt.SearchParams(probe=4, topk=5, rerank=20))
    view = TraceView(device=[], host=[("search", 0.0, 1.0)],
                     window=(0.0, 2.0))
    ctx = types.SimpleNamespace(trace=view, log=print,
                                work=types.SimpleNamespace(traced=[0]))
    assert stages.read_stage(ctx, "search.select") is None
    assert stages.stage_pass(ctx) is None
    assert not spans._held


def test_stage_pass_reruns_the_traced_batches_with_spans_on(
        spans, monkeypatch):
    """The readers' pass runs the traced batches again through the
    harness's loop, as many in flight as the traced loop had, one round
    first; the spans are off again after it. On the CPU the spans have no
    device times, so it gives nothing to read."""
    search_mod = importlib.import_module("rabitq_tpu_torch.index.search")
    idx, q = _index(64, 0.2)
    batches = q[:40].reshape(5, 8, 64)
    seen = []
    real = search_mod.search

    def search(index, queries, params):
        seen.append(queries.data_ptr())
        return real(index, queries, params)

    monkeypatch.setattr(search_mod, "search", search)
    host = [("search", 0.0, 1.0), ("copy ids", 1.0, 1.5),
            ("search", 2.0, 3.0), ("copy ids", 3.0, 3.5),
            ("wait", 4.0, 5.0), ("search", 5.0, 6.0)]
    view = TraceView(device=[("k", 0.0, 5.0)], host=host, window=(0.0, 6.0))
    assert stages.in_flight(view) == 2
    ctx = types.SimpleNamespace(
        trace=view, log=print,
        work=types.SimpleNamespace(index=idx, params=rt.SearchParams(
            probe=4, topk=5, rerank=20), batches=batches, traced=[3, 4, 0]))
    assert stages.stage_pass(ctx) is None
    ptr = [batches[j].data_ptr() for j in (3, 4, 3, 4, 0)]
    assert seen == ptr
    assert [list(b) for b in spans.batches()] == [BATCH] * 5
    assert spans.span("search") is profiling._OFF


def _span(name, a_us, b_us, parent=None):
    return types.SimpleNamespace(name=name, start_ns=int(a_us * 1e3),
                                 end_ns=int(b_us * 1e3), parent=parent)


def test_idle_split_by_span():
    # The program's clock runs 1000 us ahead of the trace's; each search
    # span starts 2 us after its stamp and ends 3 us before its end.
    lag = 1000.0
    spans = []
    host = []
    for k in range(2):
        t = 100.0 * k
        host += [("search", t, t + 50), ("wait", t + 50, t + 100)]
        spans += [_span("search", t + 2 + lag, t + 47 + lag),
                  _span("search.rank", t + 2 + lag, t + 20 + lag, 0),
                  _span("search.select", t + 25 + lag, t + 47 + lag, 0)]
    # Busy everywhere but gaps centred at 10 (rank), 22 (between stages),
    # 30 (select), 70 (wait) and 201 (other: the window's tail).
    device = [("k", 0, 9), ("k", 11, 21), ("k", 23, 29), ("k", 31, 69),
              ("k", 71, 199)]
    view = TraceView(device=device, host=host, window=(0.0, 203.0))
    idle, err = stages.idle_by_span(view, spans)
    assert idle == pytest.approx({"search.rank": 2e-6, "search": 2e-6,
                                  "search.select": 2e-6, "wait": 2e-6,
                                  "other": 4e-6})
    # Aligned at the least start lag (2 us), so each span reads 2 us early
    # and its end 5 us before its stamp's: the error is at most 5 us.
    assert err == pytest.approx(5.0)


def test_stage_log_and_reads_from_a_pass():
    """A pass on the card gives each stage's mean device ms; its log line
    sets the stages beside the pass's busy time and the traced batches'."""
    host = [("search", 0.0, 2.0), ("wait", 2.0, 10.0),
            ("search", 10.0, 13.0), ("wait", 13.0, 20.0)]
    view = TraceView(device=[("k", 0.0, 8.0), ("k", 10.0, 18.0)], host=host,
                     window=(0.0, 20.0))
    batches = [{s: (1000 * (j + 1), 0.5 + j) for s in STAGES}
               for j in range(2)]
    p = types.SimpleNamespace(view=view, spans=[], batches=batches)
    lines = []
    ctx = types.SimpleNamespace(trace=view, log=lines.append, stage_pass=p,
                                work=types.SimpleNamespace(traced=[0, 1]))
    assert stages.read_stage(ctx, "search.scan") == pytest.approx(1.0)
    stages._log(ctx, p)
    (line,) = lines
    # Six stages of 1 ms a batch against 8 us of busy a batch.
    assert "search.scan 1.0000 (12500.0%) / 0.0015" in line
    assert "the six stages' device 6.0000 = 75000.0% of busy 0.0080" in line
    assert "search calls, median, 0.0025 with the spans on, 0.0025 off" in line
