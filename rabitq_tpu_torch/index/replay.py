"""A search batch replayed from a CUDA graph.

A batch's search enqueues some 80 operator and kernel launches, 2-4 ms of
host time on a loaded host: longer than the card's whole batch at sift's
shape (about 2.4 ms of an H100), so there the host set the rate and its
noise the latency. ``run`` records the batch's launches once as a CUDA
graph and replays them, so a batch costs the host one copy of the
queries, one graph launch and one copy of each result.

A graph is kept per key: the index (its identity, and the address, shape
and dtype of each of its tensors with its other fields), the parameters,
the queries' shape, dtype and device, the current stream and the TF32
switch. A key's first call runs eagerly, so that lazily built kernels,
launch plans and cuBLAS handles exist; its second runs the batch once
more on the capture stream, records it, and replays the graph; later
calls replay it. A failed capture leaves the key eager. At most
``MAX_GRAPHS`` graphs are kept: once that many are held for live indexes,
a new key runs eagerly (a graph holds its batch's memory).

A replay runs the same kernels on the same operands as the eager batch.
The ops' launch counters (``cuda_rough_scan.launches`` and the like)
advance on each replay by what the recorded batch launched, as an eager
batch's do; the warm-up and the recording count nothing. Spans do not
replay, so the search runs eagerly while they are on (profiling.enable).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import weakref

import torch

from rabitq_tpu_torch.profiling import SPANS

logger = logging.getLogger(__name__)

MAX_GRAPHS = 4

_lock = threading.Lock()
_graphs: dict = {}  # key -> entry
_seen: collections.OrderedDict = collections.OrderedDict()  # keys run once
_streams: dict = {}  # device -> capture stream
_paused = 0


@dataclasses.dataclass
class _Entry:
    graph: torch.cuda.CUDAGraph | None  # None: the key runs eagerly
    queries: torch.Tensor | None  # the graph's input
    outs: tuple  # the graph's outputs
    counts: tuple  # (op, counter, launches a replay)
    index: weakref.ref
    lock: threading.Lock = dataclasses.field(default_factory=threading.Lock)


def eligible(queries: torch.Tensor) -> bool:
    """Whether a batch of ``queries`` may be replayed: on a card, with the
    spans off and replay not paused, outside another capture."""
    return (queries.device.type == "cuda" and not SPANS.on and not _paused
            and not torch.cuda.is_current_stream_capturing())


@contextlib.contextmanager
def paused():
    """Every search inside the block runs eagerly, its stages called from
    Python (tools/bench.py's ``run_captured`` counts those calls)."""
    global _paused
    _paused += 1
    try:
        yield
    finally:
        _paused -= 1


def _key(index, queries: torch.Tensor, params) -> tuple:
    fields = []
    for f in dataclasses.fields(index):
        v = getattr(index, f.name)
        fields.append((v.data_ptr(), tuple(v.shape), v.dtype, v.device)
                      if isinstance(v, torch.Tensor) else v)
    stream = torch.cuda.current_stream(queries.device).cuda_stream
    return (id(index), tuple(fields), params, tuple(queries.shape),
            queries.dtype, queries.device, stream,
            torch.backends.cuda.matmul.allow_tf32)


def _counters() -> dict:
    """{(op name, counter): value} of the ops' launch counters: each
    integer attribute whose name starts with ``launches`` on a public
    callable of ``rabitq_tpu_torch.ops``."""
    from rabitq_tpu_torch import ops

    out = {}
    for name in dir(ops):
        fn = getattr(ops, name)
        if name.startswith("_") or not callable(fn):
            continue
        for attr, v in getattr(fn, "__dict__", {}).items():
            if attr.startswith("launches") and isinstance(v, int):
                out[name, attr] = v
    return out


def _set_counters(values: dict) -> None:
    from rabitq_tpu_torch import ops

    for (name, attr), v in values.items():
        setattr(getattr(ops, name), attr, v)


def _capture(fn, index, queries, params) -> _Entry:
    """The entry of one key: the batch run once on the capture stream,
    then recorded there."""
    dev = queries.device
    stream = _streams.get(dev)
    if stream is None:
        stream = _streams[dev] = torch.cuda.Stream(dev)
    before = _counters()
    static_q = torch.empty_like(queries, memory_format=torch.contiguous_format)
    static_q.copy_(queries)
    graph = torch.cuda.CUDAGraph()
    cur = torch.cuda.current_stream(dev)
    stream.wait_stream(cur)
    try:
        with torch.cuda.stream(stream):
            fn(index, static_q, params)
            warm = _counters()
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                outs = fn(index, static_q, params)
            finally:
                graph.capture_end()
    except Exception as e:  # noqa: BLE001 — any failure leaves it eager
        logger.warning("search batch not recorded as a CUDA graph (%s); it "
                       "runs eagerly", e)
        cur.wait_stream(stream)
        _set_counters(before)
        return _Entry(None, None, (), (), weakref.ref(index))
    cur.wait_stream(stream)
    from rabitq_tpu_torch import ops

    counts = tuple((getattr(ops, name), attr, v - warm.get((name, attr), 0))
                   for (name, attr), v in _counters().items()
                   if v != warm.get((name, attr), 0))
    _set_counters(before)
    return _Entry(graph, static_q, tuple(outs), counts, weakref.ref(index))


def _replay(e: _Entry, queries: torch.Tensor) -> tuple:
    with e.lock:
        e.queries.copy_(queries)
        e.graph.replay()
        outs = tuple(t.clone() for t in e.outs)
        for op, attr, n in e.counts:
            setattr(op, attr, getattr(op, attr) + n)
    return outs


def _purge() -> None:
    """Drop the graphs of indexes that are gone, after a synchronize of
    their cards: a replay of one may still be running."""
    dead = [k for k, e in _graphs.items() if e.index() is None]
    for dev in {k[5] for k in dead}:
        torch.cuda.synchronize(dev)
    for k in dead:
        del _graphs[k]


def run(fn, index, queries: torch.Tensor, params) -> tuple:
    """``fn(index, queries, params)`` (a tuple of tensors computed on the
    card with no host sync), replayed from its key's graph where it has
    one, recorded at the key's second call while fewer than
    ``MAX_GRAPHS`` graphs of live indexes are kept (module docstring).
    Call only where ``eligible(queries)``."""
    key = _key(index, queries, params)
    with _lock:
        e = _graphs.get(key)
        if e is not None and e.index() is not index:
            _purge()  # the key's index is gone and its id reused
            e = None
        if e is None and key in _seen:
            if len(_graphs) >= MAX_GRAPHS:
                _purge()
            if len(_graphs) < MAX_GRAPHS:
                del _seen[key]
                e = _graphs[key] = _capture(fn, index, queries, params)
    if e is None:
        out = fn(index, queries, params)
        with _lock:
            _seen[key] = None
            while len(_seen) > 4 * MAX_GRAPHS:
                _seen.popitem(last=False)
        return out
    if e.graph is None:
        return fn(index, queries, params)
    return _replay(e, queries)


def clear() -> None:
    """Drop every graph (after a synchronize of each card that ran one)."""
    with _lock:
        for dev in {k[5] for k in _graphs}:
            torch.cuda.synchronize(dev)
        _graphs.clear()
        _seen.clear()
