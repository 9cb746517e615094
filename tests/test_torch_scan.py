"""Parity of the port's rough scan with the JAX package's, and the task
grouping that the CUDA kernel relies on.

The port's CPU path is the kernel's plain twin (rough_scan_reference, which
``cuda_rough_scan`` runs for CPU tensors). It is held against
``pallas_rough_scan`` in interpret mode on the aligned path that search uses
on the TPU, against the portable jnp scan the JAX package runs on the CPU,
and against tests/reference_model.py. +inf slots must be identical; values
agree within rtol 1e-5 (f32 rounding: the JAX paths may contract or reorder
the estimator's float operations).

The lane fold (``fold`` 1 or 2) is held bit for bit against a numpy oracle
built from the port's own unfolded twin, and against
``pallas_rough_scan(reduce=1|2)`` in interpret mode within that tolerance
plus the packing quantum, where a near-tie may swap a bucket's kept slot.

The nibble-packed query operand (``qpack``, D % 256 == 0) is held bit for
bit against the unpacked twin on the same values, and against
``pallas_rough_scan(qpack=True)`` in interpret mode in each mode.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu_torch as rt
from conftest import make_clustered_dataset
from rabitq_tpu.index.index import padded_offsets
from rabitq_tpu.ops import pairwise_l2sq, quantize_query_residuals, rotate
from rabitq_tpu.ops.scan_kernel import pallas_rough_scan
from rabitq_tpu_torch.ops import (
    cuda_rough_scan,
    pack_query_nibbles,
    rough_scan_reference,
)
from rabitq_tpu_torch.ops.scan_kernel import (
    QPC,
    effective_fold,
    fold_slot_bits,
    group_tasks,
)
from reference_model import ref_rough_distance
from torch_parity import gist_like_corpus, port_index_from_jax

jscan = importlib.import_module("rabitq_tpu.ops.scan_kernel")

# The packages export a ``search`` function that shadows the module name.
jsearch = importlib.import_module("rabitq_tpu.index.search")
tsearch = importlib.import_module("rabitq_tpu_torch.index.search")


def _assert_scan_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(
        got[fin], want[fin], rtol=1e-5, atol=1e-6 * scale
    )


def _oracle(codes, factors, starts, sizes, qvals, scal, span):
    """Direct float64 evaluation of the scan contract."""
    out = np.full((starts.shape[0], span), np.inf)
    for t in range(starts.shape[0]):
        lo, delta, _, ycd = scal[t].astype(np.float64)
        for j in range(sizes[t]):
            row = starts[t] + j
            ip, ppc, err, cdsq = factors[row].astype(np.float64)
            dot = float(codes[row].astype(np.int64) @ qvals[t])
            out[t, j] = cdsq + ycd + lo * ppc + dot * ip * delta - err * np.sqrt(ycd)
    return out


def _random_operands(rng, n, d, span, sizes, starts, bits=4):
    m = (1 << bits) - 1
    codes = (2 * rng.integers(0, m + 1, (n, d)) - m).astype(np.int8)
    factors = rng.standard_normal((n, 4)).astype(np.float32)
    factors[:, 3] = np.abs(factors[:, 3])
    s = len(sizes)
    qvals = rng.integers(0, 16, (s, d)).astype(np.int8)
    scal = rng.standard_normal((s, 4)).astype(np.float32)
    scal[:, 1] = np.abs(scal[:, 1]) + 0.01
    scal[:, 2] = qvals.sum(1)
    scal[:, 3] = np.abs(scal[:, 3])
    return (codes, factors, np.asarray(starts, np.int32),
            np.asarray(sizes, np.int32), qvals, scal)


def test_twin_matches_oracle_with_edge_cases(rng):
    """Size 0, size == span, a cluster ending at the last row."""
    n, d, span = 700, 128, 256
    starts = [0, 5, 100, n - span, n - 3, 17, 300]
    sizes = [0, span, 37, span, 3, 1, 129]
    ops = _random_operands(rng, n, d, span, sizes, starts)
    got = rough_scan_reference(*map(torch.from_numpy, ops), span).numpy()
    _assert_scan_close(got, _oracle(*ops, span))
    assert np.isinf(got[0]).all() and np.isfinite(got[1]).all()


def test_wrapper_runs_twin_on_cpu_without_counting(rng):
    ops = _random_operands(rng, 300, 64, 128, [128, 40], [0, 172])
    tensors = list(map(torch.from_numpy, ops))
    before = cuda_rough_scan.launches
    got = cuda_rough_scan(*tensors, 128)
    assert torch.equal(got, rough_scan_reference(*tensors, 128))
    assert cuda_rough_scan.launches == before


def test_wrapper_rejects_bad_operands(rng):
    ops = list(map(torch.from_numpy, _random_operands(rng, 300, 64, 128, [8], [0])))
    bad = list(ops)
    bad[0] = ops[0].to(torch.int32)
    with pytest.raises(ValueError, match="codes"):
        cuda_rough_scan(*bad, 128)
    bad = list(ops)
    bad[4] = ops[4][:, :32]
    with pytest.raises(ValueError, match="qvals"):
        cuda_rough_scan(*bad, 128)
    with pytest.raises(ValueError, match="device"):
        cuda_rough_scan(*(t.to("meta") for t in ops), 128)


# (starts, sizes) cases: ragged random keys; every task on one cluster
# (several full groups); an empty cluster sharing its start with its
# successor; a lone task; no task at all.
_GROUP_CASES = {
    "random": ([3, 9, 3, 0, 9, 9, 3, 21, 0, 3], [6, 12, 6, 3, 12, 12, 6, 1, 3, 6]),
    "one_cluster": ([40] * 100, [77] * 100),
    "empty_shares_start": ([5, 5, 5, 0, 5, 5, 0], [0, 9, 0, 5, 9, 0, 5]),
    "one_task": ([7], [2]),
    "no_tasks": ([], []),
}


def _check_groups(starts, sizes, span=64, n_rows=1000):
    """The grouping's contract: a partition of the tasks into groups of
    1..QPC tasks with one (start, size clamped to span) key each, in key
    order, each run of a key cut into full groups but its last, and no
    more groups than its bound."""
    starts = np.asarray(starts, np.int32)
    s = starts.shape[0]
    order, first = group_tasks(
        torch.from_numpy(starts), torch.tensor(sizes, dtype=torch.int32),
        n_rows, span,
    )
    sizes = np.clip(np.asarray(sizes, np.int32), 0, span)
    order, first = order.numpy(), first.numpy()
    assert (order.dtype, first.dtype) == (np.int64, np.int32)
    assert first.shape == (s + 1,) and first[s] == s
    np.testing.assert_array_equal(np.sort(order), np.arange(s))
    n_groups = int(np.searchsorted(first, s))  # groups start below s
    np.testing.assert_array_equal(first[n_groups:], s)
    keys = []
    for g in range(n_groups):
        tasks = order[first[g]:first[g + 1]]
        assert 1 <= tasks.size <= QPC
        key = {(starts[t], sizes[t]) for t in tasks}
        assert len(key) == 1
        keys.append(key.pop())
        np.testing.assert_array_equal(tasks, np.sort(tasks))  # stable
    assert keys == sorted(keys)  # key order: a cluster's groups adjacent
    for g in range(n_groups - 1):
        if keys[g] == keys[g + 1]:
            assert first[g + 1] - first[g] == QPC
    distinct = len(set(zip(starts.tolist(), sizes.tolist())))
    assert n_groups <= min(s, distinct + (s - distinct) // QPC)
    return order, first, n_groups


@pytest.mark.parametrize("reps", [1, 3, QPC])
@pytest.mark.parametrize("case", sorted(_GROUP_CASES))
def test_group_tasks_partitions_by_key(case, reps):
    """Each case's tasks repeated ``reps`` times, so that at 3 and QPC
    runs of one key outgrow a group."""
    starts, sizes = (v * reps for v in _GROUP_CASES[case])
    _, first, n_groups = _check_groups(starts, sizes)
    if case == "one_cluster":
        assert n_groups == -(-100 * reps // QPC)
    if case == "no_tasks":
        assert n_groups == 0 and first.tolist() == [0]


def test_group_tasks_property():
    """Random tasks over a few (start, size) keys, up to 3 * QPC sharing
    one, in a random order; sizes below 0 and above the span clamp into
    one key."""
    hypothesis = pytest.importorskip("hypothesis")
    st = hypothesis.strategies

    @hypothesis.settings(max_examples=60, deadline=None, database=None)
    @hypothesis.given(
        runs=st.lists(
            st.tuples(st.integers(0, 6), st.integers(-1, 5),
                      st.integers(1, 3 * QPC)),
            max_size=6,
        ),
        seed=st.integers(0, 2**32 - 1),
        n_rows=st.sampled_from([100, 2**30]),  # int32 and int64 keys
    )
    def check(runs, seed, n_rows):
        keys = [(10 * a, b) for a, b, c in runs for _ in range(c)]
        keys = [keys[i] for i in np.random.default_rng(seed).permutation(
            len(keys))]
        _check_groups([a for a, _ in keys], [b for _, b in keys], span=3,
                      n_rows=n_rows)

    check()


def _grouped_scan(codes, factors, starts, sizes, qvals, scal, span):
    """The CUDA kernel's layout in plain torch (tests only): for each group
    of ``group_tasks``, one read of the window rows [start, start + size)
    and one integer product against all of the group's query values, the
    estimator in the twin's order, and each task's slots written by task
    id; slots [size, span) stay +inf."""
    s = starts.shape[0]
    order, first = group_tasks(starts, sizes, codes.shape[0], span)
    out = torch.full((s, span), torch.inf)
    for g in range(s):
        a, b = int(first[g]), int(first[g + 1])
        if a >= s:
            break
        tasks = order[a:b]
        start = int(starts[tasks[0]])
        size = max(0, min(int(sizes[tasks[0]]), span))
        rows = slice(start, start + size)
        dot = (qvals[tasks].long() @ codes[rows].long().T).float()
        f = factors[rows]
        lo, delta, ycd = scal[tasks, 0:1], scal[tasks, 1:2], scal[tasks, 3:4]
        est = f[None, :, 3] + ycd
        est = est + lo * f[None, :, 1]
        est = est + (dot * f[None, :, 0]) * delta
        est = est - f[None, :, 2] * torch.sqrt(ycd)
        out[tasks, :size] = est
    return out


def _structured_operands(rng, n_clusters, queries, probe, d, span, bits=4):
    """Cluster-structured scan operands: random cluster sizes <= span (some
    empty, the last one full and ending at row N-1), and [queries, probe]
    distinct clusters per query drawn with skew toward a few."""
    sizes = rng.integers(0, span + 1, n_clusters)
    sizes[:: max(1, n_clusters // 5)] = 0
    sizes[-1] = span
    w = 1.0 / np.arange(1, n_clusters + 1) ** 1.2
    cids = np.stack([
        rng.choice(n_clusters, probe, replace=False, p=w / w.sum())
        for _ in range(queries)
    ])
    cids[0, 0] = n_clusters - 1
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    cids = cids.reshape(-1)
    return _random_operands(rng, int(offsets[-1]), d, span,
                            offsets[cids + 1] - offsets[cids], offsets[cids],
                            bits)


@pytest.mark.parametrize(
    "kind,d,span",
    [("random", 64, 128), ("random", 128, 256), ("structured", 128, 128),
     ("structured", 96, 384), ("one_cluster", 64, 128), ("edges", 128, 64)],
)
def test_grouped_layout_equals_twin_bitwise(rng, kind, d, span):
    """The grouped evaluation the kernel performs equals the twin bit for
    bit: the same slots, the same +inf, the same float operations."""
    if kind == "random":
        starts = rng.integers(0, 600 - span, 90)
        ops = _random_operands(rng, 600, d, span, rng.integers(0, span + 1, 90),
                               starts)
    elif kind == "structured":
        ops = _structured_operands(rng, 40, 24, 6, d, span)
    elif kind == "one_cluster":  # 70 tasks share one window: 3 groups
        ops = _random_operands(rng, 300, d, span, [span] * 70, [300 - span] * 70)
    else:  # size 0 beside its successor, size == span, size > span, N-1
        n = 200
        ops = _random_operands(rng, n, d, span, [0, 40, span, span + 9, 1, 0, 40],
                               [10, 10, 0, 50, n - 1, n - 1, 10])
    tensors = list(map(torch.from_numpy, ops))
    got = _grouped_scan(*tensors, span)
    want = rough_scan_reference(*tensors, span)
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got, want)


def _scan_inputs(jidx, queries, probe):
    """The per-task operands exactly as the JAX search builds them."""
    d = jidx.dim
    q = jnp.pad(jnp.asarray(queries), ((0, 0), (0, d - queries.shape[1])))
    y = rotate(q, jidx.orthogonal)
    _, cids = jax.lax.top_k(-pairwise_l2sq(y, jidx.centroids_rot), probe)
    yr = y[:, None, :] - jidx.centroids_rot[cids]
    ycd = jnp.sum(yr * yr, axis=-1)
    qq = quantize_query_residuals(yr)
    off = jidx.offsets
    s = cids.size
    starts = off[cids].reshape(s)
    sizes = (off[cids + 1] - off[cids]).reshape(s)
    scal = jnp.stack([qq.lower, qq.delta, qq.code_sum, ycd], -1).reshape(s, 4)
    qvals = qq.quantized.reshape(s, d).astype(jnp.int8)
    return cids, starts, sizes, qvals, scal


@pytest.fixture(scope="module", params=[1, 4])
def jax_index(request):
    rng = np.random.default_rng(11)
    base, centers = make_clustered_dataset(rng, n=1500, dim=64, k=12)
    jidx = rq.build_index(
        base, centers, key=jax.random.key(1), bits=request.param
    )
    return jidx, base[:2] + 0.01


def test_twin_matches_pallas_kernel_interpret(jax_index):
    jidx, queries = jax_index
    probe = 8  # S = 2 * 8 = 16 tasks: interpret mode is slow
    cids, starts, sizes, qvals, scal = _scan_inputs(jidx, queries, probe)
    span = jidx.capacity
    want, _, _ = pallas_rough_scan(
        jidx.codes_pm1, jidx.factors_tiled, starts, sizes, qvals, scal,
        span=span, k_max=jidx.k, interpret=True, cids=cids,
        starts_k=padded_offsets(jidx.offsets)[:-1], aligned=True,
        reduce=False,
    )
    pidx = port_index_from_jax(jidx)
    got = cuda_rough_scan(
        pidx.codes, pidx.factors,
        *(torch.from_numpy(np.array(a)) for a in (starts, sizes, qvals, scal)),
        span,
    )
    _assert_scan_close(got.numpy(), want)


def test_twin_matches_reference_model(jax_index):
    jidx, queries = jax_index
    _, starts, sizes, qvals, scal = map(
        np.asarray, _scan_inputs(jidx, queries, 4)
    )
    pidx = port_index_from_jax(jidx)
    span = jidx.capacity
    got = cuda_rough_scan(
        pidx.codes, pidx.factors,
        *(torch.from_numpy(np.array(a)) for a in (starts, sizes, qvals, scal)),
        span,
    ).numpy()
    codes = pidx.codes.numpy()
    fac = pidx.factors.numpy()
    want = np.full(got.shape, np.inf)
    if jidx.code_bits == 1:
        # The reference model's estimator on 0/1 sign bits.
        bits = (codes > 0).astype(np.int64)
        fdict = dict(ip=fac[:, 0], ppc=fac[:, 1], err=fac[:, 2], cdsq=fac[:, 3])
        for t in range(starts.shape[0]):
            lo, delta, ssum, ycd = scal[t]
            for j in range(sizes[t]):
                want[t, j] = ref_rough_distance(
                    bits, qvals[t].astype(np.int64), fdict, starts[t] + j,
                    ycd, lo, delta, ssum,
                )
    else:
        want = _oracle(codes, fac, starts, sizes, qvals, scal, span)
    _assert_scan_close(got, want)


def test_search_rough_scan_matches_jnp_scan(jax_index):
    """The port's stage-1..3 output equals the JAX CPU path's (_jnp_scan),
    slot for slot, on the same index and queries."""
    jidx, queries = jax_index
    params_j = rq.SearchParams(probe=6, topk=5, rerank=32, approx_select=False)
    want = jsearch.rough_scan(jidx, jnp.asarray(queries), params_j)
    pidx = port_index_from_jax(jidx)
    got = tsearch.rough_scan(
        pidx, torch.from_numpy(queries), rt.SearchParams(probe=6, topk=5, rerank=32)
    )
    np.testing.assert_array_equal(got.starts.numpy(), np.asarray(want.starts))
    np.testing.assert_array_equal(
        got.n_scanned.numpy(), np.asarray(want.n_scanned)
    )
    _assert_scan_close(got.rough.numpy(), want.rough)


def test_search_rough_scan_matches_jnp_scan_at_960d():
    """The GIST width (dim 960 padded to 1024, bits 4, spill 0.2): the
    port's stage-1..3 output equals the JAX CPU path's slot for slot. The
    twin's fp32 bmm stays exact: |dot| <= 15 * 15 * 1024 < 2^24."""
    base, queries, centers, p = gist_like_corpus()
    jidx = rq.build_index(
        base, centers, key=jax.random.key(0), orthogonal=p, bits=4,
        spill=0.2, balance=1.5,
    )
    params_j = rq.SearchParams(probe=8, topk=100, rerank=150, approx_select=False)
    want = jsearch.rough_scan(jidx, jnp.asarray(queries), params_j)
    got = tsearch.rough_scan(
        port_index_from_jax(jidx), torch.from_numpy(queries),
        rt.SearchParams(probe=8, topk=100, rerank=150),
    )
    np.testing.assert_array_equal(got.starts.numpy(), np.asarray(want.starts))
    np.testing.assert_array_equal(
        got.n_scanned.numpy(), np.asarray(want.n_scanned)
    )
    _assert_scan_close(got.rough.numpy(), want.rough)


@pytest.mark.parametrize("depth", [0, 1, 2, True])
def test_fold_gate_and_slot_bits_at_capacity_equal_scan_span(depth):
    """The port scans ``capacity`` slots, the JAX kernel scan_span(capacity)
    (its multiple of 128): the fold gate is the same for every capacity,
    and so are the slot bits wherever the fold is on. Both match the JAX
    package's own functions."""
    for cap in range(1, 4097):
        span = jsearch.scan_span(cap)
        f = effective_fold(cap, depth)
        assert f == effective_fold(span, depth) == jscan.effective_fold(span, depth)
        if f:
            assert fold_slot_bits(cap) == fold_slot_bits(span)
            assert fold_slot_bits(span) == jscan.fold_slot_bits(span)


def _np_lane_fold(unfolded, sizes, span, depth):
    """Numpy oracle of the fold, from the unfolded output: for each (task,
    lane) the slots j = lane, lane + 128, ... below the task's size enter
    the strict < chain in slot order, as the estimate's bits with the low
    fold_slot_bits(span) bits replaced by j."""
    f = effective_fold(span, depth)
    if not f:
        return unfolded
    mask = (1 << fold_slot_bits(span)) - 1
    bits = np.ascontiguousarray(unfolded, np.float32).view(np.int32)
    out = np.full((unfolded.shape[0], f * 128), np.inf, np.float32)
    for t in range(unfolded.shape[0]):
        for lane in range(128):
            v1 = v2 = np.float32(np.inf)
            for j in range(lane, min(int(sizes[t]), span), 128):
                pe = np.int32((int(bits[t, j]) & ~mask) | j).view(np.float32)
                if pe < v1:
                    v1, v2 = pe, v1
                elif pe < v2:
                    v2 = pe
            out[t, lane] = v1
            if f == 2:
                out[t, 128 + lane] = v2
    return out


@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("span", [300, 384, 256])
def test_folded_twin_matches_numpy_oracle(rng, span, depth):
    """Bit for bit, with an empty task, two single-row tasks (one at row
    N-1), a size above the span and a NaN estimate (it drops from its
    bucket). Span 300 is not a multiple of 128; span 256 at depth 2 does
    not fold, and its output is the unfolded array."""
    n, d = 1200, 64
    sizes = [0, 1, 1, span, 129, 257, span + 40, 77, 200, 131]
    starts = [5, 0, n - 1, n - span, 300, 600, 100, 900, 10, 40]
    ops = _random_operands(rng, n, d, span, sizes, starts)
    ops[1][603, 0] = np.nan  # task 5, slot 3
    tensors = list(map(torch.from_numpy, ops))
    unfolded = rough_scan_reference(*tensors, span).numpy()
    assert np.isnan(unfolded[5, 3])
    got = rough_scan_reference(*tensors, span, fold=depth).numpy()
    want = _np_lane_fold(unfolded, ops[3], span, depth)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    f = effective_fold(span, depth)
    assert got.shape == (len(sizes), f * 128 if f else span)
    if f:
        assert not np.isnan(got).any() and np.isinf(got[0]).all()
        assert np.isfinite(got[1, 0]) and np.isinf(got[1, 1:]).all()
    wrapper = cuda_rough_scan(*tensors, span, depth).numpy()
    np.testing.assert_array_equal(wrapper.view(np.int32), got.view(np.int32))


def _assert_fold_close(got, want, unfolded, sizes, span, depth):
    """Two folds of estimates that agree within _assert_scan_close's
    tolerance: the same +inf; the values with their slot bits cleared
    within that tolerance plus the packing quantum 2^(slot_bits - 23)
    relative; and each bucket's kept slots equal, unless its depth-th and
    (depth + 1)-th best unfolded values lie within that tolerance (a
    near-tie the two may break either way)."""
    mask = (1 << fold_slot_bits(span)) - 1
    rtol = 1e-5 + 2.0 ** (fold_slot_bits(span) - 23)
    atol = 1e-6 * np.abs(unfolded[np.isfinite(unfolded)]).max()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    gb, wb = got.view(np.int32), want.view(np.int32)
    fin = np.isfinite(want)
    np.testing.assert_allclose((gb & ~mask).view(np.float32)[fin],
                               (wb & ~mask).view(np.float32)[fin],
                               rtol=rtol, atol=atol)
    s = got.shape[0]
    g_slot = (gb & mask).reshape(s, depth, 128)
    w_slot = (wb & mask).reshape(s, depth, 128)
    fin = fin.reshape(s, depth, 128)
    ties = 0
    for t in range(s):
        for lane in range(128):
            kept = fin[t, :, lane]
            if set(g_slot[t, kept, lane]) == set(w_slot[t, kept, lane]):
                continue
            vals = np.sort(unfolded[t, lane:min(int(sizes[t]), span):128])
            assert vals.size > depth
            gap = abs(vals[depth] - vals[depth - 1])
            assert gap <= rtol * abs(vals[depth]) + atol, (t, lane)
            ties += 1
    assert ties <= 0.01 * s * 128


@pytest.fixture(scope="module")
def jax_fold_index():
    """A JAX index of capacity 512 (> 256: both depths fold) and 2 queries."""
    rng = np.random.default_rng(11)
    base, centers = make_clustered_dataset(rng, n=2400, dim=64, k=6)
    jidx = rq.build_index(base, centers, key=jax.random.key(1), bits=4)
    assert jidx.capacity > 256
    return jidx, base[:2] + 0.01


def _pallas_fold(jidx, scan_inputs, reduce):
    cids, starts, sizes, qvals, scal = scan_inputs
    out, _, _ = pallas_rough_scan(
        jidx.codes_pm1, jidx.factors_tiled, starts, sizes, qvals, scal,
        span=jidx.capacity, k_max=jidx.k, interpret=True, cids=cids,
        starts_k=padded_offsets(jidx.offsets)[:-1], aligned=True,
        reduce=reduce,
    )
    return np.asarray(out)


@pytest.mark.parametrize("reduce", [1, 2])
def test_folded_twin_matches_pallas_kernel_interpret(jax_fold_index, reduce):
    """The JAX kernel's own fold (its default search's) on the aligned
    path, against the port's folded twin."""
    jidx, queries = jax_fold_index
    inputs = _scan_inputs(jidx, queries, 4)
    want = _pallas_fold(jidx, inputs, reduce)
    pidx = port_index_from_jax(jidx)
    ops = [pidx.codes, pidx.factors,
           *(torch.from_numpy(np.array(a)) for a in inputs[1:])]
    span = jidx.capacity
    got = cuda_rough_scan(*ops, span, reduce).numpy()
    assert got.shape == want.shape == (8, reduce * 128)
    unfolded = cuda_rough_scan(*ops, span).numpy()
    _assert_fold_close(got, want, unfolded, np.asarray(inputs[2]), span,
                       reduce)


def test_estimate_candidates_fold_matches_jax_composition(jax_fold_index):
    """Folded candidate selection against the JAX package's composition:
    the interpret-mode fold, ``_exact_two_stage`` and the slot decode of
    rabitq_tpu/index/search.py. Bounds within rtol 1e-5 plus the packing
    quantum; positions equal but for swaps between candidates whose bounds
    lie within that tolerance."""
    jidx, queries = jax_fold_index
    probe, rerank = 4, 40
    inputs = _scan_inputs(jidx, queries, probe)
    b, span = queries.shape[0], jidx.capacity
    rough = _pallas_fold(jidx, inputs, 2).reshape(b, probe * 256)
    lb, flat = map(np.asarray, jsearch._exact_two_stage(
        jnp.asarray(rough), probe, 256, rerank))
    mask = (1 << fold_slot_bits(span)) - 1
    bits = lb.view(np.int32)
    starts = np.asarray(inputs[1]).reshape(b, probe)
    pidx = port_index_from_jax(jidx)
    pos_w = np.minimum(
        np.take_along_axis(starts, flat // 256, 1) + (bits & mask), pidx.n - 1
    )
    lb_w = (bits & ~mask).view(np.float32)

    cand = tsearch.estimate_candidates(
        pidx, torch.from_numpy(queries),
        rt.SearchParams(probe=probe, topk=5, rerank=rerank),
    )
    pos_g, lb_g = cand.pos.numpy(), cand.lower_bound.numpy()
    fin = np.isfinite(lb_g)
    assert not (lb_g[fin].view(np.int32) & mask).any()  # decoded: folded
    np.testing.assert_array_equal(fin, np.isfinite(lb_w))
    rtol = 1e-5 + 2.0 ** (fold_slot_bits(span) - 23)
    atol = 1e-6 * np.abs(lb_w[fin]).max()
    np.testing.assert_allclose(lb_g, lb_w, rtol=rtol, atol=atol)
    for q in range(b):
        got, want = set(pos_g[q, fin[q]]), set(pos_w[q, fin[q]])
        only_g = sorted(lb_g[q][np.isin(pos_g[q], list(got - want))])
        only_w = sorted(lb_w[q][np.isin(pos_w[q], list(want - got))])
        assert len(only_g) == len(only_w) <= 2
        np.testing.assert_allclose(only_g, only_w, rtol=rtol, atol=atol)


@pytest.mark.parametrize("fold", [0, 1, 2])
@pytest.mark.parametrize("d", [256, 512])
def test_qpack_twin_equals_unpacked_twin(rng, d, fold):
    """Edge cases included: size 0, size == span, size > span, row N-1."""
    n, span = 1500, 384
    sizes = [0, span, 1, 200, span + 9, 129, 300, 77]
    starts = [3, 0, n - 1, 500, 900, 40, n - span, 10]
    ops = list(map(torch.from_numpy,
                   _random_operands(rng, n, d, span, sizes, starts)))
    want = rough_scan_reference(*ops, span, fold)
    ops[4] = pack_query_nibbles(ops[4])
    got = cuda_rough_scan(*ops, span, fold, True)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_qpack_rejects_other_dims(rng):
    ops = list(map(torch.from_numpy,
                   _random_operands(rng, 300, 128, 128, [8, 9], [0, 5])))
    ops[4] = pack_query_nibbles(ops[4])
    with pytest.raises(ValueError, match="256"):
        cuda_rough_scan(*ops, 128, 0, True)
    ops = list(map(torch.from_numpy,
                   _random_operands(rng, 300, 256, 128, [8, 9], [0, 5])))
    with pytest.raises(ValueError, match="qvals"):  # unpacked values
        cuda_rough_scan(*ops, 128, 0, True)


@pytest.fixture(scope="module")
def jax_qpack_index():
    """A 256-d JAX index (the qpack gate holds) of capacity > 256 (both
    fold depths fold), and 2 queries."""
    rng = np.random.default_rng(12)
    base, centers = make_clustered_dataset(rng, n=2400, dim=256, k=6)
    jidx = rq.build_index(base, centers, key=jax.random.key(1), bits=4)
    assert jidx.dim % 256 == 0 and jidx.capacity > 256
    return jidx, base[:2] + 0.01


@pytest.mark.parametrize("reduce", [0, 1, 2])
def test_qpack_twin_matches_pallas_kernel_interpret(jax_qpack_index, reduce):
    """pallas_rough_scan(qpack=True) on the aligned path that search uses,
    against the port's packed twin, which equals its unpacked twin bit for
    bit."""
    jidx, queries = jax_qpack_index
    cids, starts, sizes, qvals, scal = _scan_inputs(jidx, queries, 4)
    packed = pack_query_nibbles(torch.from_numpy(np.array(qvals)))
    span = jidx.capacity
    want, _, _ = pallas_rough_scan(
        jidx.codes_pm1, jidx.factors_tiled, starts, sizes,
        jnp.asarray(packed.numpy()), scal, span=span, k_max=jidx.k,
        interpret=True, cids=cids, starts_k=padded_offsets(jidx.offsets)[:-1],
        aligned=True, reduce=reduce, qpack=True,
    )
    pidx = port_index_from_jax(jidx)
    ops = [pidx.codes, pidx.factors,
           *(torch.from_numpy(np.array(a)) for a in (starts, sizes))]
    scal_t = torch.from_numpy(np.array(scal))
    got = cuda_rough_scan(*ops, packed, scal_t, span, reduce, True).numpy()
    unpacked = cuda_rough_scan(
        *ops, torch.from_numpy(np.array(qvals)), scal_t, span, reduce
    ).numpy()
    np.testing.assert_array_equal(got.view(np.int32), unpacked.view(np.int32))
    want = np.asarray(want)
    if reduce:
        full = cuda_rough_scan(*ops, packed, scal_t, span, 0, True).numpy()
        _assert_fold_close(got, want, full, np.asarray(sizes), span, reduce)
    else:
        _assert_scan_close(got, want)
