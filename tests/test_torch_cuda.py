"""Card-only tests of the port: the CUDA kernels against their twins.

Marked ``cuda``; they skip where no CUDA device is present. This file
imports neither JAX nor tests/conftest.py, so on a machine with a card and
no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The rough-scan kernel must equal its twin bit for bit (the estimator is
written in the twin's operation order with explicitly rounded intrinsics,
and the int8 tensor-core dot is exact), on random operands and on
cluster-structured ones whose tasks share windows, in each of its modes
(the full output and the lane fold at depth 1 and 2), also on the
nibble-packed query operand (qpack), where it must equal the unpacked
kernel on the same values, and with the row-filter penalty operand in
every mode, also where each resident block runs many groups whose loads
overlap the previous group's work (windows of 1-8 rows, empty clusters
between full ones, windows of the span and of span - 1, fewer groups than
resident blocks, launches back to back), where ``rough_scan_counts`` adds
the groups of ``group_tasks``; and so must the int4 kernels (integer
arithmetic). The fused quantize kernel equals its twin bit for bit in the
quantized values (packed or not), lo, delta and code_sum, and its ycd =
sum r^2, summed in another order, within rtol 1e-6. The gather-l2 kernel
sums the same f32 squares as its twin in another order: rtol 1e-5, atol
1e-5 * max|out|; both give NaN exactly at positions outside [0, N). So
does its bf16-row instance, whose rows widen to f32 exactly. The search's
two-level rerank, its bf16 cluster ranking and the packed ids agree with
the CPU path. On every search path each kernel launches once a scan call,
and a batch makes no host sync.
"""

import concurrent.futures
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import rabitq_tpu_torch as rt
from chip_smoke import (
    GROUP_CASES,
    assert_gather_close,
    cluster_gather_positions,
    cluster_scan_operands,
    gather_operands,
    group_case_operands,
    quantize_operands,
    scan_operands,
    scan_penalty,
)
from rabitq_tpu_torch.ops import (
    cuda_gather_l2,
    cuda_int4_dot,
    cuda_quantize_residuals,
    cuda_rough_scan,
    pack_query_nibbles,
    quantize_residuals_reference,
    gather_l2_reference,
    int4_dot_reference,
    pack_int4,
    rough_scan_counts,
    rough_scan_reference,
)
from rabitq_tpu_torch.ops.quantize import quantize_plan
from rabitq_tpu_torch.ops.scan_kernel import (
    effective_fold,
    fold_slot_bits,
    group_tasks,
)
from rabitq_tpu_torch.tools import int4probe

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize(
    "n,d,span,s,bits",
    [
        (700, 64, 128, 37, 1),
        (5000, 128, 384, 300, 4),
        (3000, 960, 256, 64, 4),
        (1_200_000, 128, 384, 2048 * 28, 4),  # the sift path's shapes
        (1_200_000, 1024, 512, 1024 * 80, 4),  # the gist path's shapes
    ],
)
def test_kernel_equals_twin(dev, n, d, span, s, bits):
    ops = scan_operands(dev, n, s, span, d, seed=n + d, bits=bits)
    got = cuda_rough_scan(*ops, span)
    want = rough_scan_reference(*ops, span)
    torch.cuda.synchronize()
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert torch.equal(got, want)
    assert torch.isinf(got[0]).all() and torch.isfinite(got[1]).all()
    assert torch.isfinite(got[2]).all() and torch.isfinite(got[3, :1]).all()


@pytest.mark.parametrize(
    "d,n_clusters,b,probe,span",
    [
        (128, 40, 64, 6, 128),
        (96, 300, 128, 16, 200),
        (128, 4097, 2048, 28, 384),  # the sift path's shapes
        (1024, 4097, 1024, 80, 384),  # the gist path's shapes
    ],
)
def test_grouped_kernel_equals_twin_on_clusters(dev, d, n_clusters, b, probe,
                                                span):
    """Tasks that share windows, with empty clusters beside their
    successors and the last cluster full and ending at row N-1."""
    ops = cluster_scan_operands(dev, n_clusters, b, probe, span, d,
                                seed=d + b)
    got = cuda_rough_scan(*ops, span)
    want = rough_scan_reference(*ops, span)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.isfinite(got[0]).all()  # the last cluster, size == span


@pytest.mark.parametrize("fold", [0, 1, 2])
@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize("s", [1, 16, 17, 24, 32, 33, 2048])
def test_grouped_kernel_max_sharing(dev, d, s, fold):
    """Every task probes one window ending at row N-1 (17-31 tasks: two
    m16 tiles, the second partial; 33: two groups; 2048 tasks: 64 groups
    of one key); every third task instead probes an empty cluster at the
    same start, a group whose window is empty."""
    n, span = 1000, 384
    ops = list(scan_operands(dev, n, max(s, 4), span, d, seed=s + d))
    ops[4], ops[5] = ops[4][:s], ops[5][:s]
    ops[2] = torch.full((s,), n - span, dtype=torch.int32, device=dev)
    ops[3] = torch.full((s,), span, dtype=torch.int32, device=dev)
    ops[3][1::3] = 0
    got = cuda_rough_scan(*ops, span, fold)
    want = rough_scan_reference(*ops, span, fold)
    torch.cuda.synchronize()
    assert got.shape == (s, fold * 128 if fold else span)
    assert torch.equal(got, want)
    assert torch.isfinite(got[0]).all()
    if s > 1:
        assert torch.isinf(got[1]).all()


def _same_bits(got, want):
    return torch.equal(got.view(torch.int32), want.view(torch.int32))


def _without_host_sync(fn):
    """fn() under sync debug mode "error": an op that synchronizes with
    the host raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


@pytest.mark.parametrize("fold", [1, 2])
@pytest.mark.parametrize(
    "d,span,kind",
    [(128, 384, "random"), (1024, 384, "random"), (128, 300, "random"),
     (1024, 520, "random"), (128, 384, "clusters"), (1024, 384, "clusters"),
     (96, 700, "clusters")],
)
def test_folded_kernel_equals_twin(dev, d, span, kind, fold):
    """The lane fold, bit for bit, on random operands (edge cases: size 0,
    size == span, a cluster ending at row N-1, a single row there) and on
    clustered ones whose tasks share windows; spans not a multiple of
    128 among them."""
    if kind == "random":
        ops = scan_operands(dev, 5000, 300, span, d, seed=span + d + fold)
    else:
        ops = cluster_scan_operands(dev, 300, 128, 16, span, d,
                                    seed=span + d + fold)
    assert effective_fold(span, fold) == fold
    got = cuda_rough_scan(*ops, span, fold)
    want = rough_scan_reference(*ops, span, fold)
    torch.cuda.synchronize()
    assert got.shape == (ops[2].shape[0], fold * 128)
    assert _same_bits(got, want)
    if kind == "random":
        assert torch.isinf(got[0]).all() and torch.isfinite(got[1]).all()
        assert torch.isfinite(got[3, 0]) and torch.isinf(got[3, 1:]).all()


@pytest.mark.parametrize("fold", [1, 2])
@pytest.mark.parametrize("d", [128, 1024])
def test_fold_bucket_walk(dev, d, fold):
    """Chosen (task, bucket) pairs get their best three values in the
    window's three tiles, in each of the six orders, over both m16 tiles,
    all eight warps, both n8 tiles and both accumulator columns, and two
    groups (40 tasks on one window). Every other slot estimates to 200.
    The kernel keeps the best (and second best) by slot, values exact,
    and equals the twin bit for bit."""
    s, span = 40, 384
    pairs = [(0, 0), (9, 17), (15, 38), (16, 51), (23, 73), (31, 94),
             (5, 109), (28, 127), (35, 66), (39, 3), (16, 8), (31, 120)]
    orders = list(itertools.permutations(range(3)))
    codes = torch.zeros((span, d), dtype=torch.int8)
    qvals = torch.zeros((s, d), dtype=torch.int8)
    factors = torch.zeros((span, 4))
    factors[:, 0] = 1.0    # ip
    factors[:, 3] = 200.0  # cdsq
    scal = torch.zeros((s, 4))
    scal[:, 1] = 1.0  # delta: the estimate is 200 + dot
    expect = []
    for k, (t, r) in enumerate(pairs):
        qvals[t, k] = 1
        slots = [tile * 128 + r for tile in orders[k % len(orders)]]
        for rank, j in enumerate(slots):
            codes[j, k] = -100 + 10 * rank  # estimates 100, 110, 120
        expect.append((t, r, slots))
    starts = torch.zeros(s, dtype=torch.int32)
    sizes = torch.full((s,), span, dtype=torch.int32)
    ops = [x.to(dev) for x in (codes, factors, starts, sizes, qvals, scal)]
    got = cuda_rough_scan(*ops, span, fold)
    want = rough_scan_reference(*ops, span, fold)
    torch.cuda.synchronize()
    assert _same_bits(got, want)
    mask = (1 << fold_slot_bits(span)) - 1
    bits = got.cpu().view(torch.int32)
    for t, r, slots in expect:
        for rank in range(fold):
            b = int(bits[t, rank * 128 + r])
            assert b & mask == slots[rank], (t, r, rank)
            value = torch.tensor(b & ~mask, dtype=torch.int32).view(
                torch.float32)
            assert float(value) == 100.0 + 10 * rank


@pytest.mark.parametrize("d", [128, 1024])
@pytest.mark.parametrize(
    "task,row,k",
    [(0, 0, 0), (7, 9, 5), (8, 127, 17), (15, 128, 31), (16, 200, 100),
     (31, 383, 1023), (20, 130, 64), (3, 255, 47)],
)
def test_fragment_layout_one_hot(dev, d, task, row, k):
    """One query value and one code value are non-zero, and the factors and
    scalars reduce the estimator to the dot: exactly one slot, (task, row),
    holds 5 * 3 and every other slot 0. A wrong ldmatrix or mma fragment
    mapping moves or loses it."""
    s, span = 32, 384
    k %= d
    codes = torch.zeros((span, d), dtype=torch.int8, device=dev)
    codes[row, k] = 3
    factors = torch.zeros((span, 4), device=dev)
    factors[:, 0] = 1.0  # ip
    qvals = torch.zeros((s, d), dtype=torch.int8, device=dev)
    qvals[task, k] = 5
    scal = torch.zeros((s, 4), device=dev)
    scal[:, 1] = 1.0  # delta
    starts = torch.zeros(s, dtype=torch.int32, device=dev)
    sizes = torch.full((s,), span, dtype=torch.int32, device=dev)
    got = cuda_rough_scan(codes, factors, starts, sizes, qvals, scal, span)
    want = torch.zeros((s, span), device=dev)
    want[task, row] = 15.0
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_kernel_rejects_dim_not_multiple_of_32(dev):
    ops = scan_operands(dev, 500, 8, 128, 48, seed=3)
    with pytest.raises(ValueError, match="multiple of 32"):
        cuda_rough_scan(*ops, 128)


def test_shared_memory_size_across_threads(dev):
    """The kernel's shared-memory maximum is one attribute of the device:
    a thread that launches at D 128 after another thread's D 1024 launch
    must not leave it too small for that thread's next D 1024 launch."""
    wide = scan_operands(dev, 2000, 40, 256, 1024, seed=5)
    narrow = scan_operands(dev, 2000, 40, 256, 128, seed=6)
    want = rough_scan_reference(*wide, 256)
    with concurrent.futures.ThreadPoolExecutor(1) as a, \
            concurrent.futures.ThreadPoolExecutor(1) as b:
        first = a.submit(cuda_rough_scan, *wide, 256).result()
        b.submit(cuda_rough_scan, *narrow, 256).result()
        again = a.submit(cuda_rough_scan, *wide, 256).result()
    torch.cuda.synchronize()
    assert torch.equal(first, want) and torch.equal(again, want)


def test_launch_counter(dev):
    ops = scan_operands(dev, 500, 8, 300, 64, seed=1)
    before = cuda_rough_scan.launches
    cuda_rough_scan(*ops, 300)
    cuda_rough_scan(*ops, 300, 2)
    assert cuda_rough_scan.launches == before + 2
    empty = [t[:0] if i >= 2 else t for i, t in enumerate(ops)]
    assert cuda_rough_scan(*empty, 300).shape == (0, 300)
    assert cuda_rough_scan(*empty, 300, 2).shape == (0, 256)
    assert cuda_rough_scan.launches == before + 2


def test_kernel_rejects_misaligned_operands(dev):
    ops = list(scan_operands(dev, 500, 9, 128, 64, seed=2))
    # Contiguous, but 4 bytes past a 16-byte boundary.
    ops[5] = torch.zeros((9 * 4 + 1,), device=dev)[1:].view(9, 4)
    with pytest.raises(ValueError, match="aligned"):
        cuda_rough_scan(*ops, 128)


# The scan's operand modes in the many-group tests: D, qpack, and the share
# of rows the penalty filters (0: no penalty operand).
RING_MODES = {"plain": (128, False, 0.0), "qpack": (256, True, 0.0),
              "penalty": (128, False, 0.3),
              "qpack_penalty": (1024, True, 0.3)}


def _ring_operands(dev, case, d, qpack, density, seed):
    ops = list(group_case_operands(dev, case, 384, d, seed=seed))
    if qpack:
        ops[4] = pack_query_nibbles(ops[4])
    pen = (scan_penalty(dev, ops[0].shape[0], density, seed=seed)
           if density else None)
    return ops, pen


@pytest.mark.parametrize("mode", sorted(RING_MODES))
@pytest.mark.parametrize("fold", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_ring_across_groups_equals_twin(dev, case, fold, mode):
    """Each resident block runs many groups, whose loads the producer warp
    issues while the consumers work on the previous group: windows of 1-8
    rows in groups of 1 and 32 tasks, empty clusters between full ones, a
    window of exactly the span and one of span - 1, and fewer groups than
    resident blocks. Bit-equal to the twin in every fold depth, with and
    without qpack and the penalty."""
    d, qpack, density = RING_MODES[mode]
    ops, pen = _ring_operands(dev, case, d, qpack, density,
                              seed=fold * 7 + d)
    got = cuda_rough_scan(*ops, 384, fold, qpack, pen)
    want = rough_scan_reference(*ops, 384, fold, qpack, pen)
    torch.cuda.synchronize()
    assert got.shape == (ops[2].shape[0], fold * 128 if fold else 384)
    assert _same_bits(got, want)


@pytest.mark.parametrize("fold", [0, 1, 2])
def test_ring_back_to_back_launches(dev, fold):
    """Three launches on one stream with no sync between them, at D 128,
    1024 (another launch plan: one block an SM, more stages) and 128
    again: each block's barriers and ring start clean."""
    calls = [(*_ring_operands(dev, "tiny", 128, False, 0.0, seed=11), False),
             (*_ring_operands(dev, "span_edges", 1024, True, 0.3, seed=12),
              True)]
    calls.append(calls[0])
    outs = [cuda_rough_scan(*ops, 384, fold, qpack, pen)
            for ops, pen, qpack in calls]
    for (ops, pen, qpack), got in zip(calls, outs):
        want = rough_scan_reference(*ops, 384, fold, qpack, pen)
        torch.cuda.synchronize()
        assert _same_bits(got, want)


@pytest.mark.parametrize("case", sorted(GROUP_CASES))
def test_rough_scan_counts_groups(dev, case):
    """rough_scan_counts: a launch adds the groups of group_tasks to the
    groups run, and at most as many to the groups prefetched."""
    ops = group_case_operands(dev, case, 384, 128, seed=5)
    s = ops[2].shape[0]
    _, first = group_tasks(ops[2], ops[3], ops[0].shape[0], 384)
    n_groups = int((first < s).sum())
    run0, pre0 = rough_scan_counts(dev)
    cuda_rough_scan(*ops, 384, 2)
    run1, pre1 = rough_scan_counts(dev)
    assert run1 - run0 == n_groups
    assert 0 <= pre1 - pre0 <= n_groups


@pytest.mark.parametrize("select_reduce", [True, False])
def test_gpu_search_matches_cpu_search(dev, select_reduce):
    """The default search folds on both devices (capacity > 256), the
    kernel on the card and its twin on the CPU; and unfolded."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((16, 96)).astype(np.float32)
    base = (centers[rng.integers(0, 16, 6000)]
            + 0.3 * rng.standard_normal((6000, 96))).astype(np.float32)
    queries = torch.from_numpy(base[:64] + 0.05)
    idx = rt.build_index(
        base, centers, bits=4, spill=0.2, balance=1.5, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0),
    )
    cpu_idx = _cpu_copy(idx)
    assert effective_fold(idx.capacity, 2) == 2
    params = rt.SearchParams(probe=6, topk=10, rerank=32,
                             select_reduce=select_reduce)
    d_gpu, i_gpu = rt.search(idx, queries.to(dev), params)
    d_cpu, i_cpu = rt.search(cpu_idx, queries, params)
    same = i_gpu.cpu() == i_cpu
    assert same.float().mean() >= 0.98
    torch.testing.assert_close(
        d_gpu.cpu()[same], d_cpu[same], rtol=1e-5, atol=1e-5
    )


@pytest.mark.parametrize(
    "n,d,b,r",
    [
        (3000, 256, 12, 40),
        (1500, 512, 4, 130),
        (1_200_000, 128, 2048, 32),  # the sift path's shapes
        (1_200_000, 1024, 1024, 150),  # the gist path's shapes
    ],
)
def test_gather_l2_kernel_matches_twin(dev, n, d, b, r):
    base, pos, q = gather_operands(dev, n, d, b, r, seed=n + d)
    got = cuda_gather_l2(base, pos, q)
    want = gather_l2_reference(base, pos, q)
    torch.cuda.synchronize()
    assert_gather_close(got, want)
    assert torch.equal(got[:, 2], got[:, 3])  # duplicate positions
    last = ((base[n - 1][None, :] - q) ** 2).sum(-1)
    torch.testing.assert_close(got[:, 0], last, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("r", [1, 7, 31, 32, 33, 150, 300])
@pytest.mark.parametrize("d", [4, 64, 128, 132, 256, 960, 1024, 2052])
def test_gather_l2_kernel_edges(dev, d, r):
    """Both instances (D <= 128: 8 lanes a row; D > 128: 32 lanes in
    1024-float chunks; vectors past the row masked; D 2052 in three
    chunks, the query reloaded per chunk), R across the 32-position item
    and a step (1 ... 300), B = 37
    (not a multiple of the 8 items a block takes), and out-of-range
    positions beside valid ones in one step of one lane group: NaN exactly
    there, the twin's values everywhere else."""
    n, b = 3000, 37
    gen = torch.Generator(device=dev).manual_seed(d * 1000 + r)
    base = torch.randn((n, d), generator=gen, device=dev)
    q = torch.randn((b, d), generator=gen, device=dev)
    pos = torch.randint(0, n, (b, r), generator=gen, device=dev)
    bad = [(5, 0, -1), (5, min(1, r - 1), n), (36, r - 1, n + 7)]
    if r > 32:
        bad.append((20, 32, -(2**40)))  # the second item's first position
    for i, j, v in bad:
        pos[i, j] = v
    got = cuda_gather_l2(base, pos, q, check_pos=False)
    want = gather_l2_reference(base, pos, q)
    torch.cuda.synchronize()
    nan = torch.zeros((b, r), dtype=torch.bool, device=dev)
    for i, j, _ in bad:
        nan[i, j] = True
    assert torch.equal(got.isnan(), nan) and torch.equal(want.isnan(), nan)
    assert_gather_close(got[~nan], want[~nan])


def test_gather_l2_cluster_local_positions(dev):
    """The sift shape on positions drawn from 28 windows a query."""
    base, _, q = gather_operands(dev, 1_200_000, 128, 2048, 32, seed=9)
    pos = cluster_gather_positions(dev, 1_200_000, 2048, 32, seed=9)
    got = cuda_gather_l2(base, pos, q)
    want = gather_l2_reference(base, pos, q)
    torch.cuda.synchronize()
    assert_gather_close(got, want)


def test_gather_l2_launch_counter_and_rejections(dev):
    base, pos, q = gather_operands(dev, 500, 64, 6, 10, seed=3)
    before = cuda_gather_l2.launches
    cuda_gather_l2(base, pos, q)
    assert cuda_gather_l2.launches == before + 1
    assert cuda_gather_l2(base, pos[:0], q[:0]).shape == (0, 10)
    assert cuda_gather_l2(base, pos[:, :0], q).shape == (6, 0)
    assert cuda_gather_l2.launches == before + 1
    for bad in (-1, 500):
        p = pos.clone()
        p[2, 5] = bad
        with pytest.raises(ValueError, match="outside"):
            cuda_gather_l2(base, p, q)
    # Unchecked, the kernel reads no row outside [0, N): NaN there.
    p = pos.clone()
    p[2, 5], p[4, 0] = -1, 500
    got = cuda_gather_l2(base, p, q, check_pos=False)
    assert got[2, 5].isnan() and got[4, 0].isnan()
    assert got.isnan().sum() == 2
    assert cuda_gather_l2.launches == before + 2
    misaligned = torch.zeros(6 * 64 + 1, device=dev)[1:].view(6, 64)
    with pytest.raises(ValueError, match="aligned"):
        cuda_gather_l2(base, pos, misaligned)
    with pytest.raises(ValueError, match="multiple of 4"):
        cuda_gather_l2(base[:, :62].contiguous(), pos, q[:, :62].contiguous())
    assert cuda_gather_l2.launches == before + 2


@pytest.mark.parametrize(
    "m,n,k",
    [
        (int4probe.M, int4probe.N, int4probe.K),  # the TPU probe's shapes
        (37, 70, 96),  # ragged tiles
        (65536, 64, 1024),  # a scan window against a batch of queries
    ],
)
@pytest.mark.parametrize("staged", [False, True])
def test_int4_kernels_equal_twin(dev, m, n, k, staged):
    a8, b8, want = int4probe.operands(seed=m, m=m, n=n, k=k)
    a = pack_int4(torch.from_numpy(a8).to(dev))
    b = pack_int4(torch.from_numpy(b8).to(dev))
    got = cuda_int4_dot(a, b, staged=staged)
    assert torch.equal(got, int4_dot_reference(a, b))
    assert torch.equal(got.cpu(), torch.from_numpy(want))


def _int4_exact(dev, a8, b8, staged):
    a = pack_int4(torch.from_numpy(a8).to(dev))
    b = pack_int4(torch.from_numpy(b8).to(dev))
    got = cuda_int4_dot(a, b, staged=staged).cpu().numpy()
    want = a8.astype(np.int32) @ b8.astype(np.int32).T
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("staged", [False, True])
def test_int4_one_hot_pins_widening_and_fragments(dev, staged):
    """Row i of A holds one +-1, at column (i + shift) % K; column k of B
    one +-1, in row k % N. So each row lands in exactly one output,
    (i, ((i + shift) % K) % N), with the product of the two signs. Over
    all K shifts every (row, column) of A takes its turn: both nibbles of
    a byte, every word and lane quad of a chunk, two chunks, two 256-row
    tiles (the second ragged), both m16 tiles and halves of a warp, all
    eight n8 tiles."""
    m, n, k = 300, 64, 256
    rng = np.random.default_rng(7)
    rows = np.arange(m)
    for shift in range(k):
        cols = (rows + shift) % k
        a8 = np.zeros((m, k), np.int8)
        a8[rows, cols] = rng.choice(np.array([-1, 1], np.int8), m)
        b8 = np.zeros((n, k), np.int8)
        b8[np.arange(k) % n, np.arange(k)] = rng.choice(
            np.array([-1, 1], np.int8), k)
        got = _int4_exact(dev, a8, b8, staged)
        assert np.count_nonzero(got) == m
        assert (got[rows, cols % n] == a8[rows, cols] * b8[cols % n, cols]).all()


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("k", [32, 1024, 4096])
@pytest.mark.parametrize("va,vb", [(-8, -8), (7, 7), (-8, 7)])
def test_int4_extreme_operands(dev, va, vb, k, staged):
    """All -8 / all 7: every output is va * vb * K (64 K, 49 K, -56 K);
    K 32 is one k step, K 4096 two widenings of B (2048 columns each)."""
    m, n = 300, 65
    got = _int4_exact(dev, np.full((m, k), va, np.int8),
                      np.full((n, k), vb, np.int8), staged)
    assert (got == va * vb * k).all()


@pytest.mark.parametrize("staged", [False, True])
@pytest.mark.parametrize("n", [1, 8, 63, 64, 65, 512])
@pytest.mark.parametrize("m", [1, 255, 256, 257, 513])
def test_int4_ragged_tiles(dev, m, n, staged):
    """M around the 256-row tile, N around the 8- and 64-column tiles
    (odd N stores element by element), K 160: a full 128-column chunk
    and a 32-column one."""
    a8, b8, _ = int4probe.operands(seed=m * 1000 + n, m=m, n=n, k=160)
    _int4_exact(dev, a8, b8, staged)


@pytest.mark.parametrize("staged", [False, True])
def test_int4_wide_k(dev, staged):
    """K 4160: B widened three times a tile, the last 64 columns alone."""
    a8, b8, _ = int4probe.operands(seed=3, m=700, n=70, k=4160)
    _int4_exact(dev, a8, b8, staged)


def test_int4_probe_runs_both_kernels(dev):
    before = (cuda_int4_dot.launches_direct, cuda_int4_dot.launches_staged)
    stages = int4probe.run(dev)
    assert set(stages) == {
        "1 twin", "1b nbytes", "2 int4_dot_direct", "3 int4_dot_staged"
    }
    assert (cuda_int4_dot.launches_direct, cuda_int4_dot.launches_staged) == (
        before[0] + 1, before[1] + 1
    )


def test_int4_launch_counters_and_rejections(dev):
    a = torch.zeros((40, 64), dtype=torch.uint8, device=dev)
    b = torch.zeros((8, 64), dtype=torch.uint8, device=dev)
    before = (cuda_int4_dot.launches_direct, cuda_int4_dot.launches_staged)
    for staged in (False, True):
        assert cuda_int4_dot(a[:0], b, staged=staged).shape == (0, 8)
        assert cuda_int4_dot(a, b[:0], staged=staged).shape == (40, 0)
    assert (cuda_int4_dot.launches_direct,
            cuda_int4_dot.launches_staged) == before
    with pytest.raises(ValueError, match="multiple of 16"):
        cuda_int4_dot(a[:, :36], b[:, :36], staged=False)  # K = 72
    misaligned = torch.zeros(40 * 64 + 4, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        cuda_int4_dot(misaligned[4:].view(40, 64), b, staged=True)


def _quantize_equal(got, want):
    (qg, sg), (qw, sw) = got, want
    assert torch.equal(qg, qw)
    assert torch.equal(sg[:, :3], sw[:, :3])
    torch.testing.assert_close(sg[:, 3], sw[:, 3], rtol=1e-6, atol=0)


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize(
    "b,probe,d,pack",
    [
        (1, 1, 8, False), (5, 3, 8, True), (7, 9, 96, False),
        (33, 5, 256, True), (3, 2, 4096, True),  # beyond 48 KB of smem
        (2048, 28, 128, False),  # the sift path's shapes
        (1024, 80, 1024, True),  # the gist path's shapes (qpack)
        (3, 100, 1024, True),  # probe not a multiple of a block's groups
        (4, 1, 128, False),  # probe 1: one 8-lane group busy of a warp's four
        (5, 3, 128, False),  # the last 8-lane group of a block partial
        (600, 29, 128, False),  # runs of tasks that cross queries
        (6, 7, 136, False), (4, 9, 520, True),  # rows not whole 16-byte units
        (5, 11, 160, False), (3, 21, 544, True),  # lanes without a unit
        (2, 33, 256, False), (2, 33, 256, True),  # 8 lanes, 8 slots a lane
        (3, 17, 1024, False),  # two units a lane
        (3, 5, 1032, True),  # just above the register path
    ],
)
def test_quantize_kernel_equals_twin(dev, b, probe, d, pack, dither):
    y, c, cids, bias = quantize_operands(dev, b, probe, d, seed=b + d)
    rb = bias if dither else None
    got = cuda_quantize_residuals(y, c, cids, rb, pack)
    want = quantize_residuals_reference(y, c, cids, rb, pack)
    torch.cuda.synchronize()
    _quantize_equal(got, want)


def test_quantize_edge_values(dev):
    """A zero residual (delta at its guard, every q 0), a constant one, and
    values halfway between two steps (round half to even)."""
    y, c, cids, _ = quantize_operands(dev, 4, 3, 64, seed=1)
    cids[0, 0], cids[1, 1] = 0, 1
    c[0] = y[0]  # task 0: r = 0
    y[1], c[1] = 0.0, -2.5  # task 4: r = 2.5 exactly
    y[2] = torch.arange(64, device=dev, dtype=torch.float32) * 0.5
    got = cuda_quantize_residuals(y, c, cids)
    want = quantize_residuals_reference(y, c, cids)
    torch.cuda.synchronize()
    _quantize_equal(got, want)
    tiny = torch.tensor(1e-30, device=dev)
    assert got[1][0, 1] == tiny and got[1][4, 1] == tiny
    assert not got[0][0].any() and not got[0][4].any()


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize(
    "b,probe,d,pack", [(600, 28, 128, False), (200, 80, 1024, True)]
)
def test_quantize_zero_residual_after_first_task(dev, b, probe, d, pack,
                                                 dither):
    """Zero residuals (delta at its guard, every q 0) in tasks that follow
    others in their lane group's run, whose row was loaded while the one
    before was quantized, and in tasks that start a run."""
    y, c, cids, bias = quantize_operands(dev, b, probe, d, seed=3)
    run = quantize_plan(cids.numel(), d, pack, dither).run
    assert run > 1
    tasks = [t for t in range(probe, 2 * probe) if t % run in (0, run - 1)]
    for t in tasks[:4]:
        c[cids[1, t - probe]] = y[1]
    rb = bias if dither else None
    got = cuda_quantize_residuals(y, c, cids, rb, pack)
    want = quantize_residuals_reference(y, c, cids, rb, pack)
    torch.cuda.synchronize()
    _quantize_equal(got, want)
    for t in tasks[:4]:
        assert got[1][t, 1] == 1e-30 and got[1][t, 3] == 0
        assert not got[0][t].any()


def test_quantize_launch_counter_and_rejections(dev):
    y, c, cids, bias = quantize_operands(dev, 3, 4, 64, seed=2)
    before = cuda_quantize_residuals.launches
    cuda_quantize_residuals(y, c, cids, bias, True)
    assert cuda_quantize_residuals(y[:0], c, cids[:0])[0].shape == (0, 64)
    assert cuda_quantize_residuals.launches == before + 1
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_quantize_residuals(y[:, :60].contiguous(),
                                c[:, :60].contiguous(), cids)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_quantize_residuals(y, c, cids[:, ::2])


@pytest.mark.parametrize("fold", [0, 1, 2])
@pytest.mark.parametrize("kind", ["random", "clusters"])
@pytest.mark.parametrize("d", [256, 1024])
def test_qpack_kernel_equals_twin_and_unpacked(dev, d, kind, fold):
    if kind == "random":
        ops = list(scan_operands(dev, 5000, 700, 384, d, seed=d))
    else:
        ops = list(cluster_scan_operands(dev, 300, 128, 16, 384, d, seed=d))
    unpacked = cuda_rough_scan(*ops, 384, fold)
    ops[4] = pack_query_nibbles(ops[4])
    got = cuda_rough_scan(*ops, 384, fold, True)
    want = rough_scan_reference(*ops, 384, fold, True)
    torch.cuda.synchronize()
    assert _same_bits(got, want) and _same_bits(got, unpacked)


def test_qpack_launch_counter_and_rejections(dev):
    ops = list(scan_operands(dev, 500, 8, 300, 256, seed=4))
    ops[4] = pack_query_nibbles(ops[4])
    before = (cuda_rough_scan.launches, cuda_rough_scan.launches_qpack)
    cuda_rough_scan(*ops, 300, 2, True)
    assert (cuda_rough_scan.launches, cuda_rough_scan.launches_qpack) == (
        before[0] + 1, before[1] + 1)
    with pytest.raises(ValueError, match="256"):
        small = list(scan_operands(dev, 500, 8, 300, 128, seed=4))
        small[4] = pack_query_nibbles(small[4])
        cuda_rough_scan(*small, 300, 0, True)


def test_search_at_1024d_runs_quantize_and_qpack_once(dev, tmp_path):
    """A 960-d index (padded to 1024): one batch launches the quantize
    kernel once and the scan once in qpack mode, and makes no host sync;
    the results equal the CPU path's but at near-ties, and a dump reloaded
    on the card searches alike."""
    from rabitq_tpu_torch.index.serialize import dump_to_dir, load_from_dir

    rng = np.random.default_rng(1)
    centers = rng.standard_normal((12, 960)).astype(np.float32)
    base = (centers[rng.integers(0, 12, 4000)]
            + 0.3 * rng.standard_normal((4000, 960))).astype(np.float32)
    idx = rt.build_index(base, centers, bits=4, spill=0.2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    assert idx.dim == 1024
    queries = torch.from_numpy(base[:32] + 0.05)
    params = rt.SearchParams(probe=4, topk=10, rerank=40)
    before = (cuda_quantize_residuals.launches, cuda_rough_scan.launches,
              cuda_rough_scan.launches_qpack)
    d_gpu, i_gpu = rt.search(idx, queries.to(dev), params)
    torch.cuda.synchronize()
    assert (cuda_quantize_residuals.launches, cuda_rough_scan.launches,
            cuda_rough_scan.launches_qpack) == tuple(x + 1 for x in before)
    q = queries.to(dev)
    _without_host_sync(lambda: rt.search(idx, q, params))
    cpu_idx = _cpu_copy(idx)
    d_cpu, i_cpu = rt.search(cpu_idx, queries, params)
    same = i_gpu.cpu() == i_cpu
    assert same.float().mean() >= 0.98
    torch.testing.assert_close(d_gpu.cpu()[same], d_cpu[same], rtol=1e-5,
                               atol=1e-5)
    dump_to_dir(idx, tmp_path)
    loaded = load_from_dir(tmp_path, device=dev)
    d2, i2 = rt.search(loaded, queries.to(dev), params)
    assert torch.equal(i2, i_gpu) and torch.equal(d2, d_gpu)


@pytest.mark.parametrize("density", [0.01, 0.5])
@pytest.mark.parametrize("fold", [0, 1, 2])
@pytest.mark.parametrize("kind", ["random", "clusters"])
@pytest.mark.parametrize("d,qpack", [(128, False), (1024, False),
                                     (1024, True)])
def test_penalty_kernel_equals_twin(dev, d, qpack, kind, fold, density):
    """The row-filter penalty operand ([N] f32, +inf on a ``density``
    share of the rows), in every mode, bit for bit; a penalized row is
    +inf unfolded and never in a fold bucket."""
    if kind == "random":
        ops = list(scan_operands(dev, 5000, 300, 384, d, seed=d + fold))
    else:
        ops = list(cluster_scan_operands(dev, 300, 128, 16, 384, d,
                                         seed=d + fold))
    pen = scan_penalty(dev, ops[0].shape[0], density, seed=fold)
    if qpack:
        ops[4] = pack_query_nibbles(ops[4])
    before = cuda_rough_scan.launches
    got = cuda_rough_scan(*ops, 384, fold, qpack, pen)
    want = rough_scan_reference(*ops, 384, fold, qpack, pen)
    plain = cuda_rough_scan(*ops, 384, fold, qpack)
    torch.cuda.synchronize()
    assert cuda_rough_scan.launches == before + 2
    assert _same_bits(got, want)
    assert not _same_bits(got, plain)
    assert torch.isinf(got).sum() > torch.isinf(plain).sum()


@pytest.mark.parametrize(
    "n,d,b,r",
    [
        (3000, 256, 12, 40),
        (1_200_000, 128, 2048, 32),  # the sift path's shapes
        (1_200_000, 1024, 1024, 150),  # the gist path's shapes
    ],
)
def test_gather_l2_bf16_kernel_matches_twin(dev, n, d, b, r):
    base, pos, q = gather_operands(dev, n, d, b, r, seed=n + d)
    base = base.to(torch.bfloat16)
    got = cuda_gather_l2(base, pos, q)
    want = gather_l2_reference(base, pos, q)
    torch.cuda.synchronize()
    assert_gather_close(got, want)
    assert torch.equal(got[:, 2], got[:, 3])  # duplicate positions


@pytest.mark.parametrize("r", [1, 31, 33, 150])
@pytest.mark.parametrize("d", [8, 64, 128, 136, 256, 1024, 2056])
def test_gather_l2_bf16_kernel_edges(dev, d, r):
    """Both bf16 instances (D <= 128: 8 lanes a row, 2 vectors a lane;
    D > 128: 32 lanes in 1024-value chunks, D 2056 in three), R across an
    item, B = 37, and out-of-range positions: NaN exactly there."""
    n, b = 3000, 37
    gen = torch.Generator(device=dev).manual_seed(d * 1000 + r)
    base = torch.randn((n, d), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((b, d), generator=gen, device=dev)
    pos = torch.randint(0, n, (b, r), generator=gen, device=dev)
    bad = [(5, 0, -1), (36, r - 1, n + 7)]
    for i, j, v in bad:
        pos[i, j] = v
    got = cuda_gather_l2(base, pos, q, check_pos=False)
    want = gather_l2_reference(base, pos, q)
    torch.cuda.synchronize()
    nan = torch.zeros((b, r), dtype=torch.bool, device=dev)
    for i, j, _ in bad:
        nan[i, j] = True
    assert torch.equal(got.isnan(), nan) and torch.equal(want.isnan(), nan)
    assert_gather_close(got[~nan], want[~nan])


def test_gather_l2_bf16_launch_counter_and_rejections(dev):
    base, pos, q = gather_operands(dev, 500, 64, 6, 10, seed=4)
    bf = base.to(torch.bfloat16)
    f32, before = cuda_gather_l2.launches, cuda_gather_l2.launches_bf16
    cuda_gather_l2(bf, pos, q)
    assert cuda_gather_l2.launches_bf16 == before + 1
    assert cuda_gather_l2.launches == f32
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_gather_l2(bf[:, :60].contiguous(), pos, q[:, :60].contiguous())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        cuda_gather_l2(base.half(), pos, q)
    assert cuda_gather_l2.launches_bf16 == before + 1


def test_rerank_bf16_and_bf16_ranking_on_card_equal_cpu(dev):
    """The two-level rerank at refine -1 and 0, and the bf16 ranking, on
    the card: the bf16 instance launches once a batch (and the f32 one
    once more when it refines), a batch makes no host sync, the results
    equal the CPU path's but at near-ties; the packed ids unpack to the
    search's."""
    from rabitq_tpu_torch.index.index import with_bf16_base
    from rabitq_tpu_torch.index.search import search_many_packed
    from rabitq_tpu_torch.ops.distances import bf16_gemm_route
    from rabitq_tpu_torch.ops.idpack import nbits_for, unpack_ids

    rng = np.random.default_rng(4)
    centers = rng.standard_normal((16, 128)).astype(np.float32)
    base = (centers[rng.integers(0, 16, 6000)]
            + 0.3 * rng.standard_normal((6000, 128))).astype(np.float32)
    idx = with_bf16_base(rt.build_index(
        base, centers, bits=4, spill=0.2, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0)))
    cpu_idx = with_bf16_base(_cpu_copy(idx))
    queries = torch.from_numpy(base[:32] + 0.01)
    for refine, f32_launches in ((-1, 1), (0, 0)):
        params = rt.SearchParams(probe=6, topk=10, rerank=64,
                                 rerank_bf16=True, rerank_refine=refine)
        before = (cuda_gather_l2.launches, cuda_gather_l2.launches_bf16)
        d_gpu, i_gpu = rt.search(idx, queries.to(dev), params)
        torch.cuda.synchronize()
        assert (cuda_gather_l2.launches - before[0],
                cuda_gather_l2.launches_bf16 - before[1]) == (f32_launches, 1)
        q = queries.to(dev)
        _without_host_sync(lambda: rt.search(idx, q, params))
        d_cpu, i_cpu = rt.search(cpu_idx, queries, params)
        same = i_gpu.cpu() == i_cpu
        assert same.float().mean() >= 0.98
        torch.testing.assert_close(d_gpu.cpu()[same], d_cpu[same],
                                   rtol=1e-5, atol=1e-5)
    assert bf16_gemm_route(dev).startswith("cublas")
    p = rt.SearchParams(probe=6, topk=10, rerank=64, rank_precision="default")
    d_gpu, i_gpu = rt.search(idx, queries.to(dev), p)
    d_cpu, i_cpu = rt.search(cpu_idx, queries, p)
    assert (i_gpu.cpu() == i_cpu).float().mean() >= 0.98
    nb = nbits_for(idx.n)
    words = search_many_packed(idx, queries.to(dev).reshape(2, 16, 128), p,
                               nb)
    _, ids = rt.search_many(idx, queries.to(dev).reshape(2, 16, 128), p)
    np.testing.assert_array_equal(unpack_ids(words, nb, ids.numel()),
                                  ids.cpu().numpy().reshape(-1))


def test_filtered_mutated_adaptive_search_on_card(dev):
    """A filtered search of a mutated index (tombstones and a memtable)
    and an adaptive one, on the card: each scan call launches the
    quantize, scan and gather_l2 kernels once, the filtered batch makes no
    host sync, and the results equal the CPU path's but at near-ties."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((16, 128)).astype(np.float32)
    base = (centers[rng.integers(0, 16, 6000)]
            + 0.3 * rng.standard_normal((6000, 128))).astype(np.float32)
    idx = rt.build_index(base, centers, bits=4, spill=0.2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    fresh = rng.standard_normal((50, 128)).astype(np.float32)
    idx = rt.delete(rt.insert(idx, fresh), np.arange(0, 6000, 7))
    rf = rt.make_row_filter(idx, allow_ids=np.arange(0, 6050, 2))
    cpu_idx = _cpu_copy(idx)
    cpu_rf = rt.RowFilter(rf.penalty.cpu(), rf.extra_penalty.cpu())
    queries = torch.from_numpy(np.concatenate([base[:24], fresh[:8]]) + 0.01)
    params = rt.SearchParams(probe=6, topk=10, rerank=64)
    counters = (cuda_quantize_residuals, cuda_rough_scan, cuda_gather_l2)
    before = [c.launches for c in counters]
    d_gpu, i_gpu = rt.search(idx, queries.to(dev), params, rf)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 1 for b in before]
    q = queries.to(dev)
    _without_host_sync(lambda: rt.search(idx, q, params, rf))
    d_cpu, i_cpu = rt.search(cpu_idx, queries, params, cpu_rf)
    ids = i_gpu.cpu()
    assert not torch.isin(ids, torch.arange(1, 6050, 2)).any()
    assert not torch.isin(ids, torch.arange(0, 6000, 7)).any()
    same = ids == i_cpu
    assert same.float().mean() >= 0.98
    # The memtable's distances come from |q|^2 - 2<q, x> + |x|^2 (as in the
    # JAX package): the two devices round its terms apart, by a few ulp of
    # |q|^2 + |x|^2, whatever the distance.
    atol = 1e-5 * float((queries * queries).sum(1).max())
    torch.testing.assert_close(d_gpu.cpu()[same], d_cpu[same], rtol=1e-5,
                               atol=atol)
    d_a, i_a, p_a = rt.search_adaptive(idx, queries.to(dev), params._replace(
        probe=2))
    d_c, i_c, p_c = rt.search_adaptive(cpu_idx, queries, params._replace(
        probe=2))
    assert p_a == p_c
    same = i_a.cpu() == i_c
    assert same.float().mean() >= 0.98


def test_search_with_store_on_card_equals_cpu(dev, tmp_path):
    """The store tier on the card: a base-less index (and a mutated one
    under a filter) searched with search_with_store through a DeviceStore
    on the card launches the quantize and scan kernels once and gather_l2
    never, and equals the same call on the CPU but at near-ties (the
    exact distances are host numpy over the same rows: equal ids give
    equal distances). Its estimate makes no host sync (the batch's one
    copy to the host, for the store's rows, is by design)."""
    from rabitq_tpu_torch.index.search import estimate_candidates
    from rabitq_tpu_torch.index.serialize import dump_to_dir, load_from_dir
    from rabitq_tpu_torch.store import DeviceStore, MmapStore, search_with_store

    rng = np.random.default_rng(3)
    centers = rng.standard_normal((16, 128)).astype(np.float32)
    base = (centers[rng.integers(0, 16, 6000)]
            + 0.3 * rng.standard_normal((6000, 128))).astype(np.float32)
    idx = rt.build_index(base, centers, bits=4, spill=0.2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    dump_to_dir(idx, tmp_path)
    lean = load_from_dir(tmp_path, keep_base=False, device=dev)
    lean_cpu = load_from_dir(tmp_path, keep_base=False, device="cpu")
    queries = base[:40] + np.float32(0.01)
    params = rt.SearchParams(probe=6, topk=10, rerank=48)
    fresh = rng.standard_normal((30, 128)).astype(np.float32)
    mut = rt.delete(rt.insert(idx, fresh), np.arange(0, 6000, 9))
    mut_cpu = _cpu_copy(mut)
    allow = np.arange(0, 6030, 2)
    cases = [
        (lean, lean_cpu, DeviceStore(idx.base), DeviceStore(idx.base.cpu()),
         None, None, queries),
        (lean, lean_cpu, MmapStore(tmp_path / "base.fvecs"),
         MmapStore(tmp_path / "base.fvecs"), None, None,
         torch.from_numpy(queries).to(dev)),
        (mut, mut_cpu, DeviceStore(mut.base), DeviceStore(mut_cpu.base),
         rt.make_row_filter(mut, allow_ids=allow),
         rt.make_row_filter(mut_cpu, allow_ids=allow),
         np.concatenate([queries[:20], fresh[:8] + np.float32(0.01)])),
    ]
    counters = (cuda_quantize_residuals, cuda_rough_scan, cuda_gather_l2)
    for gidx, cidx, gst, cst, gf, cf, q in cases:
        before = [c.launches for c in counters]
        d_g, i_g = search_with_store(gidx, q, params, gst, row_filter=gf)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 0]
        q_cpu = q.cpu().numpy() if isinstance(q, torch.Tensor) else q
        d_c, i_c = search_with_store(cidx, q_cpu, params, cst, row_filter=cf)
        same = i_g == i_c
        assert same.mean() >= 0.98
        np.testing.assert_array_equal(d_g[same], d_c[same])
        if gf is not None:
            assert np.isin(i_g[i_g >= 0], allow).all()
    q = torch.from_numpy(queries).to(dev)
    _without_host_sync(lambda: estimate_candidates(lean, q, params))


@pytest.mark.parametrize("path", ["plain", "packed"])
def test_search_path_launches_once_a_scan_call_without_host_sync(dev, path):
    """search_many at D 128, returning ids and distances or the packed
    ids: every search kernel launches once a scan call (probe_rank at
    least once), and one batch makes no host sync. The other paths check
    the same in their own tests."""
    from rabitq_tpu_torch.index.search import search_many_packed
    from rabitq_tpu_torch.ops.idpack import nbits_for
    from rabitq_tpu_torch.tools.bench import run_captured

    rng = np.random.default_rng(7)
    centers = rng.standard_normal((16, 128)).astype(np.float32)
    base = (centers[rng.integers(0, 16, 6000)]
            + 0.3 * rng.standard_normal((6000, 128))).astype(np.float32)
    idx = rt.build_index(base, centers, bits=4, spill=0.2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    qd = torch.from_numpy(base[:64] + 0.01).to(dev).reshape(2, 32, 128)
    params = rt.SearchParams(probe=6, topk=10, rerank=64)
    if path == "packed":
        def run(q):
            return search_many_packed(idx, q, params, nbits_for(idx.n))
    else:
        def run(q):
            return rt.search_many(idx, q, params)
    _, counts = run_captured(lambda: run(qd))
    want = {k: 2 for k in ("rough_scan calls", "quantize", "rough_scan",
                           "select", "gather_l2")}
    assert {k: counts[k] for k in want} == want, counts
    assert counts["probe_rank"] >= 2, counts
    _without_host_sync(lambda: run(qd[:1]))
    torch.cuda.synchronize()


def _replay_index(dev, case):
    """A small index and its parameters for each case of the replay tests:
    D 128 with spilled (deduped) rows, D 960 padded to 1024 (qpack), the
    two-level bf16 rerank, and a live memtable with deletions."""
    dim = 960 if case == "qpack" else 128
    rng = np.random.default_rng(11)
    centers = rng.standard_normal((16, dim)).astype(np.float32)
    base = (centers[rng.integers(0, 16, 5000)]
            + 0.3 * rng.standard_normal((5000, dim))).astype(np.float32)
    idx = rt.build_index(base, centers, bits=4, spill=0.2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    params = rt.SearchParams(probe=6, topk=10, rerank=48)
    if case == "bf16":
        from rabitq_tpu_torch.index.index import with_bf16_base

        idx = with_bf16_base(idx)
        params = params._replace(rerank_bf16=True)
    if case == "memtable":
        idx = rt.delete(rt.insert(idx, base[:40] + 0.02), np.arange(0, 5000, 11))
    qs = torch.from_numpy(base[:96] + 0.01).to(dev).reshape(3, 32, dim)
    return idx, params, qs


@pytest.mark.parametrize("case", ["plain", "qpack", "bf16", "memtable"])
def test_search_replay_equals_eager(dev, case):
    """A batch shape's first search runs eagerly, its second records a
    CUDA graph, and from then on the search replays it: every result
    equals the eager search of the same batch bit for bit, a result is
    not overwritten by later replays, each kernel's launch counter
    advances once a search, and a replay makes no host sync."""
    from rabitq_tpu_torch.index import replay
    from rabitq_tpu_torch.ops import cuda_gather_l2, cuda_select_candidates

    idx, params, qs = _replay_index(dev, case)
    with replay.paused():
        want = [rt.search(idx, q, params) for q in qs]
    replay.clear()
    counters = (cuda_quantize_residuals, cuda_rough_scan,
                cuda_select_candidates, cuda_gather_l2)
    before = [c.launches for c in counters]
    order = [0, 1, 2, 1, 0]
    got = [rt.search(idx, qs[b], params) for b in order[:4]]
    got.append(_without_host_sync(lambda: rt.search(idx, qs[0], params)))
    torch.cuda.synchronize()
    assert [c.launches - n for c, n in zip(counters, before)] == [5] * 4
    (entry,) = replay._graphs.values()
    assert entry.graph is not None
    for b, (d, i) in zip(order, got):
        assert torch.equal(d, want[b][0]) and torch.equal(i, want[b][1]), b


def test_search_replay_keys(dev):
    """Another index, other parameters or another batch shape get graphs
    of their own, and each replays its own results; past MAX_GRAPHS
    graphs a new key runs eagerly; a row-filtered batch and a batch with
    the spans on run eagerly and record nothing."""
    from rabitq_tpu_torch import profiling
    from rabitq_tpu_torch.index import replay

    idx, params, qs = _replay_index(dev, "plain")
    other = rt.delete(idx, np.arange(0, 5000, 3))
    wide = params._replace(probe=9)
    runs = [(idx, qs[0], params), (other, qs[0], params), (idx, qs[0], wide),
            (idx, qs[1, :16], params), (idx, qs[1, :8], params)]
    with replay.paused():
        want = [rt.search(*r) for r in runs]
    replay.clear()
    for _ in range(3):
        for r, (d, i) in zip(runs, want):
            got = rt.search(*r)
            assert torch.equal(got[0], d) and torch.equal(got[1], i)
    assert len(replay._graphs) == replay.MAX_GRAPHS == 4
    assert all(e.graph is not None for e in replay._graphs.values())
    assert replay._key(idx, qs[1, :8], params) in replay._seen
    replay.clear()
    flt = rt.make_row_filter(idx, allow_ids=np.arange(0, 5000, 2))
    for _ in range(3):
        rt.search(idx, qs[0], params, row_filter=flt)
    profiling.SPANS.enable()
    try:
        for _ in range(3):
            rt.search(idx, qs[0], params)
    finally:
        profiling.SPANS.disable()
    assert not replay._graphs and not replay._seen


def _cpu_copy(index):
    return dataclasses.replace(index, **{
        f.name: getattr(index, f.name).cpu() for f in dataclasses.fields(index)
        if isinstance(getattr(index, f.name), torch.Tensor)
    })


def _sharded_corpus(seed, n=8000, k=32):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, 128)).astype(np.float32)
    base = (centers[rng.integers(0, k, n)]
            + 0.3 * rng.standard_normal((n, 128))).astype(np.float32)
    return rng, base, centers


@pytest.mark.parametrize("exact", [False, True])
def test_sharded_search_on_card_equals_cpu(dev, exact):
    """sharded_search over 4 shards on cuda:0 (and one shard a card where
    the host has 4) against the same shards on the CPU: each search kernel
    launches once a shard a batch, the ids are the CPU path's but at
    near-ties, a filtered batch keeps only allowed ids, and a batch makes
    no host sync."""
    from rabitq_tpu_torch.parallel import (
        make_mesh,
        make_sharded_row_filter,
        shard_index,
        sharded_search,
    )

    rng, base, centers = _sharded_corpus(4)
    idx = rt.build_index(base, centers, bits=4, spill=0.2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    idx = rt.insert(idx, rng.standard_normal((20, 128)).astype(np.float32))
    cpu_idx = _cpu_copy(idx)
    meshes = [make_mesh(devices=[dev] * 4)]
    if torch.cuda.device_count() >= 4:
        meshes.append(make_mesh(4))
    cpu_mesh = make_mesh(devices=["cpu"] * 4)
    cpu_s = shard_index(cpu_idx, cpu_mesh)
    queries = torch.from_numpy(base[:48] + np.float32(0.01))
    params = rt.SearchParams(probe=8, topk=10, rerank=48)
    allow = np.arange(0, 8020, 3)
    counters = (cuda_quantize_residuals, cuda_rough_scan, cuda_gather_l2)
    d_c, i_c = sharded_search(cpu_s, queries, params, cpu_mesh, exact=exact)
    for mesh in meshes:
        sidx = shard_index(cpu_idx, mesh)
        q = queries.to(mesh.home)
        before = [c.launches for c in counters]
        d_g, i_g = sharded_search(sidx, q, params, mesh, exact=exact)
        torch.cuda.synchronize()
        assert [c.launches - b for c, b in zip(counters, before)] == [4] * 3
        same = i_g.cpu() == i_c
        assert same.float().mean() >= 0.98
        atol = 1e-5 * float((queries * queries).sum(1).max())
        torch.testing.assert_close(d_g.cpu()[same], d_c[same], rtol=1e-5,
                                   atol=atol)
        rf = make_sharded_row_filter(sidx, mesh, allow_ids=allow)
        torch.cuda.set_sync_debug_mode("error")
        try:
            _, i_f = sharded_search(sidx, q, params, mesh, exact=exact,
                                    row_filter=rf)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        i_f = i_f.cpu()
        assert np.isin(i_f[i_f >= 0].numpy(), allow).all()


def test_sharded_store_tier_on_card_equals_cpu(dev, tmp_path):
    """sharded_search_with_store over 4 base-less shards on cuda:0 and one
    mmap store: quantize and rough_scan launch once a shard, gather_l2
    never, and the result equals the CPU shards' but at near-ties, equal
    ids carrying equal distances (the same numpy sums)."""
    from rabitq_tpu_torch.index.serialize import dump_to_dir
    from rabitq_tpu_torch.parallel import (
        make_mesh,
        shard_global_positions,
        shard_index,
        sharded_search_with_store,
    )
    from rabitq_tpu_torch.store import MmapStore

    _, base, centers = _sharded_corpus(5)
    idx = rt.build_index(base, centers, bits=4, spill=0.2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    dump_to_dir(idx, tmp_path)
    lean = dataclasses.replace(_cpu_copy(idx), base=None)
    gpos = shard_global_positions(lean, 4)
    store = MmapStore(tmp_path / "base.fvecs")
    params = rt.SearchParams(probe=8, topk=10, rerank=48)
    queries = base[:40] + np.float32(0.01)
    out = {}
    counters = (cuda_quantize_residuals, cuda_rough_scan, cuda_gather_l2)
    for name, devs in (("card", [dev] * 4), ("cpu", ["cpu"] * 4)):
        mesh = make_mesh(devices=devs)
        before = [c.launches for c in counters]
        out[name] = sharded_search_with_store(
            shard_index(lean, mesh), queries, params, mesh, store, gpos)
        if name == "card":
            assert [c.launches - b for c, b in zip(counters, before)] == [
                4, 4, 0]
    (d_g, i_g), (d_c, i_c) = out["card"], out["cpu"]
    same = i_g == i_c
    assert same.mean() >= 0.98
    np.testing.assert_array_equal(d_g[same], d_c[same])


def test_build_index_sharded_on_card_is_bit_equal(dev):
    """build_index_sharded over 4 shards on cuda:0 equals
    shard_index(build_index(...)) bit for bit on the card: every build
    step has the same shape (chunk_rows), so a row's codes and factors do
    not depend on which rows share its step."""
    from rabitq_tpu_torch.parallel import (
        build_index_sharded,
        make_mesh,
        shard_index,
    )

    _, base, centers = _sharded_corpus(6, n=40000, k=64)
    mesh = make_mesh(devices=[dev] * 4)
    kw = dict(bits=4, spill=0.2, balance=1.5, chunk=16384)
    ref = shard_index(rt.build_index(
        base, centers, device=dev,
        generator=torch.Generator(device=dev).manual_seed(1), **kw), mesh)
    new = build_index_sharded(
        base, centers, mesh,
        generator=torch.Generator(device=dev).manual_seed(1), **kw)
    assert (new.k_max, new.rows_max, new.tiles_max) == (
        ref.k_max, ref.rows_max, ref.tiles_max)
    for (si, a), (_, b) in zip(new.local(), ref.local()):
        for f in ("codes", "factors", "offsets", "map_ids", "centroids_rot",
                  "base"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (si, f)


@pytest.mark.parametrize("dim,probe,rerank,topk", [(128, 28, 32, 10),
                                                   (960, 64, 150, 100)])
def test_stage_spans_cover_the_search_on_card(dev, dim, probe, rerank, topk):
    """With spans on, the six stages' device ms of a batch sum to within
    10% of a synchronized event pair around the whole ``search`` call.
    The card is kept busy ahead of the host (``torch.cuda._sleep``), so
    the host's time between stages leaves no gap on the device."""
    from rabitq_tpu_torch import profiling

    stages = ("search.rank", "search.quantize", "search.scan",
              "search.select", "search.rerank", "search.topk")
    rng = np.random.default_rng(5)
    k, n = 256, 60000
    centers = rng.standard_normal((k, dim)).astype(np.float32)
    base = (centers[rng.integers(0, k, n)]
            + 0.3 * rng.standard_normal((n, dim))).astype(np.float32)
    idx = rt.build_index(base, centers, bits=4, spill=0.2, balance=1.5,
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    q = torch.from_numpy(base[:2048] + 0.05).to(dev)
    params = rt.SearchParams(probe=probe, topk=topk, rerank=rerank)
    want = rt.search(idx, q, params)
    profiling.SPANS.clear()
    profiling.enable()
    try:
        for _ in range(3):
            torch.cuda._sleep(50_000_000)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            got = rt.search(idx, q, params)
            b.record()
            torch.cuda.synchronize()
            whole = a.elapsed_time(b)
            (batch,) = profiling.SPANS.batches(last=1)
            total = sum(batch[s][1] for s in stages)
            assert 0.9 * whole <= total <= batch["search"][1] + 1e-3, (
                whole, batch)
            assert batch["search"][1] <= whole + 1e-3
            assert all(torch.equal(x, y) for x, y in zip(got, want))
    finally:
        profiling.disable()
        profiling.SPANS.clear()
