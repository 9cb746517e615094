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
every mode; and so must the int4 kernels (integer
arithmetic). The fused quantize kernel equals its twin bit for bit in the
quantized values (packed or not), lo, delta and code_sum, and its ycd =
sum r^2, summed in another order, within rtol 1e-6. The gather-l2 kernel
sums the same f32 squares as its twin in another order: rtol 1e-5, atol
1e-5 * max|out|; both give NaN exactly at positions outside [0, N).
"""

import concurrent.futures
import dataclasses
import itertools

import numpy as np
import pytest
import torch

import rabitq_tpu_torch as rt
from chip_smoke import (
    assert_gather_close,
    cluster_gather_positions,
    cluster_scan_operands,
    gather_operands,
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
    rough_scan_reference,
)
from rabitq_tpu_torch.ops.quantize import quantize_plan
from rabitq_tpu_torch.ops.scan_kernel import effective_fold, fold_slot_bits
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
    cpu_idx = dataclasses.replace(idx, **{
        f.name: getattr(idx, f.name).cpu() for f in dataclasses.fields(idx)
        if isinstance(getattr(idx, f.name), torch.Tensor)
    })
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
    chunks, the query reloaded per chunk), R across the 32-position item and a step (1 ... 300), B = 37
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
    kernel once and the scan once in qpack mode; the results equal the CPU
    path's but at near-ties, and a dump reloaded on the card searches
    alike."""
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
    cpu_idx = dataclasses.replace(idx, **{
        f.name: getattr(idx, f.name).cpu() for f in dataclasses.fields(idx)
        if isinstance(getattr(idx, f.name), torch.Tensor)
    })
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


def test_filtered_mutated_adaptive_search_on_card(dev):
    """A filtered search of a mutated index (tombstones and a memtable)
    and an adaptive one, on the card: each scan call launches the
    quantize, scan and gather_l2 kernels once, and the results equal the
    CPU path's but at near-ties."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((16, 128)).astype(np.float32)
    base = (centers[rng.integers(0, 16, 6000)]
            + 0.3 * rng.standard_normal((6000, 128))).astype(np.float32)
    idx = rt.build_index(base, centers, bits=4, spill=0.2, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    fresh = rng.standard_normal((50, 128)).astype(np.float32)
    idx = rt.delete(rt.insert(idx, fresh), np.arange(0, 6000, 7))
    rf = rt.make_row_filter(idx, allow_ids=np.arange(0, 6050, 2))
    cpu_idx = dataclasses.replace(idx, **{
        f.name: getattr(idx, f.name).cpu() for f in dataclasses.fields(idx)
        if isinstance(getattr(idx, f.name), torch.Tensor)
    })
    cpu_rf = rt.RowFilter(rf.penalty.cpu(), rf.extra_penalty.cpu())
    queries = torch.from_numpy(np.concatenate([base[:24], fresh[:8]]) + 0.01)
    params = rt.SearchParams(probe=6, topk=10, rerank=64)
    counters = (cuda_quantize_residuals, cuda_rough_scan, cuda_gather_l2)
    before = [c.launches for c in counters]
    d_gpu, i_gpu = rt.search(idx, queries.to(dev), params, rf)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [b + 1 for b in before]
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
