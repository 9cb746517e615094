"""The select stage: the plain version against a numpy brute force on the
CPU, and the CUDA kernel (csrc/select.cu) against the plain version on
the card.

The card tests are marked ``cuda`` and skip without a CUDA device. This
file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_select.py

Both versions keep the R lowest values of each row by (value, flat index):
NaN after +inf, and among equal values the lower flat index first. The
kernel writes them in flat order, the plain version in value order, so
the card tests compare the (lower bound bits, position) pairs as
multisets, which also holds the kernel to the tie rule.
"""

import importlib

import numpy as np
import pytest
import torch

import rabitq_tpu_torch as rt
from chip_smoke import assert_same_candidates
from rabitq_tpu_torch.ops import (
    cuda_select_candidates,
    select_candidates_reference,
)


def pack_slots(values, slots, slot_bits):
    """The scan's lane fold packing: each finite value's low ``slot_bits``
    mantissa bits replaced by its window slot; +inf stays +inf."""
    bits = values.view(np.int32).copy()
    mask = (1 << slot_bits) - 1
    fin = np.isfinite(values)
    bits[fin] = (bits[fin] & ~mask) | slots[fin]
    return bits.view(np.float32)


def rows(seed, b, probe, width, finite=1.0, negative=False, ties=0,
         slot_bits=0, capacity=None):
    """[B, probe * width] rough values and [B, probe] int32 starts: random
    estimates (some negative), a share ``finite`` of them finite and the
    rest +inf; folded rows carry random slots below ``capacity``;
    ``ties`` copies of each row's 10th lowest value planted at random
    places, so that the R-th lowest (R > 10) is one of them. Starts are
    cluster starts in [0, 1000)."""
    rng = np.random.default_rng(seed)
    n = probe * width
    v = rng.uniform(1.0, 4.0, (b, n)).astype(np.float32)
    if negative:
        v -= np.float32(3.0)
    v[rng.random((b, n)) >= finite] = np.inf
    if slot_bits:
        slots = rng.integers(0, capacity, (b, n)).astype(np.int32)
        v = pack_slots(v, slots, slot_bits)
    if ties:
        for row in v:
            row[rng.choice(n, ties, replace=False)] = np.sort(row)[9]
    starts = rng.integers(0, 1000, (b, probe)).astype(np.int32)
    return v, starts


def brute_force(v, starts, width, r, slot_bits, n):
    """numpy: the R lowest by (value, flat index) of each row, decoded;
    (pos, lb) in value order."""
    order = np.argsort(v, axis=1, kind="stable")[:, :r]
    lb = np.take_along_axis(v, order, 1)
    base = np.take_along_axis(starts.astype(np.int64), order // width, 1)
    if slot_bits:
        mask = (1 << slot_bits) - 1
        bits = lb.view(np.int32)
        pos = base + (bits & mask)
        lb = (bits & ~mask).view(np.float32)
    else:
        pos = base + order % width
    return np.minimum(pos, n - 1), lb


# (probe, width, R, slot_bits or 0, row options, index rows n)
CPU_CASES = {
    "sift cell, folded": (28, 256, 32, 9, dict(finite=0.9), 1_000_000),
    "gist cell, folded": (64, 256, 150, 10, dict(finite=0.95), 1_000_000),
    "folded, +inf decodes to slot 0": (4, 256, 40, 9, dict(finite=0.05),
                                       1_000_000),
    "unfolded, +inf pads": (6, 37, 50, 0, dict(finite=0.1), 1_000_000),
    "unfolded, clamp to n - 1": (5, 300, 64, 0, dict(finite=0.5), 1100),
    "folded, clamp to n - 1": (8, 256, 60, 9, dict(finite=0.8), 1050),
    "negative estimates": (8, 128, 30, 0, dict(negative=True), 1_000_000),
    "ties at the threshold": (8, 128, 30, 0, dict(ties=40), 1_000_000),
    "R equal to n": (4, 16, 64, 0, dict(finite=0.7), 1_000_000),
    "all +inf": (3, 64, 20, 0, dict(finite=0.0), 1_000_000),
}


@pytest.mark.parametrize("case", list(CPU_CASES))
def test_reference_equals_brute_force(case):
    """The plain version: an exact top-R with the lowest flat index among
    equal values, the fold's slot decode, the clamp to n - 1 and +inf
    pads (slot 0 of their task when folded), bit for bit."""
    probe, width, r, slot_bits, opts, n = CPU_CASES[case]
    v, starts = rows(7, 6, probe, width, slot_bits=slot_bits,
                     capacity=300, **opts)
    pos, lb = select_candidates_reference(
        torch.from_numpy(v), torch.from_numpy(starts), width, r, slot_bits,
        n)
    want_pos, want_lb = brute_force(v, starts, width, r, slot_bits, n)
    np.testing.assert_array_equal(pos.numpy(), want_pos)
    np.testing.assert_array_equal(lb.numpy().view(np.int32),
                                  want_lb.view(np.int32))
    assert pos.dtype == torch.int64 and lb.dtype == torch.float32
    assert int(pos.max()) <= n - 1
    # The CPU wrapper is the plain version.
    pos2, lb2 = cuda_select_candidates(
        torch.from_numpy(v), torch.from_numpy(starts), width, r, slot_bits,
        n)
    assert torch.equal(pos2, pos) and torch.equal(lb2.view(torch.int32),
                                                  lb.view(torch.int32))


def test_reference_rejects_bad_operands():
    v, starts = rows(1, 2, 4, 64)
    v, starts = torch.from_numpy(v), torch.from_numpy(starts)
    with pytest.raises(ValueError, match="rerank"):
        select_candidates_reference(v, starts, 64, 257, 0, 100)
    with pytest.raises(ValueError, match="expected"):
        select_candidates_reference(v, starts, 32, 10, 0, 100)
    with pytest.raises(ValueError, match="int32"):
        select_candidates_reference(v, starts.long(), 64, 10, 0, 100)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (B, probe, width, R, slot_bits, row options, launches streamed)
CARD_CASES = {
    "sift cell (28 x 256, R 32, folded)": (
        2048, 28, 256, 32, 9, dict(finite=0.93), 0),
    "gist cell (64 x 256, R 150, folded)": (
        1024, 64, 256, 150, 10, dict(finite=0.97), 0),
    "filtered, unfolded, odd row, 1% finite": (
        256, 27, 301, 32, 0, dict(finite=0.01), 0),
    "filtered, unfolded, 10% finite": (
        256, 28, 301, 150, 0, dict(finite=0.10), 0),
    "streamed (384 x 256, R 150)": (
        64, 384, 256, 150, 10, dict(finite=0.9), 1),
    "blobs cell, streamed (384 x 256, R 32, folded)": (
        512, 384, 256, 32, 9, dict(finite=0.9), 1),
    "streamed, unfolded, odd row, 1% finite": (
        16, 97, 301, 150, 0, dict(finite=0.01), 1),
    "R equal to n": (64, 4, 64, 256, 0, dict(finite=0.8), 0),
    "fewer finite than R": (128, 8, 256, 150, 9, dict(finite=0.02), 0),
    "all +inf": (32, 8, 129, 40, 0, dict(finite=0.0), 0),
    "negative estimates": (512, 28, 256, 32, 0, dict(negative=True), 0),
    "ties at the threshold": (512, 28, 256, 32, 0, dict(ties=64), 0),
    "ties at the threshold, folded": (
        512, 64, 256, 150, 10, dict(ties=200), 0),
    "few ties, ranked by one warp": (512, 28, 256, 11, 0, dict(ties=3), 0),
    "R above the 2048 staged slots": (64, 16, 256, 3000, 0, dict(), 0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernel_equals_reference(dev, case):
    """The kernel's (lb, pos) pairs equal the plain version's, ties
    included, at the cells' shapes, filtered and streamed rows and the
    edge cases; and the launch counters move by one."""
    b, probe, width, r, slot_bits, opts, streamed = CARD_CASES[case]
    v, starts = rows(11, b, probe, width, slot_bits=slot_bits,
                     capacity=300, **opts)
    n = 1_000_000
    rough, st = torch.from_numpy(v).to(dev), torch.from_numpy(starts).to(dev)
    before = (cuda_select_candidates.launches,
              cuda_select_candidates.launches_streamed)
    got = cuda_select_candidates(rough, st, width, r, slot_bits, n)
    torch.cuda.synchronize()
    assert (cuda_select_candidates.launches,
            cuda_select_candidates.launches_streamed) == (
        before[0] + 1, before[1] + streamed)
    want = select_candidates_reference(rough, st, width, r, slot_bits, n)
    assert_same_candidates(got, want)
    # And the numpy brute force on a few rows.
    pos_w, lb_w = brute_force(v[:4], starts[:4], width, r, slot_bits, n)
    assert_same_candidates([t[:4] for t in got], (torch.from_numpy(pos_w),
                                                  torch.from_numpy(lb_w)))


@pytest.mark.cuda
def test_kernel_writes_flat_order_and_keeps_lowest_ties(dev):
    """Unfolded with one start a row: positions are flat indices, so the
    output is ascending, and of 64 equal values at the threshold the
    lowest-indexed are kept."""
    n_val, r = 4096, 100
    v = np.full((8, n_val), 5.0, np.float32)
    v[:, 1000:1050] = 1.0  # 50 below the threshold, then ties at 5.0
    starts = np.zeros((8, 1), np.int32)
    pos, lb = cuda_select_candidates(
        torch.from_numpy(v).to(dev), torch.from_numpy(starts).to(dev),
        n_val, r, 0, 1 << 20)
    want = np.concatenate([np.arange(50), np.arange(1000, 1050)])
    want.sort()
    np.testing.assert_array_equal(pos.cpu().numpy(),
                                  np.broadcast_to(want, (8, r)))
    np.testing.assert_array_equal(
        lb.cpu().numpy(), np.where(np.isin(want, np.arange(1000, 1050)),
                                   np.float32(1.0), np.float32(5.0))[None]
        .repeat(8, 0))


@pytest.mark.cuda
def test_kernel_rejects_bad_operands(dev):
    v, starts = rows(1, 2, 4, 64)
    v, starts = torch.from_numpy(v).to(dev), torch.from_numpy(starts).to(dev)
    with pytest.raises(ValueError, match="rerank"):
        cuda_select_candidates(v, starts, 64, 257, 0, 100)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_select_candidates(v.t().contiguous().t(), starts, 64, 10, 0,
                               100)
    pos, lb = cuda_select_candidates(v[:0], starts[:0], 64, 10, 0, 100)
    assert pos.shape == lb.shape == (0, 10)


@pytest.mark.cuda
@pytest.mark.parametrize("select_reduce", [True, False])
def test_search_through_kernel_equals_reference(dev, monkeypatch,
                                                select_reduce):
    """search on a small spilled index on the card returns the same ids
    and distances through the kernel and through the plain version, the
    fold on and off."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((16, 96)).astype(np.float32)
    base = (centers[rng.integers(0, 16, 6000)]
            + 0.3 * rng.standard_normal((6000, 96))).astype(np.float32)
    queries = torch.from_numpy(base[:128] + 0.05).to(dev)
    idx = rt.build_index(
        base, centers, bits=4, spill=0.2, balance=1.5, device=dev,
        generator=torch.Generator(device=dev).manual_seed(0),
    )
    assert idx.dedup_ids
    params = rt.SearchParams(probe=6, topk=10, rerank=48,
                             select_reduce=select_reduce)
    before = cuda_select_candidates.launches
    d_k, i_k = rt.search(idx, queries, params)
    assert cuda_select_candidates.launches == before + 1
    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    monkeypatch.setattr(tsearch, "cuda_select_candidates",
                        select_candidates_reference)
    d_r, i_r = rt.search(idx, queries, params)
    assert cuda_select_candidates.launches == before + 1
    assert torch.equal(i_k, i_r)
    assert torch.equal(d_k, d_r)
