"""The benchmark's probe_rank_roofline reader on the CPU: its bytes for a
small index, its share from a trace's records, and nothing where the
trace holds no record of the kernel or the program counts no launch (as
on a program without the kernel)."""

import types

import numpy as np
import pytest
import torch

import rabitq_tpu_torch as rt
from benchmark import spec
from benchmark.metrics import probe_rank_roofline as mod


@pytest.fixture(scope="module")
def index():
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((24, 32)).astype(np.float32)
    base = (centers[rng.integers(0, 24, 2000)]
            + 0.3 * rng.standard_normal((2000, 32))).astype(np.float32)
    return rt.build_index(base, centers, bits=4, device="cpu",
                          generator=torch.Generator().manual_seed(0))


def context(index, params, device, launches):
    lines = []
    work = types.SimpleNamespace(index=index, params=params,
                                 batches=torch.zeros((2, 16, 32)),
                                 traced=[0, 1, 0])
    return lines, types.SimpleNamespace(
        trace=types.SimpleNamespace(device=device), work=work,
        log=lines.append, launches=launches)


@pytest.mark.parametrize("probe", [5, 24, 100])
def test_bytes_of_a_small_index(index, probe):
    """A batch's [B, K] row and B norms read, K norms once a launch,
    probe ids (capped at K) written at 8 bytes."""
    params = rt.SearchParams(probe=probe, topk=10, rerank=32)
    k = index.k
    assert k == 24
    assert mod.rank_bytes(index, params, 16) == (
        16 * k * 4 + 16 * 4 + k * 4 + 16 * min(probe, k) * 8)


def test_share_from_the_trace(index):
    """The share is the bytes of the traced batches over the HBM peak over
    the kernel's mean record times the launches; the fused and streamed
    shares are logged."""
    params = rt.SearchParams(probe=5, topk=10, rerank=32)
    recs = [("void (anonymous namespace)::probe_rank_kernel<true, true>",
             0.0, 4.0), ("other", 4.0, 9.0),
            ("void (anonymous namespace)::probe_rank_kernel<true, true>",
             10.0, 12.0)]
    lines, ctx = context(index, params, recs,
                         {mod.COUNTER: 3, mod.FUSED: 3, mod.STREAMED: 0})
    nbytes = 16 * 24 * 4 + 16 * 4 + 24 * 4 + 16 * 5 * 8
    want = 100 * 3 * nbytes / 3.35e12 / (3 * 3e-6)
    assert spec.load_reader("probe_rank_roofline")(ctx) == pytest.approx(want)
    assert mod.read(ctx) == pytest.approx(want)
    assert "fused 3 (100.0%), streamed 0 (0.0%)" in lines[0]


@pytest.mark.parametrize("case", ["no records", "no launches", "no trace"])
def test_none_without_the_kernel(index, case):
    """A program without the kernel: no record of it in the trace, or no
    launch counter, or no trace at all, reads as None."""
    params = rt.SearchParams(probe=5, topk=10, rerank=32)
    recs = [("void select_kernel<true>", 0.0, 4.0),
            ("radixSortKVInPlace", 4.0, 9.0)]
    launches = {"cuda_select_candidates.launches": 3}
    if case != "no records":
        recs.append(("probe_rank_kernel<true, true>", 10.0, 12.0))
    if case != "no launches":
        launches[mod.COUNTER] = 3
    _, ctx = context(index, params, recs, launches)
    if case == "no trace":
        ctx.trace = None
    assert mod.read(ctx) is None
