"""Parity of the port's exact rerank (gather + squared L2) with the JAX
package's.

``gather_l2_reference`` is the CPU path of ``cuda_gather_l2`` (the CUDA
kernel's twin). It is held against ``pallas_gather_l2`` in interpret mode
and against the XLA gather the JAX search runs without the kernel
(``_gather_l2``), on the cases of tests/test_rerank_kernel.py plus the
GIST width (D = 1024, R = 150). Tolerance rtol 1e-5, atol 1e-4: the same
f32 squares summed in different orders, as the JAX kernel's own tests
allow. End to end, the port searches a 960-d JAX index at topk 100 with
rerank 150 < 2 * topk against JAX search with the rerank kernel.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu_torch as rt
import rabitq_tpu_torch.ops.rerank_kernel as trerank
from rabitq_tpu.index.index import with_tiled_base
from rabitq_tpu.ops.rerank_kernel import pallas_gather_l2
from rabitq_tpu_torch.ops import cuda_gather_l2, gather_l2_reference
from torch_parity import gist_like_corpus, port_index_from_jax

# The package exports a ``search`` function that shadows the module name.
jsearch = importlib.import_module("rabitq_tpu.index.search")


def _operands(rng, n, d, b, r):
    """Random rows, queries and positions; positions hold row N-1, row 0
    and a duplicate in every query."""
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    pos = rng.integers(0, n, (b, r))
    pos[:, 0], pos[:, 1], pos[:, 2] = n - 1, 0, pos[:, 3]
    return base, pos, q


def _twin(base, pos, q):
    return gather_l2_reference(
        torch.from_numpy(base), torch.from_numpy(pos), torch.from_numpy(q)
    ).numpy()


@pytest.mark.parametrize(
    "n,d,b,r",
    [
        (3000, 256, 12, 40),     # b % 8 != 0, r < the JAX chunk
        (2000, 128, 8, 128),     # r == the JAX chunk
        (1500, 512, 4, 130),     # r pads to 2 JAX chunks
        (1200, 1024, 4, 150),    # the GIST width and rerank budget
    ],
)
def test_twin_matches_pallas_kernel_interpret(n, d, b, r):
    base, pos, q = _operands(np.random.default_rng(42), n, d, b, r)
    want = np.asarray(
        pallas_gather_l2(
            jnp.asarray(base.reshape(n, d // 128, 128)),
            jnp.asarray(pos.astype(np.int32)),
            jnp.asarray(q.reshape(b, d // 128, 128)),
            interpret=True,
        )
    )
    got = _twin(base, pos, q)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got[:, 2], got[:, 3])


@pytest.mark.parametrize("d", [128, 1024])
def test_twin_matches_jax_xla_gather(d):
    base, pos, q = _operands(np.random.default_rng(d), 900, d, 20, 64)
    want = np.asarray(
        jsearch._gather_l2(
            jnp.asarray(base), jnp.asarray(pos.astype(np.int32)),
            jnp.asarray(q), 0,
        )
    )
    got = _twin(base, pos, q)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    last = ((base[-1][None, :] - q) ** 2).sum(-1)
    np.testing.assert_allclose(got[:, 0], last, rtol=1e-5, atol=1e-4)


def test_twin_chunks_give_the_same_values(monkeypatch):
    base, pos, q = _operands(np.random.default_rng(1), 500, 256, 9, 30)
    whole = _twin(base, pos, q)
    # 2 queries a chunk, the last chunk ragged.
    monkeypatch.setattr(trerank, "_TWIN_CHUNK_BYTES", 2 * 30 * 256 * 4)
    np.testing.assert_array_equal(_twin(base, pos, q), whole)


def test_wrapper_runs_twin_on_cpu_without_counting():
    base, pos, q = map(
        torch.from_numpy, _operands(np.random.default_rng(2), 300, 64, 5, 16)
    )
    before = cuda_gather_l2.launches
    got = cuda_gather_l2(base, pos, q)
    assert torch.equal(got, gather_l2_reference(base, pos, q))
    assert torch.equal(cuda_gather_l2(base, pos, q, check_pos=False), got)
    assert cuda_gather_l2.launches == before


def test_wrapper_rejects_bad_operands():
    base, pos, q = map(
        torch.from_numpy, _operands(np.random.default_rng(3), 300, 64, 5, 16)
    )
    with pytest.raises(ValueError, match="pos"):
        cuda_gather_l2(base, pos.int(), q)
    with pytest.raises(ValueError, match="q"):
        cuda_gather_l2(base, pos, q[:, :32])
    with pytest.raises(ValueError, match="q"):  # 5 rows of pos, 4 of q
        cuda_gather_l2(base, pos, q[:4])
    with pytest.raises(ValueError, match="2-D"):
        cuda_gather_l2(base, pos[0], q)
    with pytest.raises(ValueError, match="device"):
        cuda_gather_l2(*(t.to("meta") for t in (base, pos, q)))


def test_twin_gives_nan_exactly_outside_the_rows():
    """The twin's contract is the kernel's: a position outside [0, N) is
    not read and gives NaN, its neighbours the right sums."""
    base, pos, q = _operands(np.random.default_rng(4), 300, 64, 5, 40)
    want = _twin(base, pos, q)
    pos[1, 5], pos[1, 6], pos[3, 33] = -1, 300, 10**12
    got = _twin(base, pos, q)
    nan = np.isnan(got)
    assert nan.sum() == 3 and nan[1, 5] and nan[1, 6] and nan[3, 33]
    np.testing.assert_array_equal(got[~nan], want[~nan])
    t = map(torch.from_numpy, (base, pos, q))
    assert torch.equal(cuda_gather_l2(*t).isnan(), torch.from_numpy(nan))


@pytest.mark.parametrize("r", [1, 33, 150])
@pytest.mark.parametrize("d", [4, 128, 132, 1024])
def test_twin_nan_contract_across_shapes(d, r):
    """At the widths and candidate counts the kernel's instances and items
    split on: NaN exactly at positions outside [0, N) (below 0, N, far
    past N), float64 numpy's sums everywhere else."""
    n, b = 200, 6
    rng = np.random.default_rng(d * 1000 + r)
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    pos = rng.integers(0, n, (b, r))
    bad = [(0, 0, -1), (3, r - 1, n), (5, r // 2, 2**40)]
    for i, j, v in bad:
        pos[i, j] = v
    got = _twin(base, pos, q)
    nan = np.zeros((b, r), bool)
    for i, j, _ in bad:
        nan[i, j] = True
    np.testing.assert_array_equal(np.isnan(got), nan)
    rows = base.astype(np.float64)[np.where(nan, 0, pos)]
    want = ((rows - q.astype(np.float64)[:, None, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got[~nan], want[~nan], rtol=1e-5, atol=1e-4)


def test_chip_smoke_gather_helpers():
    """The smoke's cluster-local positions stay inside [0, N) and within
    each query's windows; its bound on 2048 x 32 distinct positions at D
    128 is 35.4 MB of rows, positions, queries and output over 3.35 TB/s."""
    import chip_smoke

    pos = chip_smoke.cluster_gather_positions("cpu", 10_000, 64, 32,
                                              windows=28, width=300, seed=1)
    assert pos.shape == (64, 32) and pos.dtype == torch.int64
    assert int(pos.min()) >= 0 and int(pos.max()) < 10_000
    assert torch.equal(
        pos, chip_smoke.cluster_gather_positions("cpu", 10_000, 64, 32,
                                                 windows=28, width=300,
                                                 seed=1))
    one = chip_smoke.cluster_gather_positions("cpu", 10_000, 50, 32,
                                              windows=1, width=300, seed=2)
    span = one.max(1).values - one.min(1).values
    assert int(span.max()) < 300
    pos = torch.arange(2048 * 32).reshape(2048, 32)
    ms, by, gb, rows = chip_smoke.gather_bound(pos, 1_200_000, 128)
    assert by == "bytes" and rows == 2048 * 32
    assert gb == pytest.approx(2048 * 32 * (512 + 12) / 1e9 + 2048 * 512 / 1e9)
    assert ms == pytest.approx(gb / 3.35e12 * 1e12)


@pytest.mark.parametrize(
    "name,pos,rows",
    [
        ("distinct", [[0, 1, 2], [3, 4, 5]], 6),
        ("repeat within a query", [[7, 7, 2], [3, 4, 5]], 5),
        ("rows shared by queries", [[0, 9, 2], [9, 2, 0]], 3),
        ("outside [0, N) not read", [[-1, 1, 2], [100, 4, 2**40]], 3),
        ("every position one row", [[5, 5, 5], [5, 5, 5]], 1),
    ],
)
def test_chip_smoke_gather_bound_counts_distinct_rows(name, pos, rows):
    """The bound reads each distinct valid row once, however many
    positions name it; positions and outputs count at every slot, the
    operations only at valid ones."""
    import chip_smoke

    pos = torch.tensor(pos)
    n, dim = 100, 64
    ms, by, gb, got = chip_smoke.gather_bound(pos, n, dim)
    assert got == rows
    want = rows * dim * 4 + pos.numel() * 12 + pos.shape[0] * dim * 4
    assert gb == pytest.approx(want / 1e9) and by == "bytes"
    assert ms == pytest.approx(want / 3.35e12 * 1e3)


def test_search_matches_jax_rerank_kernel_at_960d():
    """The port searching a 960-d JAX index (CPU: the kernels' twins)
    against JAX search with its rerank kernel (interpret mode), exact
    selection and full-precision cluster ranking, at topk 100 and
    rerank 150 < 2 * topk (the GIST bench line)."""
    base, queries, centers, p = gist_like_corpus()
    jidx = rq.build_index(
        base, centers, key=jax.random.key(0), orthogonal=p, bits=4,
        spill=0.2, balance=1.5,
    )
    q = queries[:4]  # the interpret-mode kernel is slow
    dj, ij = rq.search(
        with_tiled_base(jidx), jnp.asarray(q),
        rq.SearchParams(
            probe=8, topk=100, rerank=150, rerank_kernel=True,
            rank_precision="highest", select_mode="exact",
        ),
    )
    dt, it = rt.search(
        port_index_from_jax(jidx), torch.from_numpy(q),
        rt.SearchParams(probe=8, topk=100, rerank=150),
    )
    dj, ij, dt, it = map(np.asarray, (dj, ij, dt, it))
    np.testing.assert_allclose(dt, dj, rtol=1e-5)
    differ = it != ij
    assert differ.mean() <= 0.02, differ.mean()
    # Where ids differ, the two candidates tie to f32 rounding.
    np.testing.assert_allclose(dt[differ], dj[differ], rtol=1e-5)
