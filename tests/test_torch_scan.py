"""Parity of the port's rough scan with the JAX package's.

The port's CPU path is the kernel's plain twin (rough_scan_reference, which
``cuda_rough_scan`` runs for CPU tensors). It is held against
``pallas_rough_scan`` in interpret mode on the aligned path that search uses
on the TPU, against the portable jnp scan the JAX package runs on the CPU,
and against tests/reference_model.py. +inf slots must be identical; values
agree within rtol 1e-5 (f32 rounding: the JAX paths may contract or reorder
the estimator's float operations).
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
from rabitq_tpu_torch.ops import cuda_rough_scan, rough_scan_reference
from reference_model import ref_rough_distance
from torch_parity import gist_like_corpus, port_index_from_jax

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
