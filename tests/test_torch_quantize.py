"""Parity of the port's fused residual quantization with the JAX package's.

``cuda_quantize_residuals`` runs its plain twin (quantize_residuals_reference)
on CPU tensors. Held against ``rabitq_tpu.ops.quantize
.quantize_query_residuals`` applied to the same residuals y[b] -
centroids[cids[b, j]]: q, lo, delta and code_sum exactly, ycd = sum r^2 to
f32 rounding (rtol 1e-6: two orders of summing D f32 squares), and the
packed bytes against the JAX search's packing expression
(rabitq_tpu/index/search.py:404-407).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabitq_tpu.ops.quantize import quantize_query_residuals
from rabitq_tpu_torch.ops import (
    cuda_quantize_residuals,
    pack_query_nibbles,
    quantize_residuals_reference,
    unpack_query_nibbles,
)


def _inputs(seed, b, probe, d, k=50):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((b, d)).astype(np.float32)
    c = rng.standard_normal((k, d)).astype(np.float32)
    cids = np.stack([rng.choice(k, probe, replace=False) for _ in range(b)])
    bias = rng.random(d).astype(np.float32)
    c[cids[0, 0]] = y[0]  # a zero residual: delta falls to the guard
    return y, c, cids.astype(np.int64), bias


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("d,pack", [(128, False), (256, True), (1024, True),
                                    (64, True), (96, False)])
def test_twin_matches_jax_quantize(d, pack, dither):
    b, probe = 6, 5
    y, c, cids, bias = _inputs(d, b, probe, d)
    yr = jnp.asarray(y)[:, None, :] - jnp.asarray(c)[cids]
    jq = quantize_query_residuals(yr, jnp.asarray(bias) if dither else None)
    ycd = np.asarray(jnp.sum(yr * yr, axis=-1)).reshape(-1)
    q_want = np.asarray(jq.quantized).reshape(b * probe, d)
    if pack:
        # The JAX search's packing of its qpack operand.
        qu = jnp.asarray(q_want).astype(jnp.uint8)
        q_want = np.asarray(
            (qu[:, : d // 2] | (qu[:, d // 2 :] << 4)).astype(jnp.int8)
        )

    qvals, scal = cuda_quantize_residuals(
        torch.from_numpy(y), torch.from_numpy(c), torch.from_numpy(cids),
        torch.from_numpy(bias) if dither else None, pack=pack,
    )
    assert qvals.dtype == torch.int8
    assert qvals.shape == (b * probe, d // 2 if pack else d)
    np.testing.assert_array_equal(qvals.numpy(), q_want)
    scal = scal.numpy()
    for col, want in enumerate((jq.lower, jq.delta, jq.code_sum)):
        np.testing.assert_array_equal(scal[:, col],
                                      np.asarray(want).reshape(-1))
    np.testing.assert_allclose(scal[:, 3], ycd, rtol=1e-6)
    assert scal[0, 1] == np.float32(1e-30) and scal[0, 3] == 0


def test_pack_round_trip():
    q = torch.from_numpy(
        np.random.default_rng(0).integers(0, 16, (9, 512)).astype(np.int8)
    )
    p = pack_query_nibbles(q)
    assert p.shape == (9, 256) and p.dtype == torch.int8
    assert torch.equal(unpack_query_nibbles(p), q)
    assert int(p.view(torch.uint8)[0, 0]) == int(q[0, 0]) | int(q[0, 256]) << 4


def test_wrapper_runs_twin_on_cpu_without_counting():
    y, c, cids, bias = map(torch.from_numpy, _inputs(1, 3, 4, 256))
    before = cuda_quantize_residuals.launches
    got = cuda_quantize_residuals(y, c, cids, bias, pack=True)
    want = quantize_residuals_reference(y, c, cids, bias, pack=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert cuda_quantize_residuals.launches == before
    qv, sc = cuda_quantize_residuals(y[:0], c, cids[:0], None)
    assert qv.shape == (0, 256) and sc.shape == (0, 4)


def test_wrapper_rejects_bad_operands():
    y, c, cids, bias = map(torch.from_numpy, _inputs(2, 3, 4, 64))
    with pytest.raises(ValueError, match="cids"):
        cuda_quantize_residuals(y, c, cids.int())
    with pytest.raises(ValueError, match="centroids_rot"):
        cuda_quantize_residuals(y, c[:, :32], cids)
    with pytest.raises(ValueError, match="rand_bias"):
        cuda_quantize_residuals(y, c, cids, bias[:8])
    with pytest.raises(ValueError, match="even dim"):
        cuda_quantize_residuals(y[:, :63], c[:, :63], cids, pack=True)
    with pytest.raises(ValueError, match="device"):
        cuda_quantize_residuals(*(t.to("meta") for t in (y, c, cids)))


def test_quantize_ab_refuses_without_a_card():
    """The A/B tool parses its sources, then refuses to time on the CPU."""
    from rabitq_tpu_torch.tools import quantize_ab

    assert quantize_ab.main(["--other", "old=old.cu"]) == 1
    with pytest.raises(SystemExit):
        quantize_ab.main(["--other", "kernel=old.cu"])  # name taken
    with pytest.raises(SystemExit):
        quantize_ab.main(["--other", "old.cu"])  # no name


def test_quantize_ab_names_register_counts_by_instance():
    """ptxas -v output read into registers per kernel instance."""
    from rabitq_tpu_torch.tools import quantize_ab

    ptxas = (
        "ptxas info : Compiling entry function '_ZN4_GLOBAL15quantize_kernel"
        "ILi32ELi1ELb1ELb0EEEvPKf' for 'sm_90a'\n"
        "ptxas info : Used 104 registers, used 1 barriers\n"
        "ptxas info : Compiling entry function '_ZN4_GLOBAL20quantize_kernel"
        "_smemEPKf' for 'sm_90a'\n"
        "ptxas info : Used 48 registers\n"
    )
    assert quantize_ab.registers(ptxas) == {
        "32 lanes, 1 units, packed": 104, "shared-memory path": 48}


@pytest.mark.parametrize("dither", [False, True])
def test_kernel_fast_rule_emulated_equals_twin(dither):
    """The CUDA kernel's division-free rule (csrc/quantize.cu, qfast),
    emulated in numpy f32: z = fma(v, 1/delta, -lo/delta) [+ bias - 1/2],
    clamped, rounded by adding 1.5 * 2^23. Wherever it does not flag the
    task (a value within 2^-16 of a rounding edge, or |lo/delta| >= 16),
    its values equal the twin's exact rule; on Gaussian residuals it flags
    few tasks."""
    from rabitq_tpu_torch.ops.quantize import quantize_query_residuals as twin

    f = np.float32
    rng = np.random.default_rng(7)
    bias = rng.random(256).astype(f)
    edge = f(0.5) - f(2.0 ** -16)
    big = f(1.5 * 2 ** 23)
    flagged = {"gauss": 0, "other": 0}
    for trial in range(600):
        scale = f(10.0 ** rng.uniform(-20, 20))
        v = rng.standard_normal(256).astype(f) * scale
        kind = "gauss" if trial % 3 == 2 else "other"
        if trial % 3 == 0:  # values on a grid: quotients near half-steps
            v = (np.round(v / scale * 7) * scale / f(7)).astype(f)
        elif trial % 3 == 1:  # one-signed: |lo / delta| large
            v = (v + f(rng.uniform(-8, 8)) * scale * f(3)).astype(f)
        qq = twin(torch.from_numpy(v[None]),
                  torch.from_numpy(bias) if dither else None)
        lo, delta = qq.lower.numpy()[0], qq.delta.numpy()[0]
        rcp = f(1) / delta
        c0 = f(-lo * rcp)
        z = (v.astype(np.float64) * np.float64(rcp) + np.float64(c0)).astype(f)
        if dither:
            z = (z + (bias - f(0.5)).astype(f)).astype(f)
        z = np.clip(z, f(0), f(15)).astype(f)
        t = (z + big).astype(f)
        near = np.abs((z - (t - big).astype(f)).astype(f)) > edge
        if near.any() or not abs(c0) < 16:
            flagged[kind] += 1
            continue
        np.testing.assert_array_equal(t.view(np.uint32) & 0xFF,
                                      qq.quantized.numpy()[0])
    assert flagged["gauss"] <= 20  # of 200 Gaussian tasks
