"""Parity of the port's ops (rabitq_tpu_torch.ops) with rabitq_tpu.ops.

The same numpy inputs, made from a seed, go through both packages. Float
results must agree to f32 rounding (rtol 1e-5: the two packages sum in
different orders); integer results exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu.ops as jops
import rabitq_tpu_torch.ops as tops
from rabitq_tpu_torch.utils import calculate_recall, pad_last_dim, round_up


@pytest.mark.parametrize("dim", [64, 128])
def test_rotate_matches_jax(rng, dim):
    x = rng.standard_normal((50, dim)).astype(np.float32)
    p = np.linalg.qr(rng.standard_normal((dim, dim)))[0].astype(np.float32)
    want = np.asarray(jops.rotate(jnp.asarray(x), jnp.asarray(p)))
    got = tops.rotate(torch.from_numpy(x), torch.from_numpy(p)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dim", [64, 128])
def test_pairwise_l2sq_matches_jax(rng, dim):
    x = rng.standard_normal((40, dim)).astype(np.float32)
    c = rng.standard_normal((24, dim)).astype(np.float32)
    c[0] = x[0]  # a zero distance: the clamp at 0 must agree too
    want = np.asarray(jops.pairwise_l2sq(jnp.asarray(x), jnp.asarray(c)))
    got = tops.pairwise_l2sq(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (got >= 0).all()
    np.testing.assert_allclose(
        tops.l2sq(torch.from_numpy(x), torch.from_numpy(c[:1])).numpy(),
        ((x - c[:1]) ** 2).sum(-1),
        rtol=1e-5,
    )


def test_random_orthogonal_is_orthogonal_and_seeded():
    g = torch.Generator().manual_seed(3)
    p = tops.gen_random_orthogonal(128, g)
    np.testing.assert_allclose(
        (p.T @ p).numpy(), np.eye(128, dtype=np.float32), atol=1e-5
    )
    again = tops.gen_random_orthogonal(128, torch.Generator().manual_seed(3))
    assert torch.equal(p, again)


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("dim", [64, 128])
def test_quantize_query_residuals_matches_jax(rng, dither, dim):
    yr = rng.standard_normal((6, 9, dim)).astype(np.float32)
    yr[0, 0] = 0.5  # constant residual: delta hits the 1e-30 guard
    bias = rng.random(dim).astype(np.float32) if dither else None
    jq = jops.quantize_query_residuals(
        jnp.asarray(yr), None if bias is None else jnp.asarray(bias)
    )
    tq = tops.quantize_query_residuals(
        torch.from_numpy(yr), None if bias is None else torch.from_numpy(bias)
    )
    assert tq.quantized.dtype == torch.int8
    np.testing.assert_array_equal(tq.quantized.numpy(), np.asarray(jq.quantized))
    for name in ("lower", "delta", "code_sum"):
        np.testing.assert_allclose(
            getattr(tq, name).numpy(),
            np.asarray(getattr(jq, name)),
            rtol=1e-6,
            err_msg=name,
        )


def test_round_is_half_to_even():
    # 0.5 and 2.5 steps must round down to even, as jnp.round does.
    yr = np.array([[0.0, 0.5, 2.5, 15.0]], np.float32)
    tq = tops.quantize_query_residuals(torch.from_numpy(yr))
    jq = jops.quantize_query_residuals(jnp.asarray(yr))
    np.testing.assert_array_equal(tq.quantized.numpy(), [[0, 0, 2, 15]])
    np.testing.assert_array_equal(tq.quantized.numpy(), np.asarray(jq.quantized))


def test_utils():
    assert round_up(100, 128) == 128 and round_up(256, 128) == 256
    assert pad_last_dim(np.ones((2, 3)), 5).shape == (2, 5)
    with pytest.raises(ValueError):
        pad_last_dim(np.ones((2, 6)), 5)
    assert calculate_recall(np.array([1, 2, 3]), np.array([3, 9, 1]), 3) == 2 / 3
