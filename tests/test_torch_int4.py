"""Packed int4 operands of the port (rabitq_tpu_torch/ops/int4.py) against
numpy and the two int4 Pallas kernels of tools/int4probe.py.

``int4_dot_reference`` is the CPU path of ``cuda_int4_dot`` (the CUDA
kernels' twin). Integer arithmetic throughout, so every comparison is
exact. The Pallas bodies ``k2`` and ``k3`` are local to
tools/int4probe.py:main, so they are restated here (tools/int4probe.py:64-70
and :84-95) and run with jnp.int4 operands in interpret mode.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rabitq_tpu_torch.ops import (
    cuda_int4_dot,
    int4_dot_reference,
    pack_int4,
    unpack_int4,
)
from rabitq_tpu_torch.ops.int4 import check_kernel_shape
from rabitq_tpu_torch.tools import int4probe


def _k2(x_ref, y_ref, o_ref):  # tools/int4probe.py:64-70
    x = x_ref[...].astype(jnp.int8)
    y = y_ref[...].astype(jnp.int8)
    o_ref[...] = jax.lax.dot_general(
        x, y, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def _k3(x_hbm, y_ref, o_ref, xbuf, sem):  # tools/int4probe.py:84-95
    cp = pltpu.make_async_copy(x_hbm.at[pl.ds(0, 256)], xbuf, sem)
    cp.start()
    cp.wait()
    x = xbuf[...].astype(jnp.int8)
    y = y_ref[...].astype(jnp.int8)
    o_ref[...] = jax.lax.dot_general(
        x, y, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def _packed(a8, b8):
    return pack_int4(torch.from_numpy(a8)), pack_int4(torch.from_numpy(b8))


def test_pack_round_trip_every_value_in_both_nibbles():
    v = np.arange(-8, 8, dtype=np.int8)
    lo, hi = np.meshgrid(v, v, indexing="ij")
    x = np.stack([lo.ravel(), hi.ravel()], axis=1)  # [256, 2]: every pair
    p = pack_int4(torch.from_numpy(x))
    assert p.dtype == torch.uint8 and p.shape == (256, 1)
    want = (lo.ravel().astype(np.uint8) & 0xF) | (
        (hi.ravel().astype(np.uint8) & 0xF) << 4
    )
    np.testing.assert_array_equal(p[:, 0].numpy(), want)
    assert p[0, 0] == 0x88 and p[8 * 16 + 15, 0] == 0x70  # (-8,-8), (0,7)
    np.testing.assert_array_equal(unpack_int4(p).numpy(), x)
    wide = np.tile(x.reshape(1, -1), (3, 1))  # [3, 512]
    np.testing.assert_array_equal(
        unpack_int4(pack_int4(torch.from_numpy(wide))).numpy(), wide
    )


def test_pack_rejects_bad_input():
    with pytest.raises(ValueError, match="-8, 7"):
        pack_int4(torch.tensor([[0, 8]], dtype=torch.int8))
    with pytest.raises(ValueError, match="even K"):
        pack_int4(torch.zeros((2, 3), dtype=torch.int8))
    with pytest.raises(ValueError, match="uint8"):
        unpack_int4(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize(
    "seed,m,n,k",
    [(0, int4probe.M, int4probe.N, int4probe.K), (5, 37, 70, 96)],
)
def test_twin_equals_numpy(seed, m, n, k):
    a8, b8, want = int4probe.operands(seed=seed, m=m, n=n, k=k)
    got = int4_dot_reference(*_packed(a8, b8))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_twin_equals_pallas_k2_and_k3_interpret():
    a8, b8, want = int4probe.operands()
    a4, b4 = jnp.asarray(a8).astype(jnp.int4), jnp.asarray(b8).astype(jnp.int4)
    out_shape = jax.ShapeDtypeStruct(want.shape, jnp.int32)
    k2 = pl.pallas_call(_k2, out_shape=out_shape, interpret=True)(a4, b4)
    k3 = pl.pallas_call(
        _k3,
        out_shape=out_shape,
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        scratch_shapes=[
            pltpu.VMEM(a8.shape, jnp.int4),
            pltpu.SemaphoreType.DMA,
        ],
        interpret=True,
    )(a4, b4)
    got = int4_dot_reference(*_packed(a8, b8)).numpy()
    np.testing.assert_array_equal(got, np.asarray(k2))
    np.testing.assert_array_equal(got, np.asarray(k3))
    np.testing.assert_array_equal(got, want)


def test_wrapper_runs_twin_on_cpu_without_counting():
    a, b = _packed(*int4probe.operands(seed=2, m=20, n=9, k=64)[:2])
    before = (cuda_int4_dot.launches_direct, cuda_int4_dot.launches_staged)
    for staged in (False, True):
        assert torch.equal(cuda_int4_dot(a, b, staged), int4_dot_reference(a, b))
    assert (cuda_int4_dot.launches_direct,
            cuda_int4_dot.launches_staged) == before


def test_wrapper_rejects_bad_operands():
    a = torch.zeros((4, 6), dtype=torch.uint8)  # K = 12
    with pytest.raises(ValueError, match="multiple of 8"):
        cuda_int4_dot(a, a, staged=False)
    b = torch.zeros((4, 8), dtype=torch.uint8)
    with pytest.raises(ValueError, match="K/2 differs"):
        cuda_int4_dot(b, b[:, :4], staged=False)
    with pytest.raises(ValueError, match="uint8"):
        cuda_int4_dot(b.to(torch.int8), b, staged=False)
    with pytest.raises(ValueError, match="device"):
        cuda_int4_dot(b.to("meta"), b.to("meta"), staged=True)


@pytest.mark.parametrize("k", [32, 96, 4096])
@pytest.mark.parametrize("va,vb", [(-8, -8), (7, 7), (-8, 7)])
def test_twin_extreme_operands(k, va, vb):
    """All -8 / all 7 operands: every output is va * vb * K (64 K, 49 K,
    -56 K), exactly."""
    a = pack_int4(torch.full((5, k), va, dtype=torch.int8))
    b = pack_int4(torch.full((3, k), vb, dtype=torch.int8))
    got = int4_dot_reference(a, b)
    assert torch.equal(got, torch.full((5, 3), va * vb * k, dtype=torch.int32))


@pytest.mark.parametrize("kb,n", [(16, 1), (48, 64), (512, 65), (2048, 512),
                                  (8192, 64 * 65_535)])
def test_kernel_shape_accepts(kb, n):
    """K any multiple of 32: B is widened 2048 columns at a time, so no K
    is too wide for shared memory (the staged kernel used to take a
    16 x K/2 tile whole)."""
    check_kernel_shape(kb, n)


def test_kernel_shape_rejects():
    with pytest.raises(ValueError, match="multiple of 16"):
        check_kernel_shape(40, 8)  # K = 80
    with pytest.raises(ValueError, match="exceeds"):
        check_kernel_shape(64, 64 * 65_535 + 1)


def test_probe_stages_on_cpu():
    """On a CPU device every stage runs (2 and 3 through the twin)."""
    assert int4probe.run("cpu") == {
        "1 twin": "exact",
        "1b nbytes": 1024 * 1024 // 2,
        "2 int4_dot_direct": "exact",
        "3 int4_dot_staged": "exact",
    }


def test_probe_main_fails_without_a_card():
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = str(repo) + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "rabitq_tpu_torch.tools.int4probe"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
