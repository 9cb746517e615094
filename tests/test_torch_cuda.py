"""Card-only tests of the port: the CUDA rough-scan kernel against its twin.

Marked ``cuda``; they skip where no CUDA device is present. This file
imports neither JAX nor tests/conftest.py, so on a machine with a card and
no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

The kernel must equal the twin bit for bit (the estimator is written in the
twin's operation order with explicitly rounded intrinsics).
"""

import dataclasses

import numpy as np
import pytest
import torch

import rabitq_tpu_torch as rt
from chip_smoke import scan_operands
from rabitq_tpu_torch.ops import cuda_rough_scan, rough_scan_reference

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
        (1_200_000, 128, 384, 2048 * 28, 4),  # the main path's shapes
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


def test_launch_counter(dev):
    ops = scan_operands(dev, 500, 8, 128, 64, seed=1)
    before = cuda_rough_scan.launches
    cuda_rough_scan(*ops, 128)
    cuda_rough_scan(*ops, 128)
    assert cuda_rough_scan.launches == before + 2
    empty = [t[:0] if i >= 2 else t for i, t in enumerate(ops)]
    assert cuda_rough_scan(*empty, 128).shape == (0, 128)
    assert cuda_rough_scan.launches == before + 2


def test_kernel_rejects_misaligned_operands(dev):
    ops = list(scan_operands(dev, 500, 9, 128, 64, seed=2))
    # Contiguous, but 4 bytes past a 16-byte boundary.
    ops[5] = torch.zeros((9 * 4 + 1,), device=dev)[1:].view(9, 4)
    with pytest.raises(ValueError, match="aligned"):
        cuda_rough_scan(*ops, 128)


def test_gpu_search_matches_cpu_search(dev):
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((24, 96)).astype(np.float32)
    base = (centers[rng.integers(0, 24, 6000)]
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
    params = rt.SearchParams(probe=6, topk=10, rerank=32)
    d_gpu, i_gpu = rt.search(idx, queries.to(dev), params)
    d_cpu, i_cpu = rt.search(cpu_idx, queries, params)
    same = i_gpu.cpu() == i_cpu
    assert same.float().mean() >= 0.98
    torch.testing.assert_close(
        d_gpu.cpu()[same], d_cpu[same], rtol=1e-5, atol=1e-5
    )
