"""Packed int4 operands on the card: the port of tools/int4probe.py.

The scan at large dim is bound by the bytes of its code window, and packed
4-bit codes would halve them. This probe checks, on one device, that the
packed-int4 product kernels are exact:

  1.  the twin (unpack + product) equals numpy's int32 A . B^T;
  1b. a packed [M, K] operand holds M * K / 2 bytes, half of int8;
  2.  int4_dot_direct (the TPU probe's k2) equals numpy;
  3.  int4_dot_staged (k3: the A tile copied to shared memory first)
      equals numpy.

Unlike the TPU probe, a failed stage raises. Run it alone on the card:

    python -m rabitq_tpu_torch.tools.int4probe
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from rabitq_tpu_torch.ops import cuda_int4_dot, int4_dot_reference, pack_int4

# The TPU probe's operands: [256, 128] x [512, 128] int4, seed 0.
M, N, K = 256, 512, 128


def operands(seed: int = 0, m: int = M, n: int = N, k: int = K):
    """int8 operands in [-8, 7] and numpy's exact int32 product."""
    rng = np.random.default_rng(seed)
    a8 = rng.integers(-8, 8, size=(m, k), dtype=np.int8)
    b8 = rng.integers(-8, 8, size=(n, k), dtype=np.int8)
    return a8, b8, a8.astype(np.int32) @ b8.astype(np.int32).T


def run(device: torch.device | str) -> dict:
    """Run the probe's stages on ``device``; raise on any wrong product.

    Returns {stage: result}. On a CPU device stages 2 and 3 run the twin,
    since the wrapper sends CPU tensors there.
    """
    device = torch.device(device)
    a8, b8, want = operands()
    a = pack_int4(torch.from_numpy(a8).to(device))
    b = pack_int4(torch.from_numpy(b8).to(device))
    out = {}

    def exact(stage, got):
        got = got.cpu().numpy()
        if got.shape != want.shape or not np.array_equal(got, want):
            bad = int((got != want).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"{stage}: {bad} entries differ from numpy")
        out[stage] = "exact"

    exact("1 twin", int4_dot_reference(a, b))
    big = pack_int4(torch.zeros((1024, 1024), dtype=torch.int8, device=device))
    nbytes = big.numel() * big.element_size()
    if nbytes != 1024 * 1024 // 2:
        raise AssertionError(f"1b: packed [1024, 1024] holds {nbytes} bytes")
    out["1b nbytes"] = nbytes
    exact("2 int4_dot_direct", cuda_int4_dot(a, b, staged=False))
    exact("3 int4_dot_staged", cuda_int4_dot(a, b, staged=True))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("int4probe: no CUDA device; the probe runs the card's kernels",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(f"device: {torch.cuda.get_device_name(dev)}")
    for stage, result in run(dev).items():
        print(f"{stage}: {result}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
