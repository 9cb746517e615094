"""Random orthogonal rotation (port of rabitq_tpu.ops.rotation).

Row vectors are rotated as ``v @ P``; queries use the same expression.
"""

from __future__ import annotations

import torch

from rabitq_tpu_torch.utils import resolve_device


def gen_random_orthogonal(
    dim: int,
    generator: torch.Generator | None = None,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """QR-based random orthogonal matrix, float32 [dim, dim].

    The signs of R's diagonal are fixed positive so Q is Haar-distributed
    and deterministic given the generator. ``device`` defaults to the
    generator's device, else CUDA (raising without a card).
    """
    device = resolve_device(device, generator)
    g = torch.randn(
        (dim, dim), generator=generator, device=device, dtype=torch.float32
    )
    q, r = torch.linalg.qr(g)
    d = torch.sign(torch.diagonal(r))
    d = torch.where(d == 0, torch.ones_like(d), d)
    return q * d[None, :]


def rotate(v: torch.Tensor, orthogonal: torch.Tensor) -> torch.Tensor:
    """Rotate row vector(s): ``v @ P``. [..., D] x [D, D] -> [..., D].

    Full fp32: the package turns TF32 off at import, since a TF32 product
    flips sign bits of near-zero residuals.
    """
    return torch.matmul(v, orthogonal)
