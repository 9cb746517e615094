"""Distances (port of rabitq_tpu.ops.distances)."""

from __future__ import annotations

import torch


def l2sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise-broadcast squared L2 over the last axis."""
    d = x - y
    return torch.sum(d * d, dim=-1)


def pairwise_l2sq(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """All-pairs squared L2: [n, d] x [k, d] -> [n, k].

    By the identity ||x - c||^2 = ||x||^2 - 2<x, c> + ||c||^2 (one fp32
    matmul), clamped at 0 against cancellation.
    """
    xx = torch.sum(x * x, dim=-1, keepdim=True)  # [n, 1]
    cc = torch.sum(c * c, dim=-1)  # [k]
    xc = torch.matmul(x, c.T)  # [n, k]
    return torch.clamp(xx - 2.0 * xc + cc[None, :], min=0.0)
