"""Distances (port of rabitq_tpu.ops.distances)."""

from __future__ import annotations

import torch

def l2sq(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Elementwise-broadcast squared L2 over the last axis."""
    d = x - y
    return torch.sum(d * d, dim=-1)


def bf16_gemm_route(device: torch.device) -> str:
    """How bf16_pass_matmul computes on ``device``: "cublas bf16, f32 out"
    (a bf16 GEMM whose f32 sums are never rounded to bf16; torch's
    ``mm(..., out_dtype=torch.float32)``, CUDA only) or "fp32 product of
    bf16-rounded operands" (TF32 off: the same products, exact in f32, and
    f32 sums; no faster than the fp32 product)."""
    if torch.device(device).type == "cuda" and hasattr(torch.ops.aten.mm,
                                                       "dtype"):
        return "cublas bf16, f32 out"
    return "fp32 product of bf16-rounded operands"


def bf16_pass_matmul(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """[n, d] x [k, d] -> [n, k] f32 inner products in one bf16 pass, as
    the TPU MXU's Precision.DEFAULT: both operands rounded to bf16 (to
    nearest even), every product exact in f32, the sums in f32 and an f32
    output (a plain matmul of two bf16 tensors would round its output to
    bf16, another function). The route is bf16_gemm_route's."""
    xb, cb = x.to(torch.bfloat16), c.to(torch.bfloat16)
    if bf16_gemm_route(x.device).startswith("cublas"):
        return torch.mm(xb, cb.T, out_dtype=torch.float32)
    return torch.matmul(xb.to(torch.float32), cb.to(torch.float32).T)


def pairwise_l2sq(
    x: torch.Tensor, c: torch.Tensor, precision: str = "highest"
) -> torch.Tensor:
    """All-pairs squared L2: [n, d] x [k, d] -> [n, k].

    By the identity ||x - c||^2 = ||x||^2 - 2<x, c> + ||c||^2, clamped at
    0 against cancellation. The norms are f32 sums; the cross term is one
    fp32 matmul (TF32 off) at ``precision="highest"``, or one bf16 pass
    (bf16_pass_matmul) at "default", as JAX's Precision.DEFAULT.
    """
    xx = torch.sum(x * x, dim=-1, keepdim=True)  # [n, 1]
    cc = torch.sum(c * c, dim=-1)  # [k]
    if precision == "highest":
        xc = torch.matmul(x, c.T)  # [n, k]
    elif precision == "default":
        xc = bf16_pass_matmul(x, c)
    else:
        raise ValueError(f"precision must be 'highest' or 'default', got "
                         f"{precision!r}")
    return torch.clamp(xx - 2.0 * xc + cc[None, :], min=0.0)
