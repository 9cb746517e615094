"""Query-residual scalar quantization (port of rabitq_tpu.ops.quantize).

The rotated query residual (y - c) of every probed cluster is quantized to
THETA_LOG_DIM bits per dimension with a per-residual affine scale, by
round-to-nearest (``torch.round`` is half-to-even like ``jnp.round``) or by
floor plus a uniform dither.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rabitq_tpu_torch.consts import SCALAR, THETA_LOG_DIM

_QMAX = (1 << THETA_LOG_DIM) - 1
# Guard against delta == 0 (all residual components equal): any positive
# delta works because (v - lo) == 0 everywhere in that case.
_TINY = 1e-30


class QuantizedQueries(NamedTuple):
    """Per-(query, probed-cluster) quantization state."""

    quantized: torch.Tensor  # [..., D] int8 in [0, 2^B - 1]
    lower: torch.Tensor      # [...] f32 lo bound of the residual
    delta: torch.Tensor      # [...] f32 quantization step
    code_sum: torch.Tensor   # [...] f32 sum of quantized values


def quantize_query_residuals(
    residuals: torch.Tensor,
    rand_bias: torch.Tensor | None = None,
) -> QuantizedQueries:
    """Quantize query residuals to THETA_LOG_DIM bits along the last axis.

    residuals: [..., D] f32 (rotated query minus probed centroid).
    rand_bias: optional [D] f32 dither in [0, 1); when given, quantizes by
        floor(scaled + dither), otherwise by round-to-nearest.
    """
    lo = residuals.amin(dim=-1)
    hi = residuals.amax(dim=-1)
    delta = torch.clamp((hi - lo) * SCALAR, min=_TINY)
    scaled = (residuals - lo[..., None]) / delta[..., None]
    if rand_bias is None:
        q = torch.round(scaled)
    else:
        q = torch.floor(scaled + rand_bias)
    q = torch.clamp(q, 0, _QMAX).to(torch.int8)
    code_sum = q.sum(dim=-1, dtype=torch.int32).to(torch.float32)
    return QuantizedQueries(q, lo, delta, code_sum)
