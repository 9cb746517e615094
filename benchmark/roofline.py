"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), and the least time a piece of work
can take on it."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1.979e15
FP32_FLOPS_PER_S = 67e12  # outside the tensor cores


def bound_s(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """(seconds, "bytes" or "operations"): the larger of ``nbytes`` over the
    memory's peak and ``ops`` over ``ops_per_s``, and which one it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
