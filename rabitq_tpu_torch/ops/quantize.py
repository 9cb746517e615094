"""Query-residual scalar quantization (port of rabitq_tpu.ops.quantize).

The rotated query residual (y - c) of every probed cluster is quantized to
THETA_LOG_DIM bits per dimension with a per-residual affine scale, by
round-to-nearest (``torch.round`` is half-to-even like ``jnp.round``) or by
floor plus a uniform dither.

Search runs the whole stage through ``cuda_quantize_residuals``: the
residual, its squared norm, the quantization and (for the scan's ``qpack``
operand) the nibble packing, fused in the hand-written kernel
csrc/quantize.cu on CUDA tensors, and in its plain twin
``quantize_residuals_reference`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from rabitq_tpu_torch.consts import SCALAR, THETA_LOG_DIM
from rabitq_tpu_torch.ops import _cuda

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


def pack_query_nibbles(q: torch.Tensor) -> torch.Tensor:
    """[..., D] int8 values in 0..15 -> [..., D/2] int8 in the JAX split-half
    layout (rabitq_tpu/index/search.py:404-407): byte i = q[i] | q[i + D/2]
    << 4."""
    d2 = q.shape[-1] // 2
    u = q.to(torch.uint8)
    return (u[..., :d2] | (u[..., d2:] << 4)).view(torch.int8)


def unpack_query_nibbles(p: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_query_nibbles``: [..., D/2] -> [..., D] int8."""
    u = p.view(torch.uint8)
    return torch.cat([u & 15, u >> 4], dim=-1).to(torch.int8)


def _check(y, centroids_rot, cids, rand_bias, pack):
    if y.dim() != 2 or centroids_rot.dim() != 2 or cids.dim() != 2:
        raise ValueError("y [B, D], centroids_rot [K, D], cids [B, probe]")
    b, d = y.shape
    expect = {
        "y": (y, torch.float32, (b, d)),
        "centroids_rot": (centroids_rot, torch.float32,
                          (centroids_rot.shape[0], d)),
        "cids": (cids, torch.int64, (b, cids.shape[1])),
    }
    if rand_bias is not None:
        expect["rand_bias"] = (rand_bias, torch.float32, (d,))
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != y.device:
            raise ValueError(f"{name} on {t.device}, y on {y.device}")
    if pack and d % 2:
        raise ValueError(f"packing needs an even dim, got {d}")


def quantize_residuals_reference(
    y: torch.Tensor,
    centroids_rot: torch.Tensor,
    cids: torch.Tensor,
    rand_bias: torch.Tensor | None = None,
    pack: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the kernel: same contract, any device. It
    materialises the [B, probe, D] f32 residual that the kernel keeps on
    chip."""
    _check(y, centroids_rot, cids, rand_bias, pack)
    b, probe = cids.shape
    d = y.shape[1]
    yr = y[:, None, :] - centroids_rot[cids]  # [B, probe, D]
    ycd = torch.sum(yr * yr, dim=-1)
    qq = quantize_query_residuals(yr, rand_bias)
    q = qq.quantized.reshape(b * probe, d)
    if pack:
        q = pack_query_nibbles(q)
    scal = torch.stack([qq.lower, qq.delta, qq.code_sum, ycd], dim=-1)
    return q, scal.reshape(b * probe, 4)


@functools.cache
def _library():
    """The built kernel library. Its launcher takes six pointers, n_tasks,
    probe, dim, pack, the three scale constants as f32, and the stream
    (pointers and the stream as c_void_p so ctypes does not cut them to 32
    bits)."""
    lib = _cuda.load("quantize")
    lib.rabitq_quantize_residuals.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float] * 3
        + [ctypes.c_void_p]
    )
    lib.rabitq_quantize_residuals.restype = ctypes.c_int
    lib.rabitq_quantize_plan.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int)
    ]
    lib.rabitq_quantize_plan.restype = ctypes.c_int
    return lib


class QuantizePlan(NamedTuple):
    """How the kernel launches on the current card: ``lanes`` a task (8 or
    32 on the register path, 0 on the shared-memory path), ``warps`` a
    block, 16-byte output ``units`` a lane, ``blocks``, and the ``run`` of
    consecutive tasks each lane group takes."""

    lanes: int
    warps: int
    units: int
    blocks: int
    run: int


def quantize_plan(n_tasks: int, dim: int, pack: bool,
                  dither: bool) -> QuantizePlan:
    """The launch plan the built kernel takes for a call of ``n_tasks``
    tasks on the current CUDA device (builds the kernel at first use)."""
    out = (ctypes.c_int * 5)()
    err = _library().rabitq_quantize_plan(n_tasks, dim, int(pack),
                                          int(dither), out)
    if err:
        raise RuntimeError(f"quantize plan failed: CUDA error {err}")
    return QuantizePlan(*out)


def cuda_quantize_residuals(
    y: torch.Tensor,
    centroids_rot: torch.Tensor,
    cids: torch.Tensor,
    rand_bias: torch.Tensor | None = None,
    pack: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize every task's residual r = y[b] - centroids_rot[cids[b, j]]
    (task t = b * probe + j). Returns ``qvals`` [S, D] int8 (with ``pack``:
    [S, D/2], byte i = q[i] | q[i + D/2] << 4) and ``scal`` [S, 4] f32 =
    (lo, delta, code_sum, ycd = sum r^2), the rough scan's operands.

    y [B, D] f32, centroids_rot [K, D] f32, cids [B, probe] int64 in
    [0, K) (the caller's guarantee), rand_bias [D] f32 or None (None:
    round to nearest; else floor + dither). CUDA tensors launch the sm_90a
    kernel, which needs D % 8 == 0 (lane groups on runs of tasks with the
    query, r and the next task's centroid row in registers, at D <= 1024 in
    whole 16-byte output words; a warp a task with r in shared memory
    otherwise: ``quantize_plan``); CPU tensors take
    the twin. The kernel equals the twin bit for bit in qvals, lo, delta
    and code_sum; its ycd sums in another order (f32 rounding).

    ``cuda_quantize_residuals.launches`` counts kernel launches (not twin
    calls).
    """
    if y.device.type == "cpu":
        return quantize_residuals_reference(
            y, centroids_rot, cids, rand_bias, pack
        )
    if y.device.type != "cuda":
        raise ValueError(f"unsupported device {y.device}")
    _check(y, centroids_rot, cids, rand_bias, pack)
    b, d = y.shape
    s = cids.numel()
    if torch.cuda.get_device_capability(y.device) != (9, 0):
        raise RuntimeError("the quantize kernel is built for sm_90a only")
    if d % 8:
        raise ValueError(f"dim must be a multiple of 8, got {d}")
    operands = [y, centroids_rot, cids]
    if rand_bias is not None:
        operands.append(rand_bias)
    for t in operands:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16B-aligned")
    qvals = torch.empty(
        (s, d // 2 if pack else d), dtype=torch.int8, device=y.device
    )
    scal = torch.empty((s, 4), dtype=torch.float32, device=y.device)
    if s == 0:
        return qvals, scal
    launch = _library().rabitq_quantize_residuals
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            y.data_ptr(), centroids_rot.data_ptr(), cids.data_ptr(),
            None if rand_bias is None else rand_bias.data_ptr(),
            qvals.data_ptr(), scal.data_ptr(), s, cids.shape[1], d,
            int(pack), SCALAR, _TINY, float(_QMAX), stream,
        )
    if err:
        raise RuntimeError(f"quantize kernel launch failed: CUDA error {err}")
    cuda_quantize_residuals.launches += 1
    return qvals, scal


cuda_quantize_residuals.launches = 0
