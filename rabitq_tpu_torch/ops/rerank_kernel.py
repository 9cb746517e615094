"""Exact-rerank gather + squared L2: the CUDA kernel's wrapper and its twin.

Port of rabitq_tpu.ops.rerank_kernel.pallas_gather_l2:

  out[b, i] = sum_d (base[pos[b, i], d] - q[b, d])^2

for base [N, D] f32, pos [B, R] int64 rows of base and q [B, D] f32. The
JAX kernel reads a second, lane-tiled copy of the base for DMA legality;
this one reads the dense [N, D] base, so the index keeps one copy.

A bf16 base takes the kernel's bf16-row instance, the first level of the
two-level rerank (SearchParams.rerank_bf16; an XLA gather in JAX,
rabitq_tpu.index.search._gather_l2(..., cast_f32=True)): each row widened
to f32 (exactly), q and the output f32.

``cuda_gather_l2`` runs the hand-written kernel (csrc/gather_l2.cu) on
CUDA tensors and the twin ``gather_l2_reference`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rabitq_tpu_torch.ops import _cuda

# Bytes of the twin's gathered [chunk, R, D] f32 candidate rows.
_TWIN_CHUNK_BYTES = 1 << 28


# The kernel instance a base dtype takes: its C entry point, and the
# multiple of D its 16-byte row vectors need.
_INSTANCES = {
    torch.float32: ("rabitq_gather_l2", 4),
    torch.bfloat16: ("rabitq_gather_l2_bf16", 8),
}


@functools.cache
def _kernel(entry: str):
    """A built instance's C entry point: four pointers, n, b, r, dim."""
    return _cuda.bind(_cuda.load("gather_l2"), entry,
                      [ctypes.c_void_p] * 4 + [ctypes.c_int64]
                      + [ctypes.c_int] * 3)


def _check(base, pos, q):
    if base.dim() != 2 or pos.dim() != 2:
        raise ValueError("base [N, D] and pos [B, R] must be 2-D")
    if base.dtype not in _INSTANCES:
        raise ValueError(f"base: expected float32 or bfloat16, got "
                         f"{base.dtype}")
    d, (b, r) = base.shape[1], pos.shape
    expect = {
        "base": (base, base.dtype, tuple(base.shape)),
        "pos": (pos, torch.int64, (b, r)),
        "q": (q, torch.float32, (b, d)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != base.device:
            raise ValueError(f"{name} on {t.device}, base on {base.device}")


def gather_l2_reference(
    base: torch.Tensor, pos: torch.Tensor, q: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: same contract, any device. A
    position outside [0, N) gives NaN, as in the kernel. A bf16 base's
    gathered rows are cast to f32 before the difference, as JAX's
    ``_gather_l2(..., cast_f32=True)``.

    Queries run in chunks that bound the gathered [chunk, R, D] f32 rows
    to _TWIN_CHUNK_BYTES.
    """
    _check(base, pos, q)
    n, d = base.shape
    b, r = pos.shape
    out = torch.empty((b, r), dtype=torch.float32, device=base.device)
    chunk = max(1, _TWIN_CHUNK_BYTES // (4 * max(r, 1) * max(d, 1)))
    for a in range(0, b, chunk):
        p = pos[a : a + chunk]
        valid = (p >= 0) & (p < n)
        rows = base[torch.where(valid, p, 0)].to(torch.float32)
        diff = rows - q[a : a + chunk, None, :]
        out[a : a + chunk] = torch.where(
            valid, torch.sum(diff * diff, dim=-1), torch.nan
        )
    return out


def cuda_gather_l2(
    base: torch.Tensor,
    pos: torch.Tensor,
    q: torch.Tensor,
    *,
    check_pos: bool = True,
) -> torch.Tensor:
    """Squared L2 [B, R] f32 of ``base[pos[b, i]]`` against ``q[b]``;
    ``base`` f32 or bf16 (its rows widened to f32).

    CUDA tensors launch the sm_90a kernel (the instance of the base's
    dtype); CPU tensors take the twin,
    which gives NaN for a position outside [0, N). On CUDA such positions
    raise. That check reads a min/max pair back from the device, which
    stalls the stream; a caller whose positions lie in range by
    construction passes ``check_pos=False`` (the kernel still reads no row
    outside [0, N): it gives NaN there, as the twin does).
    ``cuda_gather_l2.launches`` counts the f32 instance's kernel launches
    and ``cuda_gather_l2.launches_bf16`` the bf16 instance's (not twin
    calls).
    """
    if not _cuda.on_card(base):
        return gather_l2_reference(base, pos, q)
    _check(base, pos, q)
    n, d = base.shape
    b, r = pos.shape
    entry, multiple = _INSTANCES[base.dtype]
    if d % multiple:
        raise ValueError(f"dim must be a multiple of {multiple} for a "
                         f"{base.dtype} base, got {d}")
    for t in (base, pos, q):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16B-aligned")
    out = torch.empty((b, r), dtype=torch.float32, device=base.device)
    if pos.numel() == 0:
        return out
    if check_pos:
        lo, hi = (int(v) for v in torch.aminmax(pos))
        if lo < 0 or hi >= n:
            raise ValueError(f"positions [{lo}, {hi}] outside [0, {n})")
    _cuda.launch("gather_l2", _kernel(entry), base.device, base.data_ptr(),
                 pos.data_ptr(), q.data_ptr(), out.data_ptr(), n, b, r, d)
    if base.dtype == torch.bfloat16:
        cuda_gather_l2.launches_bf16 += 1
    else:
        cuda_gather_l2.launches += 1
    return out


cuda_gather_l2.launches = 0
cuda_gather_l2.launches_bf16 = 0
