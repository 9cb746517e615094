"""Packed int4 operands: packing, the product kernels' wrapper and twin.

Port of the two kernels of tools/int4probe.py (``k2`` and ``k3``), which
ask whether 4-bit codes can halve the bytes a scan window moves. A packed
operand is [M, K/2] uint8: column 2j in the low nibble of byte j, column
2j+1 in the high nibble, each a two's-complement value in [-8, 7].

``cuda_int4_dot`` runs the hand-written kernels (csrc/int4_dot.cu) on CUDA
tensors and the twin ``int4_dot_reference`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rabitq_tpu_torch.ops import _cuda

# B rows a block takes (kTileN in csrc/int4_dot.cu; column tiles go on
# gridDim.y) and the grid's y limit.
_TILE_N = 64
_MAX_GRID_Y = 65_535


@functools.cache
def _kernel():
    """The built kernels' C entry point: three pointers, m, n, K/2, the
    staged flag and the stream (pointers and the stream as c_void_p)."""
    fn = _cuda.load("int4_dot").rabitq_int4_dot
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def pack_int4(x: torch.Tensor) -> torch.Tensor:
    """[M, K] int8 in [-8, 7] -> [M, K/2] uint8, low nibble = even column."""
    if x.dtype != torch.int8 or x.dim() != 2 or x.shape[1] % 2:
        raise ValueError(f"expected [M, even K] int8, got {x.dtype} {tuple(x.shape)}")
    if x.numel() and (int(x.min()) < -8 or int(x.max()) > 7):
        raise ValueError("int4 values must lie in [-8, 7]")
    u = x.view(torch.uint8) & 0x0F
    return u[:, 0::2] | (u[:, 1::2] << 4)


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """[M, K/2] uint8 -> [M, K] int8, the inverse of pack_int4."""
    if p.dtype != torch.uint8 or p.dim() != 2:
        raise ValueError(f"expected [M, K/2] uint8, got {p.dtype} {tuple(p.shape)}")
    nib = torch.stack([p & 0x0F, p >> 4], dim=-1).to(torch.int16)
    return ((nib ^ 8) - 8).to(torch.int8).reshape(p.shape[0], -1)


def _check(a, b):
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(
                f"{name}: expected [rows, K/2] uint8, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"K/2 differs: a {a.shape[1]}, b {b.shape[1]}")
    if a.shape[1] % 4:
        raise ValueError(f"K must be a multiple of 8, got {2 * a.shape[1]}")
    if a.device != b.device:
        raise ValueError(f"b on {b.device}, a on {a.device}")


def check_kernel_shape(kb: int, n: int) -> None:
    """Raise unless the kernels take K/2 = ``kb`` bytes a row and N = ``n``
    B rows: K a multiple of 32 (a k step of the int8 mma), and the column
    tiles within the grid. Any K fits shared memory: B is widened 2048
    columns at a time, and A streams through registers or a fixed ring."""
    if kb % 16:
        raise ValueError(f"K/2 must be a multiple of 16 bytes, got {kb}")
    if n > _TILE_N * _MAX_GRID_Y:
        raise ValueError(f"N = {n} exceeds {_TILE_N * _MAX_GRID_Y}")


def int4_dot_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch twin of the kernels: unpack, then A . B^T as [M, N]
    int32, on any device. The product runs in float64, which is exact:
    every partial sum is an integer of magnitude <= 64 K, far below 2^53
    (an integer matmul has no CUDA implementation in PyTorch)."""
    _check(a, b)
    af = unpack_int4(a).to(torch.float64)
    bf = unpack_int4(b).to(torch.float64)
    return (af @ bf.T).to(torch.int32)


def cuda_int4_dot(
    a: torch.Tensor, b: torch.Tensor, staged: bool
) -> torch.Tensor:
    """A . B^T [M, N] int32 of packed int4 operands A [M, K/2], B [N, K/2].

    CUDA tensors launch ``int4_dot_staged`` (A chunks brought through a
    cp.async ring in shared memory) or ``int4_dot_direct`` (A loaded
    straight into registers), both on the int8 tensor cores; CPU tensors
    take the twin. ``cuda_int4_dot.launches_direct`` and
    ``.launches_staged`` count the launches of each kernel (not twin
    calls).
    """
    if a.device.type == "cpu":
        return int4_dot_reference(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    _check(a, b)
    m, kb = a.shape
    n = b.shape[0]
    if torch.cuda.get_device_capability(a.device) != (9, 0):
        raise RuntimeError("the int4 kernels are built for sm_90a only")
    check_kernel_shape(kb, n)
    for t in (a, b):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16B-aligned")
    out = torch.empty((m, n), dtype=torch.int32, device=a.device)
    if m == 0 or n == 0:
        return out
    launch = _kernel()
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, kb, int(staged),
            stream,
        )
    if err:
        raise RuntimeError(f"int4_dot kernel launch failed: CUDA error {err}")
    if staged:
        cuda_int4_dot.launches_staged += 1
    else:
        cuda_int4_dot.launches_direct += 1
    return out


cuda_int4_dot.launches_direct = 0
cuda_int4_dot.launches_staged = 0
