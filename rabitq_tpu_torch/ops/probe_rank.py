"""The probe ranking: the CUDA kernel's wrapper and its plain version.

For each query b, the ids of the ``probe`` clusters of lowest ranking key,
best first: exactly ``torch.sort(key, dim=-1, stable=True).indices[:,
:probe]`` (NaN after +inf, and among equal keys the lower id first, so a
split cluster's tied segments come nearest first). The key is

  given whole ([B, K] f32: the annulus bound, a built distance matrix), or
  formed from the terms of pairwise_l2sq (``xx`` [B, 1], ``x`` the cross
  term xc [B, K], ``cc`` [K]) by ops/distances.py:l2sq_epilogue:
  max((xx - 2 xc) + cc, 0).

``cuda_probe_rank`` runs the hand-written kernel (csrc/probe_rank.cu) on
CUDA tensors, which forms the key in registers and never writes it; CPU
tensors take ``probe_rank_reference``, the epilogue and the stable sort.
Both return int64 [B, probe], the same ids bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rabitq_tpu_torch.ops import _cuda
from rabitq_tpu_torch.ops.distances import L2Terms, l2sq_epilogue


@functools.cache
def _lib():
    """The built kernel: its entry point (four pointers, b, k, probe) and
    the longest row it keeps in shared memory."""
    lib = _cuda.load("probe_rank")
    fn = _cuda.bind(lib, "rabitq_probe_rank",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3)
    return fn, lib.rabitq_probe_rank_resident_max()


def _check(x, probe, xx, cc):
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"the key must be float32 [B, K], got {x.dtype} "
                         f"{tuple(x.shape)}")
    b, k = x.shape
    if not 0 <= probe <= k:
        raise ValueError(f"probe {probe} outside [0, {k}]")
    if (xx is None) != (cc is None):
        raise ValueError("xx and cc come together (the fused key) or not "
                         "at all (a finished key)")
    if xx is None:
        return
    if xx.dtype != torch.float32 or cc.dtype != torch.float32:
        raise ValueError(f"xx and cc must be float32, got {xx.dtype} and "
                         f"{cc.dtype}")
    if xx.numel() != b or tuple(cc.shape) != (k,):
        raise ValueError(f"xx {tuple(xx.shape)} and cc {tuple(cc.shape)}: "
                         f"expected {b} and ({k},) values")
    if xx.device != x.device or cc.device != x.device:
        raise ValueError(f"xx on {xx.device}, cc on {cc.device}, the key "
                         f"on {x.device}")


def probe_rank_reference(
    x: torch.Tensor,
    probe: int,
    xx: torch.Tensor | None = None,
    cc: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: int64 [B,
    probe] (module docstring)."""
    _check(x, probe, xx, cc)
    key = x if xx is None else l2sq_epilogue(L2Terms(xx.reshape(-1, 1), x,
                                                     cc))
    return torch.sort(key, dim=-1, stable=True).indices[:, :probe]


def cuda_probe_rank(
    x: torch.Tensor,
    probe: int,
    xx: torch.Tensor | None = None,
    cc: torch.Tensor | None = None,
) -> torch.Tensor:
    """The ``probe`` lowest-keyed cluster ids of each row, best first,
    int64 [B, probe] (module docstring): ``x`` the finished key [B, K], or
    with ``xx`` [B, 1] and ``cc`` [K] the cross term xc of the fused key.

    CUDA tensors launch the sm_90a kernel, one block a row, the row's keys
    in shared memory up to the kernel's resident length and formed again
    from global memory on each pass above it; CPU tensors take the plain
    version. ``cuda_probe_rank.launches`` counts kernel launches,
    ``.launches_fused`` those that formed the key from its terms and
    ``.launches_streamed`` those on rows too long for shared memory (not
    plain-version calls)."""
    if not _cuda.on_card(x):
        return probe_rank_reference(x, probe, xx, cc)
    _check(x, probe, xx, cc)
    if not all(t.is_contiguous() for t in (x, xx, cc) if t is not None):
        raise ValueError("kernel operands must be contiguous")
    b, k = x.shape
    out = torch.empty((b, probe), dtype=torch.int64, device=x.device)
    if b == 0 or probe == 0:
        return out
    fn, resident_max = _lib()
    fused = xx is not None
    _cuda.launch("probe_rank", fn, x.device, x.data_ptr(),
                 xx.data_ptr() if fused else None,
                 cc.data_ptr() if fused else None, out.data_ptr(), b, k,
                 probe)
    cuda_probe_rank.launches += 1
    cuda_probe_rank.launches_fused += int(fused)
    cuda_probe_rank.launches_streamed += int(k > resident_max)
    return out


cuda_probe_rank.launches = 0
cuda_probe_rank.launches_fused = 0
cuda_probe_rank.launches_streamed = 0
