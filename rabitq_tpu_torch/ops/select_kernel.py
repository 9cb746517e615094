"""Exact rerank-candidate selection: the CUDA kernel's wrapper and its plain
version.

For each query b, from its rough estimates ``rough[b]`` ([probe * width]
f32, flat index j = task * width + slot, as the scan writes them), keep the
``rerank`` = R lowest and decode each into an index row:

  the R lowest values by (value, j): NaN after +inf, -0 equal to +0, and
  among equal values the lower flat index first (lax.top_k's rule);
  task = j // width, base = starts[b, task];
  folded (slot_bits > 0, the scan's lane fold packs a value's window slot
  into its low slot_bits mantissa bits): pos = base + (bits & mask),
  lower_bound = bits & ~mask, mask = 2^slot_bits - 1;
  unfolded (slot_bits 0): pos = base + j % width, lower_bound = value;
  pos = min(pos, n - 1) (+inf slots decode past a cluster's end).

``cuda_select_candidates`` runs the hand-written kernel (csrc/select.cu)
on CUDA tensors; it writes the R in ascending flat index (task order).
CPU tensors take ``select_candidates_reference``, two stable sorts (a
per-task top-min(R, width), then a global top-R over the survivors: any
value of the global top-R ranks below R in its own task), which writes
them in ascending value. Both keep the same (lower_bound, pos) pairs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rabitq_tpu_torch.ops import _cuda


@functools.cache
def _lib():
    """The built kernel: its entry point (four pointers, b, n, width, r,
    slot_bits, n_rows) and the longest row it keeps in shared memory."""
    lib = _cuda.load("select")
    fn = _cuda.bind(lib, "rabitq_select_candidates",
                    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                    + [ctypes.c_int64])
    return fn, lib.rabitq_select_resident_max()


def _check(rough, starts, width, rerank, slot_bits, n):
    if rough.dim() != 2 or starts.dim() != 2:
        raise ValueError("rough [B, probe * width] and starts [B, probe] "
                         "must be 2-D")
    b, probe = starts.shape
    if rough.dtype != torch.float32 or starts.dtype != torch.int32:
        raise ValueError(f"rough must be float32 and starts int32, got "
                         f"{rough.dtype} and {starts.dtype}")
    if tuple(rough.shape) != (b, probe * width):
        raise ValueError(f"rough {tuple(rough.shape)}: expected "
                         f"{(b, probe * width)} for starts {(b, probe)} and "
                         f"width {width}")
    if starts.device != rough.device:
        raise ValueError(f"starts on {starts.device}, rough on "
                         f"{rough.device}")
    if not 1 <= rerank <= probe * width:
        raise ValueError(f"rerank {rerank} outside [1, {probe * width}]")
    if not 0 <= slot_bits < 23 or n < 1:
        raise ValueError(f"slot_bits {slot_bits} or n {n} out of range")


def select_candidates_reference(
    rough: torch.Tensor,
    starts: torch.Tensor,
    width: int,
    rerank: int,
    slot_bits: int,
    n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel, on any device: (pos [B, R]
    int64, lower_bound [B, R] f32), sorted by value (module docstring)."""
    _check(rough, starts, width, rerank, slot_bits, n)
    b, probe = starts.shape
    m = min(rerank, width)
    vt, ji = torch.sort(rough.reshape(b, probe, width), dim=-1, stable=True)
    flat = (
        torch.arange(probe, device=rough.device)[None, :, None] * width
        + ji[..., :m]
    ).reshape(b, probe * m)
    lb, sel = torch.sort(vt[..., :m].reshape(b, probe * m), dim=-1,
                         stable=True)
    lb = lb[:, :rerank].contiguous()
    flat_idx = torch.gather(flat, 1, sel[:, :rerank])
    task = flat_idx // width  # [B, R] index into the probed clusters
    base = torch.gather(starts.long(), 1, task)
    if slot_bits:
        mask = (1 << slot_bits) - 1
        bits = lb.view(torch.int32)
        pos = base + (bits & mask)  # +inf decodes to slot 0
        lb = (bits & ~mask).view(torch.float32)
    else:
        pos = base + flat_idx % width
    return torch.clamp(pos, max=n - 1), lb


def cuda_select_candidates(
    rough: torch.Tensor,
    starts: torch.Tensor,
    width: int,
    rerank: int,
    slot_bits: int,
    n: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos [B, R] int64, lower_bound [B, R] f32) of the ``rerank`` lowest
    values of each row of ``rough`` (module docstring); ``starts`` [B,
    probe] int32 cluster start rows, ``slot_bits`` 0 unfolded, ``n`` the
    index's rows.

    CUDA tensors launch the sm_90a kernel, one block a row, the row's keys
    in shared memory up to the kernel's resident length and read again
    from global memory on each pass above it; CPU tensors take the plain
    version. ``cuda_select_candidates.launches`` counts kernel launches
    and ``.launches_streamed`` those of them on rows too long for shared
    memory (not plain-version calls)."""
    if not _cuda.on_card(rough):
        return select_candidates_reference(rough, starts, width, rerank,
                                           slot_bits, n)
    _check(rough, starts, width, rerank, slot_bits, n)
    if not (rough.is_contiguous() and starts.is_contiguous()):
        raise ValueError("kernel operands must be contiguous")
    b, row = rough.shape
    pos = torch.empty((b, rerank), dtype=torch.int64, device=rough.device)
    lb = torch.empty((b, rerank), dtype=torch.float32, device=rough.device)
    if b == 0:
        return pos, lb
    fn, resident_max = _lib()
    _cuda.launch("select", fn, rough.device, rough.data_ptr(),
                 starts.data_ptr(), pos.data_ptr(), lb.data_ptr(), b, row,
                 width, rerank, slot_bits, n)
    cuda_select_candidates.launches += 1
    cuda_select_candidates.launches_streamed += int(row > resident_max)
    return pos, lb


cuda_select_candidates.launches = 0
cuda_select_candidates.launches_streamed = 0
