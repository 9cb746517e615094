"""Bit packing into uint32 words (port of rabitq_tpu.ops.packing:
``pack_bits_u32`` and ``unpack_bits_u32``, what serialization needs).

Bit ``i`` of a vector lands in word ``i // 32`` at position ``i % 32``,
the reference's convention, so the words interconvert with the
reference-format directory's u64 code words by a little-endian view.
The shifts run in int64 (torch's uint32 has few operators); the words come
out as torch.uint32.
"""

from __future__ import annotations

import torch

WORD_BITS = 32


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD_BITS, dtype=torch.int64, device=device)


def pack_bits_u32(bits: torch.Tensor) -> torch.Tensor:
    """Pack {0, 1} values along the last axis into uint32 words:
    [..., D] -> [..., D // 32]; D must be a multiple of 32."""
    *lead, d = bits.shape
    if d % WORD_BITS:
        raise ValueError(f"dim {d} not a multiple of {WORD_BITS}")
    b = bits.reshape(*lead, d // WORD_BITS, WORD_BITS).to(torch.int64)
    return (b << _shifts(bits.device)).sum(dim=-1).to(torch.uint32)


def unpack_bits_u32(words: torch.Tensor, dim: int) -> torch.Tensor:
    """Inverse of pack_bits_u32: [..., W] uint32 -> [..., dim] int32 in
    {0, 1}."""
    *lead, w = words.shape
    if w * WORD_BITS != dim:
        raise ValueError(f"{w} words do not hold {dim} bits")
    bits = (words.to(torch.int64)[..., None] >> _shifts(words.device)) & 1
    return bits.reshape(*lead, dim).to(torch.int32)
