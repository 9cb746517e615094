"""Monotone f32 <-> sortable-i32 mapping ("ord32"), port of
rabitq_tpu.ord32.

A distance's f32 bit pattern, read as a signed int, is monotone for
non-negative floats; for negative floats all non-sign bits are flipped so
that more-negative sorts lower. The host rerankers keep their heaps of
such ints, with f32 total-order semantics (NaN above +inf). Both functions
take and return numpy arrays or scalars.
"""

from __future__ import annotations

import numpy as np

_LOW31 = np.int32(0x7FFFFFFF)


def f32_to_ord32(x):
    """float32 -> int32 whose integer order is the float order."""
    bits = np.asarray(x, dtype=np.float32).view(np.int32)
    return np.where(bits >= 0, bits, bits ^ _LOW31)


def ord32_to_f32(o):
    """Inverse of :func:`f32_to_ord32`."""
    o = np.asarray(o, dtype=np.int32)
    return np.where(o >= 0, o, o ^ _LOW31).view(np.float32)
