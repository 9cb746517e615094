"""Shared helpers: the entry points' device, padding, normalization,
recall."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None, *hints) -> torch.device:
    """``device`` if given, else the device of the first hint that is a
    tensor or a generator, else CUDA. Raises when that is CUDA and no card
    is present: the entry points run on the card unless asked for the CPU,
    and never fall back to it."""
    if device is None:
        device = next(
            (h.device for h in hints
             if isinstance(h, (torch.Tensor, torch.Generator))),
            "cuda",
        )
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' (or CPU tensors or a CPU "
            "generator) to run on the CPU"
        )
    return device


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_last_dim(a: np.ndarray, dim: int) -> np.ndarray:
    """Zero-pad the last axis of ``a`` up to ``dim`` (no-op if equal)."""
    cur = a.shape[-1]
    if cur == dim:
        return a
    if cur > dim:
        raise ValueError(f"cannot pad {cur} down to {dim}")
    pad = [(0, 0)] * (a.ndim - 1) + [(0, dim - cur)]
    return np.pad(a, pad)


def normalize_rows(a: np.ndarray) -> np.ndarray:
    """L2-normalize rows (zero rows stay zero). Cosine-metric indexes store
    unit vectors so cosine similarity reduces to L2 distance (d^2 = 2-2cos)."""
    a = np.asarray(a, dtype=np.float32)
    norms = np.linalg.norm(a, axis=-1, keepdims=True)
    return a / np.maximum(norms, 1e-30)


def calculate_recall(truth: np.ndarray, result: np.ndarray, topk: int) -> float:
    """|result ∩ truth[:topk]| / topk for one query."""
    t = set(np.asarray(truth)[:topk].tolist())
    r = np.asarray(result)[:topk]
    return sum(1 for i in r.tolist() if i in t) / topk
