"""fvecs/ivecs/u64vecs/bvecs (de)serialization (port of rabitq_tpu.io.vecs).

The *vecs* container format (texmex / faiss convention, and the on-disk
index format of the reference-format directory): a stream of
little-endian records ``[u32 count][count x payload]`` where the payload is
4 bytes for fvecs/ivecs, 8 bytes for u64vecs and 1 byte for bvecs.

Plain numpy on the host: uniform-dimension files (the common case) are
parsed with one reshape; ragged files fall back to an offset walk. The
files are byte-identical to the JAX package's.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def _read_records(raw: np.ndarray, payload_words: int) -> list[np.ndarray]:
    """Walk ragged records over a u32-viewed buffer.

    payload_words: u32 words per payload element (1 for f32/i32, 2 for u64).
    """
    out = []
    pos = 0
    total = raw.shape[0]
    while pos < total:
        dim = int(raw[pos])
        end = pos + 1 + dim * payload_words
        if end > total:
            raise ValueError(f"corrupt vecs record at word offset {pos}")
        out.append(raw[pos + 1 : end])
        pos = end
    return out


def read_vecs(path: str | Path, dtype=np.float32) -> list[np.ndarray]:
    """Read a 4-byte-payload vecs file into a list of 1-D arrays."""
    dtype = np.dtype(dtype)
    if dtype.itemsize != 4:
        raise ValueError("use read_u64_vecs for 8-byte payloads")
    raw = np.fromfile(path, dtype=np.uint32)
    return [rec.view(dtype) for rec in _read_records(raw, 1)]


def read_matrix(path: str | Path, dtype=np.float32) -> np.ndarray:
    """Read a uniform-dimension 4-byte vecs file as an (n, dim) matrix;
    a ragged file is read record by record and stacked (its records must
    then share one length)."""
    dtype = np.dtype(dtype)
    if dtype.itemsize != 4:
        raise ValueError("read_matrix reads 4-byte payloads")
    raw = np.fromfile(path, dtype=np.uint32)
    if raw.size == 0:
        return np.empty((0, 0), dtype=dtype)
    stride = int(raw[0]) + 1
    if raw.size % stride == 0 and np.all(raw[::stride] == stride - 1):
        mat = raw.reshape(-1, stride)[:, 1:]
        return np.ascontiguousarray(mat).view(dtype)
    return np.stack(read_vecs(path, dtype))


def read_u64_vecs(path: str | Path) -> list[np.ndarray]:
    """Read an 8-byte-payload vecs file."""
    raw = np.fromfile(path, dtype=np.uint32)
    return [np.ascontiguousarray(rec).view(np.uint64)
            for rec in _read_records(raw, 2)]


def write_vecs(path: str | Path, vecs) -> None:
    """Write 1-D arrays as consecutive 4-byte-payload records."""
    with open(path, "wb") as f:
        for v in vecs:
            v = np.asarray(v)
            if v.dtype.itemsize != 4 or v.ndim != 1:
                raise ValueError("write_vecs takes 1-D 4-byte arrays")
            np.uint32(v.shape[0]).tofile(f)
            v.tofile(f)


def write_matrix(path: str | Path, mat: np.ndarray) -> None:
    """Write an (n, dim) matrix of 4-byte values as n records, in one
    write."""
    mat = np.asarray(mat)
    if mat.ndim != 2 or mat.dtype.itemsize != 4:
        raise ValueError("write_matrix takes an (n, dim) 4-byte matrix")
    n, dim = mat.shape
    out = np.empty((n, dim + 1), dtype=np.uint32)
    out[:, 0] = dim
    out[:, 1:] = np.ascontiguousarray(mat).view(np.uint32)
    out.tofile(path)


def write_u64_vecs(path: str | Path, vecs) -> None:
    """Write 1-D uint64 arrays as consecutive 8-byte-payload records."""
    with open(path, "wb") as f:
        for v in vecs:
            v = np.ascontiguousarray(np.asarray(v, dtype=np.uint64))
            np.uint32(v.shape[0]).tofile(f)
            v.tofile(f)


def mmap_fvecs_matrix(path: str | Path) -> np.ndarray:
    """Zero-copy read-only mmap view of a uniform-dim fvecs file as an
    (n, dim) float32 array."""
    size = os.path.getsize(path)
    head = np.fromfile(path, dtype=np.uint32, count=1)
    if head.size == 0:
        return np.empty((0, 0), dtype=np.float32)
    stride = int(head[0]) + 1
    if size % (4 * stride):
        raise ValueError("not a uniform fvecs file")
    n = size // (4 * stride)
    mm = np.memmap(path, dtype=np.float32, mode="r", shape=(n, stride))
    return mm[:, 1:]


def read_bvecs_matrix(path: str | Path) -> np.ndarray:
    """Read a uniform-dim bvecs file ([u32 dim][dim x u8] records, the
    SIFT1B/bigann byte-vector format) as an (n, dim) float32 array."""
    size = os.path.getsize(path)
    head = np.fromfile(path, dtype=np.uint32, count=1)
    if head.size == 0:
        return np.empty((0, 0), dtype=np.float32)
    dim = int(head[0])
    stride = 4 + dim
    if size % stride:
        raise ValueError("not a uniform bvecs file")
    raw = np.memmap(path, dtype=np.uint8, mode="r").reshape(-1, stride)
    dims = raw[:, :4].copy().view(np.uint32)[:, 0]
    if not np.all(dims == dim):
        raise ValueError("corrupt bvecs file: inconsistent dims")
    return raw[:, 4:].astype(np.float32)


def write_bvecs_matrix(path: str | Path, mat: np.ndarray) -> None:
    """Write an (n, dim) array of 0..255 values as bvecs records."""
    mat = np.asarray(mat)
    if mat.ndim != 2:
        raise ValueError("write_bvecs_matrix takes an (n, dim) matrix")
    n, dim = mat.shape
    out = np.empty((n, 4 + dim), dtype=np.uint8)
    out[:, :4] = np.full((n, 1), dim, np.uint32).view(np.uint8).reshape(n, 4)
    out[:, 4:] = mat.astype(np.uint8)
    out.tofile(path)
