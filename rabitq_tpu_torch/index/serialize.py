"""Index (de)serialization (port of rabitq_tpu.index.serialize).

Three formats, each byte-compatible with the JAX package's, so an index
dumped by either package loads in the other:

1. **Reference directory format** (also the Rust reference's):

   - ``base.fvecs``           n records x dim f32 (padded, cluster-sorted)
   - ``orthogonal.fvecs``     dim records x dim f32 (the rotation)
   - ``centroids.fvecs``      dim records x k f32 (rotated, stored
                              transposed)
   - ``offsets_ids.ivecs``    2 records: offsets [k+1], map_ids [n]
   - ``factors.fvecs``        1 record of 4n f32 (ip, ppc, err, cdsq quads)
   - ``x_binary_vec.u64vecs`` 1 record of n * dim * code_bits / 64 u64
                              code words
   - ``meta.json``            rand_bias, dim_orig, capacity, metric,
                              code_bits, dedup_ids (written by both
                              packages, not by the Rust reference)
   - ``extra_base.fvecs``     the insert memtable's M rows (padded), and
     ``extra_ids.ivecs``      1 record of its M ids; only when M > 0

   The file stores each row's code as plane-major uint32 words: W = dim/32
   words a plane, ``code_bits`` planes, plane p holding bit p of the code
   value u in [0, 2^bits - 1] (rabitq_tpu/index/index.py:9-16), bit i of
   a plane in word i // 32 at position i % 32; pairs of words make the u64
   words. The port holds the int8 grid v = 2u - (2^bits - 1). ``codes_to_
   words`` and ``words_to_codes`` convert exactly, both ways.

   A directory without ``meta.json`` (written by the Rust reference) has
   no rand_bias, the query dither. The JAX package draws it from
   ``jax.random`` (``key=``); the port draws it from the ``generator=``
   that the caller must pass, with torch's numbers. So on such a directory
   only a ``dither=True`` search can differ between the two packages.

2. **JSON** (``dump_to_json``): the whole index, human-readable.

3. **npz** (``dump_to_npz``): one file, everything preserved.

A mutated index round-trips: its tombstones ride in ``factors`` (cdsq
+inf) and ``map_ids`` (-1, stored as uint32 0xFFFFFFFF as the JAX package
stores it), its memtable in the files above or the npz/JSON keys
``extra_base``/``extra_ids``.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from rabitq_tpu_torch.index.index import RaBitQIndex
from rabitq_tpu_torch.io import (
    read_matrix,
    read_u64_vecs,
    read_vecs,
    write_matrix,
    write_u64_vecs,
    write_vecs,
)
from rabitq_tpu_torch.ops.packing import WORD_BITS, pack_bits_u32, unpack_bits_u32
from rabitq_tpu_torch.utils import resolve_device, round_up

_META = "meta.json"
# Rows converted at a time: bounds the int64 bit tensors of the packing.
_CONVERT_ELEMS = 1 << 24


def codes_to_words(codes: torch.Tensor, code_bits: int) -> torch.Tensor:
    """int8 grid codes [N, D] (v = 2u - (2^bits - 1)) -> the file's
    plane-major words [N, D/32 * code_bits] uint32, on the codes' device."""
    n, d = codes.shape
    m = (1 << code_bits) - 1
    rows = max(1, _CONVERT_ELEMS // max(d, 1))
    out = []
    for a in range(0, n, rows):
        u = (codes[a : a + rows].to(torch.int32) + m) >> 1
        out.append(torch.cat(
            [pack_bits_u32((u >> p) & 1) for p in range(code_bits)], dim=-1
        ))
    if not out:
        return torch.empty((0, d // WORD_BITS * code_bits),
                           dtype=torch.uint32, device=codes.device)
    return torch.cat(out)


def words_to_codes(
    words: torch.Tensor, dim: int, code_bits: int
) -> torch.Tensor:
    """Inverse of ``codes_to_words``: [N, dim/32 * code_bits] uint32 ->
    int8 grid codes [N, dim]."""
    n = words.shape[0]
    w = dim // WORD_BITS
    if words.shape[1] != w * code_bits:
        raise ValueError(f"{words.shape[1]} code words a row, expected "
                         f"{w} x {code_bits} planes")
    m = (1 << code_bits) - 1
    rows = max(1, _CONVERT_ELEMS // max(dim, 1))
    codes = torch.empty((n, dim), dtype=torch.int8, device=words.device)
    for a in range(0, n, rows):
        wa = words[a : a + rows]
        u = sum(unpack_bits_u32(wa[:, p * w : (p + 1) * w], dim) << p
                for p in range(code_bits))
        codes[a : a + rows] = (2 * u - m).to(torch.int8)
    return codes


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def dump_to_dir(
    index: RaBitQIndex, path: str | Path, *, require_base: bool = True
) -> None:
    """Write the reference directory format (+ meta.json).

    ``require_base=False`` permits dumping an index without its base:
    every file but base.fvecs is written; such a directory loads with
    ``load_from_dir(keep_base=False)``.
    """
    if index.base is None and require_base:
        raise ValueError("dump requires the full-precision base (pass "
                         "require_base=False to dump without it)")
    if index.dim % 64:
        raise ValueError(f"u64 code words need dim % 64 == 0, got {index.dim}")
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    if index.base is not None:
        write_matrix(path / "base.fvecs", _np(index.base))
    write_matrix(path / "orthogonal.fvecs", _np(index.orthogonal))
    write_matrix(path / "centroids.fvecs", _np(index.centroids_rot).T)
    write_vecs(
        path / "offsets_ids.ivecs",
        [_np(index.offsets).astype(np.uint32),
         _np(index.map_ids).astype(np.uint32)],
    )
    write_vecs(path / "factors.fvecs", [_np(index.factors).reshape(-1)])
    words = _np(codes_to_words(index.codes, index.code_bits))
    write_u64_vecs(
        path / "x_binary_vec.u64vecs",
        [np.ascontiguousarray(words).reshape(-1).view(np.uint64)],
    )
    if index.m:
        write_matrix(path / "extra_base.fvecs", _np(index.extra_base))
        write_vecs(path / "extra_ids.ivecs", [_np(index.extra_ids)])
    (path / _META).write_text(json.dumps(dict(
        format=1,
        dim=index.dim,
        dim_orig=index.dim_orig,
        capacity=index.capacity,
        metric=index.metric,
        code_bits=index.code_bits,
        dedup_ids=index.dedup_ids,
        rand_bias=_np(index.rand_bias).tolist(),
    )))


def _index(device, *, codes_words, factors, offsets, map_ids, centroids_rot,
           orthogonal, rand_bias, base, dim, dim_orig, capacity, metric,
           code_bits, dedup_ids, extra_base=None,
           extra_ids=None) -> RaBitQIndex:
    """The port's index on ``device`` from host arrays, the codes as the
    file's [N, W * bits] uint32 words; an empty memtable becomes None."""

    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

    words = torch.from_numpy(
        np.ascontiguousarray(codes_words, dtype=np.uint32)
    ).to(device)
    return RaBitQIndex(
        codes=words_to_codes(words, int(dim), int(code_bits)),
        factors=t(factors, torch.float32).reshape(-1, 4).contiguous(),
        offsets=t(offsets, torch.int32),
        map_ids=t(map_ids, torch.int32),
        centroids_rot=t(centroids_rot, torch.float32).contiguous(),
        orthogonal=t(orthogonal, torch.float32).contiguous(),
        rand_bias=(rand_bias.to(device) if isinstance(rand_bias, torch.Tensor)
                   else t(rand_bias, torch.float32)),
        base=None if base is None else t(base, torch.float32),
        dim=int(dim),
        dim_orig=int(dim_orig),
        capacity=int(capacity),
        metric=metric,
        code_bits=int(code_bits),
        dedup_ids=bool(dedup_ids),
        extra_base=(None if extra_base is None or len(extra_base) == 0
                    else t(extra_base, torch.float32)),
        extra_ids=(None if extra_base is None or len(extra_base) == 0
                   else t(extra_ids, torch.int32)),
    )


def load_from_dir(
    path: str | Path,
    *,
    keep_base: bool = True,
    generator: torch.Generator | None = None,
    device: torch.device | str | None = None,
) -> RaBitQIndex:
    """Load the directory format onto ``device`` (default: the generator's,
    else CUDA, raising without a card).

    A directory without meta.json (the Rust reference's) needs
    ``generator``: it draws the rand_bias dither (torch.rand, [dim]).
    ``keep_base=False`` leaves the base on disk; such an index is searched
    through the store tier (rabitq_tpu_torch.store.search_with_store) and
    ``search`` raises on it.
    """
    path = Path(path)
    device = resolve_device(device, generator)
    orthogonal = read_matrix(path / "orthogonal.fvecs")
    dim = orthogonal.shape[0]
    if dim % 64:
        raise ValueError(f"stored dim must be a multiple of 64, got {dim}")
    centroids_rot = read_matrix(path / "centroids.fvecs").T  # [k, dim]
    offsets_ids = read_vecs(path / "offsets_ids.ivecs", np.int32)
    offsets, map_ids = offsets_ids[0], offsets_ids[-1]
    k, n = offsets.shape[0] - 1, map_ids.shape[0]
    if centroids_rot.shape != (k, dim):
        raise ValueError(f"centroids {centroids_rot.shape}, expected "
                         f"{(k, dim)}")
    factors = np.concatenate(read_vecs(path / "factors.fvecs"))
    words = np.concatenate(read_u64_vecs(path / "x_binary_vec.u64vecs"))

    meta_path = path / _META
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        rand_bias = np.asarray(meta["rand_bias"], np.float32)
        dim_orig = int(meta["dim_orig"])
        capacity = int(meta["capacity"])
        metric = meta.get("metric", "l2")
        code_bits = int(meta.get("code_bits", 1))
        dedup_ids = bool(meta.get("dedup_ids", False))
    else:
        if generator is None:
            raise ValueError(
                f"{path} has no {_META} (a reference-built directory): "
                "pass generator= to draw its query dither rand_bias"
            )
        rand_bias = torch.rand(dim, generator=generator,
                               device=generator.device)
        dim_orig, metric, code_bits, dedup_ids = dim, "l2", 1, False
        sizes = offsets[1:] - offsets[:-1]
        capacity = max(128, round_up(int(sizes.max(initial=1)), 128))
    w32 = dim // WORD_BITS * code_bits
    base = read_matrix(path / "base.fvecs") if keep_base else None
    if base is not None and base.size == 0:  # an empty file: no rows
        base = base.reshape(0, dim)
    if base is not None and base.shape != (n, dim):
        raise ValueError(f"base {base.shape}, expected {(n, dim)}")
    extra_base = extra_ids = None
    if (path / "extra_base.fvecs").exists():
        extra_base = read_matrix(path / "extra_base.fvecs")
        extra_ids = read_vecs(path / "extra_ids.ivecs", np.int32)[0]
    return _index(
        device, codes_words=words.view(np.uint32).reshape(n, w32),
        factors=factors, offsets=offsets, map_ids=map_ids,
        centroids_rot=centroids_rot, orthogonal=orthogonal,
        rand_bias=rand_bias, base=base, dim=dim, dim_orig=dim_orig,
        capacity=capacity, metric=metric, code_bits=code_bits,
        dedup_ids=dedup_ids, extra_base=extra_base, extra_ids=extra_ids,
    )


def dump_to_json(index: RaBitQIndex, path: str | Path) -> None:
    """Whole-index JSON dump: human-readable and diffable; use npz for
    anything large."""
    if index.base is None:
        raise ValueError("dump requires the full-precision base")
    payload = dict(
        dim=index.dim,
        dim_orig=index.dim_orig,
        capacity=index.capacity,
        base=_np(index.base).tolist(),
        orthogonal=_np(index.orthogonal).tolist(),
        centroids_rot=_np(index.centroids_rot).tolist(),
        rand_bias=_np(index.rand_bias).tolist(),
        offsets=_np(index.offsets).tolist(),
        map_ids=_np(index.map_ids).tolist(),
        codes=_np(codes_to_words(index.codes, index.code_bits)).tolist(),
        factors=_np(index.factors).tolist(),
        metric=index.metric,
        code_bits=index.code_bits,
        dedup_ids=index.dedup_ids,
    )
    if index.m:
        payload["extra_base"] = _np(index.extra_base).tolist()
        payload["extra_ids"] = _np(index.extra_ids).tolist()
    Path(path).write_text(json.dumps(payload))


def load_from_json(
    path: str | Path, *, device: torch.device | str | None = None
) -> RaBitQIndex:
    """Load a JSON dump onto ``device`` (default CUDA)."""
    device = resolve_device(device)
    z = json.loads(Path(path).read_text())
    return _index(
        device, codes_words=np.asarray(z["codes"], np.uint32),
        factors=np.asarray(z["factors"], np.float32),
        offsets=np.asarray(z["offsets"], np.int32),
        map_ids=np.asarray(z["map_ids"], np.int32),
        centroids_rot=np.asarray(z["centroids_rot"], np.float32),
        orthogonal=np.asarray(z["orthogonal"], np.float32),
        rand_bias=np.asarray(z["rand_bias"], np.float32),
        base=np.asarray(z["base"], np.float32),
        dim=z["dim"], dim_orig=z["dim_orig"], capacity=z["capacity"],
        metric=z.get("metric", "l2"), code_bits=z.get("code_bits", 1),
        dedup_ids=z.get("dedup_ids", False),
        extra_base=(np.asarray(z["extra_base"], np.float32)
                    if "extra_base" in z else None),
        extra_ids=(np.asarray(z["extra_ids"], np.int32)
                   if "extra_ids" in z else None),
    )


def dump_to_npz(index: RaBitQIndex, path: str | Path) -> None:
    """One uncompressed .npz file that preserves everything."""
    arrays = dict(
        codes=_np(codes_to_words(index.codes, index.code_bits)),
        factors=_np(index.factors),
        offsets=_np(index.offsets),
        map_ids=_np(index.map_ids),
        centroids_rot=_np(index.centroids_rot),
        orthogonal=_np(index.orthogonal),
        rand_bias=_np(index.rand_bias),
        meta=np.asarray([index.dim, index.dim_orig, index.capacity,
                         index.code_bits, int(index.dedup_ids)]),
        metric=np.asarray(index.metric),
    )
    if index.base is not None:
        arrays["base"] = _np(index.base)
    if index.m:
        arrays["extra_base"] = _np(index.extra_base)
        arrays["extra_ids"] = _np(index.extra_ids)
    np.savez(path, **arrays)


def load_from_npz(
    path: str | Path,
    *,
    keep_base: bool = True,
    device: torch.device | str | None = None,
) -> RaBitQIndex:
    """Load an npz dump onto ``device`` (default CUDA)."""
    device = resolve_device(device)
    with np.load(path) as z:
        meta = [int(v) for v in z["meta"]]
        return _index(
            device, codes_words=z["codes"], factors=z["factors"],
            offsets=z["offsets"], map_ids=z["map_ids"],
            centroids_rot=z["centroids_rot"], orthogonal=z["orthogonal"],
            rand_bias=z["rand_bias"],
            base=z["base"] if keep_base and "base" in z else None,
            dim=meta[0], dim_orig=meta[1], capacity=meta[2],
            code_bits=meta[3] if len(meta) > 3 else 1,
            dedup_ids=bool(meta[4]) if len(meta) > 4 else False,
            metric=str(z["metric"]) if "metric" in z else "l2",
            extra_base=z["extra_base"] if "extra_base" in z else None,
            extra_ids=z["extra_ids"] if "extra_ids" in z else None,
        )
