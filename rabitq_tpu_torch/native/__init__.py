"""ctypes bindings of the host runtime pieces in ``block_cache.cpp``: the
LRU block cache of the store tier and a one-pass fvecs parser (the port's
copy of rabitq_tpu.native, with the same entry points and signatures).

The library is compiled by ``g++`` at first use, never at import, into
``build/librabitq_native-<hash>.so`` at the root of the checkout, the hash
taken over the source and the flags, so an edited source rebuilds. The
compiler writes to a temporary name that is then renamed into place, so a
process that builds at the same time as another never loads a half-written
file. A failed build raises ``NativeUnavailable``; callers that have a
pure-Python path fall back to it (store/vector_store.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "block_cache.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared")

_lib = None
_lib_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    pass


def library_path() -> Path:
    """Where the library built from this source and these flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"librabitq_native-{digest}.so"


def _build(out: Path) -> None:
    """Compile the source into ``out``: a temporary file, then a rename."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise NativeUnavailable("no C++ compiler (g++) found")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
            capture_output=True, text=True, timeout=120,
        )
        if proc.returncode != 0:
            raise NativeUnavailable(
                f"native build failed ({proc.returncode}): {proc.stderr}"
            )
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeUnavailable(f"native build failed: {e}") from e
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> ctypes.CDLL:
    """Build (if needed) and load the library, once a process."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            _build(path)
        lib = ctypes.CDLL(str(path))
        lib.rbq_cache_new.restype = ctypes.c_void_p
        lib.rbq_cache_new.argtypes = [ctypes.c_size_t]
        lib.rbq_cache_free.restype = None
        lib.rbq_cache_free.argtypes = [ctypes.c_void_p]
        lib.rbq_cache_get.restype = ctypes.c_int64
        lib.rbq_cache_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_size_t,
        ]
        lib.rbq_cache_put.restype = None
        lib.rbq_cache_put.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_size_t,
        ]
        lib.rbq_cache_size.restype = ctypes.c_size_t
        lib.rbq_cache_size.argtypes = [ctypes.c_void_p]
        lib.rbq_vecs_parse.restype = ctypes.c_int64
        lib.rbq_vecs_parse.argtypes = [
            ctypes.c_char_p,
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_uint32),
        ]
        _lib = lib
        return _lib


class NativeBlockCache:
    """Thread-safe C++ LRU cache of float blocks keyed by block id. ``get``
    copies the whole block out on every hit."""

    def __init__(
        self, max_blocks: int, floats_per_block: int, row_dim: int
    ) -> None:
        self._lib = get_lib()
        self._handle = self._lib.rbq_cache_new(max_blocks)
        self._cap = int(floats_per_block)
        self._cols = int(row_dim)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rbq_cache_free(self._handle)
            self._handle = None

    def get(self, block_id: int) -> np.ndarray | None:
        out = np.empty(self._cap, dtype=np.float32)
        n = self._lib.rbq_cache_get(
            self._handle,
            block_id,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self._cap,
        )
        if n < 0:
            return None
        return out[:n].reshape(-1, self._cols)

    def put(self, block_id: int, block: np.ndarray) -> None:
        block = np.ascontiguousarray(block, dtype=np.float32)
        if block.ndim != 2 or block.shape[1] != self._cols:
            raise ValueError(
                f"block of shape {block.shape}, expected [m, {self._cols}]"
            )
        self._lib.rbq_cache_put(
            self._handle,
            block_id,
            block.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            block.size,
        )

    def __len__(self) -> int:
        return self._lib.rbq_cache_size(self._handle)


def parse_vecs_matrix(raw: bytes) -> np.ndarray:
    """Single-pass native parse of a uniform 4-byte-payload vecs buffer.

    Returns a [n, dim] uint32 matrix (the caller views it as f32 or i32).
    Raises NativeUnavailable when the library cannot be built and
    ValueError on a corrupt or ragged buffer.
    """
    lib = get_lib()
    if len(raw) < 4:
        return np.empty((0, 0), dtype=np.uint32)
    cap = len(raw) // 4
    out = np.empty(cap, dtype=np.uint32)
    dim = ctypes.c_uint32(0)
    n = lib.rbq_vecs_parse(
        raw,
        len(raw),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        cap,
        ctypes.byref(dim),
    )
    if n == -1:
        raise ValueError("corrupt or ragged vecs buffer")
    if n < 0:
        raise NativeUnavailable("output capacity")
    return out[: n * dim.value].reshape(int(n), dim.value)
