"""Build and load the package's hand-written CUDA kernels.

Each kernel source in ``rabitq_tpu_torch/csrc/`` has a plain C interface.
At first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under ``build/`` at the root of the checkout, named by a hash of
the source, the headers beside it (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds, and loaded with ``ctypes``. Nothing
here runs at import time; the CPU tests never build.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def find_nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); cannot build kernels")


@dataclasses.dataclass(frozen=True)
class Build:
    """Result of building one kernel library."""

    path: Path
    seconds: float  # nvcc wall time; 0.0 when the library was cached
    log: str  # nvcc output (ptxas -v resource usage)
    cached: bool


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>-<hash>.so``.

    Reuses the library if it already exists. The compile writes to a
    temporary name and renames, so concurrent builders never load a
    half-written file.
    """
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src.read_bytes() + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
    log_path = out.with_suffix(".log")
    if out.exists():
        log = log_path.read_text() if log_path.exists() else ""
        return Build(out, 0.0, log, cached=True)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return Build(out, seconds, log, cached=False)


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build(name).path))
