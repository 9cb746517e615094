"""Build, load and launch the package's hand-written CUDA kernels.

Each kernel source in ``rabitq_tpu_torch/csrc/`` has a plain C interface.
At first use it is compiled by ``nvcc`` for ``sm_90a`` into a shared
library under ``build/`` at the root of the checkout, named by a hash of
the source, the headers beside it (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds, and loaded with ``ctypes``. Nothing
here runs at import time; the CPU tests never build.

Every wrapper launches the same way: ``on_card`` picks the kernel or the
plain version from its operand's device, ``bind`` gives an entry point
its ctypes signature, and ``launch`` calls it on the device's current
stream.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from collections.abc import Callable
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@functools.cache
def _sm90(device: torch.device) -> bool:
    return torch.cuda.get_device_capability(device) == (9, 0)


def on_card(t: torch.Tensor) -> bool:
    """Whether ``t``'s device runs the kernels: False on the CPU, where the
    caller takes its plain version, True on a CUDA device. Any other
    device raises ValueError, and a card other than sm_90 RuntimeError:
    the libraries are built for sm_90a alone (NVCC_FLAGS)."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    if not _sm90(t.device):
        raise RuntimeError(f"the kernels are built for sm_90a only, "
                           f"{t.device} is not sm_90")
    return True


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


def bind(lib: ctypes.CDLL, symbol: str, argtypes: list) -> Callable[..., int]:
    """``lib``'s entry point ``symbol``, taking ``argtypes`` and then the
    stream, returning a CUDA error code. Pass pointers as c_void_p, as the
    stream is, so that ctypes does not cut them to 32 bits."""
    fn = getattr(lib, symbol)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def launch(name: str, fn: Callable[..., int], device: torch.device,
           *args) -> None:
    """``fn(*args, stream)`` under ``device``'s guard on its current
    stream; a CUDA error raises, naming the kernel ``name``."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
