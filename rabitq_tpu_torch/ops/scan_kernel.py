"""Rough-distance scan: the CUDA kernel's wrapper and its plain twin.

Port of rabitq_tpu.ops.scan_kernel.pallas_rough_scan (unfolded, unpacked).
A task t is one (query, probed cluster) pair; slot j of its output is row
``starts[t] + j`` of the cluster-sorted index:

  rough[t, j] = ((((cdsq + ycd) + lo*ppc) + (dot*ip)*delta) - err*sqrt(ycd))

with dot = <qvals[t], codes[row]> (exact int), (ip, ppc, err, cdsq) the
row's factors and (lo, delta, code_sum, ycd) = scal[t]. Slots j >= sizes[t]
are +inf. These are the coordinates of the JAX package's aligned kernel
path: slot = rank of the row within its cluster.

``cuda_rough_scan`` runs the hand-written kernel (csrc/rough_scan.cu) on
CUDA tensors and the twin ``rough_scan_reference`` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rabitq_tpu_torch.ops import _cuda

# Bytes of the twin's gathered [chunk, span, D] f32 code window.
_TWIN_CHUNK_BYTES = 1 << 28


@functools.cache
def _kernel():
    """The built kernel's C entry point, with its ctypes signature: seven
    pointers, n_tasks, dim, span, and the stream (pointers and the stream
    as c_void_p so ctypes does not cut them to 32 bits)."""
    fn = _cuda.load("rough_scan").rabitq_rough_scan
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(codes, factors, starts, sizes, qvals, scal, span):
    n, d = codes.shape
    s = starts.shape[0]
    expect = {
        "codes": (codes, torch.int8, (n, d)),
        "factors": (factors, torch.float32, (n, 4)),
        "starts": (starts, torch.int32, (s,)),
        "sizes": (sizes, torch.int32, (s,)),
        "qvals": (qvals, torch.int8, (s, d)),
        "scal": (scal, torch.float32, (s, 4)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"{name}: expected {dtype} {shape}, got {t.dtype} "
                f"{tuple(t.shape)}"
            )
        if t.device != codes.device:
            raise ValueError(f"{name} on {t.device}, codes on {codes.device}")
    if span <= 0:
        raise ValueError(f"span must be positive, got {span}")


def rough_scan_reference(
    codes: torch.Tensor,
    factors: torch.Tensor,
    starts: torch.Tensor,
    sizes: torch.Tensor,
    qvals: torch.Tensor,
    scal: torch.Tensor,
    span: int,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: same contract, any device.

    The integer dot is an fp32 batched matmul, exact because every partial
    sum is an integer below 2^24 (|dot| <= 127 * 15 * D) and TF32 is off.
    Tasks run in chunks that bound the [chunk, span, D] gathered window.
    """
    _check(codes, factors, starts, sizes, qvals, scal, span)
    n, d = codes.shape
    s = starts.shape[0]
    out = torch.empty((s, span), dtype=torch.float32, device=codes.device)
    iota = torch.arange(span, device=codes.device)
    chunk = max(1, _TWIN_CHUNK_BYTES // (4 * span * d))
    for a in range(0, s, chunk):
        b = min(a + chunk, s)
        valid = iota[None, :] < sizes[a:b, None]
        pos = torch.clamp(starts[a:b, None].long() + iota[None, :], 0, n - 1)
        win = codes[pos].to(torch.float32)  # [c, span, D]
        q = qvals[a:b].to(torch.float32)
        dot = torch.bmm(win, q[:, :, None])[:, :, 0]  # [c, span]
        fac = factors[pos]  # [c, span, 4]
        lo, delta, ycd = scal[a:b, 0:1], scal[a:b, 1:2], scal[a:b, 3:4]
        est = fac[..., 3] + ycd
        est = est + lo * fac[..., 1]
        est = est + (dot * fac[..., 0]) * delta
        est = est - fac[..., 2] * torch.sqrt(ycd)
        out[a:b] = torch.where(valid, est, torch.inf)
    return out


def cuda_rough_scan(
    codes: torch.Tensor,
    factors: torch.Tensor,
    starts: torch.Tensor,
    sizes: torch.Tensor,
    qvals: torch.Tensor,
    scal: torch.Tensor,
    span: int,
) -> torch.Tensor:
    """Rough scan [S, span] f32. CUDA tensors launch the sm_90a kernel;
    CPU tensors take the twin. The caller guarantees
    ``starts[t] + min(sizes[t], span) <= N`` for every task.

    ``cuda_rough_scan.launches`` counts kernel launches (not twin calls).
    """
    if codes.device.type == "cpu":
        return rough_scan_reference(
            codes, factors, starts, sizes, qvals, scal, span
        )
    if codes.device.type != "cuda":
        raise ValueError(f"unsupported device {codes.device}")
    _check(codes, factors, starts, sizes, qvals, scal, span)
    n, d = codes.shape
    s = starts.shape[0]
    if torch.cuda.get_device_capability(codes.device) != (9, 0):
        raise RuntimeError("the rough-scan kernel is built for sm_90a only")
    if d % 4:
        raise ValueError(f"dim must be a multiple of 4, got {d}")
    args = (codes, factors, starts, sizes, qvals, scal)
    for t in args:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16B-aligned")
    out = torch.empty((s, span), dtype=torch.float32, device=codes.device)
    launch = _kernel()
    with torch.cuda.device(codes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(
            *(t.data_ptr() for t in args),
            out.data_ptr(),
            s,
            d,
            span,
            stream,
        )
    if err:
        raise RuntimeError(f"rough_scan kernel launch failed: CUDA error {err}")
    if s:
        cuda_rough_scan.launches += 1
    return out


cuda_rough_scan.launches = 0
