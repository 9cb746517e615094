"""Rough-distance scan: the CUDA kernel's wrapper and its plain twin.

Port of rabitq_tpu.ops.scan_kernel.pallas_rough_scan: the full output, the
lane fold and the nibble-packed query operand (``qpack``). A task t is one
(query, probed cluster) pair; slot j of its output is row ``starts[t] + j``
of the cluster-sorted index:

  rough[t, j] = ((((cdsq + ycd) + lo*ppc) + (dot*ip)*delta) - err*sqrt(ycd))

with dot = <qvals[t], codes[row]> (exact int), (ip, ppc, err, cdsq) the
row's factors and (lo, delta, code_sum, ycd) = scal[t]. Slots j >= sizes[t]
are +inf. These are the coordinates of the JAX package's aligned kernel
path: slot = rank of the row within its cluster.

With ``fold`` = f > 0 (``effective_fold``) the output is the lane fold of
that [S, span] array, [S, f * 128]: column ``lane`` holds the smallest
SLOT-PACKED value of the bucket {j : j % 128 == lane, j < sizes[t]} and
column ``128 + lane`` (f = 2) the second smallest. A packed value is the
estimate's bit pattern with its low ``fold_slot_bits(span)`` mantissa bits
replaced by j, so it carries its own slot and orders as the estimate
does, up to that quantization. A bucket with fewer valid slots than f
holds +inf, never packed.

With ``penalty`` ([N] f32, the row filter of index/filter.py: 0 for an
allowed row, +inf for a filtered one) each estimate of row r becomes
``rough[t, j] + penalty[r]``, added before the fold packs and selects, so a
filtered row is +inf unfolded and never enters a fold bucket.

With ``qpack`` the query values come nibble-packed, [S, D/2] int8 in the
JAX split-half layout (byte i = dim i | dim i + D/2 << 4, as
ops/quantize.py:pack_query_nibbles writes them), and D must be a multiple
of 256, as the JAX search's gate (rabitq_tpu/index/search.py:403). The
output is that of the unpacked call on the same values, bit for bit.

``cuda_rough_scan`` runs the hand-written kernel (csrc/rough_scan.cu) on
CUDA tensors and the twin ``rough_scan_reference`` on CPU tensors. Before
the launch, ``group_tasks`` groups the tasks that share a cluster (the
port of the JAX kernel's ``_group_tasks``), so that one window read and
one int8 tensor-core product serve up to ``QPC`` tasks.

The kernel is persistent and warp-specialised: in each resident block a
producer warp takes the next group, fetches its descriptor, stages its
query tile and streams its window through a ring of shared-memory stages
(cp.async, full and empty mbarriers), while eight consumer warps
multiply, fold and store the group before it. The ring runs across
groups, so group g+1's loads are in flight while group g computes and
stores. Two blocks an SM, with 4 stages at D 128 and 3 at D 1024 packed
(the source's "Design"). ``rough_scan_counts`` reads the kernel's own
count of the groups it ran and of those whose loads it issued while the
block's previous group was still being worked on.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from rabitq_tpu_torch.consts import LANES
from rabitq_tpu_torch.ops import _cuda
from rabitq_tpu_torch.ops.quantize import unpack_query_nibbles

# Bytes of the twin's gathered [chunk, span, D] f32 code window.
_TWIN_CHUNK_BYTES = 1 << 28

# Tasks per group: the kernel's kQpc (checked when the kernel is loaded),
# two m16 tiles of the int8 mma. The
# tensor cores have work to spare (the scan is bound by bytes), so zero
# query rows in a small group cost nothing measurable, while a larger group
# re-reads a shared window fewer times than _pick_qpc's 8 or 16 would.
QPC = 32


@functools.cache
def _kernel():
    """The built kernel's C entry point: twelve pointers, n_tasks, dim,
    span, fold, qpack. Raises unless the kernel was built for groups of
    ``QPC`` tasks."""
    lib = _cuda.load("rough_scan")
    if lib.rabitq_rough_scan_qpc() != QPC:
        raise RuntimeError(
            f"rough_scan kernel built for {lib.rabitq_rough_scan_qpc()} "
            f"tasks a group, grouping cuts at {QPC}"
        )
    return _cuda.bind(lib, "rabitq_rough_scan",
                      [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5)


@functools.cache
def _counts(device: torch.device) -> torch.Tensor:
    """The kernel's counters on ``device``: [groups run, groups prefetched]
    int64, added to by every launch there."""
    return torch.zeros(2, dtype=torch.int64, device=device)


def rough_scan_counts(device: torch.device | str) -> tuple[int, int]:
    """(groups run, groups prefetched) by every scan kernel launch on
    ``device`` since the process started: the groups of ``group_tasks``
    that the kernel's blocks ran, and those of them whose first window
    stage (an empty window's descriptor) the block's producer warp issued
    while its consumer warps still held the block's previous group. Reads
    the device (a host sync), so it is never called on the search path;
    (0, 0) on the CPU, where no kernel runs."""
    device = torch.device(device)
    if device.type != "cuda":
        return 0, 0
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    run, prefetched = _counts(device).tolist()
    return run, prefetched


def fold_slot_bits(span: int) -> int:
    """Low mantissa bits that hold the window slot of a folded value:
    enough for any slot below ``span`` (rabitq_tpu.ops.scan_kernel)."""
    return max(1, (span - 1).bit_length())


def effective_fold(span: int, depth: bool | int) -> int:
    """The fold depth the scan applies at this span: ``depth`` clamped to
    0..2 (True is 2), and 0 unless the window has more than ``depth``
    128-slot tiles. Below that the output is the raw [S, span] estimates,
    not slot-packed, so a caller that decodes packed slots gates on this
    and not on the depth it asked for.

    The port passes ``index.capacity`` as the span where the JAX package
    passes its multiple of 128, ``scan_span(capacity)``. Both give the same
    gate, since ``depth * 128`` is a multiple of 128, and wherever the fold
    is on the same slot bits: they differ only if a power of two lay in
    [capacity, scan_span(capacity)), and one above 128 is itself a
    multiple of 128."""
    depth = 2 if depth is True else min(2, max(0, int(depth)))
    return depth if (depth and span > depth * LANES) else 0


def group_tasks(
    starts: torch.Tensor,
    sizes: torch.Tensor,
    n_rows: int,
    span: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Group the tasks that scan one window, on the tensors' device.

    The key of a task is (start, size clamped to [0, span]): the window
    the kernel reads. Sizes join the key because an empty cluster shares
    its start with its successor. Tasks are sorted stably by key and each
    run of equal keys is cut into groups of at most ``QPC``. Returns
    ``order`` [S] int64 (task ids in key order) and ``group_first``
    [S + 1] int32: group g holds ``order[group_first[g]:group_first[g+1]]``
    and ``group_first`` is S from one past the last group on. Groups
    follow key order, so a cluster's groups are adjacent. No host sync:
    sort, searchsorted and cumsum run on the device with static shapes.
    The key packs into int32 when ``n_rows * (span + 1)`` allows (half
    the radix-sort passes), else int64.
    """
    s = starts.shape[0]
    dev = starts.device
    dt = torch.int32 if n_rows * (span + 1) < 2**31 else torch.int64
    key = starts.to(dt) * (span + 1) + sizes.clamp(0, span).to(dt)
    key, order = torch.sort(key, stable=True)
    # Rank of each sorted task within its run of equal keys.
    rank = torch.arange(s, device=dev) - torch.searchsorted(key, key)
    gid = torch.cumsum(rank % QPC == 0, 0) - 1
    group_first = torch.searchsorted(
        gid, torch.arange(s + 1, device=dev), out_int32=True
    )
    return order, group_first


def _check(codes, factors, starts, sizes, qvals, scal, span, qpack,
           penalty=None):
    n, d = codes.shape
    s = starts.shape[0]
    if qpack and d % 256:
        raise ValueError(f"qpack needs dim % 256 == 0, got dim {d}")
    expect = {
        "codes": (codes, torch.int8, (n, d)),
        "factors": (factors, torch.float32, (n, 4)),
        "starts": (starts, torch.int32, (s,)),
        "sizes": (sizes, torch.int32, (s,)),
        "qvals": (qvals, torch.int8, (s, d // 2 if qpack else d)),
        "scal": (scal, torch.float32, (s, 4)),
    }
    if penalty is not None:
        expect["penalty"] = (penalty, torch.float32, (n,))
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
    fold: int = 0,
    qpack: bool = False,
    penalty: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: same contract, any device.

    The integer dot is an fp32 batched matmul, exact because every partial
    sum is an integer below 2^24 (|dot| <= 127 * 15 * D) and TF32 is off.
    Tasks run in chunks that bound the [chunk, span, D] gathered window;
    with a fold each chunk's estimates are packed and folded in turn. With
    ``qpack`` the query values are unpacked first. The penalty is added to
    the estimates before the fold or the +inf mask, as in the kernel.
    """
    _check(codes, factors, starts, sizes, qvals, scal, span, qpack, penalty)
    if qpack:
        qvals = unpack_query_nibbles(qvals)
    n, d = codes.shape
    s = starts.shape[0]
    f = effective_fold(span, fold)
    out = torch.empty(
        (s, f * LANES if f else span), dtype=torch.float32, device=codes.device
    )
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
        if penalty is not None:
            est = est + penalty[pos]
        if f:
            out[a:b] = _lane_fold(est, valid, span, f)
        else:
            out[a:b] = torch.where(valid, est, torch.inf)
    return out


def _lane_fold(
    est: torch.Tensor, valid: torch.Tensor, span: int, fold: int
) -> torch.Tensor:
    """[c, span] estimates -> [c, fold * 128] bucket minima, slot-packed.

    The strict ``<`` chain of the JAX kernel's epilogue, tile by tile in
    slot order, so that NaN estimates drop and ties resolve as there."""
    mask = (1 << fold_slot_bits(span)) - 1
    slot = torch.arange(span, dtype=torch.int32, device=est.device)
    packed = ((est.view(torch.int32) & ~mask) | slot).view(torch.float32)
    packed = torch.where(valid, packed, torch.inf)
    tiles = -(-span // LANES)
    packed = torch.nn.functional.pad(
        packed, (0, tiles * LANES - span), value=torch.inf
    ).reshape(-1, tiles, LANES)
    v1 = torch.full_like(packed[:, 0], torch.inf)
    v2 = torch.full_like(v1, torch.inf)
    for t in range(tiles):
        pe = packed[:, t]
        lt1 = pe < v1
        if fold >= 2:
            v2 = torch.where(lt1, v1, torch.where(pe < v2, pe, v2))
        v1 = torch.where(lt1, pe, v1)
    return torch.cat([v1, v2], dim=1) if fold >= 2 else v1


def cuda_rough_scan(
    codes: torch.Tensor,
    factors: torch.Tensor,
    starts: torch.Tensor,
    sizes: torch.Tensor,
    qvals: torch.Tensor,
    scal: torch.Tensor,
    span: int,
    fold: int = 0,
    qpack: bool = False,
    penalty: torch.Tensor | None = None,
) -> torch.Tensor:
    """Rough scan: [S, span] f32, or [S, f * 128] slot-packed bucket minima
    when ``f = effective_fold(span, fold)`` > 0. CUDA tensors launch the
    sm_90a kernel; CPU tensors take the twin. The caller guarantees
    ``starts[t] + min(sizes[t], span) <= N`` for every task. On the card
    D must be a multiple of 32 (the index pads it to a multiple of 128).
    ``qpack``: qvals are nibble-packed [S, D/2] (module docstring).
    ``penalty``: the row filter's [N] f32 added to every estimate, or None.

    ``cuda_rough_scan.launches`` counts kernel launches (not twin calls),
    ``cuda_rough_scan.launches_qpack`` those of them with ``qpack``,
    ``cuda_rough_scan.launches_penalty`` those with a penalty.
    """
    if not _cuda.on_card(codes):
        return rough_scan_reference(
            codes, factors, starts, sizes, qvals, scal, span, fold, qpack,
            penalty,
        )
    _check(codes, factors, starts, sizes, qvals, scal, span, qpack, penalty)
    n, d = codes.shape
    s = starts.shape[0]
    if d % 32:
        raise ValueError(f"dim must be a multiple of 32, got {d}")
    args = (codes, factors, starts, sizes, qvals, scal)
    for t in args if penalty is None else (*args, penalty):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous, 16B-aligned")
    f = effective_fold(span, fold)
    out = torch.empty(
        (s, f * LANES if f else span), dtype=torch.float32, device=codes.device
    )
    if s == 0:
        return out
    order, group_first = group_tasks(starts, sizes, n, span)
    next_group = torch.zeros(1, dtype=torch.int32, device=codes.device)
    _cuda.launch(
        "rough_scan", _kernel(), codes.device,
        *(t.data_ptr() for t in args),
        None if penalty is None else penalty.data_ptr(),
        *(t.data_ptr() for t in (order, group_first, next_group,
                                 _counts(codes.device), out)),
        s, d, span, f, int(qpack),
    )
    cuda_rough_scan.launches += 1
    cuda_rough_scan.launches_qpack += int(qpack)
    cuda_rough_scan.launches_penalty += int(penalty is not None)
    return out


cuda_rough_scan.launches = 0
cuda_rough_scan.launches_qpack = 0
cuda_rough_scan.launches_penalty = 0
