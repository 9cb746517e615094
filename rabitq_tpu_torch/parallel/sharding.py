"""An index sharded over a mesh of devices (port of
rabitq_tpu.parallel.sharding).

- **Index sharding (search)**: the IVF clusters are partitioned over the
  shards (greedy, balanced by rows), so each device holds 1/S of the
  codes, factors and full-precision rows. A query batch goes to every
  shard; each shard runs the single-device search (the quantize, rough
  scan and gather_l2 kernels) on its own clusters, and the per-shard
  top-k lists are merged on the mesh's first device.
- **Data parallelism (build and training)**: k-means steps and the
  quantization pass split the corpus rows over the mesh devices; Lloyd's
  per-cluster sums and counts are summed on the first device (an
  ``all_reduce`` under a multi-process world). The centroids stay
  replicated.

A mesh is an explicit list of devices, one per shard, and a device may
repeat: S shards on one card, one shard per card, or S entries of the CPU
(the JAX package's tests do the same with virtual CPU devices). Under a
multi-process world (``init_distributed``) the mesh lists every shard's
device in order and each process owns a contiguous block of
S / world_size shards; a ShardedIndex holds None for the shards of other
processes, and the merge all-gathers the per-shard results over the
process group.

Each shard is a RaBitQIndex laid out as the JAX package's shard-local
index: ``k_max`` clusters (padding centroids at _FAR, repeated offsets
past the shard's last cluster), local offsets and global ids in
``map_ids``; the insert memtable rides on shard 0 only. Rows are not
padded: a shard's arrays hold its rows only (``rows_max`` is kept for the
global-position table and the checkpoint). A shard that gets no cluster
with rows (more shards than such clusters) is padded as JAX pads it:
``rows_max`` rows of zeros with id -1 behind offsets that are all 0, so a
search of it yields only +inf / -1 candidates, which the merge drops.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import math
import os
from typing import Sequence

import numpy as np
import torch

from rabitq_tpu_torch.consts import LANES
from rabitq_tpu_torch.index.filter import make_row_filter
from rabitq_tpu_torch.index.index import (
    RaBitQIndex,
    SearchParams,
    with_bf16_base,
)
from rabitq_tpu_torch.utils import pad_last_dim, round_up

logger = logging.getLogger(__name__)

# The coordinate of a padding centroid: its distance to any query is +inf
# in f32, so a padded cluster ranks last and is probed only when the probe
# exceeds the shard's real clusters (it then holds no rows).
_FAR = 1e30


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The devices of the shards, in shard order, and this process's place
    in the world. Process r owns shards [r * L, (r + 1) * L), L = S /
    world_size."""

    devices: tuple[torch.device, ...]
    rank: int = 0
    world_size: int = 1

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        if len(self.devices) % self.world_size:
            raise ValueError(
                f"{len(self.devices)} shards do not split evenly over "
                f"{self.world_size} processes")

    @property
    def size(self) -> int:
        return len(self.devices)

    def owner(self, si: int) -> int:
        return si * self.world_size // self.size

    @property
    def local_shards(self) -> list[int]:
        return [si for si in range(self.size) if self.owner(si) == self.rank]

    @property
    def home(self) -> torch.device:
        """Where this process merges: its first shard's device."""
        return self.devices[self.local_shards[0]]


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str | None = None,
    timeout_s: float = 120.0,
) -> bool:
    """Join a multi-process world (torch.distributed) if one is asked for.

    The coordinator is ``host:port`` (or a ``tcp://`` URL), the world size
    and this process's rank; each falls back on the MASTER_ADDR /
    MASTER_PORT, WORLD_SIZE and RANK environment variables. With neither
    (a single process and no coordinator) it does nothing and returns
    False, as the JAX package's does. ``backend`` defaults to "nccl" when
    a card is present and "gloo" otherwise; NCCL needs one card a rank.
    Call it before make_mesh. Returns True when the world has more than
    one process."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (
            f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    if coordinator_address is None and num_processes in (None, 1):
        return False
    if coordinator_address is None or num_processes is None or (
            process_id is None):
        raise ValueError("a multi-process world needs the coordinator "
                         "address, the world size and this process's rank")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    dist.init_process_group(
        backend, init_method=url, world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    logger.info("distributed: rank %d of %d, backend %s", process_id,
                num_processes, backend)
    return num_processes > 1


def make_mesh(
    n_devices: int | None = None,
    *,
    devices: Sequence[torch.device | str] | None = None,
) -> Mesh:
    """The shard mesh.

    ``devices``: the explicit placement, one entry per shard, repeats
    allowed (S shards on one card: ``["cuda:0"] * S``; the CPU tests:
    ``["cpu"] * S``). Under a multi-process world it lists every shard,
    each entry naming the device on its owner's host.

    Otherwise one shard per card: the first ``n_devices`` cards (all of
    them by default), n_devices / world_size on each process. Raises when
    fewer cards are visible; it never builds a smaller mesh or a CPU one.
    """
    rank, world = _world()
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices {n_devices} != {len(devices)} "
                             "devices")
        return Mesh(tuple(_indexed(torch.device(d)) for d in devices), rank,
                    world)
    visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n_devices is None:
        n_devices = visible * world
    if n_devices < 1 or n_devices % world:
        raise ValueError(f"make_mesh({n_devices}) over {world} processes")
    per = n_devices // world
    if per > visible:
        raise RuntimeError(
            f"make_mesh({n_devices}): this process sees {visible} CUDA "
            f"device(s) and needs {per}; pass devices=[...] to place "
            "several shards on one device")
    return Mesh(tuple(torch.device("cuda", i) for _ in range(world)
                      for i in range(per)), rank, world)


def _indexed(dev: torch.device) -> torch.device:
    """"cuda" as "cuda:<current>", so equal devices compare equal."""
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _greedy_partition(sizes: np.ndarray, s: int) -> list[list[int]]:
    """Balance clusters across s shards by total row count (LPT greedy)."""
    order = np.argsort(sizes)[::-1]
    loads = [0] * s
    groups: list[list[int]] = [[] for _ in range(s)]
    for c in order:
        dst = int(np.argmin(loads))
        groups[dst].append(int(c))
        loads[dst] += int(sizes[c])
    return groups


def _shard_layout(sizes: np.ndarray, s: int):
    """The shard plan of shard_index, shard_global_positions and
    build_index_sharded: LPT cluster groups, k_max and rows_max."""
    groups = _greedy_partition(sizes, s)
    k_max = max(1, max(len(g) for g in groups))
    rows_max = max(
        8, round_up(max(int(sizes[g].sum()) if g else 0 for g in groups), 8)
    )
    return groups, k_max, rows_max


def _tiles(offsets: np.ndarray, capacity: int) -> int:
    """128-lane tiles of the JAX package's scan blob for these offsets
    (rabitq_tpu.index.index.make_blob): the checkpoint's ``tiles_max``."""
    from rabitq_tpu_torch.index.index import padded_offsets

    n_pad = int(padded_offsets(np.asarray(offsets))[-1])
    pad_cols = round_up(capacity, LANES) + 2 * LANES
    return (n_pad + pad_cols + LANES - 1) // LANES


def _local_offsets(sizes: np.ndarray, k_max: int) -> np.ndarray:
    """[k_max + 1] int32 offsets of one shard's clusters of ``sizes``,
    repeated past its last cluster."""
    off = np.zeros(k_max + 1, np.int32)
    np.cumsum(sizes, out=off[1 : sizes.shape[0] + 1])
    off[sizes.shape[0] + 1 :] = off[sizes.shape[0]]
    return off


@dataclasses.dataclass(frozen=True)
class ShardedIndex:
    """S shard-local indexes (None for a shard another process owns), the
    padded shape every shard shares, and the mesh they lie on."""

    shards: list
    k_max: int
    rows_max: int
    tiles_max: int
    mesh: Mesh

    def local(self) -> list[tuple[int, RaBitQIndex]]:
        return [(si, self.shards[si]) for si in self.mesh.local_shards]

    @property
    def first(self) -> RaBitQIndex:
        return self.shards[self.mesh.local_shards[0]]

    @property
    def dim(self) -> int:
        return self.first.dim

    @property
    def dim_orig(self) -> int:
        return self.first.dim_orig

    @property
    def capacity(self) -> int:
        return self.first.capacity

    @property
    def metric(self) -> str:
        return self.first.metric

    @property
    def code_bits(self) -> int:
        return self.first.code_bits

    @property
    def dedup_ids(self) -> bool:
        return self.first.dedup_ids

    @property
    def has_base(self) -> bool:
        return self.first.base is not None

    @property
    def k(self) -> int:
        """Cluster slots over all shards (padding included)."""
        return self.k_max * self.mesh.size

    def live_rows(self) -> int:
        """Rows with an id (tombstones excluded) over this process's
        shards: one device-to-host read a shard."""
        return sum(int((sh.map_ids >= 0).sum()) for _, sh in self.local())


def shard_global_positions(index: RaBitQIndex, s: int) -> np.ndarray:
    """[S, rows_max] int32: the global cluster-sorted position of each
    shard-local row (-1 on padding), the shard_index plan's. The store
    tier's stores are indexed by global position (the order dump_to_dir
    writes base.fvecs in); sharded_search_with_store maps each shard's
    candidates through this table so that one store serves every shard."""
    offsets = index.offsets.cpu().numpy()
    groups, _, rows_max = _shard_layout(np.diff(offsets), s)
    gpos = np.full((s, rows_max), -1, np.int32)
    for si, group in enumerate(groups):
        row = 0
        for c in group:
            a, b = int(offsets[c]), int(offsets[c + 1])
            gpos[si, row : row + (b - a)] = np.arange(a, b, dtype=np.int32)
            row += b - a
    return gpos


def _shard_of(
    index: RaBitQIndex,
    rows: torch.Tensor,
    group: list[int],
    k_max: int,
    sizes: np.ndarray,
    device: torch.device,
    memtable: bool,
) -> RaBitQIndex:
    """One shard of ``index`` on ``device``: the rows ``rows`` (the
    clusters of ``group``, in order), k_max padded clusters."""
    cent = torch.full((k_max, index.dim), _FAR, dtype=torch.float32)
    cent[: len(group)] = index.centroids_rot[
        torch.as_tensor(group, dtype=torch.long,
                        device=index.centroids_rot.device)].cpu()
    with_mem = memtable and index.m > 0
    return RaBitQIndex(
        codes=index.codes[rows].to(device),
        factors=index.factors[rows].to(device),
        offsets=torch.from_numpy(
            _local_offsets(sizes[group], k_max)).to(device),
        map_ids=index.map_ids[rows].to(device),
        centroids_rot=cent.to(device),
        orthogonal=index.orthogonal.to(device),
        rand_bias=index.rand_bias.to(device),
        base=None if index.base is None else index.base[rows].to(device),
        dim=index.dim,
        dim_orig=index.dim_orig,
        capacity=index.capacity,
        metric=index.metric,
        code_bits=index.code_bits,
        dedup_ids=index.dedup_ids,
        extra_base=index.extra_base.to(device) if with_mem else None,
        extra_ids=index.extra_ids.to(device) if with_mem else None,
    )


def pad_empty_shard(shard: RaBitQIndex, rows_max: int) -> RaBitQIndex:
    """A shard with no rows as the JAX package lays it out: ``rows_max``
    rows of zero codes, factors and base with id -1 (its offsets, all 0,
    keep them out of every cluster). Any other shard is returned as is."""
    if shard.n:
        return shard

    def zeros(t):
        return None if t is None else t.new_zeros((rows_max, *t.shape[1:]))

    return dataclasses.replace(
        shard, codes=zeros(shard.codes), factors=zeros(shard.factors),
        map_ids=torch.full((rows_max,), -1, dtype=shard.map_ids.dtype,
                           device=shard.map_ids.device),
        base=zeros(shard.base))


def shard_index(index: RaBitQIndex, mesh: Mesh) -> ShardedIndex:
    """Partition an index over the mesh: each of this process's shards is
    sliced from ``index`` and placed straight onto its device.

    Pass an index on the CPU (``load_from_dir(..., device="cpu")``) to
    shard a corpus whose full copy should never sit on a card: only the
    shards' own bytes reach the devices. Works with or without a base (a
    base-less index is searched through sharded_search_with_store). An
    index with the bf16 rerank copy (with_bf16_base) gives each shard its
    own, cast on the shard's device from its base, as the JAX package's
    shard_index carries it."""
    offsets = index.offsets.cpu().numpy()
    sizes = np.diff(offsets).astype(np.int64)
    groups, k_max, rows_max = _shard_layout(sizes, mesh.size)
    shards: list = [None] * mesh.size
    src = index.codes.device
    for si in mesh.local_shards:
        group = groups[si]
        rows = np.concatenate(
            [np.arange(offsets[c], offsets[c + 1]) for c in group]
            or [np.zeros(0, np.int64)])
        shards[si] = pad_empty_shard(_shard_of(
            index, torch.from_numpy(rows).to(src), group, k_max, sizes,
            mesh.devices[si], memtable=si == 0), rows_max)
        if index.base_bf16 is not None:
            shards[si] = with_bf16_base(shards[si])
    tiles_max = max(
        _tiles(_local_offsets(sizes[g], k_max), index.capacity)
        for g in groups)
    return ShardedIndex(shards, k_max, rows_max, tiles_max, mesh)


def make_sharded_row_filter(
    sindex: ShardedIndex, mesh: Mesh, allow_ids=None, deny_ids=None
) -> list:
    """A filter for a sharded index (shard_index, build_index_sharded,
    load_index_sharded), by original ids as make_row_filter: a list of one
    RowFilter a shard (None for another process's shard), each built from
    that shard's own map_ids on its device, so a process reads only the
    shards it holds; the memtable's penalty rides on shard 0's."""
    if (allow_ids is None) == (deny_ids is None):
        raise ValueError("pass exactly one of allow_ids / deny_ids")
    _check_mesh(sindex, mesh)
    filters: list = [None] * mesh.size
    for si, shard in sindex.local():
        filters[si] = make_row_filter(shard, allow_ids=allow_ids,
                                      deny_ids=deny_ids)
    return filters


def _check_mesh(sindex: ShardedIndex, mesh: Mesh) -> None:
    if not isinstance(sindex, ShardedIndex):
        raise TypeError("needs a ShardedIndex (shard_index, "
                        "build_index_sharded or load_index_sharded)")
    if sindex.mesh != mesh:
        raise ValueError("the sharded index lies on another mesh")


def _local_params(
    params: SearchParams, s: int, k_local: int, exact: bool
) -> SearchParams:
    """Per-shard budgets.

    Heuristic mode (default): the global top-probe clusters spread across
    shards roughly evenly, so each shard probes ~probe/S clusters with 2x
    headroom (and reranks rerank/S with the same headroom). **This is a
    deliberate semantic deviation from single-chip search**: when the
    query's top clusters concentrate on one shard (adversarial skew), that
    shard probes fewer of them than an unsharded index would, and recall
    can drop below the unsharded result for the same SearchParams.

    Exact mode: every shard probes min(k_local, probe) clusters and keeps
    the full rerank budget — the union of probed clusters is then a
    superset of the unsharded probe set, so results are at least as good
    as single-chip search at ~S x the per-shard work.
    """
    if exact:
        return params._replace(probe=min(k_local, params.probe))
    probe = min(k_local, max(1, math.ceil(params.probe / s) * 2))
    rerank = max(params.topk, math.ceil(params.rerank / s) * 2)
    return params._replace(probe=probe, rerank=rerank)


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """[L, ...] of this process's shards -> [S, ...] of every shard, in
    shard order, on ``t``'s device. Gloo has no all_gather for CUDA
    tensors (torch.distributed's backend table), so under gloo the
    gather runs on host copies: a device-to-host sync a call."""
    import torch.distributed as dist

    gloo = dist.get_backend() == "gloo"
    src = t.cpu() if gloo and t.is_cuda else t.contiguous()
    if gloo and t.is_cuda:
        logger.info("sharded merge: gloo gathers host copies of the "
                    "per-shard results (no CUDA all_gather in gloo)")
    out = [torch.empty_like(src) for _ in range(mesh.world_size)]
    dist.all_gather(out, src)
    return torch.cat(out).to(t.device)


def _merge_topk(
    d_all: torch.Tensor, i_all: torch.Tensor, topk: int, dedup: bool
) -> tuple[torch.Tensor, torch.Tensor]:
    """[S, B, t] per-shard top-t lists -> the [B, topk] global top-k, as
    the JAX package merges them: shard-major columns; on a spilled index
    each id keeps its best entry (sorted by (id, distance) by two stable
    sorts, the rest of each id's run +inf); then the lowest distances,
    ties to the lower column (a stable sort, as lax.top_k), ids -1 where
    the distance is not finite."""
    s, b, t = d_all.shape
    d = d_all.permute(1, 0, 2).reshape(b, s * t)
    i = i_all.permute(1, 0, 2).reshape(b, s * t)
    if dedup:
        o = torch.sort(d, dim=1, stable=True).indices
        d, i = torch.gather(d, 1, o), torch.gather(i, 1, o)
        o = torch.sort(i, dim=1, stable=True).indices
        d, i = torch.gather(d, 1, o), torch.gather(i, 1, o)
        run = i[:, 1:] == i[:, :-1]
        d = torch.cat([d[:, :1], torch.where(run, torch.inf, d[:, 1:])], 1)
    sel = torch.sort(d, dim=1, stable=True).indices[:, :topk]
    dists = torch.gather(d, 1, sel)
    ids = torch.gather(i, 1, sel)
    return dists, torch.where(torch.isfinite(dists), ids, -1)


def _queries_on(queries, devices) -> dict:
    """The f32 query batch on each distinct device (one copy each, pinned
    and asynchronous from the host)."""
    from rabitq_tpu_torch.store.vector_store import _to_device

    if not isinstance(queries, torch.Tensor):
        queries = torch.from_numpy(np.asarray(queries, dtype=np.float32))
    queries = queries.to(torch.float32)
    out = {}
    for dev in devices:
        if dev in out:
            continue
        if queries.device == dev:
            out[dev] = queries
        elif queries.device.type == "cpu":
            out[dev] = _to_device(queries.contiguous().numpy(), dev)
        else:
            out[dev] = queries.to(dev, non_blocking=True)
    return out


def sharded_search(
    sindex: ShardedIndex,
    queries,
    params: SearchParams,
    mesh: Mesh,
    *,
    exact: bool = False,
    row_filter: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Search a sharded index: (dists [B, topk], ids [B, topk]) on
    ``mesh.home``; ids -1 where the distance is +inf.

    Each local shard runs the single-device ``search`` on its device, on
    that device's current stream, with the per-shard budgets of
    _local_params (``exact``: every shard probes min(probe, k_max)
    clusters with the full rerank budget, so the probed set is a superset
    of the unsharded one). The [B, topk] lists move to the home device:
    a copy between cards is ordered after the source stream's work by
    events on both devices' current streams, with no host sync. Under a
    multi-process world they are all-gathered over the process group.
    The merge is _merge_topk. ``row_filter`` comes from
    make_sharded_row_filter over this index. A batch makes no host sync
    when ``queries`` lie on a mesh device (from the host, pinned copies).
    """
    from rabitq_tpu_torch.index.search import search

    _check_mesh(sindex, mesh)
    lp = _local_params(params, mesh.size, sindex.k_max, exact)
    local = sindex.local()
    q_on = _queries_on(queries, [mesh.devices[si] for si, _ in local])
    home = mesh.home
    ds, ids = [], []
    for si, shard in local:
        rf = None if row_filter is None else row_filter[si]
        d, i = search(shard, q_on[mesh.devices[si]], lp, rf)
        ds.append(d.to(home, non_blocking=True))
        ids.append(i.to(home, non_blocking=True))
    d_all, i_all = torch.stack(ds), torch.stack(ids)
    if mesh.world_size > 1:
        d_all, i_all = _all_gather(mesh, d_all), _all_gather(mesh, i_all)
    return _merge_topk(d_all, i_all, params.topk, sindex.dedup_ids)


def sharded_search_with_store(
    sindex: ShardedIndex,
    queries,
    params: SearchParams,
    mesh: Mesh,
    store,
    global_pos: np.ndarray,
    *,
    exact: bool = False,
    row_filter: list | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """The store tier over a sharded index: each shard's estimate on its
    device, one host store serving every shard's rerank. Returns numpy
    (dists f32 [B, topk], ids int32 [B, topk]).

    Every local shard runs ``estimate_candidates``; the candidates of all
    the shards on one device (positions, bounds, ids, scanned rows, and
    the memtable on shard 0's) reach the host in one copy a device. Each
    shard's positions map to global positions through ``global_pos``
    (shard_global_positions, load_global_positions) and its rows come
    from one ``store.get_rows``; the exact distances are f32 numpy, as
    in search_with_store and the JAX package. The memtable joins once,
    then the spill dedup and the top-k, as the JAX package's.
    ``exact`` has sharded_search's meaning. One process only."""
    from rabitq_tpu_torch.index.search import estimate_candidates
    from rabitq_tpu_torch.metrics import METRICS
    from rabitq_tpu_torch.store.vector_store import (
        _sq_dist_chunked,
        _to_host,
        merge_exact,
    )

    _check_mesh(sindex, mesh)
    if mesh.world_size > 1:
        raise NotImplementedError(
            "sharded_search_with_store runs in one process; under a "
            "multi-process world use sharded_search")
    lp = _local_params(params, mesh.size, sindex.k_max, exact)
    local = sindex.local()
    q_on = _queries_on(queries, [mesh.devices[si] for si, _ in local])
    on_mesh = isinstance(queries, torch.Tensor) and queries.device in q_on
    q_host = None if on_mesh else np.asarray(
        queries.detach().cpu().numpy() if isinstance(queries, torch.Tensor)
        else queries, dtype=np.float32)

    # Enqueue every shard's estimate, then one copy a device (the queries,
    # when they lie on a mesh device, ride in that device's copy).
    groups: dict = {}
    for si, shard in local:
        dev = mesh.devices[si]
        rf = None if row_filter is None else row_filter[si]
        cand = estimate_candidates(shard, q_on[dev], lp, rf)
        ts = [cand.pos, cand.lower_bound, shard.map_ids[cand.pos],
              cand.n_scanned.sum(dtype=torch.int64)]
        if si == 0 and shard.m:
            ts += [shard.extra_base, shard.extra_ids]
            if rf is not None and rf.extra_penalty is not None:
                ts.append(rf.extra_penalty)
        groups.setdefault(dev, []).append((si, ts))
    if on_mesh:
        groups[queries.device].append(("q", [q_on[queries.device]]))
    host = {}
    for items in groups.values():
        flat = _to_host(*[t for _, ts in items for t in ts])
        at = 0
        for si, ts in items:
            host[si] = flat[at : at + len(ts)]
            at += len(ts)
    if on_mesh:
        q_host = host.pop("q")[0]

    qpad = pad_last_dim(q_host, store.dim)
    if sindex.metric == "cosine":
        norms = np.linalg.norm(qpad, axis=-1, keepdims=True)
        qpad = qpad / np.maximum(norms, 1e-30)
    exact_all, ids_all = [], []
    n_scanned = 0
    for si, _ in local:
        pos, lb, cand_ids, scanned = host[si][:4]
        b, r = pos.shape
        gpos = global_pos[si][pos]  # [B, R] global positions (-1 pad)
        valid = np.isfinite(lb) & (gpos >= 0)
        rows = store.get_rows(np.maximum(gpos, 0).reshape(-1)).reshape(
            b, r, store.dim)
        exact_all.append(np.where(valid, _sq_dist_chunked(qpad, rows),
                                  np.inf))
        ids_all.append(cand_ids)
        METRICS.add_precise_count(int(valid.sum()))
        n_scanned += int(scanned)
    METRICS.add_rough_count(n_scanned)
    METRICS.add_query_count(b)
    return merge_exact(np.concatenate(exact_all, axis=1),
                       np.concatenate(ids_all, axis=1), qpad,
                       host.get(0, [])[4:], sindex.dedup_ids, params.topk)


def build_index_sharded(
    base,
    centroids,
    mesh: Mesh,
    *,
    generator: torch.Generator | None = None,
    orthogonal=None,
    chunk: int = 16384,
    keep_base: bool = True,
    metric: str = "l2",
    balance: float | None = 2.0,
    split: bool = True,
    bits: int = 1,
    spill: float = 0.0,
    spill_mode: str = "dist",
    spill_soar_lambda: float = 1.0,
    return_global_pos: bool = False,
):
    """Build a sharded index directly: equal bit for bit to
    ``shard_index(build_index(...), mesh)`` with the same arguments (the
    same generator seed or ``orthogonal``), without the unsharded index.

    1. assignment in whole build steps (chunk_rows) split over the
       distinct local devices: each row's candidate clusters, ranking
       distances and the exact squared residual norm of each candidate
       (the within-cluster sort key, needed before quantization since the
       split segments, and so a row's shard, depend on it);
    2. on the host, the bookkeeping of build_index (balance, spill
       admission, the cluster sort, the split) through its helpers, and
       the shard plan of shard_index;
    3. each local shard uploads its rows, cluster-sorted, to its device
       and quantizes them there in build steps of the same shape as
       build_index's, so every row's codes and factors are the same bits.

    ``return_global_pos`` also returns shard_global_positions' table.
    Under a multi-process world every process runs steps 1-2 over the
    whole corpus and step 3 for its own shards only.
    """
    import time

    from rabitq_tpu_torch.index.build import (
        _assign_top,
        _quantize_rows,
        chunk_rows,
        plan_assignment,
        plan_layout,
    )
    from rabitq_tpu_torch.ops import gen_random_orthogonal, rotate
    from rabitq_tpu_torch.utils import normalize_rows

    if metric not in ("l2", "cosine"):
        raise ValueError(f"unknown metric {metric!r}")
    if not 1 <= bits <= 7:
        raise ValueError(f"bits must be in 1..7, got {bits}")
    t0 = time.perf_counter()
    base = np.asarray(base, dtype=np.float32)
    if isinstance(centroids, torch.Tensor):
        centroids = centroids.detach().cpu().numpy()
    centroids = np.asarray(centroids, dtype=np.float32)
    if metric == "cosine":
        base = normalize_rows(base)
        centroids = normalize_rows(centroids)
    n, d_orig = base.shape
    k = centroids.shape[0]
    if centroids.shape[1] != d_orig:
        raise ValueError(f"centroids dim {centroids.shape[1]} != {d_orig}")
    dim = round_up(d_orig, LANES)
    s = mesh.size
    local = mesh.local_shards
    if generator is None:
        generator = torch.Generator(device=mesh.home).manual_seed(0)
    gdev = generator.device
    if orthogonal is None:
        p = gen_random_orthogonal(dim, generator, gdev)
    else:
        p = torch.as_tensor(orthogonal, dtype=torch.float32, device=gdev)
        if tuple(p.shape) != (dim, dim):
            raise ValueError(f"orthogonal must be [{dim}, {dim}]")
    rand_bias = torch.rand(dim, generator=generator, device=gdev,
                           dtype=torch.float32)
    c_rot = rotate(
        torch.as_tensor(pad_last_dim(centroids, dim), device=gdev), p)
    chunk = chunk_rows(n, chunk)
    devs = list(dict.fromkeys(mesh.devices[si] for si in local))
    p_on = {dev: p.to(dev) for dev in devs}
    c_on = {dev: c_rot.to(dev) for dev in devs}

    # 1. Assignment in whole steps, a slice of steps per local device.
    top = 4 if (balance or spill > 0) else 1
    per = round_up(-(-n // len(devs)), chunk)
    parts = []
    for j, dev in enumerate(devs):
        lo, hi = j * per, min(n, (j + 1) * per)
        if lo >= hi:
            break
        x = torch.from_numpy(pad_last_dim(base[lo:hi], dim)).to(dev)
        parts.append(_assign_top(x, p_on[dev], c_on[dev], top, chunk,
                                 exact_cdsq=True))
    cand_labels, cand_dists, cd_exact = (
        np.concatenate(a) for a in zip(*parts))
    t1 = time.perf_counter()

    # 2. Host bookkeeping: build_index's plan (its sort key the exact
    # residual norms, sorted on the host), then shard_index's.
    labels, pick, spill_tgt, cap_unspilled = plan_assignment(
        cand_labels, cand_dists, base, centroids, k=k, balance=balance,
        split=split, spill=spill, spill_mode=spill_mode,
        spill_soar_lambda=spill_soar_lambda,
    )
    key = cd_exact[np.arange(n), np.argmax(cand_labels == labels[:, None], 1)]
    if pick.size:
        col = np.argmax(cand_labels[pick] == spill_tgt[:, None], axis=1)
        key = np.concatenate([key, cd_exact[pick, col]])
    labels_ext, orig_of, order, offsets, capacity, seg_src = plan_layout(
        labels, pick, spill_tgt, torch.from_numpy(key), k=k,
        balance=balance, split=split, cap_unspilled=cap_unspilled,
    )
    order = order.numpy()
    sizes_seg = np.diff(offsets).astype(np.int64)
    groups, k_max, rows_max = _shard_layout(sizes_seg, s)
    cent_seg = c_rot.cpu()
    if seg_src is not None:
        cent_seg = cent_seg[torch.from_numpy(seg_src).long()]
    t2 = time.perf_counter()

    # 3. Each local shard's rows quantized on its device.
    shards: list = [None] * s
    gpos = np.full((s, rows_max), -1, np.int32) if return_global_pos else None
    for si, group in enumerate(groups):
        segs = [np.arange(offsets[c], offsets[c + 1]) for c in group]
        if gpos is not None:
            g = np.concatenate(segs or [np.zeros(0, np.int64)])
            gpos[si, : g.shape[0]] = g
        if mesh.owner(si) != mesh.rank:
            continue
        loc = order[np.concatenate(segs or [np.zeros(0, np.int64)])]
        dev = mesh.devices[si]
        x = torch.from_numpy(pad_last_dim(base[orig_of[loc]], dim)).to(dev)
        lab = torch.from_numpy(labels_ext[loc].astype(np.int64)).to(dev)
        if loc.size:
            _, codes, factors = _quantize_rows(x, lab, p_on[dev], c_on[dev],
                                               bits, chunk)
        else:  # a shard with no rows: pad_empty_shard fills it below
            codes = torch.zeros((0, dim), dtype=torch.int8, device=dev)
            factors = torch.zeros((0, 4), dtype=torch.float32, device=dev)
        cent = torch.full((k_max, dim), _FAR, dtype=torch.float32)
        cent[: len(group)] = cent_seg[torch.as_tensor(group).long()]
        shards[si] = pad_empty_shard(RaBitQIndex(
            codes=codes,
            factors=factors,
            offsets=torch.from_numpy(
                _local_offsets(sizes_seg[group], k_max)).to(dev),
            map_ids=torch.from_numpy(orig_of[loc].astype(np.int32)).to(dev),
            centroids_rot=cent.to(dev),
            orthogonal=p_on[dev],
            rand_bias=rand_bias.to(dev),
            base=x if keep_base else None,
            dim=dim,
            dim_orig=d_orig,
            capacity=capacity,
            metric=metric,
            code_bits=bits,
            dedup_ids=bool(pick.size),
        ), rows_max)
    tiles_max = max(
        _tiles(_local_offsets(sizes_seg[g], k_max), capacity) for g in groups)
    logger.info(
        "sharded build: assign %.2fs, plan %.2fs, quantize %.2fs (n %d, "
        "spilled %d, %d shards, k_max %d, rows_max %d, capacity %d)",
        t1 - t0, t2 - t1, time.perf_counter() - t2, n, int(pick.size), s,
        k_max, rows_max, capacity)
    out = ShardedIndex(shards, k_max, rows_max, tiles_max, mesh)
    return (out, gpos) if return_global_pos else out


def _f32(a, device) -> torch.Tensor:
    """An f32 tensor on ``device``: a tensor moved, an array copied."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _row_parts(x, mesh: Mesh) -> tuple[list, int]:
    """This process's [per, d] row parts of x (S equal parts, the last
    zero-padded) on their shards' devices, and the row count."""
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.asarray(x, dtype=np.float32))
    x = x.to(torch.float32)
    n = x.shape[0]
    per = -(-n // mesh.size)
    parts = []
    for si in mesh.local_shards:
        part = x[si * per : (si + 1) * per]
        if part.shape[0] < per:
            part = torch.cat([part, part.new_zeros(
                (per - part.shape[0],) + tuple(x.shape[1:]))])
        parts.append(part.to(mesh.devices[si]))
    return parts, n


def _sum_over_shards(mesh: Mesh, parts: list) -> torch.Tensor:
    """Sum of this process's per-shard tensors on the home device (an
    all_reduce over the world when it has more than one process)."""
    import torch.distributed as dist

    total = sum(t.to(mesh.home) for t in parts)
    if mesh.world_size > 1:
        gloo = dist.get_backend() == "gloo"
        buf = total.cpu() if gloo and total.is_cuda else total
        dist.all_reduce(buf)
        total = buf.to(mesh.home)
    return total


def dp_build_chunk(x, orthogonal, centroids_rot, mesh: Mesh, bits: int = 1):
    """Data-parallel quantization pass: the rows of x split over the mesh
    devices, each part assigned to its nearest centroid and quantized on
    its device (no communication but the final gather). Returns (labels
    [n] int64, cdsq [n], codes [n, D] int8 grid values, factors [n, 4]) on
    the home device; under a multi-process world, every row's."""
    from rabitq_tpu_torch.index.build import _build_chunk
    from rabitq_tpu_torch.ops import pairwise_l2sq, rotate

    parts, n = _row_parts(x, mesh)
    outs = []
    for si, part in zip(mesh.local_shards, parts):
        dev = mesh.devices[si]
        p, c = _f32(orthogonal, dev), _f32(centroids_rot, dev)
        lab = torch.argmin(pairwise_l2sq(rotate(part, p), c), dim=-1)
        cdsq, codes, factors = _build_chunk(part, lab, p, c, bits)
        outs.append([t.to(mesh.home) for t in (lab, cdsq, codes, factors)])
    res = [torch.cat(ts) for ts in zip(*outs)]
    if mesh.world_size > 1:
        res = [_all_gather(mesh, t) for t in res]
    return tuple(t[:n] for t in res)


def sharded_lloyd_step(x, centroids, mesh: Mesh):
    """One data-parallel Lloyd iteration: each device's part of the rows
    gives its per-cluster sums, counts and cost, summed on the home device
    (all_reduce over a multi-process world); the centroids are replicated.
    Returns (new centroids [k, d], cost under the old ones, a 0-d tensor)
    on the home device. Empty clusters keep their centroid."""
    from rabitq_tpu_torch.ops import pairwise_l2sq

    parts, n = _row_parts(x, mesh)
    c0 = _f32(centroids, "cpu")
    k, d = c0.shape
    per = parts[0].shape[0] if parts else 0
    stats = []
    for si, part in zip(mesh.local_shards, parts):
        dev = mesh.devices[si]
        c = c0.to(dev)
        rows = part[: max(0, min(per, n - si * per))]  # not the padding
        sums = torch.zeros((k, d), dtype=torch.float32, device=dev)
        counts = torch.zeros(k, dtype=torch.float32, device=dev)
        cost = torch.zeros(1, dtype=torch.float32, device=dev)
        if rows.shape[0]:
            mind, lab = pairwise_l2sq(rows, c).min(dim=-1)
            sums.index_add_(0, lab, rows)
            counts = torch.bincount(lab, minlength=k).to(torch.float32)
            cost = mind.sum().reshape(1)
        stats.append(torch.cat([sums.reshape(-1), counts, cost]))
    total = _sum_over_shards(mesh, stats)
    sums = total[: k * d].reshape(k, d)
    counts = total[k * d : k * d + k]
    cost = total[-1]
    c = c0.to(mesh.home)
    new_c = torch.where(counts[:, None] > 0,
                        sums / torch.clamp(counts, min=1.0)[:, None], c)
    return new_c, cost
