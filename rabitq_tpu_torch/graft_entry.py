"""Entry points for a harness (the port's twin of __graft_entry__.py).

- entry(): a single-device forward step (batched RaBitQ search on a small
  IVF index) and its example arguments, on the card unless ``device``
  says otherwise.
- dryrun_multichip(n_devices, devices=None): the multi-device training and
  serving steps on an n-shard mesh: a data-parallel Lloyd step and
  quantization pass, index-sharded search with the top-k merge (exact
  mode at full probe against the unsharded index, and at a partial probe
  no worse than it), the sharded store tier, the direct-to-shard build,
  a checkpoint round trip, and the filtered mesh engine. ``devices`` is
  the explicit placement (S shards on one card: ``["cuda:0"] * S``);
  without it, one shard per card.
"""

from __future__ import annotations

import dataclasses
import shutil
import tempfile

import numpy as np
import torch


def _tiny_corpus(n=4096, dim=128, k=32, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((k, dim)).astype(np.float32)
    base = (
        centers[rng.integers(0, k, n)]
        + 0.2 * rng.standard_normal((n, dim)).astype(np.float32)
    ).astype(np.float32)
    return base, centers


def entry(device=None):
    from rabitq_tpu_torch import SearchParams, build_index, search
    from rabitq_tpu_torch.utils import resolve_device

    device = resolve_device(device)
    base, centers = _tiny_corpus()
    index = build_index(
        base, centers, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    params = SearchParams(probe=8, topk=10, rerank=64)

    def fn(queries):
        return search(index, queries, params)

    return fn, (torch.from_numpy(base[:16]).to(device),)


def _overlap(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.mean([len(set(a[i]) & set(b[i])) / a.shape[1]
                          for i in range(a.shape[0])]))


# The dry run's corpus: rows at least (more when 64 a shard needs more).
N_ROWS = 65_536


class _ArrayStore:
    """A host store over a numpy matrix (rows by global position)."""

    def __init__(self, mat):
        self._m = np.asarray(mat)
        self.dim = int(self._m.shape[1])

    def get_rows(self, pos):
        return self._m[pos]


def dryrun_multichip(n_devices: int, devices=None) -> str:
    """Run steps 1-7 on an ``n_devices``-shard mesh over a corpus of at
    least N_ROWS rows; raises on a failed check, returns the summary line
    it prints."""
    from rabitq_tpu_torch import SearchParams, build_index, search
    from rabitq_tpu_torch.ops import gen_random_orthogonal, rotate
    from rabitq_tpu_torch.parallel import (
        build_index_sharded,
        dp_build_chunk,
        dump_index_sharded,
        init_distributed,
        load_index_sharded,
        make_mesh,
        shard_global_positions,
        shard_index,
        sharded_lloyd_step,
        sharded_search,
        sharded_search_with_store,
    )
    from rabitq_tpu_torch.service.server import BatchingEngine

    # The multi-process call sequence, degenerately: init (a no-op in one
    # process without a coordinator), then the mesh.
    distributed = init_distributed()
    mesh = make_mesh(n_devices, devices=devices)
    home = mesh.home

    # 64k+ rows over k=256 clusters of Zipf-distributed populations, so
    # the padded layouts, the LPT balance and exact mode's guarantees are
    # exercised, not just the merge.
    n = max(N_ROWS, 64 * n_devices)
    dim, k = 128, 256
    rng = np.random.default_rng(1)
    centers = rng.standard_normal((k, dim)).astype(np.float32) * 4.0
    w = 1.0 / np.arange(1, k + 1, dtype=np.float64) ** 1.1
    lab = rng.choice(k, size=n, p=w / w.sum())
    base = (centers[lab] + 0.3 * rng.standard_normal((n, dim))).astype(
        np.float32)

    # 1. Training: one data-parallel Lloyd step.
    _, cost = sharded_lloyd_step(base, centers, mesh)
    if not torch.isfinite(cost):
        raise AssertionError(f"lloyd cost {cost}")

    # 2. Build: the data-parallel quantization pass.
    p = gen_random_orthogonal(dim, torch.Generator(device=home).manual_seed(0),
                              home)
    c_rot = rotate(torch.from_numpy(centers).to(home), p)
    _, cd, _, _ = dp_build_chunk(base, p, c_rot, mesh)
    if not torch.isfinite(cd).all():
        raise AssertionError("dp_build_chunk: non-finite cdsq")

    # 3. Serving: the index sharded over the mesh; bits=4 so that the
    # multi-bit estimator rides the sharded path too.
    def gen():
        return torch.Generator(device=home).manual_seed(2)

    index = build_index(base, centers, generator=gen(), bits=4, device=home)
    sizes = np.diff(index.offsets.cpu().numpy())
    if index.k <= k or sizes.max() < 2 * max(1, int(sizes.mean())):
        raise AssertionError(f"the skew did not split clusters (k "
                             f"{index.k}, sizes max {sizes.max()})")
    sidx = shard_index(index, mesh)
    nq = 16
    queries = torch.from_numpy(base[:nq]).to(home)

    # 3a. Exact mode at full probe and a rerank covering every row: both
    # sides reduce to brute force, equal up to f32 distance ties. The lane
    # fold is off: at a rerank this close to the probed rows it would keep
    # only 2 of each 4-row bucket of the unsharded index's clusters (the
    # shards' narrower budgets leave it off there).
    pfull = SearchParams(probe=index.k, topk=10, rerank=n,
                         select_reduce=False)
    d_s, i_s = sharded_search(sidx, queries, pfull, mesh, exact=True)
    d_1, i_1 = search(index, queries, pfull)
    torch.testing.assert_close(d_s, d_1, rtol=1e-5, atol=1e-5)
    parity = _overlap(i_s.cpu(), i_1.cpu())
    if parity < 0.98:
        raise AssertionError(f"exact-mode parity {parity}")

    # 3b. A partial probe under skew: exact mode at least as good as the
    # unsharded index at the same params (it probes a superset).
    ppart = SearchParams(probe=16, topk=10, rerank=256)
    _, i_sp = sharded_search(sidx, queries, ppart, mesh, exact=True)
    _, i_1p = search(index, queries, ppart)
    rec_s, rec_1 = _overlap(i_sp.cpu(), i_1.cpu()), _overlap(i_1p.cpu(),
                                                             i_1.cpu())
    if rec_s < rec_1 - 1e-9:
        raise AssertionError(f"partial probe: sharded {rec_s} < {rec_1}")

    # 4. The sharded store tier: no base on any device, one host store.
    store = _ArrayStore(index.base.cpu().numpy())
    baseless = dataclasses.replace(index, base=None)
    sidx_d = shard_index(baseless, mesh)
    gpos = shard_global_positions(baseless, mesh.size)
    d_st, i_st = sharded_search_with_store(
        sidx_d, queries, pfull, mesh, store, gpos, exact=True)
    np.testing.assert_allclose(d_st, d_1.cpu().numpy(), rtol=1e-5,
                               atol=1e-5)
    parity_st = _overlap(i_st, i_1.cpu())
    if parity_st < 0.98:
        raise AssertionError(f"store-tier parity {parity_st}")

    # 5. The direct-to-shard build equals shard_index(build_index(...)).
    direct = build_index_sharded(base, centers, mesh, generator=gen(),
                                 bits=4)
    for si, sh in direct.local():
        ref = sidx.shards[si]
        for f in ("codes", "factors", "offsets", "map_ids", "centroids_rot",
                  "base"):
            if not torch.equal(getattr(sh, f), getattr(ref, f)):
                raise AssertionError(f"direct build: shard {si} {f} differs")
    d_dd, i_dd = sharded_search(direct, queries, ppart, mesh)
    d_ss, i_ss = sharded_search(sidx, queries, ppart, mesh)
    if not (torch.equal(i_dd, i_ss) and torch.equal(d_dd, d_ss)):
        raise AssertionError("direct build: search differs")

    # 6. Checkpoint round trip, then 7. the filtered mesh engine on the
    # loaded index.
    ckpt = tempfile.mkdtemp(prefix="rabitq_ckpt_")
    try:
        dump_index_sharded(sidx, ckpt)
        loaded = load_index_sharded(ckpt, mesh)
        d_ck, i_ck = sharded_search(loaded, queries, ppart, mesh)
        if not (torch.equal(i_ck, i_ss) and torch.equal(d_ck, d_ss)):
            raise AssertionError("checkpoint round trip: search differs")
        eng = BatchingEngine(loaded, mesh=mesh, sharded_exact=True,
                             max_batch=8)
        try:
            allow = np.arange(0, n, 2)
            eng.register_filter("even", allow_ids=allow)
            _, ids = eng.submit(base[2], 10, 16, filter_name="even")
            if ids[0] != 2 or not set(ids[ids >= 0].tolist()) <= set(
                    allow.tolist()):
                raise AssertionError(f"filtered engine: {ids}")
            _, ids = eng.submit(base[3], 10, 16)
            if ids[0] != 3:
                raise AssertionError(f"engine: {ids}")
        finally:
            eng.close()
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)

    line = (
        f"dryrun_multichip({n_devices}): ok on {[str(d) for d in mesh.devices]}"
        f" — corpus {n}x{dim}, k={k} (split to {index.k}), cluster sizes "
        f"[{int(sizes.min())}, {int(sizes.max())}] (mean {sizes.mean():.0f}, "
        f"Zipf), exact-mode parity {parity:.4f}, store-tier parity "
        f"{parity_st:.4f}, skew recall sharded {rec_s:.4f} >= single "
        f"{rec_1:.4f}, lloyd cost {float(cost):.3f}, direct-to-shard build "
        f"exact, checkpoint round trip exact, filtered mesh engine ok, "
        f"distributed init "
        f"{'multi-process' if distributed else 'one process (no-op)'}")
    print(line)
    return line
