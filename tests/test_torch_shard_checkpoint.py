"""The port's sharded checkpoints (rabitq_tpu_torch.parallel.checkpoint)
against the JAX package's, on the CPU: byte-identical both ways.

JAX -> port -> JAX: a JAX sharded index dumped with dump_index_sharded,
loaded by the port onto 8 CPU shards and dumped again: every file equal
to the byte. Port -> JAX -> port: the same from the port's side through
JAX's load and dump. With and without base, memtable and tombstones, and
global positions. Then load_shard_as_single, load_global_positions, and a
shard count that differs from the mesh's.
"""

import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu.parallel as jp
import rabitq_tpu_torch as rt
import rabitq_tpu_torch.parallel as tp
from conftest import make_clustered_dataset
from rabitq_tpu.index import serialize as jser
from rabitq_tpu_torch.index import serialize as tser

S = 8

_CASES = ["plain", "baseless_gpos", "memtable", "spilled_4bit"]


@pytest.fixture(scope="module")
def jmesh():
    return jp.make_mesh(S)


@pytest.fixture(scope="module")
def tmesh():
    return tp.make_mesh(devices=["cpu"] * S)


def _jax_index(case, tmp_path):
    """A JAX index of the case, and whether its checkpoint carries the
    global positions."""
    rng = np.random.default_rng(30)
    base, centers = make_clustered_dataset(rng, n=1600, dim=48, k=16)
    kw = dict(bits=4, spill=0.2) if case == "spilled_4bit" else {}
    idx = rq.build_index(base, centers, key=jax.random.key(31), **kw)
    if case == "memtable":
        idx = rq.insert(idx, rng.standard_normal((3, 48)).astype(np.float32),
                        ids=[9001, 9002, 9003])
        idx = rq.delete(idx, [0, 9002])
    if case == "baseless_gpos":
        idx = dataclasses.replace(idx, base=None, base_bf16=None)
    return idx, base


def _files(path: Path) -> dict[str, bytes]:
    return {str(f.relative_to(path)): f.read_bytes()
            for f in sorted(path.rglob("*")) if f.is_file()}


def assert_same_bytes(a: Path, b: Path):
    fa, fb = _files(a), _files(b)
    assert sorted(fa) == sorted(fb)
    for name in fa:
        assert fa[name] == fb[name], name


@pytest.mark.parametrize("case", _CASES)
def test_jax_to_port_to_jax_byte_identical(case, jmesh, tmesh, tmp_path):
    jidx, _ = _jax_index(case, tmp_path)
    gpos = jp.shard_global_positions(jidx, S) if case == "baseless_gpos" \
        else None
    jp.dump_index_sharded(jp.shard_index(jidx, jmesh), tmp_path / "jax",
                          global_pos=gpos)
    loaded = tp.load_index_sharded(tmp_path / "jax", tmesh)
    assert loaded.has_base == (case != "baseless_gpos")
    tp.dump_index_sharded(loaded, tmp_path / "port",
                          global_pos=tp.load_global_positions(
                              tmp_path / "jax"))
    assert_same_bytes(tmp_path / "jax", tmp_path / "port")


@pytest.mark.parametrize("case", _CASES)
def test_port_to_jax_to_port_byte_identical(case, jmesh, tmesh, tmp_path):
    jidx, base = _jax_index(case, tmp_path)
    jser.dump_to_dir(jidx, tmp_path / "single", require_base=False)
    tidx = tser.load_from_dir(tmp_path / "single", device="cpu",
                              keep_base=jidx.base is not None)
    gpos = tp.shard_global_positions(tidx, S) if case == "baseless_gpos" \
        else None
    sidx = tp.shard_index(tidx, tmesh)
    tp.dump_index_sharded(sidx, tmp_path / "port", global_pos=gpos)
    meta = json.loads((tmp_path / "port" / "meta.json").read_text())
    assert meta["shards"] == S and meta["tiles_max"] == sidx.tiles_max
    loaded = jp.load_index_sharded(tmp_path / "port", jmesh)
    jp.dump_index_sharded(loaded, tmp_path / "jax",
                          global_pos=jp.load_global_positions(
                              tmp_path / "port"))
    assert_same_bytes(tmp_path / "port", tmp_path / "jax")
    # The port's round trip: equal shards and equal search.
    back = tp.load_index_sharded(tmp_path / "jax", tmesh)
    for (si, a), (_, b) in zip(sidx.local(), back.local()):
        for f in ("codes", "factors", "offsets", "map_ids", "centroids_rot",
                  "orthogonal", "rand_bias", "base", "extra_base",
                  "extra_ids"):
            u, v = getattr(a, f), getattr(b, f)
            assert (u is None) == (v is None), (si, f)
            if u is not None:
                assert torch.equal(u, v), (si, f)
    if case != "baseless_gpos":
        q = torch.from_numpy(base[:8])
        p = rt.SearchParams(probe=8, topk=5, rerank=64)
        x, y = (tp.sharded_search(i, q, p, tmesh) for i in (sidx, back))
        assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1])


def test_load_shard_as_single_and_global_positions(tmesh, tmp_path):
    rng = np.random.default_rng(34)
    base, centers = make_clustered_dataset(rng, n=1500, dim=32, k=16)
    idx = rt.build_index(base, centers, device="cpu")
    gpos = tp.shard_global_positions(idx, S)
    tp.dump_index_sharded(tp.shard_index(idx, tmesh), tmp_path / "ckpt",
                          global_pos=gpos)
    np.testing.assert_array_equal(
        tp.load_global_positions(tmp_path / "ckpt"), gpos)
    one = tp.load_shard_as_single(tmp_path / "ckpt", 3, device="cpu")
    shard_ids = set(one.map_ids.tolist())
    assert 0 < len(shard_ids) < 1500
    _, ids = rt.search(one, torch.from_numpy(base[:4]),
                       rt.SearchParams(probe=4, topk=3, rerank=32))
    assert set(ids.ravel().tolist()) - {-1} <= shard_ids
    # Without global positions, load_global_positions gives None.
    tp.dump_index_sharded(tp.shard_index(idx, tmesh), tmp_path / "bare")
    assert tp.load_global_positions(tmp_path / "bare") is None


def test_load_rejects_another_shard_count(tmesh, tmp_path):
    rng = np.random.default_rng(37)
    base, centers = make_clustered_dataset(rng, n=400, dim=32, k=8)
    idx = rt.build_index(base, centers, device="cpu")
    tp.dump_index_sharded(tp.shard_index(idx, tmesh), tmp_path / "ckpt")
    with pytest.raises(ValueError, match="8 shards"):
        tp.load_index_sharded(tmp_path / "ckpt",
                              tp.make_mesh(devices=["cpu"] * 4))
