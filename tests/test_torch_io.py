"""The port's vecs readers and writers against the JAX package's.

Every writer gives files byte-identical to the JAX package's writer on the
same arrays, and every reader gives back the arrays. The JAX side's
``read_matrix`` is left out: it may build and load the native parser,
which the port never reaches; its numpy readers stand in for it.
"""

import numpy as np
import pytest

from rabitq_tpu import io as jio
from rabitq_tpu.io import vecs as jvecs
from rabitq_tpu_torch import io as tio

_MATRICES = {
    "fvecs": lambda rng: rng.standard_normal((37, 24)).astype(np.float32),
    "ivecs": lambda rng: rng.integers(-2**31, 2**31, (5, 7), dtype=np.int32),
    "uint32": lambda rng: rng.integers(0, 2**32, (9, 3), dtype=np.uint32),
    "one_row": lambda rng: rng.standard_normal((1, 960)).astype(np.float32),
    "empty": lambda rng: np.zeros((0, 4), np.float32),
}


@pytest.mark.parametrize("kind", sorted(_MATRICES))
def test_write_matrix_bytes_and_read_back(tmp_path, rng, kind):
    mat = _MATRICES[kind](rng)
    tio.write_matrix(tmp_path / "t.vecs", mat)
    jio.write_matrix(tmp_path / "j.vecs", mat)
    raw = (tmp_path / "t.vecs").read_bytes()
    assert raw == (tmp_path / "j.vecs").read_bytes()
    got = tio.read_matrix(tmp_path / "t.vecs", mat.dtype)
    if mat.shape[0]:
        np.testing.assert_array_equal(got, mat)
        np.testing.assert_array_equal(got, np.stack(
            jio.read_vecs(tmp_path / "j.vecs", mat.dtype)))
    else:
        assert got.size == 0
    if mat.dtype == np.float32 and mat.shape[0]:
        mm = tio.mmap_fvecs_matrix(tmp_path / "t.vecs")
        np.testing.assert_array_equal(mm, mat)
        np.testing.assert_array_equal(
            mm, jvecs.mmap_fvecs_matrix(tmp_path / "j.vecs"))


def test_ragged_vecs(tmp_path, rng):
    recs = [rng.standard_normal(n).astype(np.float32) for n in (3, 0, 5, 1)]
    tio.write_vecs(tmp_path / "t.fvecs", recs)
    jio.write_vecs(tmp_path / "j.fvecs", recs)
    assert (tmp_path / "t.fvecs").read_bytes() == (
        tmp_path / "j.fvecs").read_bytes()
    got = tio.read_vecs(tmp_path / "t.fvecs")
    assert [g.tolist() for g in got] == [r.tolist() for r in recs]
    ints = [np.arange(4, dtype=np.int32), np.arange(2, dtype=np.int32)]
    tio.write_vecs(tmp_path / "t.ivecs", ints)
    got = tio.read_vecs(tmp_path / "t.ivecs", np.int32)
    assert [g.dtype for g in got] == [np.int32] * 2
    assert [g.tolist() for g in got] == [[0, 1, 2, 3], [0, 1]]
    with pytest.raises(ValueError):
        tio.read_vecs(tmp_path / "t.ivecs", np.int64)


def test_u64_vecs(tmp_path, rng):
    recs = [rng.integers(0, 2**64, 6, dtype=np.uint64),
            np.array([2**64 - 1, 0], np.uint64)]
    tio.write_u64_vecs(tmp_path / "t.u64vecs", recs)
    jio.write_u64_vecs(tmp_path / "j.u64vecs", recs)
    assert (tmp_path / "t.u64vecs").read_bytes() == (
        tmp_path / "j.u64vecs").read_bytes()
    for reader in (tio.read_u64_vecs, jio.read_u64_vecs):
        got = reader(tmp_path / "t.u64vecs")
        assert [g.tolist() for g in got] == [r.tolist() for r in recs]


def test_bvecs(tmp_path, rng):
    mat = rng.integers(0, 256, (11, 128)).astype(np.uint8)
    tio.write_bvecs_matrix(tmp_path / "t.bvecs", mat)
    jio.write_bvecs_matrix(tmp_path / "j.bvecs", mat)
    assert (tmp_path / "t.bvecs").read_bytes() == (
        tmp_path / "j.bvecs").read_bytes()
    got = tio.read_bvecs_matrix(tmp_path / "t.bvecs")
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, mat)
    np.testing.assert_array_equal(
        got, jio.read_bvecs_matrix(tmp_path / "j.bvecs"))


def test_corrupt_files_raise(tmp_path):
    (tmp_path / "bad.fvecs").write_bytes(np.array([5, 1, 2], np.uint32).tobytes())
    with pytest.raises(ValueError, match="corrupt"):
        tio.read_vecs(tmp_path / "bad.fvecs")
    (tmp_path / "bad.bvecs").write_bytes(bytes([3, 0, 0, 0, 1, 2]))
    with pytest.raises(ValueError, match="bvecs"):
        tio.read_bvecs_matrix(tmp_path / "bad.bvecs")
