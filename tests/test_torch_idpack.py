"""The port's bit-plane id packing (rabitq_tpu_torch.ops.idpack) and
``search_many_packed`` against the JAX package's, case for case with
tests/test_idpack.py: packed words bit-equal to JAX's (random ids, -1
slots and the full range), the round trip exact, and the packed search's
ids those of ``search_many`` on one JAX-built index, on the CPU.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabitq_tpu as rq
import rabitq_tpu_torch as rt
from rabitq_tpu.ops import idpack as jidpack
from rabitq_tpu_torch.ops.idpack import nbits_for, pack_ids, unpack_ids
from torch_parity import port_index_from_jax

jsearch = importlib.import_module("rabitq_tpu.index.search")
tsearch = importlib.import_module("rabitq_tpu_torch.index.search")


@pytest.mark.parametrize("n", [1, 2, 1000, 1_000_000, (1 << 20) - 1,
                               1 << 20])
def test_nbits_equal_jax_and_leave_the_sentinel_free(n):
    nb = nbits_for(n)
    assert nb == jidpack.nbits_for(n)
    assert (1 << nb) - 1 > n - 1


@pytest.mark.parametrize("n_ids", [1, 31, 32, 33, 2048 * 10, 12345])
def test_pack_bit_equal_to_jax_random_ids(n_ids):
    rng = np.random.default_rng(n_ids)
    nb = nbits_for(1_000_000)
    ids = rng.integers(0, 1_000_000, size=n_ids).astype(np.int32)
    ids[rng.random(n_ids) < 0.1] = -1
    got = pack_ids(torch.from_numpy(ids), nb)
    want = np.asarray(jidpack.pack_ids(jnp.asarray(ids), nb))
    assert got.dtype == torch.uint32 and want.dtype == np.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    assert tuple(got.shape) == (-(-n_ids // 32), nb)
    np.testing.assert_array_equal(unpack_ids(got, nb, n_ids), ids)
    np.testing.assert_array_equal(
        unpack_ids(got.numpy(), nb, n_ids),
        jidpack.unpack_ids(want, nb, n_ids))


@pytest.mark.parametrize("nb", [1, 20, 31])
def test_pack_bit_equal_to_jax_full_range(nb):
    """The largest valid id, -1 and 0 at every bit width; a 2-D input
    flattens row-major as in JAX."""
    top = (1 << nb) - 2
    ids = np.array([[0, top, -1], [top // 2 if nb > 1 else 0, -1, 0]],
                   dtype=np.int32)
    got = pack_ids(torch.from_numpy(ids), nb).numpy()
    want = np.asarray(jidpack.pack_ids(jnp.asarray(ids), nb))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(unpack_ids(got, nb, 6), ids.reshape(-1))
    # -1 packs as all ones in each plane of its lane.
    lane = 2
    assert all((int(w) >> lane) & 1 for w in got[0])


def test_search_many_packed_matches_search_many_and_jax():
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((16, 32)).astype(np.float32)
    base = (centers[rng.integers(0, 16, 2000)]
            + 0.1 * rng.standard_normal((2000, 32))).astype(np.float32)
    jidx = rq.build_index(base, centers, key=jax.random.key(0))
    tidx = port_index_from_jax(jidx)
    q = base[:64].reshape(2, 32, 32)
    nb = nbits_for(2000)
    tparams = rt.SearchParams(probe=4, topk=10, rerank=32,
                              select_reduce=False)
    _, ids = rt.search_many(tidx, torch.from_numpy(q), tparams)
    words = tsearch.search_many_packed(tidx, torch.from_numpy(q), tparams,
                                       nb)
    assert words.dtype == torch.uint32 and words.shape == (20, nb)
    out = unpack_ids(words, nb, 2 * 32 * 10)
    np.testing.assert_array_equal(out, ids.numpy().reshape(-1))
    jparams = rq.SearchParams(probe=4, topk=10, rerank=32,
                              approx_select=False)
    jwords = np.asarray(jsearch.search_many_packed(
        jidx, jnp.asarray(q), jparams, nb))
    jids = jidpack.unpack_ids(jwords, nb, 2 * 32 * 10)
    assert (out == jids).mean() >= 0.99
    # The packed ids take nb / 32 of the int32 ids' bytes (-1 slots too).
    assert words.numel() * 4 == ids.numel() * 4 * nb // 32
