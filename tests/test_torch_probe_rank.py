"""The probe ranking: the plain version against the code it replaced (the
distance epilogue, then a stable sort of every column) on the CPU, and
the CUDA kernel (csrc/probe_rank.cu) against the plain version on the
card, bit for bit.

The card tests are marked ``cuda`` and skip without a CUDA device. This
file imports neither JAX nor tests/conftest.py, so on a machine with a
card and no JAX it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_probe_rank.py

Both versions return the ids of the ``probe`` lowest keys of each row by
(key, id), best first: NaN after +inf, and among equal keys the lower id
first (a split cluster's segments repeat its centroid and tie exactly).
"""

import importlib
import re
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import rabitq_tpu_torch as rt
from benchmark import data
from rabitq_tpu_torch.kmeans import kmeans
from rabitq_tpu_torch.ops import cuda_probe_rank, probe_rank_reference, rotate
from rabitq_tpu_torch.ops.distances import (
    L2Terms,
    bf16_pass_matmul,
    l2sq_epilogue,
    pairwise_l2sq,
    pairwise_terms,
)

tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
ROOT = Path(__file__).resolve().parents[1]


def old_pairwise_l2sq(x, c, precision):
    """pairwise_l2sq as one function, before its split into terms."""
    xx = torch.sum(x * x, dim=-1, keepdim=True)
    cc = torch.sum(c * c, dim=-1)
    xc = torch.matmul(x, c.T) if precision == "highest" else (
        bf16_pass_matmul(x, c))
    return torch.clamp(xx - 2.0 * xc + cc[None, :], min=0.0)


def old_rank_clusters(index, cdist, probe, params):
    """The ranking before the kernel: the key, a stable sort of every
    column, the first ``probe``."""
    if isinstance(cdist, L2Terms):
        cdist = l2sq_epilogue(cdist)
    key = (tsearch._annulus_bound(index, cdist)
           if params.probe_rank == "annulus" else cdist)
    return torch.sort(key, dim=-1, stable=True).indices[:, :probe]


def lexsort_ids(key, probe):
    """numpy: the ``probe`` lowest of each row by (key, id), NaN last."""
    key = np.asarray(key)
    ids = np.broadcast_to(np.arange(key.shape[1]), key.shape)
    nan = np.isnan(key)
    return np.lexsort((ids, np.where(nan, 0, key), nan), axis=-1)[:, :probe]


def terms_with_ties(seed, b, k, dim, precision="highest", tied=0.2,
                    device="cpu"):
    """The terms of queries near random centroids, a share ``tied`` of
    the centroid rows a copy of the row before them (exact ties)."""
    g = torch.Generator().manual_seed(seed)
    c = torch.randn((k, dim), generator=g)
    if k > 1:
        at = torch.randperm(k - 1, generator=g)[: int(tied * (k - 1))]
        c[at + 1] = c[at]
    y = c[torch.randint(0, k, (b,), generator=g)] + torch.randn(
        (b, dim), generator=g) / 3
    return pairwise_terms(y.to(device), c.to(device), precision)


# --- on the CPU --------------------------------------------------------------


@pytest.mark.parametrize("precision", ["highest", "default"])
def test_pairwise_l2sq_unchanged_by_the_split(precision):
    """pairwise_l2sq, the epilogue of its terms, is bit-identical to the
    one-function version every caller (k-means, the build, sharding,
    autotune, the twin) had."""
    g = torch.Generator().manual_seed(1)
    x, c = torch.randn((33, 96), generator=g), torch.randn((70, 96),
                                                           generator=g)
    want = old_pairwise_l2sq(x, c, precision)
    got = pairwise_l2sq(x, c, precision)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    xx, xc, cc = pairwise_terms(x, c, precision)
    assert xx.shape == (33, 1) and xc.shape == (33, 70) and cc.shape == (70,)
    assert torch.equal(l2sq_epilogue(L2Terms(xx, xc, cc)), want)


@pytest.mark.parametrize("precision", ["highest", "default"])
@pytest.mark.parametrize("probe", [1, 28, 97])
def test_reference_equals_the_sort_of_the_epilogue(precision, probe):
    """From the terms, the plain version (and the CPU wrapper) returns the
    first ``probe`` of a stable sort of pairwise_l2sq's old output, with
    exact ties between repeated centroids; so does numpy's lexsort."""
    terms = terms_with_ties(3, 40, 97, 64, precision)
    key = torch.clamp(terms.xx - 2.0 * terms.xc + terms.cc[None, :], min=0.0)
    want = torch.sort(key, dim=-1, stable=True).indices[:, :probe]
    for fn in (probe_rank_reference, cuda_probe_rank):
        got = fn(terms.xc, probe, terms.xx, terms.cc)
        assert got.dtype == torch.int64 and torch.equal(got, want)
    np.testing.assert_array_equal(want.numpy(), lexsort_ids(key, probe))
    assert bool((key[:, :, None] == key[:, None, :]).sum() > key.numel())


@pytest.mark.parametrize("probe", [1, 5, 50])
def test_reference_on_a_finished_key(probe):
    """A finished key (the annulus bound's +inf for empty clusters, NaN,
    many ties): the stable sort's ids, NaN after +inf."""
    g = torch.Generator().manual_seed(4)
    key = torch.randint(0, 6, (16, 50), generator=g).float()
    key[:, 7] = torch.inf
    key[3, :] = torch.inf
    key[5, 11] = torch.nan
    key[6, :] = torch.nan
    want = torch.sort(key, dim=-1, stable=True).indices[:, :probe]
    assert torch.equal(cuda_probe_rank(key, probe), want)
    np.testing.assert_array_equal(want.numpy(), lexsort_ids(key, probe))


def test_reference_rejects_bad_operands():
    terms = terms_with_ties(1, 4, 10, 8)
    with pytest.raises(ValueError, match="probe"):
        probe_rank_reference(terms.xc, 11, terms.xx, terms.cc)
    with pytest.raises(ValueError, match="together"):
        probe_rank_reference(terms.xc, 3, terms.xx)
    with pytest.raises(ValueError, match="float32"):
        probe_rank_reference(terms.xc.double(), 3)
    with pytest.raises(ValueError, match="expected"):
        probe_rank_reference(terms.xc, 3, terms.xx[:3], terms.cc)
    assert probe_rank_reference(terms.xc, 0).shape == (4, 0)


@pytest.fixture(scope="module")
def split_index():
    """A small skewed corpus whose build splits clusters (their segments
    repeat the centroid), and its queries."""
    cfg = dict(rows=8000, dim=128,
               data=dict(generator="blobs", centers=32, zipf=1.2,
                         spread=0.3, structure_seed=0),
               kmeans=dict(train_rows=8000))
    base, queries, train = data.make(cfg, 64, 5, "cpu")
    cents = kmeans(train, 48, iters=8, device="cpu",
                   generator=data.generator(0, 1, "cpu"))
    idx = rt.build_index(base.numpy(), cents, bits=4, spill=0.0, balance=2.0,
                         device="cpu", generator=data.generator(5, 2, "cpu"))
    cr = idx.centroids_rot
    assert any(torch.equal(cr[c], cr[c + 1]) for c in range(idx.k - 1))
    return types.SimpleNamespace(index=idx, queries=queries)


@pytest.mark.parametrize("probe_rank", ["centroid", "annulus"])
def test_rank_clusters_on_a_split_index(split_index, probe_rank):
    """_rank_clusters from the terms (the scan's and the certificate's)
    gives the old ranking's ids, tied segments nearest first."""
    idx, q = split_index.index, split_index.queries
    params = rt.SearchParams(probe=12, topk=10, rerank=32,
                             probe_rank=probe_rank)
    y = rotate(q, idx.orthogonal)
    terms = tsearch._rank_terms(idx, y, params)
    want = old_rank_clusters(idx, l2sq_epilogue(terms), idx.k, params)
    for probe in (1, 12, idx.k):
        got = tsearch._rank_clusters(idx, terms, probe, params)
        assert torch.equal(got, want[:, :probe])


@pytest.mark.parametrize("probe_rank", ["centroid", "annulus"])
def test_adaptive_and_certificate_unchanged_on_a_split_index(
        split_index, monkeypatch, probe_rank):
    """search_adaptive's [lo:] escalations (levels of 3 ranks from probe 2)
    and _certificate_safe give the same results, bit for bit, as with the
    old ranking."""
    idx, q = split_index.index, split_index.queries
    params = rt.SearchParams(probe=2, topk=10, rerank=32,
                             probe_rank=probe_rank)

    def run():
        d, i, used = rt.search_adaptive(idx, q, params, max_probe=16,
                                        level_width=3)
        cert = tsearch._search_with_certificate(idx, q, params._replace(
            probe=7))
        return d, i, used, cert

    got = run()
    monkeypatch.setattr(tsearch, "_rank_clusters", old_rank_clusters)
    want = run()
    assert got[2] == want[2] and got[2] > params.probe
    for a, b in zip((*got[:2], *got[3]), (*want[:2], *want[3])):
        assert torch.equal(a, b)


# --- on the card -------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def resident_max():
    src = (ROOT / "rabitq_tpu_torch" / "csrc" / "probe_rank.cu").read_text()
    return int(re.search(r"kResidentMax = (\d+);", src).group(1))


CARD_SHAPES = [(k, p) for k in (1, 7, 4096, 5327, resident_max() + 1)
               for p in sorted({min(p, k) for p in (1, 28, 64, 384, k)})]


@pytest.mark.cuda
@pytest.mark.parametrize("instance", ["fused", "finished"])
@pytest.mark.parametrize("k,probe", CARD_SHAPES)
def test_kernel_equals_reference(dev, k, probe, instance):
    """The kernel's ids equal the plain version's bit for bit, from the
    terms and from a finished key (+inf and NaN columns besides), with
    exact ties, at every K and probe; the launch counters move by one."""
    from rabitq_tpu_torch.ops.probe_rank import _lib

    assert _lib()[1] == resident_max()
    b = 16 if k > resident_max() else 64
    terms = terms_with_ties(k + probe, b, k, 32, device=dev)
    if instance == "fused":
        args = (terms.xc, probe, terms.xx, terms.cc)
    else:
        key = l2sq_epilogue(terms)
        key[:, ::5] = torch.inf
        key[1, 2::7] = torch.nan
        args = (key.contiguous(), probe)
    before = (cuda_probe_rank.launches, cuda_probe_rank.launches_fused,
              cuda_probe_rank.launches_streamed)
    got = cuda_probe_rank(*args)
    torch.cuda.synchronize()
    assert (cuda_probe_rank.launches, cuda_probe_rank.launches_fused,
            cuda_probe_rank.launches_streamed) == (
        before[0] + 1, before[1] + (instance == "fused"),
        before[2] + (k > resident_max()))
    want = probe_rank_reference(*args)
    assert got.shape == (b, probe) and torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_on_the_annulus_bound(dev):
    """The annulus key of an index with empty clusters (+inf): the
    kernel's ids equal the plain version's at every probe."""
    rng = np.random.default_rng(2)
    centers = rng.standard_normal((64, 48)).astype(np.float32)
    base = (centers[rng.integers(0, 48, 5000)]
            + 0.2 * rng.standard_normal((5000, 48))).astype(np.float32)
    idx = rt.build_index(base, centers, bits=4, device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    q = torch.from_numpy(base[:200]).to(dev)
    y = rotate(tsearch._prep_queries(idx, q), idx.orthogonal)
    params = rt.SearchParams(probe=8, probe_rank="annulus")
    key = tsearch._annulus_bound(
        idx, l2sq_epilogue(tsearch._rank_terms(idx, y, params)))
    assert bool(torch.isinf(key).any())
    for probe in (1, 8, 28, idx.k):
        assert torch.equal(cuda_probe_rank(key, probe),
                           probe_rank_reference(key, probe))


@pytest.mark.cuda
def test_kernel_rejects_bad_operands_and_empty_batches(dev):
    terms = terms_with_ties(1, 4, 100, 16, device=dev)
    before = cuda_probe_rank.launches
    for args in ((terms.xc[:0], 5, terms.xx[:0], terms.cc),
                 (terms.xc[:0], 5)):
        assert cuda_probe_rank(*args).shape == (0, 5)
    assert cuda_probe_rank.launches == before
    with pytest.raises(ValueError, match="probe"):
        cuda_probe_rank(terms.xc, 101)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_probe_rank(terms.xc.t().contiguous().t(), 5)


@pytest.mark.cuda
@pytest.mark.parametrize("probe_rank", ["centroid", "annulus"])
def test_search_through_kernel_equals_reference(dev, monkeypatch,
                                                probe_rank):
    """search and search_adaptive on a small index on the card return the
    same ids and distances through the kernel and through the plain
    version; the scan's ranking is fused only by centroid distance."""
    rng = np.random.default_rng(3)
    centers = rng.standard_normal((40, 96)).astype(np.float32)
    base = (centers[rng.integers(0, 40, 8000)]
            + 0.3 * rng.standard_normal((8000, 96))).astype(np.float32)
    q = torch.from_numpy(base[:256] + 0.05).to(dev)
    idx = rt.build_index(base, centers, bits=4, spill=0.2, balance=1.5,
                         device=dev,
                         generator=torch.Generator(device=dev).manual_seed(0))
    params = rt.SearchParams(probe=4, topk=10, rerank=48,
                             probe_rank=probe_rank)

    def run():
        return (*rt.search(idx, q, params),
                *rt.search_adaptive(idx, q, params, level_width=3)[:2])

    before = (cuda_probe_rank.launches, cuda_probe_rank.launches_fused)
    got = run()
    assert cuda_probe_rank.launches > before[0] + 1
    assert (cuda_probe_rank.launches_fused > before[1]) == (
        probe_rank == "centroid")
    monkeypatch.setattr(tsearch, "cuda_probe_rank", probe_rank_reference)
    want = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
