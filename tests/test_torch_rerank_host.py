"""The port's host rerankers and ord32 mapping against the JAX package's.

The rerankers (the CLI's --rerank-mode heap and heuristic) run on numpy,
so the same candidates, distances and ids must give the same results,
thresholds and counters in both packages.
"""

import numpy as np
import pytest

from rabitq_tpu import ord32 as jord
from rabitq_tpu import rerank as jrerank
from rabitq_tpu.metrics import METRICS as JMETRICS
from rabitq_tpu_torch import ord32 as tord
from rabitq_tpu_torch import rerank as trerank
from rabitq_tpu_torch.consts import WINDOW_SIZE
from rabitq_tpu_torch.metrics import METRICS as TMETRICS


def _candidates(seed, n=400, m=150):
    rng = np.random.default_rng(seed)
    exact = rng.random(n).astype(np.float32) * 10
    pos = rng.choice(n, m, replace=False)
    rough = (exact[pos] - rng.random(m).astype(np.float32)).astype(np.float32)
    rough[::17] = np.inf
    exact[pos[5]] = np.nan  # sorts above +inf in the heap
    map_ids = rng.permutation(n).astype(np.int32)
    return exact, rough, pos, map_ids


@pytest.mark.parametrize("batches", [1, 3])
@pytest.mark.parametrize("heuristic", [False, True])
@pytest.mark.parametrize("topk", [1, 10, 50])
def test_rerankers_match_jax(topk, heuristic, batches):
    exact, rough, pos, map_ids = _candidates(topk)
    results = []
    for mod, metrics in ((jrerank, JMETRICS), (trerank, TMETRICS)):
        metrics.reset()
        rr = mod.new_re_ranker(topk, lambda p: float(exact[p]), heuristic)
        for part in np.array_split(np.arange(len(pos)), batches):
            rr.rank_batch(rough[part], pos[part], map_ids)
        results.append((rr.get_result(), float(rr.threshold),
                        metrics.rough, metrics.precise))
        metrics.reset()
    (jres, jthr, jr, jp), (tres, tthr, tr, tp) = results
    assert len(tres) == len(jres) <= topk
    np.testing.assert_array_equal(np.array(tres), np.array(jres))
    assert np.isnan(tthr) == np.isnan(jthr) and (np.isnan(jthr) or tthr == jthr)
    assert (tr, tp) == (jr, jp) == (len(pos), tp)


def test_window_size_matches_jax():
    from rabitq_tpu.consts import WINDOW_SIZE as J_WINDOW

    assert WINDOW_SIZE == J_WINDOW


def test_ord32_round_trip_and_order(rng):
    x = np.concatenate([
        rng.standard_normal(200).astype(np.float32) * 1e3,
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45],
                 np.float32),
    ])
    o = tord.f32_to_ord32(x)
    np.testing.assert_array_equal(o, jord.f32_to_ord32(x))
    back = tord.ord32_to_f32(o)
    np.testing.assert_array_equal(back.view(np.int32), x.view(np.int32))
    fin = x[~np.isnan(x)]
    order = np.argsort(tord.f32_to_ord32(fin), kind="stable")
    assert (np.diff(fin[order]) >= 0).all()
    assert tord.f32_to_ord32(np.float32(np.nan)) > tord.f32_to_ord32(np.float32(np.inf))
