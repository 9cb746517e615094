"""The port's benchmark twin (rabitq_tpu_torch.tools.bench) against the
repo's bench.py, on the CPU at small sizes.

The data generators must draw bench.py's numbers exactly; the
configuration table must hold bench.py's constants (read from its source);
each JSON line must carry bench.py's keys (read from its source) with the
documented changes. A small sift-like run's ids must equal the JAX search's
on the same index (handed over through index/convert.py) but at near-ties,
the port's side unfolded (select_reduce=False) and JAX's selecting exactly
(approx_select=False), as ROADMAP's "What must match" states. Small
service and deep10m runs go through the HTTP server and the faulty range
server. The reduced-precision flags (``--rerank-bf16``,
``--rerank-refine``, ``--rank-precision``) reach SearchParams and the
line's detail, and the gist config ranks at "default" as bench.py's does.
The flags that stay refused exit non-zero with their reason.
"""

import ast
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
import rabitq_tpu as rq
import rabitq_tpu_torch as rt
from rabitq_tpu_torch.tools import bench
from torch_parity import port_index_from_jax

REPO = Path(__file__).resolve().parent.parent
BENCH_SRC = ast.parse((REPO / "bench.py").read_text())

# detail keys of bench.py's search line that the twin drops, and adds.
DROPPED = {"transport", "rerank_chunk"}
ADDED = {"device_ms_per_batch", "enqueue_ms_per_batch", "power_limit_w"}


def _function(name):
    return next(n for n in ast.walk(BENCH_SRC)
                if isinstance(n, ast.FunctionDef) and n.name == name)


def _line_keys(name):
    """The keys of the JSON line that bench.py's function ``name`` prints:
    (top-level keys, detail keys)."""
    for node in ast.walk(_function(name)):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") == \
                "dict" and any(k.arg == "detail" for k in node.keywords):
            detail = next(k.value for k in node.keywords if k.arg == "detail")
            keys = {k.arg for k in detail.keywords if k.arg}
            # **cache_arm: the deep10m arm's dict literal.
            if any(k.arg is None for k in detail.keywords):
                for sub in ast.walk(_function(name)):
                    if isinstance(sub, ast.Assign) and getattr(
                            sub.targets[0], "id", "") == "cache_arm" and \
                            isinstance(sub.value, ast.Call):
                        keys |= {k.arg for k in sub.value.keywords}
            return {k.arg for k in node.keywords}, keys
    raise AssertionError(name)


def _tuples(name):
    """The literal tuples bench.py's function ``name`` assigns to tuples
    of names, in order."""
    return [ast.literal_eval(st.value) for st in _function(name).body
            if isinstance(st, ast.Assign)
            and isinstance(st.targets[0], ast.Tuple)
            and isinstance(st.value, ast.Tuple)]


def _assigned(stmts):
    """{name: value} of the literal assignments among ``stmts``."""
    vals = {}
    for st in stmts:
        if isinstance(st, ast.Assign):
            tgt = st.targets[0]
            names = ([e.id for e in tgt.elts] if isinstance(tgt, ast.Tuple)
                     else [tgt.id] if isinstance(tgt, ast.Name) else [])
            try:
                v = ast.literal_eval(st.value)
            except ValueError:
                continue
            vals.update(zip(names, v if isinstance(v, tuple) else [v]))
    return vals


def test_config_table_equals_bench_py():
    """bench.py main's size branches: quick, gist200k, gist, and the else
    branch (sift and blobs, blobs with 256 centers)."""
    branch = {}
    for n in ast.walk(_function("main")):
        if isinstance(n, ast.If):
            branch.setdefault(ast.unparse(n.test), n)
    gist = branch["args.config == 'gist'"]
    want = {"quick": _assigned(branch["args.quick"].body),
            "gist200k": _assigned(branch["args.config == 'gist200k'"].body),
            "gist": _assigned(gist.body)}
    sift = _assigned(gist.orelse)
    want["sift"] = want["blobs"] = sift
    for name, vals in want.items():
        cfg = bench.CONFIGS[name]
        for f in ("n", "dim", "k", "nq", "n_centers", "train_cap"):
            expect = 256 if (name, f) == ("blobs", "n_centers") else vals[f]
            assert getattr(cfg, f) == expect, (name, f)
        assert cfg.iters == 15 and cfg.rerank == "scale"
    # topk, balance, spill and batch: bench.py's defaults per config.
    assert [bench.CONFIGS[c].topk for c in ("sift", "gist", "gist200k",
                                            "blobs", "quick")] == \
        [10, 100, 100, 10, 10]
    assert [bench.CONFIGS[c].balance for c in ("sift", "gist", "gist200k",
                                               "blobs", "quick")] == \
        [1.5, 1.5, 1.5, 2.0, 1.5]
    assert [bench.CONFIGS[c].spill for c in ("sift", "gist", "gist200k",
                                             "blobs", "quick")] == \
        [0.2, 0.2, 0.0, 0.0, 0.0]
    assert bench.CONFIGS["gist"].max_batch == 1024
    # bench_service and bench_deep10m: their tuple assignments.
    s = bench.CONFIGS["service"]
    assert _tuples("bench_service") == [(s.n, s.dim, s.k, s.nq),
                                        (s.probe, s.topk, s.workers)]
    assert (s.train_cap, s.iters, s.bits, s.balance, s.batch) == (
        100_000, 10, 1, 2.0, 64)
    d = bench.CONFIGS["deep10m"]
    assert _tuples("bench_deep10m") == [(d.n, d.dim, d.k, d.nq, d.topk)]
    assert (d.n_centers, d.train_cap, d.iters, d.balance, d.spill,
            d.fault_every) == (2048, 1_000_000, 10, 1.5, 0.0, 50)


@pytest.mark.parametrize("dim", [96, 960])
@pytest.mark.parametrize("gen", ["make_dataset", "make_blobs_dataset"])
@pytest.mark.parametrize("chunk_rows", [64, 1000, 1 << 16])
def test_generators_draw_bench_py_numbers(gen, chunk_rows, dim):
    """Also at the GIST width, with the noise drawn in row chunks (the
    last one ragged)."""
    want = getattr(jbench, gen)(700, dim, 16, 9, seed=3)
    got = getattr(bench, gen)(700, dim, 16, 9, seed=3, chunk_rows=chunk_rows)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_ground_truth_is_brute_force():
    rng = np.random.default_rng(4)
    base = rng.standard_normal((3000, 24)).astype(np.float32)
    q = rng.standard_normal((37, 24)).astype(np.float32)
    d = ((q[:, None, :].astype(np.float64) - base[None]) ** 2).sum(-1)
    want = np.argsort(d, axis=1)[:, :7]
    for chunk_bytes in (37 * 4 * 100, 1 << 30):  # 30 chunks, and one
        got = bench.ground_truth(base, q, 7, "cpu", chunk_bytes=chunk_bytes)
        np.testing.assert_array_equal(got, want)
    assert bench.recall_at(want, want) == 1.0
    assert bench.recall_at(want[:, ::-1], want) == 1.0
    assert bench.recall_at(np.full_like(want, -1), want) == 0.0


def _small(name, **kw):
    return dataclasses.replace(bench.CONFIGS[name], **kw)


SIFT_SMALL = dict(n=4000, nq=256, k=64, n_centers=32, train_cap=2000,
                  batch=128)


def test_sift_like_run_prints_bench_py_line():
    args = bench.parse_args(["--device", "cpu"])
    line, ids = bench.run(args, "cpu", cfg=_small("sift", **SIFT_SMALL))
    top, detail = _line_keys("main")
    assert set(line) == top
    assert set(line["detail"]) == (detail - DROPPED) | ADDED
    assert line["metric"] == "qps@recall0.95_sift-like-4k-128d_top10"
    assert line["vs_baseline"] is None and line["unit"] == "queries/s"
    d = line["detail"]
    assert d["device"] == "cpu" and d["power_limit_w"] is None
    assert d["device_ms_per_batch"] is None and d["enqueue_ms_per_batch"] > 0
    assert d["rerank"] == 32 and d["bits"] == 4 and d["spill"] == 0.2
    assert d["recall"] >= 0.95 and ids.shape == (256, 10)
    assert line["value"] == max(d["qps_fused"], d["qps_pipelined"])
    json.dumps(line)


def test_sift_like_ids_equal_jax_search_on_one_index():
    """The twin's sweep and timing on a JAX-built index (converted): the
    chosen probe's ids equal JAX's exact-selection search but at
    near-ties."""
    cfg = _small("sift", **SIFT_SMALL)
    base, queries = bench.make_dataset(cfg.n, cfg.dim, cfg.n_centers,
                                       cfg.nq)
    truth = bench.ground_truth(base, queries, cfg.topk, "cpu")
    centroids = base[np.random.default_rng(1).choice(cfg.n, cfg.k,
                                                     replace=False)]
    jidx = rq.build_index(base, centroids, key=jax.random.key(2), bits=4,
                          balance=1.5, spill=0.2)
    tidx = port_index_from_jax(jidx)
    args = bench.parse_args(["--device", "cpu", "--fold", "0"])
    res = bench.sweep_and_time(cfg, args, tidx, queries, truth, "cpu")
    p = res["params"]
    assert not p.select_reduce
    jp = rq.SearchParams(probe=p.probe, topk=p.topk, rerank=p.rerank,
                         approx_select=False)
    jd, ji = rq.search(jidx, jnp.asarray(queries), jp)
    jd, ji = np.asarray(jd), np.asarray(ji)
    same = res["ids"] == ji
    assert same.mean() >= 0.99, same.mean()
    # A differing id sits at a near-tie of the JAX distances.
    for b, j in zip(*np.nonzero(~same)):
        row = jd[b]
        assert np.isclose(row, row[j], rtol=1e-4).sum() > 1 or \
            j == row.shape[0] - 1, (b, j)
    assert abs(res["recall"] - bench.recall_at(ji, truth)) <= 0.01


def test_service_run_reports_latency_and_recall():
    args = bench.parse_args(["--device", "cpu", "--config", "service"])
    cfg = _small("service", n=4000, nq=96, k=64, n_centers=32,
                 train_cap=2000, workers=8)
    line, _ = bench.run(args, "cpu", cfg=cfg)
    top, detail = _line_keys("bench_service")
    assert set(line) == top
    assert set(line["detail"]) == detail | {"device", "power_limit_w"}
    assert line["metric"] == "service_p99_ms@8conc_4k-128d"
    assert line["unit"] == "ms" and line["vs_baseline"] is None
    d = line["detail"]
    assert 0 < d["p50_ms"] <= line["value"]
    assert d["recall"] >= 0.9 and d["recall_batched"] >= 0.9
    assert d["qps"] > 0 and d["qps_batched"] > 0


def test_deep10m_run_through_the_faulty_range_server():
    """The block cache behind a range server that answers 500 to every
    third GET: the runner holds its ids to the mmap store's (it raises
    otherwise), every fault absorbed by the retrying source."""
    args = bench.parse_args(["--device", "cpu", "--config", "deep10m"])
    cfg = _small("deep10m", n=20_000, nq=64, k=64, n_centers=32,
                 train_cap=5000, fault_every=3)
    line, ids = bench.run(args, "cpu", cfg=cfg)
    top, detail = _line_keys("bench_deep10m")
    assert set(line) == top
    assert set(line["detail"]) == detail | {"device", "power_limit_w"}
    assert line["metric"] == "qps@recall0.95_deep10m-96d_top10_hoststore"
    d = line["detail"]
    assert d["transients_injected"] > 0 and d["block_misses_cold"] > 0
    assert d["block_misses_warm"] == 0 and d["recall"] >= 0.95
    assert d["filter_construction"]["tenants"] == 8
    truth = bench.ground_truth(*bench.make_dataset(cfg.n, cfg.dim,
                                                   cfg.n_centers, cfg.nq),
                               cfg.topk, "cpu")
    assert round(bench.recall_at(ids, truth), 4) == d["recall"]


@pytest.mark.parametrize("argv", [
    ["--select-passes", "2"], ["--rerank-chunk", "256"], ["--rerank-kernel"],
    ["--no-rerank-kernel"],
])
def test_refused_flags_exit_nonzero_with_their_reason(argv, capsys):
    with pytest.raises(SystemExit) as e:
        bench.parse_args(argv)
    assert e.value.code != 0
    err = capsys.readouterr().err
    assert argv[0] in err and bench.REFUSED[argv[0]][:30] in err


@pytest.mark.parametrize("argv,field,value", [
    (["--rerank-bf16"], "rerank_bf16", True),
    (["--rerank-refine", "-1"], "rerank_refine", -1),
    (["--rank-precision", "default"], "rank_precision", "default"),
    (["--rank-precision", "highest"], "rank_precision", "highest"),
])
def test_precision_flags_reach_search_params(argv, field, value):
    """bench.py's flags, accepted: each sets its SearchParams field on
    every search configuration (--rank-precision over the config's
    default, gist's "default" included)."""
    assert set(bench.REFUSED) == {"--select-passes", "--rerank-chunk",
                                  "--rerank-kernel", "--no-rerank-kernel"}
    for config in ("sift", "gist", "gist200k", "blobs"):
        args = bench.parse_args(["--config", config, *argv])
        _, cfg = bench.config_of(args)
        assert getattr(bench.search_params(cfg, args, 8), field) == value


def test_gist_config_ranks_clusters_in_one_bf16_pass():
    """bench.py's gist branch sets rank_precision "default" when the flag
    is absent; its other configurations keep "highest". So does the twin."""
    gist = next(n for n in ast.walk(_function("main"))
                if isinstance(n, ast.If)
                and ast.unparse(n.test) == "args.config == 'gist'")
    sets = [ast.unparse(st) for node in ast.walk(gist)
            if isinstance(node, ast.If)
            and ast.unparse(node.test) == "args.rank_precision is None"
            for st in node.body]
    assert sets == ["args.rank_precision = 'default'"]
    for config, want in (("gist", "default"), ("sift", "highest"),
                         ("gist200k", "highest"), ("blobs", "highest")):
        args = bench.parse_args(["--config", config])
        _, cfg = bench.config_of(args)
        assert cfg.rank_precision == want
        assert bench.search_params(cfg, args, 8).rank_precision == want
    quick = bench.parse_args(["--config", "gist", "--quick"])
    assert bench.search_params(bench.config_of(quick)[1], quick,
                               8).rank_precision == "highest"


def test_rerank_bf16_run_reports_its_params():
    """A small sift-like run with --rerank-bf16 --rerank-refine 0
    --rank-precision default: the line's detail carries the three, and the
    search reached the target recall."""
    args = bench.parse_args(["--device", "cpu", "--rerank-bf16",
                             "--rerank-refine", "0", "--rank-precision",
                             "default"])
    line, ids = bench.run(args, "cpu", cfg=_small("sift", **SIFT_SMALL))
    _, detail = _line_keys("main")
    d = line["detail"]
    assert set(d) == (detail - DROPPED) | ADDED | {"rerank_bf16",
                                                    "rerank_refine"}
    assert d["rerank_bf16"] is True and d["rerank_refine"] == 0
    assert d["rank_precision"] == "default"
    assert d["recall"] >= 0.95 and ids.shape == (256, 10)


def test_accepted_flags_and_no_card():
    a = bench.parse_args(["--fold", "0", "--topk", "5", "--quick",
                          "--config", "blobs"])
    name, cfg = bench.config_of(a)
    assert name == "quick" and cfg.topk == 5 and cfg.generator == "blobs"
    assert cfg.balance == 2.0 and cfg.n == 100_000
    if not torch.cuda.is_available():  # the default device: no fallback
        assert bench.main(["--quick"]) == 1


def test_build_index_keep_base_false_drops_only_the_base():
    rng = np.random.default_rng(8)
    base = rng.standard_normal((1500, 40)).astype(np.float32)
    c = base[:16]
    kw = dict(bits=4, spill=0.1, device="cpu")
    full = rt.build_index(base, c, generator=torch.Generator().manual_seed(1),
                          **kw)
    lean = rt.build_index(base, c, generator=torch.Generator().manual_seed(1),
                          keep_base=False, **kw)
    assert lean.base is None and full.base is not None
    for f in ("codes", "factors", "offsets", "map_ids", "centroids_rot"):
        assert torch.equal(getattr(lean, f), getattr(full, f)), f


def test_run_captured_counts_from_zero_and_restores_the_stage(monkeypatch):
    """The kernels' counters are set to 0 just before fn(), the stage's
    calls are counted through the search module, and the stage is put
    back after fn()."""
    from rabitq_tpu_torch.ops import cuda_gather_l2

    monkeypatch.setattr(cuda_gather_l2, "launches", 5)
    tsearch = __import__("importlib").import_module(
        "rabitq_tpu_torch.index.search")
    monkeypatch.setattr(tsearch, "rough_scan", lambda *a, **k: None)
    stage = tsearch.rough_scan

    def run():
        for _ in range(3):
            tsearch.rough_scan()
            cuda_gather_l2.launches += 1
        return "out"

    out, counts = bench.run_captured(run)
    assert out == "out"
    assert counts["rough_scan calls"] == 3 and counts["gather_l2"] == 3
    assert counts["quantize"] == counts["select"] == 0
    assert tsearch.rough_scan is stage
