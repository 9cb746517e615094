"""The port's CLI (``python -m rabitq_tpu_torch.cli``) against the JAX CLI.

Both run in-process (``main(argv)``) on the CPU, the port's with
``--device cpu``, over small fvecs fixtures. On one JAX-built directory the
two ``run`` commands report the same recall: the port's with ``--no-fold``
(the JAX CPU path never folds), and with the fold on, held to that recall
within the fold's loss (at most one candidate of a query in a hundred);
the host rerankers (``--rerank-mode heap|heuristic``) too. The port's
``build`` writes a directory that JAX loads and searches to the same
recall. ``--adaptive``, ``--probe-rank annulus`` and ``--autotune`` report
the JAX CLI's recall (the autotune one on an unspilled index: on a spilled
one the JAX ground truth can name an id twice, ROADMAP queue 3).
``--rerank-bf16`` and ``--rerank-refine`` reach the port's SearchParams
and report the JAX CLI's recall; ``--select-passes`` (the JAX package's
TPU-only approximate selection) exits 2; ``train --tree`` trains a
hierarchical k-means. ``--profile`` prints the phases' and the search
stages' totals.
"""

import importlib
import logging
import re

import numpy as np
import pytest
import torch

from rabitq_tpu.cli import main as jax_main
from rabitq_tpu.index.serialize import load_from_dir as jax_load
from rabitq_tpu_torch.cli import main as port_main
from rabitq_tpu_torch.io import read_matrix, write_matrix

TOPK = 5


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Fixture files (clusters of ~375 rows, so capacity > 256 and the fold
    is on) and a JAX-built index directory."""
    d = tmp_path_factory.mktemp("cli")
    rng = np.random.default_rng(3)
    k, n, dim, nq = 8, 3000, 40, 24
    centers = rng.standard_normal((k, dim)).astype(np.float32)
    base = (centers[rng.integers(0, k, n)]
            + 0.3 * rng.standard_normal((n, dim))).astype(np.float32)
    queries = (base[:nq] + 0.05 * rng.standard_normal((nq, dim))).astype(
        np.float32)
    d2 = ((base[None] - queries[:, None]) ** 2).sum(-1)
    truth = np.argsort(d2, axis=1)[:, :TOPK].astype(np.int32)
    paths = {name: d / f"{name}.fvecs" for name in
             ("base", "centroids", "query", "truth")}
    for name, arr in (("base", base), ("centroids", centers),
                      ("query", queries), ("truth", truth)):
        write_matrix(paths[name], arr)
    paths["jax_dir"] = d / "jax_index"
    jax_main(["build", *_index_args(paths, paths["jax_dir"]), "--bits", "4",
              "--spill", "0.2"])
    return paths


def _index_args(paths, saved):
    return ["-b", str(paths["base"]), "-c", str(paths["centroids"]),
            "-s", str(saved)]


def _run_args(paths, saved, *extra):
    return ["run", *_index_args(paths, saved), "-q", str(paths["query"]),
            "-t", str(paths["truth"]), "-p", "3", "-k", str(TOPK),
            "--rerank", "40", "--batch", "8", *extra]


def _jax_recall(caplog, argv):
    with caplog.at_level(logging.INFO):
        caplog.clear()
        jax_main(argv)
    found = re.findall(r"recall: ([0-9.]+)", caplog.text)
    assert found, caplog.text
    return found[-1]


def _reported(recall):
    """The recall as both CLIs log it."""
    return f"{recall:.4f}"


@pytest.mark.parametrize("mode", ["no-fold", "fold", "heap", "heuristic"])
def test_run_recall_matches_jax_cli(files, caplog, mode):
    extra = {"no-fold": ["--no-fold"], "fold": [],
             "heap": ["--rerank-mode", "heap"],
             "heuristic": ["--rerank-mode", "heuristic"]}[mode]
    argv = _run_args(files, files["jax_dir"], *extra)
    want = _jax_recall(caplog, argv)
    got = port_main(argv + ["--device", "cpu"])
    assert got["qps"] > 0
    if mode == "fold":
        assert float(want) - 0.01 <= got["recall"] <= float(want) + 1e-4
    else:
        assert _reported(got["recall"]) == want


def test_port_build_loads_in_jax(files, tmp_path, caplog, capsys):
    saved = tmp_path / "port_index"
    port_main(["build", *_index_args(files, saved), "--bits", "4", "--spill",
               "0.2", "--device", "cpu"])
    jidx = jax_load(saved)
    assert jidx.code_bits == 4 and jidx.dedup_ids
    got = port_main(_run_args(files, saved, "--no-fold", "--device", "cpu"))
    assert _reported(got["recall"]) == _jax_recall(caplog,
                                                   _run_args(files, saved))
    # --rerank-kernel is accepted and changes nothing.
    again = port_main(_run_args(files, saved, "--no-fold", "--rerank-kernel",
                                "--device", "cpu", "--profile"))
    assert again["recall"] == got["recall"]
    # --profile prints the phases' totals, then the search stages'.
    out = capsys.readouterr().out
    for phase in ("load_or_build", "warmup", "search", "recall"):
        assert f"\n{phase}: " in "\n" + out, out
    stages = out[out.index("spans over"):]
    for name in ("search", "search.rank", "search.quantize", "search.scan",
                 "search.select", "search.rerank", "search.topk"):
        assert f"  {name}: host " in stages, out


@pytest.mark.parametrize("mode", ["adaptive", "annulus", "autotune"])
def test_run_adaptive_annulus_autotune_match_jax_cli(files, tmp_path, caplog,
                                                     mode):
    saved = files["jax_dir"]
    extra = {"adaptive": ["--adaptive"],
             "annulus": ["--probe-rank", "annulus"],
             "autotune": ["--autotune", "0.9"]}[mode]
    if mode == "autotune":
        saved = tmp_path / "unspilled"
        jax_main(["build", *_index_args(files, saved), "--bits", "4"])
    argv = _run_args(files, saved, "--no-fold", *extra)
    want = _jax_recall(caplog, argv)
    with caplog.at_level(logging.INFO):
        caplog.clear()
        got = port_main(argv + ["--device", "cpu"])
    assert _reported(got["recall"]) == want
    if mode == "autotune":
        assert "autotune(target=0.900)" in caplog.text


def test_train(files, tmp_path):
    out = tmp_path / "c.fvecs"
    port_main(["train", "-i", str(files["base"]), "-o", str(out), "-k", "8",
               "--iters", "3", "--device", "cpu"])
    c = read_matrix(out)
    assert c.shape == (8, 40) and np.isfinite(c).all()


@pytest.mark.parametrize(
    "extra,message",
    [
        (["--select-passes", "1"], "only on a TPU"),
    ],
)
def test_run_refuses_unported_flags(files, capsys, extra, message):
    with pytest.raises(SystemExit) as e:
        port_main(_run_args(files, files["jax_dir"], *extra, "--device",
                            "cpu"))
    assert e.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize(
    "extra,bf16,refine",
    [
        (["--rerank-bf16"], True, -1),
        (["--rerank-refine", "8"], False, 8),
    ],
)
def test_run_accepts_rerank_bf16_flags(files, caplog, monkeypatch, extra,
                                       bf16, refine):
    """The flags reach every search's SearchParams (with the index's bf16
    copy under --rerank-bf16) and the run reports the JAX CLI's recall
    with the same flags."""
    argv = _run_args(files, files["jax_dir"], "--no-fold", *extra)
    want = _jax_recall(caplog, argv)
    tsearch = importlib.import_module("rabitq_tpu_torch.index.search")
    search, seen = tsearch.search_with_stats, []

    def spy(index, q, params, *a):
        seen.append((index.base_bf16 is not None, params))
        return search(index, q, params, *a)

    monkeypatch.setattr(tsearch, "search_with_stats", spy)
    got = port_main(argv + ["--device", "cpu"])
    assert _reported(got["recall"]) == want
    assert seen and all(
        has == bf16 and p.rerank_bf16 == bf16 and p.rerank_refine == refine
        for has, p in seen)


def test_train_tree_and_cuda_without_card(files, tmp_path, capsys):
    """train --tree T D writes T * D finite centroids (hierarchical
    k-means); train without -k or --tree exits 2; -k without a card
    raises."""
    out = tmp_path / "tree.fvecs"
    port_main(["train", "-i", str(files["base"]), "-o", str(out), "--tree",
               "2", "4", "--iters", "5", "--device", "cpu"])
    c = read_matrix(out)
    assert c.shape == (8, read_matrix(files["base"]).shape[1])
    assert np.isfinite(c).all()
    with pytest.raises(SystemExit) as e:
        port_main(["train", "-i", str(files["base"]), "-o", str(out),
                   "--device", "cpu"])
    assert e.value.code == 2
    assert "-k or --tree" in capsys.readouterr().err
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_main(["train", "-i", str(files["base"]), "-o",
                   str(tmp_path / "c.fvecs"), "-k", "4"])
