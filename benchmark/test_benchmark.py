"""The benchmark's own tests, on the CPU at the rehearsal's tiny size:

    python3 -m pytest benchmark/test_benchmark.py -q

Each cell's run gives a whole result line with ``correct`` true; the
control (the reference in TF32) and each fault the system can have make
``correct`` false; the measured command refuses to run without a card
and without the program beside it.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import control, rehearse, spec

CELLS = ("sift1m.b16384", "gist1m.b8192")
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_run_line(name):
    line = rehearse.rehearse(name)
    assert line["correct"], line["checks"]
    assert list(line)[: len(KEYS)] == KEYS and list(line)[-1] == "checks"
    cell = spec.load_cell(name)
    assert set(line["metrics"]) == set(cell.end_to_end)
    assert line["attempted"] > 0 and line["failed"] == 0
    assert 0.0 < line["metrics"]["recall"]["value"] <= 1.0
    json.dumps(line)


@pytest.mark.parametrize("name", CELLS)
def test_traced_line(name):
    line = rehearse.rehearse(name, trace=True)
    assert line["correct"], line["checks"]
    # The CPU has no device trace: the readers of device metrics find
    # nothing, and the harness leaves them out.
    with open(spec.ROOT / "BENCHMARK.json") as f:
        host = {m["name"] for m in json.load(f)["per_layer"]
                if m["source"] == "host_clock"}
    assert set(line["metrics"]) == host & set(spec.load_cell(name).per_layer)
    assert line["device"]["window_s"] > 0
    assert line["breakdown"]["idle_gaps"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    line = rehearse.rehearse(name, make_search=control.control_search)
    assert not line["correct"]
    c = line["checks"]["dist_gap"]
    assert c["value"] > c["limit"], c


@pytest.mark.parametrize("fault", sorted(control.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault):
    line = rehearse.rehearse(name, make_search=control.FAULTS[fault])
    assert not line["correct"], line["checks"]


def test_tf32_round():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -3.0000001])
    assert control.tf32_round(x).tolist() == [1.0, 1.0, 1.0 + 2**-9, -3.0]


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=120, env=env)


def test_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = _run(spec.ROOT, env)
    assert out.returncode != 0 and not out.stdout.strip()


def test_refuses_without_the_program(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and not out.stdout.strip()


def test_probed_rows_with_empty_clusters():
    reader = spec.load_reader("rough_scan_roofline")
    probed_rows = reader.__globals__["probed_rows"]
    # Clusters 1 and 2 are empty and share their start (3) with cluster 3.
    offsets = torch.tensor([0, 3, 3, 3, 7, 9], dtype=torch.int32)
    # Query 0 probes clusters 0 and 3, query 1 clusters 3 and 4.
    starts = torch.tensor([[0, 3], [3, 7]], dtype=torch.int32)
    assert probed_rows(offsets, starts, torch.tensor([7, 6])) == (9, 13)
    # Query 0 probes clusters 0 and 4, query 1 cluster 4 and the empty
    # cluster 1; no query probes cluster 3, whose start cluster 1 shares.
    starts = torch.tensor([[0, 7], [7, 3]], dtype=torch.int32)
    assert probed_rows(offsets, starts, torch.tensor([5, 2])) == (5, 7)


@pytest.mark.parametrize("name", CELLS)
def test_work_counts_at_the_configured_width(name):
    from benchmark import harness

    cell = rehearse.tiny(spec.load_cell(name))
    state = harness.setup(cell, 3, torch.device("cpu"), 0.0)
    q, p = state.batches[0], state.params
    dim, b = cell.config["dim"], q.shape[0]
    scan = spec.load_reader("rough_scan_roofline").__globals__["scan_work"]
    nbytes, ops = scan(state.index, q, p)
    # Every task scans at least one row: the int8 operations are 2 * D
    # a scanned row, and the bytes at least each task's query.
    assert ops % (2 * dim) == 0 and ops >= 2 * dim * b * p.probe
    assert nbytes >= b * p.probe * dim / 2
    gather = spec.load_reader("gather_l2_roofline").__globals__["gather_work"]
    nbytes, ops = gather(state.index, q, p)
    assert ops == 3 * b * p.rerank * dim
    n_pos = b * p.rerank
    assert b * dim * 4 < nbytes <= (n_pos + b) * dim * 4 + n_pos * 12
