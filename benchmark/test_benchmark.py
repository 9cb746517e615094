"""The benchmark's own tests, on the CPU at the rehearsal's tiny size:

    python3 -m pytest benchmark/test_benchmark.py -q

Each cell's run gives a whole result line with ``correct`` true; the
control (the reference in TF32) and each fault the system can have make
``correct`` false; the measured command refuses to run without a card
and without the program beside it. A filtered cell's allow-list, its
reference and its work counts are held to plain versions written here.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import check, control, data, harness, rehearse, run, spec, truth

CELLS = ("sift1m.b16384", "gist1m.b8192", "sift1m.filter10")
FILTERED = "sift1m.filter10"
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _checks(name):
    return list(check.NAMES) + (["filtered"] if name == FILTERED else [])


@pytest.mark.parametrize("name", CELLS)
def test_run_line(name):
    line = rehearse.rehearse(name)
    assert line["correct"], line["checks"]
    assert list(line["checks"]) == _checks(name)
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
    assert list(line["checks"]) == _checks(name)
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
    # Under a filter the control ranks the allowed rows alone.
    assert line["checks"].get("filtered", {"value": 0})["value"] == 0


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS
    for fault in sorted(control.faults(spec.load_cell(name)))])
def test_fault_is_not_correct(name, fault):
    line = rehearse.rehearse(
        name, make_search=control.faults(spec.load_cell(name))[fault])
    assert not line["correct"], line["checks"]
    if fault == "unfiltered":
        c = line["checks"]
        assert c["filtered"]["value"] > 0 and c["miss"]["value"] > 0.5, c


def test_faults_of_a_cell():
    assert sorted(control.faults(spec.load_cell(CELLS[0]))) == [
        "altered", "half"]
    assert sorted(control.faults(spec.load_cell(FILTERED))) == [
        "altered", "half", "unfiltered"]


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
    # A row filter adds each distinct probed row's f32 penalty.
    more = scan(state.index, q, p, state.row_filter)[0] - nbytes
    if state.row_filter is None:
        assert more == 0
    else:
        assert 0 < more <= 4 * state.index.n and more % 4 == 0
    gather = spec.load_reader("gather_l2_roofline").__globals__["gather_work"]
    nbytes, ops = gather(state.index, q, p, state.row_filter)
    assert ops == 3 * b * p.rerank * dim
    n_pos = b * p.rerank
    assert b * dim * 4 < nbytes <= (n_pos + b) * dim * 4 + n_pos * 12


def test_jax_loaded_compares_whole_top_level_names():
    assert run.jax_loaded(["rabitq_tpu_torch", "rabitq_tpu_torch.ops",
                           "jaxtyping", "torch"]) == []
    assert run.jax_loaded(["jax.numpy", "flax", "rabitq_tpu.index",
                           "torch"]) == ["flax", "jax", "rabitq_tpu"]


def _tiny_state(name, seed=3):
    return harness.setup(rehearse.tiny(spec.load_cell(name)), seed,
                         torch.device("cpu"), 0.0)


def test_filtered_draw_leaves_the_rows_as_they_were():
    """A filtered cell draws the same base, pool and training rows as the
    unfiltered cell of its configuration; its allow-list is a fixed set
    of corpus rows, the same rows under every seed's order."""
    cell = rehearse.tiny(spec.load_cell(FILTERED))
    plain = rehearse.tiny(spec.load_cell(CELLS[0]))
    assert cell.config == plain.config
    cfg, pool = cell.config, cell.traffic["pool"]
    for a, b in zip(data.make(cfg, pool, 3, "cpu"),
                    data.make(plain.config, plain.traffic["pool"], 3, "cpu")):
        assert torch.equal(a, b)
    rows = {}
    for seed in (3, 4):
        base = data.make(cfg, pool, seed, "cpu")[0]
        ids = data.allowed_ids(cfg, 0.1, seed, "cpu")
        assert ids.numel() == round(0.1 * cfg["rows"])
        assert torch.equal(ids, torch.unique(ids))
        rows[seed] = torch.sort(base[ids], dim=0).values
    assert torch.equal(rows[3], rows[4])
    state = _tiny_state(FILTERED)
    assert torch.equal(state.allowed, data.allowed_ids(cfg, 0.1, 3, "cpu"))
    assert state.stages["filter_s"] > 0


def test_filtered_truth_is_a_masked_brute_force():
    g = torch.Generator().manual_seed(0)
    base = torch.randn((500, 16), generator=g)
    queries = torch.randn((20, 16), generator=g)
    allowed = torch.sort(torch.randperm(500, generator=g)[:60]).values
    d, ids = truth.brute_force_topk(base, queries, 5, allowed)
    full = ((queries[:, None, :].double() - base[None].double()) ** 2).sum(-1)
    mask = torch.zeros(500, dtype=torch.bool)
    mask[allowed] = True
    full[:, ~mask] = torch.inf
    want_d, want_ids = torch.topk(full, 5, dim=1, largest=False)
    assert torch.equal(ids, want_ids)
    assert torch.allclose(d.double(), want_d, rtol=1e-5, atol=1e-4)


def test_filtered_check_counts_ids_outside_the_allow_list():
    g = torch.Generator().manual_seed(1)
    base = torch.randn((50, 8), generator=g)
    batches = torch.randn((1, 4, 8), generator=g)
    allowed = torch.arange(0, 50, 2)
    d, ids = truth.brute_force_topk(base, batches[0], 3, allowed)
    limits = dict(miss=0.0, dist_gap=1e-5, dup=0, bad_slots=0, filtered=0)
    answers = check.Answers(1)
    answers.add(0, ids.numpy(), d.numpy())
    checks, correct, failed = check.compare(answers, base, batches, ids, 3,
                                            limits, allowed)
    assert correct and failed == 0 and checks["filtered"]["value"] == 0
    odd = ids.clone()
    odd[0, 2] = 1  # a denied row, its distance left as it was
    answers = check.Answers(1)
    answers.add(0, odd.numpy(), d.numpy())
    checks, correct, failed = check.compare(answers, base, batches, ids, 3,
                                            limits, allowed)
    assert not correct and failed == 1
    assert checks["filtered"]["value"] == 1
    checks, _, _ = check.compare(answers, base, batches, ids, 3, limits)
    assert "filtered" not in checks


@pytest.mark.parametrize("name", [CELLS[0], FILTERED])
def test_select_row_is_the_searchs_with_and_without_a_filter(
        name, monkeypatch):
    """select_roofline sizes the row the search hands its select: folded
    without a filter, the index's whole capacity under one."""
    import importlib

    search_mod = importlib.import_module("rabitq_tpu_torch.index.search")
    state = _tiny_state(name)
    # The tiny index's capacity (256) folds at depth 1, to 128 values.
    assert state.index.capacity == 256
    params = state.params._replace(fold_depth=1)
    seen = []
    real = search_mod.cuda_select_candidates

    def select(rough, starts, width, rerank, slot_bits, n):
        seen.append((starts.shape[1], width, rerank))
        return real(rough, starts, width, rerank, slot_bits, n)

    monkeypatch.setattr(search_mod, "cuda_select_candidates", select)
    harness.program_search(state.row_filter)(state.index, state.batches[0],
                                             params)
    select_row = spec.load_reader("select_roofline").__globals__["select_row"]
    want = select_row(state.index, params, state.row_filter is not None)
    assert seen == [want]
    assert want[1] == (256 if name == FILTERED else 128)


def test_stage_pass_runs_the_cells_search(monkeypatch):
    """The stage readers' pass calls the program's search with the cell's
    row filter on every batch."""
    import importlib
    import types

    from benchmark import stages
    from benchmark.trace import TraceView

    search_mod = importlib.import_module("rabitq_tpu_torch.index.search")
    state = _tiny_state(FILTERED)
    seen = []
    real = search_mod.search

    def search(index, queries, params, row_filter=None):
        seen.append(row_filter)
        return real(index, queries, params, row_filter)

    monkeypatch.setattr(search_mod, "search", search)
    host = [("search", 0.0, 1.0), ("wait", 1.0, 2.0)]
    view = TraceView(device=[("k", 0.0, 2.0)], host=host, window=(0.0, 2.0))
    ctx = types.SimpleNamespace(
        trace=view, log=print, work=types.SimpleNamespace(
            index=state.index, params=state.params,
            row_filter=state.row_filter, batches=state.batches,
            traced=[0, 1]))
    stages.stage_pass(ctx)
    assert len(seen) == 3 and all(f is state.row_filter for f in seen)


def test_rough_scan_log_names_the_penalty_share():
    import types

    state = _tiny_state(FILTERED)
    reader = spec.load_reader("rough_scan_roofline")
    g = reader.__globals__
    lines = []
    ctx = types.SimpleNamespace(
        trace=types.SimpleNamespace(device=[("rough_scan_kernel<0>", 0, 4)]),
        launches={g["COUNTER"]: 2, g["PENALTY"]: 2}, log=lines.append,
        work=types.SimpleNamespace(
            index=state.index, params=state.params,
            row_filter=state.row_filter, batches=state.batches,
            traced=[0, 1]))
    assert reader(ctx) > 0
    assert "2 with a penalty: 100.0%" in lines[0]
    ctx.launches = {g["COUNTER"]: 2}
    reader(ctx)
    assert "penalty launches not counted" in lines[1]
