"""A cell of BENCHMARK.json and the files it names, found by name."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict      # configs/<config>.json
    traffic: dict     # traffic/<traffic>.json
    limits: dict      # limits/<cell>.json
    end_to_end: tuple  # names of the end-to-end metrics the cell reports
    per_layer: tuple   # names of the per-layer metrics the cell reports
    units: dict        # metric -> unit, as BENCHMARK.json gives it


def _read(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reported(metrics, name):
    return tuple(m["name"] for m in metrics
                 if name in m.get("workloads", (name,)))


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its files."""
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has "
                         f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    return Cell(
        name=name,
        chips=w["chips"],
        config=_read(root / configs[w["config"]]["file"]),
        traffic=_read(HERE / "traffic" / f"{w['traffic']}.json"),
        limits=_read(HERE / "limits" / f"{name}.json"),
        end_to_end=_reported(bench["end_to_end"], name),
        per_layer=_reported(bench["per_layer"], name),
        units={m["name"]: m["unit"]
               for m in bench["end_to_end"] + bench["per_layer"]},
    )


def load_reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
