"""Resolve a workload of `BENCHMARK.json` by name to the files that make it:

  configs/<config>.json   the model as it is run (GRL's published sizes,
                          one geometry per kind of traffic)
  traffic/<mix>.json      the traffic mix, read by one general generator
  limits/<workload>.json  the limit of each number the check compares
  metrics/<metric>.py     the reader of each per-layer metric

so that a later cell, mix or metric is new files and entries, never an
edit of a file that is here.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    config_name: str
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]
    readers: Dict[str, ModuleType] = field(default_factory=dict)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def model(self) -> dict:
        """The GRL this cell runs: the configuration's sizes with the
        geometry of its kind of traffic."""
        return {**self.config["model"], **self.config["geometry"][self.kind]}


def reader(name: str) -> ModuleType:
    """metrics/<name>.py, loaded by path (metric names hold dots)."""
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"h100_bench.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    config = json.loads((HERE / "configs" / f"{w['config']}.json").read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{workload}.json").read_text())
    end_to_end = [m for m in bench["end_to_end"] if applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if applies(m, workload)]
    cell = Cell(workload, w["config"], config, traffic, limits, end_to_end, per_layer)
    cell.readers = {m["name"]: reader(m["name"]) for m in per_layer}
    return cell
