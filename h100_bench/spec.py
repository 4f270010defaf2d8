"""Resolve a workload of `BENCHMARK.json` by name to the files that make it:

  configs/<config>.json   the model as it is run (the file BENCHMARK.json's
                          `configs` entry names); its "reference" key gives
                          the path, from the checkout's root, of its plain
                          reference module
  traffic/<mix>.json      the traffic mix, read by one general generator;
                          its "kind" k names the runner cell_<k>.py
  limits/<workload>.json  the limit of each number the check compares
  metrics/<metric>.py     the reader of each per-layer metric

so that a later configuration, reference, kind of traffic, cell, mix or
metric is new files and entries, never an edit of a file that is here.

A runner, cell_<kind>.py, defines:

  run(cell, seed, seconds, traced, device, t0) -> dict
      one run of the cell (`run.execute` judges and prints it): "attempted",
      "failed", "numbers" (the check's numbers, named as in the limits),
      "memory_peak_bytes", "end_to_end" (every end-to-end metric of the
      cell by name), "log" (the line printed before the result),
      "timeline" (`trace.Timeline` of the traced window, else None),
      "spans" (the harness's ranges that label idle gaps) and "context"
      (what the readers of `metrics_context.Context.counts` take);
  readings(cell, seeds, control_seeds, seconds, device) -> iterable of dicts
      the readings the limits are set from (`calibrate.py` prints each);
  tiny_traffic(traffic) -> dict
      the mix cut for the CPU rehearsal (`tests/tiny.py`);
  NUMBERS
      the names of the numbers its check produces: the keys of "numbers",
      and of every limits/<workload>.json of its kind.

A reference module defines `param_spec(model) -> [(name, shape, kind)]`,
from which `weights.cell_weights` draws both sides' parameters, and may
define `KINDS`, {kind: (centre, spread)} merged over `weights.KINDS`,
and `tiny_model(config) -> config`, the configuration cut for the CPU
rehearsal (without it the rehearsal runs the model whole); the rest is
what its runner calls.  `tests/cells.py` holds a cell to these contracts
from its files alone.
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
    reference: ModuleType
    runner: ModuleType
    readers: Dict[str, ModuleType] = field(default_factory=dict)

    @property
    def kind(self) -> str:
        return self.traffic["kind"]

    def model(self) -> dict:
        """The model this cell runs: the configuration's sizes with the
        geometry of its kind of traffic, where it gives one."""
        return {**self.config["model"], **self.config.get("geometry", {}).get(self.kind, {})}


def load(path: Path, name: str) -> ModuleType:
    """The module in the file `path`: the package's own import where `name`
    imports from that very file, so that one module object serves every
    caller; else loaded by path under `name` (metric names hold dots, and
    a copy of the harness lies outside the package)."""
    path = path.resolve()
    if not path.is_file():
        raise FileNotFoundError(f"no file {path} for module {name}")
    try:
        found = importlib.util.find_spec(name)
    except ModuleNotFoundError:
        found = None
    if found is not None and found.origin and Path(found.origin).resolve() == path:
        return importlib.import_module(name)
    mod_spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


def reader(name: str, root: Path = ROOT) -> ModuleType:
    """metrics/<name>.py."""
    return load(root / HERE.name / "metrics" / f"{name}.py", f"{HERE.name}.metrics.{name}")


def reference(config_name: str, config: dict, root: Path = ROOT) -> ModuleType:
    """The module at the configuration's "reference" path."""
    rel = config.get("reference")
    if not rel:
        raise KeyError(f"configuration {config_name!r} names no \"reference\" module")
    path = root / rel
    if not path.is_file():
        raise FileNotFoundError(f"configuration {config_name!r}: its reference {rel} is missing")
    return load(path, ".".join(Path(rel).with_suffix("").parts))


def runner(kind: str, root: Path = ROOT) -> ModuleType:
    """cell_<kind>.py, the runner of a kind of traffic."""
    path = root / HERE.name / f"cell_{kind}.py"
    if not path.is_file():
        raise FileNotFoundError(f"traffic of kind {kind!r} has no runner {HERE.name}/{path.name}")
    return load(path, f"{HERE.name}.cell_{kind}")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    bench = benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    files = {c["name"]: c["file"] for c in bench["configs"]}
    base = root / HERE.name
    config = json.loads((root / files[w["config"]]).read_text())
    traffic = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((base / "limits" / f"{workload}.json").read_text())
    end_to_end = [m for m in bench["end_to_end"] if applies(m, workload)]
    per_layer = [m for m in bench["per_layer"] if applies(m, workload)]
    cell = Cell(workload, w["config"], config, traffic, limits, end_to_end, per_layer,
                reference(w["config"], config, root), runner(traffic["kind"], root))
    cell.readers = {m["name"]: reader(m["name"], root) for m in per_layer}
    return cell
