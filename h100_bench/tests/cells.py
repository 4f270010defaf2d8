"""The checks that hold one cell to the contracts of `spec.py`, each taken
from the cell's own files: `root` is a checkout (the repository, or a
copy of it with a cell added as new files and entries) and `workload` a
cell of its BENCHMARK.json.  The per-cell tests call them on the cells of
the repository, and `test_h100_bench_files.py` on stub cells in a copy,
so that a new cell meets the same checks as the cells that are there."""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from h100_bench import run, spec, weights
from h100_bench.tests.tiny import cut, tiny_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SEED = 3 * 2**32 + 17
# whole top-level module names: the JAX package and JAX, and the port
JAX = {"grlir", "jax", "jaxlib", "flax"}
PROGRAM = {"grlir_torch"}
# the port's modules a run imports, whatever its kind
PORT = ["grlir_torch.engines.inference", "grlir_torch.engines.train",
        "grlir_torch.engines.preprocess", "grlir_torch.optim", "grlir_torch.models.grl"]


def workloads(root: Path = spec.ROOT) -> list:
    return [w["name"] for w in spec.benchmark(root)["workloads"]]


# ------------------------------------------------- BENCHMARK.json's form

def names_units_and_keys(bench: dict) -> None:
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    names += [w["name"] for w in bench["workloads"]] + [c["name"] for c in bench["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    # a cell on four chips only where a quarter of the cells, rounded
    # down, allows it, and always one
    fours = sum(w["chips"] == 4 for w in bench["workloads"])
    assert fours <= max(1, len(bench["workloads"]) // 4)


def configs_used_and_metrics_layered(bench: dict) -> None:
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    layers = {}
    for m in bench["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


# ------------------------------------------------- one cell's files

def resolves(root: Path, workload: str):
    """The cell resolves to its configuration, mix, limits and readers;
    its limits name the numbers its runner's check produces."""
    cell = spec.resolve(workload, root)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        reader = cell.readers[m["name"]]
        assert reader.MOVES == m["moves"] and m["moves"] in e2e
    assert set(cell.limits) == set(cell.runner.NUMBERS)
    config = next(c for c in spec.benchmark(root)["configs"] if c["name"] == cell.config_name)
    assert config["file"] == f"h100_bench/configs/{cell.config_name}.json"
    assert config["reduced"] == cell.config["reduced"]
    return cell


def runner_and_reference(root: Path, workload: str):
    """The runner is cell_<kind>.py of the checkout, the reference the
    module at the configuration's "reference" path."""
    cell = spec.resolve(workload, root)
    root = Path(root).resolve()
    assert Path(cell.runner.__file__).resolve() == root / spec.HERE.name / f"cell_{cell.kind}.py"
    assert Path(cell.reference.__file__).resolve() == (root / cell.config["reference"]).resolve()
    return cell


def draw(entries, kinds, seed: int, device):
    """The draw written out: one randn over every parameter, each slice
    scaled and shifted by its kind's (centre, spread), a convolution's
    weight and bias at torch's default conv spread."""
    sizes = [math.prod(shape) for _, shape, _ in entries]
    centre, spread = [], []
    for _, shape, kind in entries:
        if kind == "conv":
            conv = 1.0 / math.sqrt(3.0 * math.prod(shape[1:]))
        c, s = (0.0, conv) if kind in ("conv", "conv_bias") else kinds[kind]
        centre.append(c)
        spread.append(s)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat.mul_(torch.repeat_interleave(torch.tensor(spread, device=device), counts))
    flat.add_(torch.repeat_interleave(torch.tensor(centre, device=device), counts))
    return {name: t.view(shape) for (name, shape, _), t in
            zip(entries, torch.split(flat, sizes))}


def weights_drawn(root: Path, workload: str, size: str = "published") -> None:
    """`cell_weights` gives one float32 tensor a `param_spec` entry, at its
    shape and in its order, the same for the same seed and another for
    another (a kind of spread 0 stays at its centre), drawn at the
    reference's `KINDS` merged over `weights.KINDS`."""
    cell = tiny_cell(workload, root=root) if size == "rehearsal" else spec.resolve(workload, root)
    ref = cell.reference
    entries = ref.param_spec(cell.model())
    kinds = {**weights.KINDS, **getattr(ref, "KINDS", {})}
    first = weights.cell_weights(cell, 7, "cpu")
    assert list(first) == [name for name, _, _ in entries]
    for name, shape, _ in entries:
        assert first[name].dtype == torch.float32 and tuple(first[name].shape) == tuple(shape)
    again = weights.cell_weights(cell, 7, "cpu")
    assert all(torch.equal(first[k], again[k]) for k in first)
    other = weights.cell_weights(cell, SEED, "cpu")
    for name, _, kind in entries:
        constant = kind not in ("conv", "conv_bias") and kinds[kind][1] == 0
        assert torch.equal(first[name], other[name]) == constant, name
    want = draw(entries, kinds, 7, "cpu")
    assert all(torch.equal(first[k], want[k]) for k in want)


def rehearsal_cut(root: Path, workload: str) -> None:
    """The rehearsal cuts the traffic through the runner's `tiny_traffic`
    and the configuration through the reference's `tiny_model`, or leaves
    the model whole where the reference has none."""
    whole = spec.resolve(workload, root)
    cell = spec.resolve(workload, root)
    runner, ref = cell.runner, cell.reference
    cut_traffic = runner.tiny_traffic
    cut_model = getattr(ref, "tiny_model", None)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(runner, "tiny_traffic", lambda t: {**cut_traffic(t), "cut_by": runner.__name__})
        if cut_model is not None:
            mp.setattr(ref, "tiny_model", lambda c: {**cut_model(c), "cut_by": ref.__name__})
        cut(cell, "float32")
    assert cell.traffic.pop("cut_by") == runner.__name__
    if cut_model is not None:
        assert cell.config.pop("cut_by") == ref.__name__
    else:
        assert cell.config == {**whole.config, "dtype": "float32"}
    tiny = tiny_cell(workload, "float32", root)
    assert (tiny.config, tiny.traffic) == (cell.config, cell.traffic)


def well_formed(result: dict, cell, traced: bool) -> None:
    keys = list(result)
    assert keys[:3] == ["correct", "attempted", "failed"] and keys[-1] == "check"
    assert {"metrics", "device"} <= set(keys)
    assert ("breakdown" in keys) == traced
    assert isinstance(result["correct"], bool)
    assert result["attempted"] > 0 and result["failed"] == 0
    names = {m["name"]: m["unit"] for m in (cell.per_layer if traced else cell.end_to_end)}
    if traced:
        assert set(result["metrics"]) <= set(names)
        assert result["device"]["window_s"] > 0 and "busy_s" in result["device"]
        for part in ("device_ops", "idle_gaps"):
            rows = result["breakdown"][part]
            assert len(rows) <= 10
            assert all(isinstance(n, str) and isinstance(t, float) for n, t in rows)
    else:
        assert set(result["metrics"]) == set(names)
    for name, m in result["metrics"].items():
        assert m["unit"] == names[name] and isinstance(m["value"], float)
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    assert set(result["check"]) == set(cell.limits)
    for v in result["check"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(result)


def tiny_run(root: Path, workload: str, traced: bool) -> None:
    """A run of the cell cut for the rehearsal, in float32 on the CPU,
    ends in a well-formed, correct result."""
    cell = tiny_cell(workload, dtype="float32", root=root)
    done = run.execute(cell, SEED, 0.5, traced, "cpu", 0.0)
    well_formed(done["result"], cell, traced)
    assert done["result"]["correct"], done["result"]["check"]
    assert "memory_peak_bytes" in done["log"]


def no_span_untraced(root: Path, workload: str, seed: int = SEED) -> None:
    """An untraced run records none of the port's spans."""
    from grlir_torch.utils import profiling as P

    P.record_spans(False)
    P.drain_spans()
    try:
        done = run.execute(tiny_cell(workload, dtype="float32", root=root), seed, 0.3, False,
                           "cpu", 0.0)
        assert done["result"]["attempted"] > 0
        assert P.recorded_spans() == []
    finally:
        P.record_spans(False)
        P.drain_spans()


# ------------------------------------------------- imports, by whole name

PROBE = """
import json, sys
sys.path.insert(0, {root!r})
for name in {mods!r}:
    __import__(name)
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def top_level(root: Path, mods) -> set:
    """The top-level names of the modules that importing `mods` loads, in a
    fresh interpreter, the checkout's `h100_bench` first on the path."""
    out = subprocess.run([sys.executable, "-c", PROBE.format(root=str(root), mods=list(mods))],
                         capture_output=True, text=True, check=True, cwd=run.ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def module_name(rel: str) -> str:
    """The module name of a file given by its path from the checkout."""
    return ".".join(Path(rel).with_suffix("").parts)


def imports_nothing_of_the_program(root: Path, mods) -> None:
    assert not top_level(root, mods) & (PROGRAM | JAX)


def run_loads_no_jax(root: Path, kind: str) -> None:
    """The modules a run of the kind imports, the port's included."""
    loaded = top_level(root, ["h100_bench.run", f"h100_bench.cell_{kind}", *PORT])
    assert "grlir_torch" in loaded
    assert not loaded & JAX


def imports(root: Path, workload: str) -> None:
    cell = spec.resolve(workload, root)
    imports_nothing_of_the_program(root, [module_name(cell.config["reference"])])
    run_loads_no_jax(root, cell.kind)


# ------------------------------------------------- all of them

def every_check(root: Path, workload: str) -> None:
    resolves(root, workload)
    runner_and_reference(root, workload)
    for size in ("rehearsal", "published"):
        weights_drawn(root, workload, size)
    rehearsal_cut(root, workload)
    for traced in (False, True):
        tiny_run(root, workload, traced)
    imports(root, workload)
    no_span_untraced(root, workload)
