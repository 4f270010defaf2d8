"""A cell resolves from data alone: its configuration names its reference
module and its kind of traffic its runner, cell_<kind>.py, so that a new
configuration, reference, kind of traffic, runner and metric are new files
and entries in a copy of the harness, with no file that is there edited,
and the new cell meets every per-cell check (`cells.py`) as today's cells
do.  The weights drawn through the cell's reference are bit-equal to the
draw the harness made before references were named by the configuration,
and the rehearsal's cut of today's cells is the one it made before the
reference and the runner made it."""

import copy
import hashlib
import importlib
import json
import math
import shutil
from pathlib import Path

import pytest
import torch

from h100_bench import cell_serve, cell_train, run, spec
from h100_bench.reference import grl
from h100_bench.tests import cells
from h100_bench.tests.tiny import tiny_cell
from h100_bench.weights import cell_weights

CELLS = cells.workloads()
RUNNERS = {"grl_s_x4.sr_256": cell_serve, "grl_base_x4.sr_256": cell_serve,
           "grl_base_x4.train_sr_p64": cell_train, "grl_s_x4.sr_assorted": cell_serve}
# the cells whose weights are GRL's draw
GRL_CELLS = [w for w in CELLS
             if spec.resolve(w).config["reference"] == "h100_bench/reference/grl.py"]


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_resolves_to_its_runner_and_reference(workload):
    cell = cells.runner_and_reference(spec.ROOT, workload)
    if workload in RUNNERS:
        assert cell.runner is RUNNERS[workload]
        assert cell.runner is importlib.import_module(f"h100_bench.cell_{cell.kind}")
        assert cell.reference is grl
        assert Path(cell.reference.__file__) == spec.HERE / "reference" / "grl.py"


# ------------------------------------------------- the parent's weights

# (centre, spread) of each kind as the draw stood before the reference
# was the configuration's; `cells.draw` is that draw, copied as it was
PARENT_KINDS = {
    "linear": (0.0, 0.02),
    "bias": (0.0, 0.02),
    "norm_weight": (1.0, 0.02),
    "norm_bias": (0.0, 0.02),
    "logit_scale": (math.log(10.0), 0.1),
    "cpb_in": (0.0, 0.5),
    "cpb_in_bias": (0.0, 0.5),
    "cpb_out": (0.0, 0.05),
}


def parent_make_weights(m, seed, device):
    return cells.draw(grl.param_spec(m), PARENT_KINDS, seed, device)


@pytest.mark.parametrize("size", ["rehearsal", "published"])
@pytest.mark.parametrize("workload", GRL_CELLS)
def test_weights_are_the_parents_bit_for_bit(workload, size):
    cell = tiny_cell(workload) if size == "rehearsal" else spec.resolve(workload)
    for seed in (7, 3 * 2**32 + 17):
        mine = cell_weights(cell, seed, "cpu")
        theirs = parent_make_weights(cell.model(), seed, "cpu")
        assert list(mine) == list(theirs)
        assert all(torch.equal(mine[k], theirs[k]) for k in mine)


@pytest.mark.parametrize("size", ["rehearsal", "published"])
@pytest.mark.parametrize("workload", CELLS)
def test_weights_are_one_tensor_an_entry_drawn_at_its_kind(workload, size):
    cells.weights_drawn(spec.ROOT, workload, size)


# ------------------------------------------------- the CPU rehearsal

@pytest.mark.parametrize("workload", CELLS)
def test_the_rehearsal_cuts_the_traffic_through_its_runner(workload):
    cells.rehearsal_cut(spec.ROOT, workload)


def parent_tiny_config(config, dtype):
    """The rehearsal's cut of a configuration as the harness made it
    before the reference's `tiny_model` made it, copied as it was."""
    cfg = copy.deepcopy(config)
    cfg["dtype"] = dtype
    cfg["model"].update(embed_dim=24, depths=[4], num_heads_window=[2], num_heads_stripe=[2])
    for g in cfg["geometry"].values():
        g["window_size"] = 8
        if g["stripe_groups"][1] is None:
            g["stripe_size"] = [16, 16]
    return cfg


# each runner's cut of the mix as the parent's `tiny_traffic` made it
PARENT_TINY_TRAFFIC = {
    "serve": lambda mix: {**mix, "shapes": [[32, 32]] if len(mix["shapes"]) == 1
                          else [[32, 32], [24, 40]],
                          "pool": 2, "shape_bucket": 16, "sample_per_shape": 1},
    "train": lambda mix: {**mix, "batch": 2, "lr_patch": 16, "pool": 4, "warmup_steps": 1},
}


@pytest.mark.parametrize("workload", list(RUNNERS))
def test_the_rehearsal_cut_of_todays_cells_is_the_parents(workload):
    whole = spec.resolve(workload)
    for dtype in ("bfloat16", "float32"):
        tiny = tiny_cell(workload, dtype)
        assert tiny.config == parent_tiny_config(whole.config, dtype)
        assert tiny.traffic == PARENT_TINY_TRAFFIC[whole.kind](whole.traffic)


# ------------------------------------------------- a new cell as new files

STUB = "stub.stub"
# the second stub cell reports an end-to-end metric that is there
STUB_TRAIN = "stub.stub_train"

STUB_REFERENCE = '''"""A stub reference: a vector of weights drawn at a kind of its own, at
spread 0, and a vector of biases drawn at one of `weights.KINDS`."""

KINDS = {"stub": (2.0, 0.0)}


def param_spec(m):
    return [("w", (m["n"],), "stub"), ("b", (m["n"],), "bias")]


def answer(P, x):
    return x * P["w"].sum() + P["b"].sum()
'''

STUB_RUNNER = '''"""A stub runner: the reference's answer to a row of numbers, repeated for
the window, checked against its closed form.  It reports each end-to-end
metric of its cell as calls a second."""

import time

import torch

from h100_bench import trace as tr
from h100_bench.weights import cell_weights

NUMBERS = ("gap",)


def run(cell, seed, seconds, traced, device, t0):
    device = torch.device(device)
    P = cell_weights(cell, seed, device)
    x = torch.arange(cell.traffic["rows"], dtype=torch.float32, device=device)
    setup_s = time.perf_counter() - t0
    prof = tr.profiler(device) if traced else None
    marks = tr.Marks()
    if prof is not None:
        prof.start()
    marks.start(tr.WINDOW)
    w0, n = time.perf_counter(), 0
    while n == 0 or time.perf_counter() < w0 + seconds:
        with marks.span("stub"):
            y = cell.reference.answer(P, x)
        n += 1
    window_s = time.perf_counter() - w0
    marks.stop(tr.WINDOW)
    timeline = None
    if prof is not None:
        prof.stop()
        timeline = tr.reduce(prof, marks)
    gap = float((y - (x * 2.0 * cell.model()["n"] + P["b"].sum())).abs().max())
    rates = {m["name"]: n / window_s for m in cell.end_to_end if m["name"] != "setup_s"}
    return {"attempted": n, "failed": 0, "numbers": {"gap": gap}, "memory_peak_bytes": 0,
            "end_to_end": {**rates, "setup_s": setup_s},
            "log": f"calls {n}; memory_peak_bytes 0", "timeline": timeline, "spans": ["stub"],
            "context": {"calls": n}}


def readings(cell, seeds, control_seeds, seconds, device):
    for seed in seeds:
        yield {"kind": "program", "seed": seed,
               "numbers": run(cell, seed, seconds, False, device, 0.0)["numbers"]}


def tiny_traffic(mix):
    return {**mix, "rows": 4}
'''

STUB_READER = '''"""Mean of the traced window's stub calls on the host's clock."""

MOVES = "{moves}"


def read(ctx):
    d = ctx.timeline.spans("stub") if ctx.timeline is not None else []
    return 1e-6 * sum(b - a for a, b in d) / len(d) if d else None
'''


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def stub_tree(tmp_path: Path, config=None, kind="stub") -> Path:
    """A copy of the harness with two stub cells added as new files and
    entries: `stub.stub`, with an end-to-end metric of its own, and
    `stub.stub_train`, which reports `train_samples_s`, as a new model's
    training cell would; each with a per-layer metric of its own."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    h = tmp_path / "h100_bench"
    new = {
        "configs/stub.json": json.dumps(config if config is not None else {
            "reference": "h100_bench/reference/stub.py", "reduced": [], "dtype": "float32",
            "model": {"n": 8}}),
        "reference/stub.py": STUB_REFERENCE,
        "traffic/stub.json": json.dumps({"kind": kind, "rows": 64}),
        "traffic/stub_train.json": json.dumps({"kind": kind, "rows": 32}),
        "cell_stub.py": STUB_RUNNER,
        f"limits/{STUB}.json": json.dumps({"gap": 0.0}),
        f"limits/{STUB_TRAIN}.json": json.dumps({"gap": 0.0}),
        "metrics/stub_ms.py": STUB_READER.replace("{moves}", "stub_per_s"),
        "metrics/stub_ms.train.py": STUB_READER.replace("{moves}", "train_samples_s"),
    }
    for rel, text in new.items():
        assert not (h / rel).exists(), rel
        (h / rel).write_text(text)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub", "source": "https://example.org/stub",
                             "file": "h100_bench/configs/stub.json", "reduced": [],
                             "why": "a stub model"})
    for name, traffic in ((STUB, "stub"), (STUB_TRAIN, "stub_train")):
        bench["workloads"].append({"name": name, "config": "stub", "traffic": traffic,
                                   "chips": 1, "why": "a stub cell"})
    bench["end_to_end"].append({"name": "stub_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock", "workloads": [STUB]})
    train = next(m for m in bench["end_to_end"] if m["name"] == "train_samples_s")
    train["workloads"].append(STUB_TRAIN)
    for name, moves, cell in (("stub_ms", "stub_per_s", STUB),
                              ("stub_ms.train", "train_samples_s", STUB_TRAIN)):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower",
                                   "source": "host_clock", "layer": "stub", "moves": moves,
                                   "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp_path


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    before = digests(spec.HERE)
    root = stub_tree(tmp_path)
    copied = digests(root / "h100_bench")
    cell = spec.resolve(STUB, root)
    assert Path(cell.runner.__file__) == root / "h100_bench" / "cell_stub.py"
    assert Path(cell.reference.__file__) == root / "h100_bench" / "reference" / "stub.py"
    assert torch.equal(cell_weights(cell, 11, "cpu")["w"], torch.full((8,), 2.0))
    plain = run.execute(cell, 11, 0.05, False, "cpu", 0.0)["result"]
    assert plain["correct"] and plain["attempted"] > 0
    assert set(plain["metrics"]) == {"stub_per_s", "setup_s"}
    traced = run.execute(cell, 12, 0.05, True, "cpu", 0.0)["result"]
    assert traced["correct"] and set(traced["metrics"]) == {"stub_ms"}
    assert traced["check"] == {"gap": {"value": 0.0, "limit": 0.0}}
    cells.every_check(root, STUB)
    # every file of the harness is as it was: only new files were added
    after = digests(root / "h100_bench")
    assert {k: after[k] for k in before} == before == {k: copied[k] for k in before}
    assert digests(spec.HERE) == before


def test_a_new_cell_may_report_an_end_to_end_metric_that_is_there(tmp_path):
    before = digests(spec.HERE)
    root = stub_tree(tmp_path)
    copied = digests(root / "h100_bench")
    bench = spec.benchmark(root)
    cells.names_units_and_keys(bench)
    cells.configs_used_and_metrics_layered(bench)
    cell = spec.resolve(STUB_TRAIN, root)
    assert [m["name"] for m in cell.end_to_end] == ["train_samples_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["stub_ms.train"]
    plain = run.execute(cell, 13, 0.05, False, "cpu", 0.0)["result"]
    assert plain["correct"] and set(plain["metrics"]) == {"train_samples_s", "setup_s"}
    traced = run.execute(cell, 14, 0.05, True, "cpu", 0.0)["result"]
    assert traced["correct"] and set(traced["metrics"]) == {"stub_ms.train"}
    cells.every_check(root, STUB_TRAIN)
    # the cell that reported the metric before reports it as it did
    train = spec.resolve("grl_base_x4.train_sr_p64", root)
    assert [m["name"] for m in train.end_to_end] == ["train_samples_s", "setup_s"]
    assert "stub_ms.train" not in train.readers
    after = digests(root / "h100_bench")
    assert {k: after[k] for k in before} == before == {k: copied[k] for k in before}
    assert digests(spec.HERE) == before


def test_a_configuration_without_a_reference_is_refused_by_name(tmp_path):
    root = stub_tree(tmp_path, config={"dtype": "float32", "model": {"n": 8}})
    with pytest.raises(KeyError, match="configuration .*stub.*reference"):
        spec.resolve(STUB, root)


def test_a_missing_reference_file_is_refused_by_name(tmp_path):
    root = stub_tree(tmp_path, config={"reference": "h100_bench/reference/nothing.py",
                                       "model": {"n": 8}})
    with pytest.raises(FileNotFoundError, match="'stub'.*reference/nothing.py"):
        spec.resolve(STUB, root)


def test_a_kind_without_a_runner_names_the_missing_file(tmp_path):
    root = stub_tree(tmp_path, kind="nothing")
    with pytest.raises(FileNotFoundError, match="cell_nothing.py"):
        spec.resolve(STUB, root)
