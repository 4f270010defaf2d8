"""A cell resolves from data alone: its configuration names its reference
module and its kind of traffic its runner, cell_<kind>.py, so that a new
configuration, reference, kind of traffic, runner and metric are new files
and entries in a copy of the harness, with no file that is there edited.
The weights drawn through the cell's reference are bit-equal to the draw
the harness made before references were named by the configuration."""

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
from h100_bench.tests.tiny import tiny_cell
from h100_bench.weights import cell_weights

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
RUNNERS = {"grl_s_x4.sr_256": cell_serve, "grl_base_x4.sr_256": cell_serve,
           "grl_base_x4.train_sr_p64": cell_train, "grl_s_x4.sr_assorted": cell_serve}


@pytest.mark.parametrize("workload", CELLS)
def test_each_cell_resolves_to_its_runner_and_reference(workload):
    cell = spec.resolve(workload)
    assert cell.runner is RUNNERS[workload]
    assert cell.runner is importlib.import_module(f"h100_bench.cell_{cell.kind}")
    assert cell.reference is grl
    assert Path(cell.reference.__file__) == spec.HERE / "reference" / "grl.py"


# ------------------------------------------------- the parent's weights

# (centre, spread) of each kind as the draw stood before the reference
# was the configuration's, and the draw itself, copied as it was
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
    spec_ = grl.param_spec(m)
    sizes = [math.prod(shape) for _, shape, _ in spec_]
    centre, spread = [], []
    for _, shape, kind in spec_:
        if kind == "conv":
            conv = 1.0 / math.sqrt(3.0 * math.prod(shape[1:]))
        c, s = (0.0, conv) if kind in ("conv", "conv_bias") else PARENT_KINDS[kind]
        centre.append(c)
        spread.append(s)
    counts = torch.tensor(sizes, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    flat.mul_(torch.repeat_interleave(torch.tensor(spread, device=device), counts))
    flat.add_(torch.repeat_interleave(torch.tensor(centre, device=device), counts))
    return {name: t.view(shape) for (name, shape, _), t in
            zip(spec_, torch.split(flat, sizes))}


@pytest.mark.parametrize("size", ["rehearsal", "published"])
@pytest.mark.parametrize("workload", CELLS)
def test_weights_are_the_parents_bit_for_bit(workload, size):
    cell = tiny_cell(workload) if size == "rehearsal" else spec.resolve(workload)
    for seed in (7, 3 * 2**32 + 17):
        mine = cell_weights(cell, seed, "cpu")
        theirs = parent_make_weights(cell.model(), seed, "cpu")
        assert list(mine) == list(theirs)
        assert all(torch.equal(mine[k], theirs[k]) for k in mine)


# ------------------------------------------------- the CPU rehearsal

@pytest.mark.parametrize("workload", CELLS)
def test_the_rehearsal_cuts_the_traffic_through_its_runner(workload, monkeypatch):
    runner = spec.resolve(workload).runner
    cut = runner.tiny_traffic
    monkeypatch.setattr(runner, "tiny_traffic", lambda t: {**cut(t), "cut_by": runner.__name__})
    assert tiny_cell(workload).traffic["cut_by"] == runner.__name__


# ------------------------------------------------- a new cell as new files

STUB_REFERENCE = '''"""A stub reference: one vector of weights, each drawn at its own kind."""

KINDS = {"stub": (2.0, 0.0)}


def param_spec(m):
    return [("w", (m["n"],), "stub")]


def answer(P, x):
    return x * P["w"].sum()
'''

STUB_RUNNER = '''"""A stub runner: the reference's answer to a row of numbers, repeated for
the window, checked against its closed form."""

import time

import torch

from h100_bench import trace as tr
from h100_bench.weights import cell_weights


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
    gap = float((y - x * 2.0 * cell.model()["n"]).abs().max())
    return {"attempted": n, "failed": 0, "numbers": {"gap": gap}, "memory_peak_bytes": 0,
            "end_to_end": {"stub_per_s": n / window_s, "setup_s": setup_s},
            "log": f"calls {n}", "timeline": timeline, "spans": ["stub"],
            "context": {"calls": n}}


def readings(cell, seeds, control_seeds, seconds, device):
    for seed in seeds:
        yield {"kind": "program", "seed": seed,
               "numbers": run(cell, seed, seconds, False, device, 0.0)["numbers"]}


def tiny_traffic(mix):
    return {**mix, "rows": 4}
'''

STUB_READER = '''"""Mean of the traced window's stub calls on the host's clock."""

MOVES = "stub_per_s"


def read(ctx):
    d = ctx.timeline.spans("stub") if ctx.timeline is not None else []
    return 1e-6 * sum(b - a for a, b in d) / len(d) if d else None
'''


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def stub_tree(tmp_path: Path, config=None, kind="stub") -> Path:
    """A copy of the harness with a stub cell added as new files and entries."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    h = tmp_path / "h100_bench"
    new = {
        "configs/stub.json": json.dumps(config if config is not None else {
            "reference": "h100_bench/reference/stub.py", "dtype": "float32",
            "model": {"n": 8}}),
        "reference/stub.py": STUB_REFERENCE,
        "traffic/stub.json": json.dumps({"kind": kind, "rows": 64}),
        "cell_stub.py": STUB_RUNNER,
        "limits/stub.stub.json": json.dumps({"gap": 0.0}),
        "metrics/stub_ms.py": STUB_READER,
    }
    for rel, text in new.items():
        assert not (h / rel).exists(), rel
        (h / rel).write_text(text)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "stub", "source": "https://example.org/stub",
                             "file": "h100_bench/configs/stub.json", "reduced": [],
                             "why": "a stub model"})
    bench["workloads"].append({"name": "stub.stub", "config": "stub", "traffic": "stub",
                               "chips": 1, "why": "a stub cell"})
    bench["end_to_end"].append({"name": "stub_per_s", "unit": "1/s", "better": "higher",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["stub.stub"]})
    bench["per_layer"].append({"name": "stub_ms", "unit": "ms", "better": "lower",
                               "source": "host_clock", "layer": "stub",
                               "moves": "stub_per_s", "workloads": ["stub.stub"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp_path


def test_a_new_cell_is_new_files_and_entries(tmp_path):
    before = digests(spec.HERE)
    root = stub_tree(tmp_path)
    copied = digests(root / "h100_bench")
    cell = spec.resolve("stub.stub", root)
    assert Path(cell.runner.__file__) == root / "h100_bench" / "cell_stub.py"
    assert Path(cell.reference.__file__) == root / "h100_bench" / "reference" / "stub.py"
    assert torch.equal(cell_weights(cell, 11, "cpu")["w"], torch.full((8,), 2.0))
    plain = run.execute(cell, 11, 0.05, False, "cpu", 0.0)["result"]
    assert plain["correct"] and plain["attempted"] > 0
    assert set(plain["metrics"]) == {"stub_per_s", "setup_s"}
    traced = run.execute(cell, 12, 0.05, True, "cpu", 0.0)["result"]
    assert traced["correct"] and set(traced["metrics"]) == {"stub_ms"}
    assert traced["check"] == {"gap": {"value": 0.0, "limit": 0.0}}
    # every file of the harness is as it was: only new files were added
    after = digests(root / "h100_bench")
    assert {k: after[k] for k in before} == before == {k: copied[k] for k in before}
    assert digests(spec.HERE) == before


def test_a_configuration_without_a_reference_is_refused_by_name(tmp_path):
    root = stub_tree(tmp_path, config={"dtype": "float32", "model": {"n": 8}})
    with pytest.raises(KeyError, match="configuration .*stub.*reference"):
        spec.resolve("stub.stub", root)


def test_a_missing_reference_file_is_refused_by_name(tmp_path):
    root = stub_tree(tmp_path, config={"reference": "h100_bench/reference/nothing.py",
                                       "model": {"n": 8}})
    with pytest.raises(FileNotFoundError, match="'stub'.*reference/nothing.py"):
        spec.resolve("stub.stub", root)


def test_a_kind_without_a_runner_names_the_missing_file(tmp_path):
    root = stub_tree(tmp_path, kind="nothing")
    with pytest.raises(FileNotFoundError, match="cell_nothing.py"):
        spec.resolve("stub.stub", root)
