"""On the card: a short run of each cell from a copy of the committed
files ends in a correct, well-formed line; a copy that holds only
BENCHMARK.json and h100_bench/ refuses to run.  Skipped without a card."""

import json
import shutil
import subprocess
import sys

import pytest
import torch

from h100_bench import run, spec
from h100_bench.tests.cells import well_formed

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def command(workload):
    return [sys.executable, "h100_bench/run.py", "--workload", workload,
            "--seed", "4294967311", "--seconds", "2", "--trace", "0"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_short_run_on_the_card(workload):
    need_card()
    out = subprocess.run(command(workload), cwd=run.ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.splitlines()[-1])
    well_formed(result, spec.resolve(workload), False)
    assert result["correct"], result["check"]


@pytest.mark.cuda
def test_only_the_benchmark_files_refuse_to_run(tmp_path):
    need_card()
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.ROOT / "h100_bench", tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(command(CELLS[0]), cwd=tmp_path,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
