"""A run of every cell, cut to a tiny size on the CPU, ends in a
well-formed result; the command refuses to run without a card."""

import subprocess
import sys

import pytest

from h100_bench import run, spec
from h100_bench.tests import cells

CELLS = cells.workloads()
SEED = cells.SEED


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_is_well_formed_and_correct_in_float32(workload, traced):
    cells.tiny_run(spec.ROOT, workload, traced)


def test_the_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=run.ROOT, capture_output=True, text=True)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
