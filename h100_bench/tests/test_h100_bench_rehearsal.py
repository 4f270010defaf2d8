"""A run of every cell, cut to a tiny size on the CPU, ends in a
well-formed result; the command refuses to run without a card."""

import json
import subprocess
import sys

import pytest

from h100_bench import run, spec
from h100_bench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 3 * 2**32 + 17


def well_formed(result, cell, traced):
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


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_tiny_run_is_well_formed_and_correct_in_float32(workload, traced):
    cell = tiny_cell(workload, dtype="float32")
    done = run.execute(cell, SEED, 0.5, traced, "cpu", 0.0)
    well_formed(done["result"], cell, traced)
    assert done["result"]["correct"], done["result"]["check"]
    assert "memory_peak_bytes" in done["log"]


def test_the_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", CELLS[0],
                          "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                         cwd=run.ROOT, capture_output=True, text=True)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())
