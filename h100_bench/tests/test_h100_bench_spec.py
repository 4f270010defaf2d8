"""BENCHMARK.json's form (keys, names, units, bounds), and every cell resolved by name to
its configuration, mix, limits and metric files."""

import dataclasses
import json

import pytest
import torch

from h100_bench import spec
from h100_bench.tests import cells

BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
# the numbers today's kinds compare, and the configurations at published size
NUMBERS = {"serve": {"rms_err", "max_err"},
           "train": {"loss_gap", "grad_gap", "delta_gap", "delta_gap_median"}}
UNREDUCED = {"grl_s_x4", "grl_base_x4"}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert BENCH["command"][1].startswith("h100_bench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    cells.names_units_and_keys(BENCH)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = cells.resolves(spec.ROOT, workload)
    if cell.kind in NUMBERS:
        assert set(cell.limits) == NUMBERS[cell.kind]
    if cell.config_name in UNREDUCED:
        assert cell.config["reduced"] == []


def test_every_config_is_used_and_metrics_layered():
    cells.configs_used_and_metrics_layered(BENCH)


@pytest.mark.parametrize("config", ["grl_s_x4", "grl_base_x4"])
def test_reference_names_every_parameter_of_the_port(config):
    """The reference's parameter list is the port's state dict, name for
    name and shape for shape, at every geometry the configuration runs."""
    from grlir_torch.models.grl import GRL, GRLConfig

    for w in CELLS:
        cell = spec.resolve(w)
        if cell.config_name != config:
            continue
        known = {f.name for f in dataclasses.fields(GRLConfig)}
        m = cell.model()
        cfg = GRLConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in m.items() if k in known})
        port = GRL(cfg, device="meta").state_dict()
        mine = {n: s for n, s, _ in cell.reference.param_spec(m)}
        assert set(mine) == set(port)
        assert all(tuple(port[n].shape) == s for n, s in mine.items())
        assert sum(torch.Size(s).numel() for s in mine.values()) == cell.config["parameters"]
