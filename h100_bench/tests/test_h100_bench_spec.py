"""BENCHMARK.json's form (keys, names, units, bounds), and every cell resolved by name to
its configuration, mix, limits and metric files."""

import dataclasses
import json
import re

import pytest
import torch

from h100_bench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert BENCH["command"][1].startswith("h100_bench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_keys():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += CELLS + [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("workload", CELLS)
def test_cell_resolves(workload):
    cell = spec.resolve(workload)
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.per_layer:
        reader = cell.readers[m["name"]]
        assert reader.MOVES == m["moves"] and m["moves"] in e2e
    assert set(cell.limits) == ({"rms_err", "max_err"} if cell.kind == "serve"
                                else {"loss_gap", "grad_gap", "delta_gap", "delta_gap_median"})
    config = next(c for c in BENCH["configs"] if c["name"] == cell.config_name)
    assert config["file"] == f"h100_bench/configs/{cell.config_name}.json"
    assert config["reduced"] == cell.config["reduced"] == []


def test_every_config_is_used_and_metrics_layered():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


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
