"""A cell of BENCHMARK.json cut to a size the CPU runs in a second: the
configuration through its reference's `tiny_model` (whole where the
reference has none), and the traffic through its runner's `tiny_traffic`,
to a few small images or patches.  Its limits are the cell's own."""

from __future__ import annotations

import copy

from h100_bench import spec


def cut(cell, dtype: str = "bfloat16"):
    """`cell` with its configuration and traffic cut for the rehearsal."""
    cfg = copy.deepcopy(cell.config)
    cfg["dtype"] = dtype
    tiny_model = getattr(cell.reference, "tiny_model", None)
    cell.config = tiny_model(cfg) if tiny_model is not None else cfg
    cell.traffic = cell.runner.tiny_traffic(cell.traffic)
    return cell


def tiny_cell(workload: str, dtype: str = "bfloat16", root=spec.ROOT):
    return cut(spec.resolve(workload, root), dtype)
