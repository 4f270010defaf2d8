"""A cell of BENCHMARK.json cut to a size the CPU runs in a second: the
same kinds of layers (window and anchored stripe halves, CAB, the x4
tail), one stage of four blocks at embed 24, and the traffic its runner's
`tiny_traffic` cuts to a few small images or patches.  Its limits are the
cell's own."""

from __future__ import annotations

import copy

from h100_bench import spec


def tiny_cell(workload: str, dtype: str = "bfloat16"):
    cell = spec.resolve(workload)
    cfg = copy.deepcopy(cell.config)
    cfg["dtype"] = dtype
    cfg["model"].update(embed_dim=24, depths=[4], num_heads_window=[2], num_heads_stripe=[2])
    for g in cfg["geometry"].values():
        g["window_size"] = 8
        if g["stripe_groups"][1] is None:
            g["stripe_size"] = [16, 16]
    cell.config = cfg
    cell.traffic = cell.runner.tiny_traffic(cell.traffic)
    return cell
