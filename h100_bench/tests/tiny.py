"""A cell of BENCHMARK.json cut to a size the CPU runs in a second: the
same kinds of layers (window and anchored stripe halves, CAB, the x4
tail), one stage of four blocks at embed 24, a few small images or
patches.  Its limits are the cell's own."""

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
    t = dict(cell.traffic)
    if t["kind"] == "serve":
        t.update(shapes=[[32, 32]] if len(t["shapes"]) == 1 else [[32, 32], [24, 40]],
                 pool=2, shape_bucket=16, sample_per_shape=1)
    else:
        t.update(batch=2, lr_patch=16, pool=4, warmup_steps=1)
    cell.traffic = t
    return cell
