"""Host ms a BSR train sample, measured as `chip_smoke.py`'s gan phase
measures it: the synthetic BSR root of `chip_smoke.write_bsr_root`, a
`BSRDataset` at the GAN cell's patch (LR 128^2), `seed(0)`, then the first
`items` samples timed one by one in this process (crop 400, jitter, USM,
degradation with the camera ISP, JPEG, patch).  Host only; no card needed.

    python3 -m grlir_torch.bsr_host_time [items] [label]

times the tree it runs from; `PYTHONPATH=<tree> python3 <this file>`
times another tree's `grlir_torch` (its `chip_smoke.py` writes the root),
so that two trees compare on one machine.  Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time


def sample_ms(items: int):
    """ms of each of the first `items` BSR train samples of the root at
    $GRLIR_DATA_ROOT, and the last sample."""
    from grlir_torch import gan_cells as gc
    from grlir_torch.data.base import TRAIN
    from grlir_torch.data.bsr import BSRDataset
    from grlir_torch.data.tasks import TaskConfig

    ds = BSRDataset(TaskConfig(name="bsr", dataset="ost", scale=4, patch_size=gc.LR_HW), TRAIN)
    ds.seed(0)
    ms = []
    for i in range(items):
        t0 = time.perf_counter()
        item = ds[i % len(ds.img_info)]
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms, item


def main(argv) -> int:
    items = int(argv[0]) if argv else 8
    label = argv[1] if len(argv) > 1 else ""
    import grlir_torch

    tree = os.path.dirname(os.path.dirname(os.path.abspath(grlir_torch.__file__)))
    sys.path.insert(0, tree)
    import chip_smoke

    with tempfile.TemporaryDirectory() as tmp:
        os.environ["GRLIR_DATA_ROOT"] = os.path.join(tmp, "data")
        os.environ["GRLIR_CACHE_DIR"] = os.path.join(tmp, "cache")
        chip_smoke.write_bsr_root(os.environ["GRLIR_DATA_ROOT"])
        ms, _ = sample_ms(items)
    print(json.dumps({"label": label, "tree": tree, "items": items, "ms": ms,
                      "median_ms": statistics.median(ms),
                      "median_ms_after_first": statistics.median(ms[1:]) if items > 1 else None}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
