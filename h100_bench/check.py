"""The numbers `correct` compares, each against its limit
(`limits/<workload>.json`, set from the readings `PERF.md` gives).

Serving: every sampled answer against the reference's answer to the same
request: the root mean square and the largest absolute difference over all
their pixels.  Training: the program's first steps against the
reference's: each step's loss, the first gradient's norm a parameter and
each parameter's change after the last checked step, each as the gap
between the two norms over the reference's norm of that parameter or of
the median parameter, whichever is larger: the worst parameter's gap, and
for the change also the median parameter's, which is steady from seed to
seed where the worst is one small parameter's rounding.
"""

from __future__ import annotations

import math
import sys
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

# a parameter whose reference gradient is under this share of the median
# parameter's moves under Adam by round-off alone: its change is not compared
ROUND_OFF_GRAD = 1e-3


def serve_numbers(pairs: Iterable[Tuple[np.ndarray, torch.Tensor]]) -> Dict[str, float]:
    se, n, worst = 0.0, 0, 0.0
    for got, want in pairs:
        d = torch.as_tensor(got, device=want.device).double() - want.double()
        if not bool(torch.isfinite(d).all()):
            return {"rms_err": math.inf, "max_err": math.inf}
        se += float((d * d).sum())
        n += d.numel()
        worst = max(worst, float(d.abs().max()))
    if n == 0:
        return {"rms_err": math.inf, "max_err": math.inf}
    return {"rms_err": math.sqrt(se / n), "max_err": worst}


def leaf_gaps(got: Dict[str, float], want: Dict[str, float], keys) -> Dict[str, float]:
    """Each parameter's gap between the two norms over the larger of the
    reference's norm of it and of the median parameter."""
    keys = list(keys)
    floor = float(np.median([want[k] for k in keys]))
    return {k: abs(got[k] - want[k]) / max(want[k], floor) if math.isfinite(got[k])
            else math.inf for k in keys}


def compared(want: dict):
    """The parameters whose change is compared: all but those whose
    reference gradient is under ROUND_OFF_GRAD of the median's."""
    g = want["grad_norms"]
    gmed = float(np.median(list(g.values())))
    return [k for k in g if g[k] >= ROUND_OFF_GRAD * gmed]


def train_numbers(got: dict, want: dict) -> Dict[str, float]:
    if len(got["losses"]) != len(want["losses"]):
        raise ValueError("the program and the reference took different step counts")
    loss_gap = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                   for a, b in zip(got["losses"], want["losses"]))
    g = want["grad_norms"]
    grad = leaf_gaps(got["grad_norms"], g, g)
    delta = leaf_gaps(got["delta_norms"], want["delta_norms"], compared(want))
    return {"loss_gap": loss_gap,
            "grad_gap": max(grad.values()),
            "delta_gap": max(delta.values()),
            "delta_gap_median": float(np.median(list(delta.values())))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    ok = all(v <= limits[k] for k, v in numbers.items())
    return ok, shown


def report(shown: dict) -> None:
    """Each number beside its limit, as the run's last lines on stderr."""
    for k, v in shown.items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
