"""Results aggregation: pivot the validation CSV into a results table (the
port's copy of `grlir.utils.report`)."""

from __future__ import annotations

import csv
from collections import OrderedDict
from typing import Dict, List


def parse_csv(path: str) -> str:
    """Pivot results.csv (tag,val_set,step,metric...) into a text table with
    one row per val_set at its latest step."""
    with open(path) as f:
        rows = list(csv.reader(f))
    if not rows:
        return ""
    header = rows[0]
    metric_cols = header[3:]

    latest: "OrderedDict[str, List[str]]" = OrderedDict()
    for row in rows[1:]:
        if not row:
            continue
        latest[row[1]] = row  # keep the last (latest-step) row per val_set

    widths = [max(12, len(c) + 2) for c in ["val_set", "step"] + metric_cols]
    lines = ["".join(c.ljust(w) for c, w in
                     zip(["val_set", "step"] + metric_cols, widths))]
    for val_set, row in latest.items():
        cells = [val_set, row[2]] + row[3:]
        lines.append("".join(c.ljust(w) for c, w in zip(cells, widths)))
    return "\n".join(lines) + "\n"
