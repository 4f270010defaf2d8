"""Per-image metric accumulation with exactly-once dedup averaging: the
port's copy of `grlir.metrics.collect`.

Shards can push overlapping (value, index) pairs, as a distributed
sampler's padding repeats samples; `compute` keeps the first occurrence of
each index.  The gather across processes waits for the data-parallel slice
(ROADMAP A8): one process needs none.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np
import torch


def dedup_average(values: np.ndarray, idx: np.ndarray) -> float:
    """Average keeping the first value per unique index."""
    seen = OrderedDict()
    for v, i in zip(np.asarray(values).ravel(), np.asarray(idx).ravel()):
        if i not in seen:
            seen[i] = v
    return float(sum(seen.values()) / len(seen))


class MetricAccumulator:
    """Accumulates named per-image metric vectors tagged with sample indices."""

    def __init__(self, names: Sequence[str]):
        self.names = list(names)
        self.reset()

    def reset(self):
        self._values: Dict[str, List[np.ndarray]] = {n: [] for n in self.names}
        self._idx: List[np.ndarray] = []
        self._files: List[str] = []

    def update(self, values: Dict[str, np.ndarray], idx, filenames=None):
        for n in self.names:
            self._values[n].append(np.atleast_1d(np.asarray(values[n])))
        self._idx.append(np.atleast_1d(np.asarray(idx)))
        if filenames is not None:
            self._files.extend(
                [filenames] if isinstance(filenames, str) else list(filenames))

    def gather_across_hosts(self):
        """With one process there is nothing to gather.  Several ranks of
        torch.distributed raise: their all-gather comes with the
        data-parallel slice (ROADMAP A8)."""
        if (torch.distributed.is_available() and torch.distributed.is_initialized()
                and torch.distributed.get_world_size() > 1):
            raise NotImplementedError(
                "gathering metrics across processes is not ported yet "
                "(ROADMAP A8)")

    def compute(self) -> Dict[str, float]:
        idx = np.concatenate(self._idx) if self._idx else np.zeros(0, np.int64)
        return {
            n: dedup_average(np.concatenate(self._values[n]), idx)
            for n in self.names
            if self._values[n]
        }

    def per_image_table(self) -> str:
        """Per-image metric text block."""
        lines = ["Filename\t" + "\t".join(self.names)]
        idx = np.concatenate(self._idx) if self._idx else np.zeros(0)
        vals = {n: np.concatenate(self._values[n]) for n in self.names if self._values[n]}
        for i in range(len(idx)):
            name = self._files[i] if i < len(self._files) else str(int(idx[i]))
            row = "\t".join(f"{vals[n][i]:.4f}" for n in self.names if n in vals)
            lines.append(f"{name:20}\t{row}")
        return "\n".join(lines) + "\n"
