"""Per-image metric accumulation with exactly-once dedup averaging: the
port's copy of `grlir.metrics.collect`.

Shards can push overlapping (value, index) pairs, as a distributed
sampler's padding repeats samples; `compute` keeps the first occurrence of
each index.  `gather_across_hosts` all-gathers every process's vectors
first.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Sequence

import numpy as np


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
        """All-gather the (value, index) vectors of every process, in rank
        order, as grlir does across hosts; `compute`'s dedup keeps each
        index once.  The processes may hold vectors of unequal lengths.
        Without a process group there is nothing to gather."""
        from grlir_torch.parallel import mesh

        if not mesh.grouped():
            return
        # float64 and int64 on every process, whatever a metric returns and
        # even where a process holds no vector (exact for fp32 values)
        for n in self.names:
            local = np.concatenate(self._values[n]) if self._values[n] else np.zeros(0)
            self._values[n] = [np.concatenate(mesh.all_gather_ragged(local.astype(np.float64)))]
        local_idx = np.concatenate(self._idx) if self._idx else np.zeros(0)
        self._idx = [np.concatenate(mesh.all_gather_ragged(local_idx.astype(np.int64)))]

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
