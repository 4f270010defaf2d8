"""Step timing and a JSONL scalar log (the `StepTimer` and `MetricsLogger`
of `grlir.utils.profiling`; its trace and cost-analysis parts wait for
ROADMAP A10)."""

from __future__ import annotations

import json
import time


class StepTimer:
    """Rolling steps/sec over the last `window` ticks."""

    def __init__(self, window: int = 100):
        self.window = window
        self._times = []

    def tick(self):
        self._times.append(time.perf_counter())
        if len(self._times) > self.window:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        return (len(self._times) - 1) / (self._times[-1] - self._times[0])


class MetricsLogger:
    """JSONL scalar logger: one line an event."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "a", buffering=1)

    def log(self, step: int, **scalars):
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self):
        self._f.close()
