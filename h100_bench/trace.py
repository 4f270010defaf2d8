"""One traced window: the device's timeline from `torch.profiler`, reduced
to what the per-layer metrics and the breakdown read.

On the card the profiler records the CUDA activities alone (kernels,
copies, fills, and the host's CUDA runtime calls): recording every host
operation as well would slow the host's dispatch by more than the
device's work in a step, and the traced window would stand for another
program.  The harness marks its window and each request or step with its
own ranges (`Marks`, the host's realtime clock, the clock the profiler's
timestamps are on).  Busy time is the union of
device intervals inside the window; idle gaps are the window less that
union, each labelled by the harness's range and the innermost host call
running at the gap's middle ("python" where none is).
"""

from __future__ import annotations

import bisect
import contextlib
import heapq
import re
import time
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

WINDOW = "window"
TOP = 10


def profiler(device) -> profile:
    acts = ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda"
            else [ProfilerActivity.CPU])
    return profile(activities=acts, record_shapes=False, with_stack=False)


class Marks:
    """The harness's own ranges, by name, in ns of the realtime clock."""

    def __init__(self):
        self.ranges: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
        self._open: Dict[str, int] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.ranges[name].append((t0, time.time_ns()))

    def start(self, name: str) -> None:
        self._open[name] = time.time_ns()

    def stop(self, name: str) -> None:
        self.ranges[name].append((self._open.pop(name), time.time_ns()))


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def short_name(name: str, n: int = 64) -> str:
    """A kernel or call name cut to n characters of [A-Za-z0-9_.]."""
    return re.sub(r"[^A-Za-z0-9_.]", "_", name)[:n]


class Timeline:
    """The reduced trace of one window (times in ns of the realtime clock)."""

    def __init__(self, events, marks: Marks):
        device, host = [], []
        for e in events:
            if e.is_user_annotation():
                continue
            item = (e.start_ns(), e.end_ns(), e.name())
            (device if e.device_type() == torch.autograd.DeviceType.CUDA else host).append(item)
        if not marks.ranges.get(WINDOW):
            raise RuntimeError("the harness marked no window")
        self.w0, self.w1 = marks.ranges[WINDOW][0]
        self.device = [(max(a, self.w0), min(b, self.w1), n) for a, b, n in device
                       if b > self.w0 and a < self.w1]
        self.host = host
        self.marks = marks.ranges
        self.busy = _merge([(a, b) for a, b, _ in self.device])
        self._busy_starts = [a for a, _ in self.busy]

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) * 1e-9

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy) * 1e-9

    def spans(self, name: str) -> List[Tuple[int, int]]:
        """The harness's ranges `name` inside the window."""
        return [(a, b) for a, b in self.marks.get(name, []) if a >= self.w0 and b <= self.w1]

    def busy_within(self, a: int, b: int) -> float:
        """Seconds of device activity inside [a, b]."""
        i = max(bisect.bisect_right(self._busy_starts, a) - 1, 0)
        total = 0
        while i < len(self.busy) and self.busy[i][0] < b:
            lo, hi = max(self.busy[i][0], a), min(self.busy[i][1], b)
            total += max(hi - lo, 0)
            i += 1
        return total * 1e-9

    def device_seconds(self, pattern: str) -> float:
        """Summed device time of the activities whose name matches the regex."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, n in self.device if rx.search(n)) * 1e-9

    def device_ops(self) -> List[List]:
        """The TOP device activities by summed time, [name, seconds]."""
        by = defaultdict(int)
        for a, b, n in self.device:
            by[n] += b - a
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[short_name(n), t * 1e-9] for n, t in top]

    def gaps(self) -> List[Tuple[int, int]]:
        edges = [self.w0] + [x for iv in self.busy for x in iv] + [self.w1]
        return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]

    def idle_gaps(self, spans: Sequence[str]) -> List[List]:
        """The TOP labels of idle time by summed seconds: the harness range
        (one of `spans`, else "window") and the innermost host call running
        at each gap's middle."""
        marks = sorted((a, b, n) for n in spans for a, b in self.spans(n))
        host = sorted(self.host)
        by = defaultdict(int)
        active: List[Tuple[int, int, str]] = []   # max-heap on start
        hi = mi = 0
        for g0, g1 in self.gaps():
            mid = (g0 + g1) // 2
            while hi < len(host) and host[hi][0] <= mid:
                a, b, n = host[hi]
                heapq.heappush(active, (-a, b, n))
                hi += 1
            # the heap's top is the latest-started call; one that ended
            # before mid has ended for every later gap too
            while active and active[0][1] <= mid:
                heapq.heappop(active)
            inner = active[0][2] if active else "python"
            while mi < len(marks) and marks[mi][1] <= mid:
                mi += 1
            span = marks[mi][2] if mi < len(marks) and marks[mi][0] <= mid else "window"
            by[f"{span}:{short_name(inner, 48)}"] += g1 - g0
        top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP]
        return [[k, t * 1e-9] for k, t in top]


def reduce(prof: profile, marks: Marks) -> Timeline:
    return Timeline(prof.profiler.kineto_results.events(), marks)
