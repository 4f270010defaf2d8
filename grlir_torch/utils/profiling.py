"""Profiling and observability hooks, the port of `grlir.utils.profiling`:
a trace of a block (`torch.profiler`, Chrome/Perfetto JSON), device memory
stats, a program's FLOPs and bytes for roofline checks (`cost_analysis`),
step timing and a JSONL scalar log.

The port's CUDA kernels are called through ctypes, not as aten operators,
so neither torch's FLOP counter nor a dispatch mode sees them: each kernel
wrapper reports its own work with `kernel_work` where it launches, and a
forward counts the same FLOPs with its kernels on or off.
"""

from __future__ import annotations

import contextlib
import json
import os
import os.path as osp
import time
from typing import Callable, Dict

# the [flops, bytes] accumulators of the cost analyses running now
_ACTIVE: list = []


def kernel_work(work: Callable, *args) -> None:
    """Add a kernel launch's work to every running `cost_analysis`:
    `work(*args)` -> (flops, bytes), evaluated only while one runs."""
    if _ACTIVE:
        flops, nbytes = work(*args)
        for acc in _ACTIVE:
            acc[0] += flops
            acc[1] += nbytes


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors given (None skipped)."""
    import torch

    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a `torch.profiler` trace (CPU, and CUDA where there is a
    card) around a block; writes `<log_dir>/trace.json` (Chrome/Perfetto
    format) and yields the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        if torch.cuda.is_available():
            # CUPTI has been seen to miss the first kernels of a session: one
            # small kernel, finished, before the block
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(osp.join(log_dir, "trace.json"))


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-device memory in MB, {"cuda:i": {"bytes_in_use_mb",
    "peak_bytes_mb"}} from `torch.cuda.memory_stats`; {} without CUDA, as
    grlir returns for a backend without stats."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        if stats:
            out[str(torch.device("cuda", i))] = {
                "bytes_in_use_mb": stats.get("allocated_bytes.all.current", 0) / 1e6,
                "peak_bytes_mb": stats.get("allocated_bytes.all.peak", 0) / 1e6,
            }
    return out


def _cost_mode():
    """A dispatch mode that counts every operator's FLOPs by the formulas
    of torch's `FlopCounterMode` (its registry, without the module tracker
    that mode adds, which fails on weight views taken under no_grad) and
    sums the tensor inputs and outputs of every operator that moves data
    (views and bare allocations skipped)."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    from torch.utils.flop_counter import flop_registry

    skip = {torch.ops.aten.empty.memory_format, torch.ops.aten.empty_strided.default,
            torch.ops.aten.empty_like.default}

    class CostMode(TorchDispatchMode):
        flops = 0
        nbytes = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                CostMode.flops += count(*args, **kwargs, out_val=out)
            if func not in skip and not func.is_view:
                CostMode.nbytes += tensor_bytes(*tree_flatten((args, kwargs))[0],
                                                *tree_flatten(out)[0])
            return out

    return CostMode()


def cost_analysis(fn: Callable, *args) -> Dict[str, float]:
    """FLOPs and bytes of running fn(*args) once, under grlir's keys
    (`flops`, `bytes_accessed`, `arithmetic_intensity`).

    FLOPs are counted by the formulas of torch's `FlopCounterMode` (2·M·N·K
    a product, and convolutions), plus the work each CUDA kernel of the
    port reports at its launch.  Bytes are the tensor inputs plus outputs
    of every dispatched operator, views and bare allocations aside, plus
    each kernel's operands read once and output written once: the
    per-operator sum that XLA's "bytes accessed" approximates for a
    compiled program.  A fused kernel moves fewer bytes than its plain
    version, so `bytes_accessed` depends on whether the kernels run; FLOPs
    do not."""
    acc = [0, 0]
    _ACTIVE.append(acc)
    mode = _cost_mode()
    try:
        with mode:
            fn(*args)
    finally:
        _ACTIVE.remove(acc)
    flops = float(type(mode).flops + acc[0])
    nbytes = float(type(mode).nbytes + acc[1])
    return {
        "flops": flops,
        "bytes_accessed": nbytes,
        "arithmetic_intensity": flops / max(nbytes, 1.0),
    }


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
