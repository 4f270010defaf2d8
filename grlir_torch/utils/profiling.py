"""Profiling and observability hooks, the port of `grlir.utils.profiling`:
a trace of a block (`torch.profiler`, Chrome/Perfetto JSON), device memory
stats, a program's FLOPs and bytes for roofline checks (`cost_analysis`),
the program's own spans (`span`) and a JSONL scalar log.

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
import threading
import time
from itertools import count
from typing import Callable, Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _torch_profiler

# the [flops, bytes] accumulators of the cost analyses running now
_ACTIVE: list = []

# The program's spans, one name a layer boundary (the benchmark's readers
# and PERF.md use these strings).  A `Restorer` call and a train step are
# roots; the others hang under them.
RESTORER_CALL = "restorer.call"          # Restorer.__call__: padding, tiling, crop
RESTORER_CAPTURE = "restorer.capture"    # warm-up forwards and capture of a new shape
RESTORER_COPY_IN = "restorer.copy_in"    # host array to the graph's static input
RESTORER_REPLAY = "restorer.replay"      # the graph's launch
RESTORER_COPY_OUT = "restorer.copy_out"  # the wait for the replay and the copy to the host
TRAIN_STEP = "train.step"
TRAIN_FORWARD = "train.forward"          # drop-path masks and the model's forward
TRAIN_BACKWARD = "train.backward"        # zero_grad and the backward
TRAIN_UPDATE = "train.update"            # the optimizer's and the LR scheduler's steps


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
    format), with the program's spans of the block (`span` records under
    the profiler) drained into it as host events, and yields the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = osp.join(log_dir, "trace.json")
    first = len(_SPANS)
    with profile(activities=activities) as prof:
        if torch.cuda.is_available():
            # CUPTI has been seen to miss the first kernels of a session: one
            # small kernel, finished, before the block
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    block = _SPANS[first:]
    del _SPANS[first:first + len(block)]
    # torch writes each timestamp in microseconds after baseTimeNanoseconds
    doc["traceEvents"] += _chrome_events(block, doc.get("baseTimeNanoseconds", 0))
    with open(path, "w") as f:
        json.dump(doc, f)


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


class Span(NamedTuple):
    """One recorded span: times in ns of `time.time_ns()`, the clock
    `torch.profiler` stamps host and device activity with; `parent` is
    the enclosing span's id (None for a root), `root` the id of the
    outermost span around it (its own for a root)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: Optional[int]
    root: int


# Spans are recorded while recording is switched on (`record_spans`) or
# while a torch profiler runs, so that a profiled window carries the
# program's spans on the profiler's clock.  Off, `span` hands back one
# shared no-op context: no clock read, no allocation, no lock.
_recording = False
_SPANS: List[Span] = []
_IDS = count(1)
_THREAD = threading.local()   # each thread's stack of open spans
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("name", "stack", "id", "parent", "root", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = getattr(_THREAD, "stack", None)
        if stack is None:
            stack = _THREAD.stack = []
        self.stack = stack
        self.id = next(_IDS)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        self.stack.pop()
        _SPANS.append(Span(self.name, self.t0, t1, self.id, self.parent, self.root))
        return False


def span(name: str):
    """A context that records the block as the span `name`, under the span
    open around it on this thread.  It never waits for the device."""
    if not (_recording or _torch_profiler._is_profiler_enabled):
        return _OFF
    return _Open(name)


def record_spans(on: bool = True) -> None:
    """Switch span recording on or off; what was recorded stays until
    drained."""
    global _recording
    _recording = on


def recorded_spans() -> List[Span]:
    """The spans recorded and not drained, in the order they ended."""
    return list(_SPANS)


def drain_spans() -> List[Span]:
    """The spans recorded and not drained, in the order they ended; the
    buffer is left empty."""
    out = _SPANS[:]
    del _SPANS[:len(out)]
    return out


def _chrome_events(spans: List[Span], base_ns: int) -> List[dict]:
    """The spans as complete ("X") host events of a Chrome trace whose
    timestamps are microseconds after base_ns, on this thread's track."""
    pid, tid = os.getpid(), threading.get_native_id()
    return [{"ph": "X", "cat": "grlir_torch", "name": s.name, "pid": pid, "tid": tid,
             "ts": (s.start_ns - base_ns) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"id": s.id, "parent": s.parent, "root": s.root}} for s in spans]


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
