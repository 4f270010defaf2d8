"""A serving cell: one client sends requests in a closed loop to the port's
`Restorer` (bucket padding, one CUDA graph a padded shape, numpy in and
out), each the next of the mix's LR images, for the window's seconds.

Set-up makes the weights and every image of the mix from the seed, builds
the model and captures every padded shape the mix gives.  The window times
each call from its start to the numpy output in hand.  A sample of the
answers, drawn from the seed with every shape in it, is kept; once the
window has closed and the program is freed, the reference answers the
same requests and the check compares.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from h100_bench import check, inputs, program, traffic
from h100_bench import trace as tr
from h100_bench.weights import cell_weights

# the numbers the check compares (`check.serve_numbers`)
NUMBERS = ("rms_err", "max_err")

# eager calls a shape takes after its capture in set-up, so that the
# window finds every replay path warm
WARM_CALLS = 2


@dataclass
class Served:
    latencies: List[float] = field(default_factory=list)
    shapes: List[int] = field(default_factory=list)
    failed: int = 0
    window_s: float = 0.0
    kept: Dict[tuple, np.ndarray] = field(default_factory=dict)
    timeline: Optional[tr.Timeline] = None


def pools(mix: dict, seed: int, device) -> List[np.ndarray]:
    """Each shape's pool of LR images, float32 NHWC on the host."""
    return [inputs.structured(mix["pool"], h, w, inputs.sub_seed(seed, 2, i), device)
            .cpu().numpy() for i, (h, w) in enumerate(mix["shapes"])]


class Reservoir:
    """k answers of each shape, a uniform sample of those served, drawn
    from the seed (Algorithm R).  An answer taken is copied into a buffer
    made before the window, so that the client drops every answer it gets,
    as a client that only consumes them would, and allocates nothing."""

    def __init__(self, shapes, k: int, scale: int, seed: int):
        self.k, self.rng = k, np.random.default_rng(seed)
        self.seen = [0] * len(shapes)
        self.slots = [[] for _ in shapes]
        # written once now, so that no copy in the window meets a fresh page
        self.buffers = [[np.full((1, h * scale, w * scale, 3), 0.0, np.float32) for _ in range(k)]
                        for h, w in shapes]

    def offer(self, s: int, j: int, y: np.ndarray) -> None:
        self.seen[s] += 1
        if len(self.slots[s]) < self.k:
            slot = len(self.slots[s])
            self.slots[s].append(None)
        else:
            slot = int(self.rng.integers(self.seen[s]))
            if slot >= self.k:
                return
        np.copyto(self.buffers[s][slot], y)
        self.slots[s][slot] = (s, j, self.buffers[s][slot])

    def items(self):
        return [it for slot in self.slots for it in slot]


def serve(restorer, mix: dict, images: List[np.ndarray], seed: int, seconds: float,
          device, traced: bool) -> Served:
    """The closed loop for `seconds`; with `traced`, under the profiler."""
    out = Served()
    scale = restorer.scale
    order = traffic.requests(mix, inputs.sub_seed(seed, 3))
    sample = Reservoir(mix["shapes"], mix["sample_per_shape"], scale, inputs.sub_seed(seed, 4))
    prof = tr.profiler(device) if traced else None
    marks = tr.Marks()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if prof is not None:
        prof.start()
    marks.start(tr.WINDOW)
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        t = time.perf_counter()
        if t >= end:
            break
        s, j = next(order)
        with marks.span("request"):
            try:
                y = restorer(images[s][j:j + 1])
            except RuntimeError:
                out.failed += 1
                continue
        out.latencies.append(time.perf_counter() - t)
        out.shapes.append(s)
        sample.offer(s, j, y)
        del y
    out.window_s = time.perf_counter() - t0
    marks.stop(tr.WINDOW)
    if prof is not None:
        prof.stop()
        out.timeline = tr.reduce(prof, marks)
    out.kept = {(s, j, n): y for n, (s, j, y) in enumerate(sample.items())}
    return out


def setup(cell, seed: int, device):
    """(restorer, images, unrouted halves) after every shape is captured and warm."""
    from grlir_torch.engines.inference import Restorer

    mix, m = cell.traffic, cell.model()
    images = pools(mix, seed, device)
    model = program.grl(cell, cell_weights(cell, seed, device), device).eval()
    restorer = Restorer(model, device, scale=m["upscale"], shape_bucket=mix["shape_bucket"])
    before = program.unrouted_halves()
    for pool in images:
        for _ in range(1 + WARM_CALLS):
            restorer(pool[:1])
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return restorer, images, program.unrouted_halves() - before


def reference_numbers(cell, seed: int, images, kept, device, prec=None) -> Dict[str, float]:
    """The check's numbers of the kept answers against the reference's."""
    m = cell.model()
    P = cell_weights(cell, seed, device)
    bucket = cell.traffic["shape_bucket"]
    pairs = []
    for (s, j, _), got in kept.items():
        img = torch.as_tensor(images[s][j:j + 1], device=device)
        with torch.no_grad():
            pairs.append((got, cell.reference.restore(P, m, img, bucket, prec)))
    return check.serve_numbers(pairs)


def run(cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    device = torch.device(device)
    mix = cell.traffic
    restorer, images, unrouted = setup(cell, seed, device)
    setup_s = time.perf_counter() - t0
    window = min(seconds, mix["trace_seconds"]) if traced else seconds
    got = serve(restorer, mix, images, seed, window, device, traced)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    del restorer
    free(device)
    numbers = reference_numbers(cell, seed, images, got.kept, device)
    lat_ms = np.array(got.latencies) * 1e3
    pixels = sum(mix["shapes"][s][0] * mix["shapes"][s][1] for s in got.shapes)
    return {
        "attempted": len(got.latencies) + got.failed,
        "failed": got.failed,
        "numbers": numbers,
        "memory_peak_bytes": peak,
        "end_to_end": {
            "restore_mpix_s": pixels / 1e6 / got.window_s,
            "image_p95_ms": float(np.percentile(lat_ms, 95)),
            "setup_s": setup_s,
        },
        "log": (f"image_ms median {float(np.median(lat_ms))!r} "
                f"p90 {float(np.percentile(lat_ms, 90))!r} "
                f"p95 {float(np.percentile(lat_ms, 95))!r} "
                f"p99 {float(np.percentile(lat_ms, 99))!r} "
                f"n {len(lat_ms)}; window_s {got.window_s!r}; "
                f"memory_peak_bytes {peak}; unrouted_halves {unrouted}"),
        "timeline": got.timeline,
        "spans": ["request"],
        "context": {"shapes": [tuple(mix["shapes"][s]) for s in got.shapes],
                    "unrouted_halves": unrouted},
    }


def readings(cell, seeds, control_seeds, seconds, device):
    """Set up once and take each seed's weights in place (the CUDA graphs
    read them where they lie), serve a short window of the cell's own
    traffic and check as many answers as a run keeps; on the control
    seeds also the reference with fp8 products in the program's place."""
    m, mix = cell.model(), cell.traffic
    restorer, _, unrouted = setup(cell, seeds[0], device)
    yield {"workload": cell.name, "unrouted_halves": unrouted}
    for seed in seeds:
        t = time.perf_counter()
        restorer.model.load_state_dict(cell_weights(cell, seed, device))
        images = pools(mix, seed, device)
        got = serve(restorer, mix, images, seed, seconds, device, False)
        yield {"kind": "program", "seed": seed, "answers": len(got.kept),
               "numbers": reference_numbers(cell, seed, images, got.kept, device),
               "seconds": time.perf_counter() - t}
        if seed in control_seeds:
            P, fp8 = cell_weights(cell, seed, device), {}
            for key in got.kept:
                img = torch.as_tensor(images[key[0]][key[1]:key[1] + 1], device=device)
                with torch.no_grad():
                    fp8[key] = cell.reference.restore(P, m, img, mix["shape_bucket"],
                                                      "fp8").cpu().numpy()
            yield {"kind": "control", "seed": seed,
                   "numbers": reference_numbers(cell, seed, images, fp8, device)}


def tiny_traffic(mix: dict) -> dict:
    """One or two small shapes, two images each, buckets of 16."""
    return {**mix, "shapes": [[32, 32]] if len(mix["shapes"]) == 1 else [[32, 32], [24, 40]],
            "pool": 2, "shape_bucket": 16, "sample_per_shape": 1}


def free(device) -> None:
    """Release the program's memory before the reference runs."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
