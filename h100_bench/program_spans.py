"""The port's own spans (`grlir_torch.utils.profiling.span`) in a traced
window, for the readers that put the device's idle time down to a part of
the program.

The port records its spans while a torch profiler runs, on the clock the
profiler stamps device activity with, and keeps them until they are
drained; the traced window runs under the profiler, so once the run has
ended its spans are there to read.  A program without the recorder gives
nothing to read.  Besides `program.py` and the cell modules, this module
alone imports the program.
"""

from __future__ import annotations

from typing import List, Tuple


def port():
    """The port's profiling module where it records spans, else None."""
    from grlir_torch.utils import profiling

    return profiling if hasattr(profiling, "recorded_spans") else None


def window_trees(ctx, root: str) -> List[Tuple[object, list]]:
    """Each span named `root` that lies inside the traced window, with the
    spans under it, in the order the roots started."""
    P = port()
    if P is None or ctx.timeline is None:
        return []
    tl = ctx.timeline
    spans = P.recorded_spans()
    roots = sorted((s for s in spans if s.name == root and s.parent is None
                    and s.start_ns >= tl.w0 and s.end_ns <= tl.w1), key=lambda s: s.start_ns)
    under = {r.id: [] for r in roots}
    for s in spans:
        if s.root in under and s.id != s.root:
            under[s.root].append(s)
    return [(r, under[r.id]) for r in roots]


def idle_s(tl, s) -> float:
    """Seconds inside span s with nothing running on the device."""
    return (s.end_ns - s.start_ns) * 1e-9 - tl.busy_within(s.start_ns, s.end_ns)


def idle_inside(tl, trees, names) -> List[float]:
    """For each tree, the device's idle seconds summed over the spans under
    its root whose name is one of `names`."""
    return [sum(idle_s(tl, s) for s in under if s.name in names) for _, under in trees]
