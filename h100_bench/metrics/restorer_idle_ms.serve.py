"""Median over the traced window's `Restorer` calls (the port's
`restorer.call` spans) of the time inside each with nothing running on the
device: the host's own time of a request (numpy copy, padding, copies in
and out, waits)."""

import statistics

from h100_bench import program_spans as ps

MOVES = "image_p95_ms"


def read(ctx):
    if ctx.kind != "serve" or not ctx.on_device():
        return None
    P = ps.port()
    calls = ps.window_trees(ctx, P.RESTORER_CALL) if P else []
    if not calls:
        return None
    return 1e3 * statistics.median(ps.idle_s(ctx.timeline, c) for c, _ in calls)
