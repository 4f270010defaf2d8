"""Median over the traced window's `Restorer` calls of the time the device
sat idle inside the call's `restorer.copy_in` (the host array made
contiguous and copied into the graph's input) and `restorer.copy_out`
spans (the wait for the replay and the answer's copy to the host),
summed."""

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
    names = {P.RESTORER_COPY_IN, P.RESTORER_COPY_OUT}
    return 1e3 * statistics.median(ps.idle_inside(ctx.timeline, calls, names))
