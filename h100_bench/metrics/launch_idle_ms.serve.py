"""Median over the traced window's `Restorer` calls of the time the device
sat idle inside the call's `restorer.replay` span: the host launching the
padded shape's CUDA graph while nothing of the forward runs yet."""

import statistics

from h100_bench import program_spans as ps

MOVES = "restore_mpix_s"


def read(ctx):
    if ctx.kind != "serve" or not ctx.on_device():
        return None
    P = ps.port()
    calls = ps.window_trees(ctx, P.RESTORER_CALL) if P else []
    if not calls:
        return None
    return 1e3 * statistics.median(ps.idle_inside(ctx.timeline, calls, {P.RESTORER_REPLAY}))
