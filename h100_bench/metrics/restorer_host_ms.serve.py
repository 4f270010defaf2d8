"""Median over the traced window's requests of the harness's span around
each `Restorer` call less the device's activity inside it: the host's own
time of a request (numpy copy, padding, copies in and out, waits)."""

import statistics

MOVES = "image_p95_ms"


def read(ctx):
    if ctx.kind != "serve" or not ctx.on_device():
        return None
    tl = ctx.timeline
    own = [(b - a) * 1e-9 - tl.busy_within(a, b) for a, b in tl.spans("request")]
    return 1e3 * statistics.median(own) if own else None
