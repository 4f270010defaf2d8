"""Share of the traced window in which nothing ran on the device (the
window less the union of device intervals), serving cells."""

MOVES = "restore_mpix_s"


def read(ctx):
    if ctx.kind != "serve" or not ctx.on_device():
        return None
    tl = ctx.timeline
    return 100.0 * (tl.window_s - tl.busy_s) / tl.window_s
