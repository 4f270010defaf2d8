"""Share of the traced window in which nothing ran on the device (the
window less the union of device intervals), the train cell."""

MOVES = "train_samples_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.on_device():
        return None
    tl = ctx.timeline
    return 100.0 * (tl.window_s - tl.busy_s) / tl.window_s
