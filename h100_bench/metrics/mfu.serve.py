"""Model FLOPs of the traced window's forwards, each at its image's own LR
shape (`work.model_flops`: padding is not useful work), over the window
and the card's peak for the compute type."""

from h100_bench import work

MOVES = "restore_mpix_s"


def read(ctx):
    if ctx.kind != "serve" or not ctx.on_device() or not ctx.counts["shapes"]:
        return None
    flops = sum(work.model_flops(ctx.model, h, w) for h, w in ctx.counts["shapes"])
    return 100.0 * flops / ctx.timeline.window_s / work.PEAKS[f"{ctx.dtype}_flops"]
