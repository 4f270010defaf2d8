"""Model FLOPs of the traced window's optimizer steps: three times the
forward's (forward and backward; the backward's recompute of the kernels'
plain twins is not counted), over the window and the card's peak for the
compute type."""

from h100_bench import work

MOVES = "train_samples_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.on_device() or not ctx.counts["steps"]:
        return None
    t = ctx.traffic
    flops = 3 * work.model_flops(ctx.model, t["lr_patch"], t["lr_patch"], t["batch"])
    return (100.0 * flops * ctx.counts["steps"] / ctx.timeline.window_s
            / work.PEAKS[f"{ctx.dtype}_flops"])
