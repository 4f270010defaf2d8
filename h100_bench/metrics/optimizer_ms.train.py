"""Mean over the traced window's steps of the optimizer's step on the
host, from torch's global optimizer step hooks (the update's dispatch:
AdamW's foreach launches and the parameter loop)."""

MOVES = "train_samples_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.on_device():
        return None
    d = [(b - a) * 1e-9 for a, b in ctx.timeline.spans("optimizer")]
    return 1e3 * sum(d) / len(d) if d else None
