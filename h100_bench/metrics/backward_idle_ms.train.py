"""Mean over the traced window's train steps (the port's `train.step`
spans) of the time the device sat idle inside the step's `train.backward`
span (`zero_grad` and autograd's backward)."""

from h100_bench import program_spans as ps

MOVES = "train_samples_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.on_device():
        return None
    P = ps.port()
    steps = ps.window_trees(ctx, P.TRAIN_STEP) if P else []
    if not steps:
        return None
    return 1e3 * sum(ps.idle_inside(ctx.timeline, steps, {P.TRAIN_BACKWARD})) / len(steps)
