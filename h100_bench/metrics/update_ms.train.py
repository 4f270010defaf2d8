"""Mean over the traced window's train steps of the port's `train.update`
span (the optimizer's and the LR scheduler's steps) on the host's clock."""

from h100_bench import program_spans as ps

MOVES = "train_samples_s"


def read(ctx):
    if ctx.kind != "train" or not ctx.on_device():
        return None
    P = ps.port()
    steps = ps.window_trees(ctx, P.TRAIN_STEP) if P else []
    if not steps:
        return None
    total = sum(s.end_ns - s.start_ns for _, under in steps for s in under
                if s.name == P.TRAIN_UPDATE)
    return 1e-6 * total / len(steps)
