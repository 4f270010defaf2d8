"""The least time for the attention halves' work of the traced window's
forward passes (`work.attention_halves` on the batch's canvas, once a
step) over the device time of the kernels `attn_kernels.json` names (the
backward runs the halves' plain twins).  Nothing to read where a half took
the plain path (the port's `unrouted_halves`)."""

import json
from pathlib import Path

from h100_bench import work

MOVES = "train_samples_s"
KERNELS = json.loads(Path(__file__).with_name("attn_kernels.json").read_text())["kernels"]


def read(ctx):
    if ctx.kind != "train" or not ctx.on_device() or ctx.counts["unrouted_halves"]:
        return None
    t = ctx.timeline.device_seconds(r"\b(" + "|".join(KERNELS) + r")\b")
    if t <= 0:
        return None
    m, tr = ctx.model, ctx.traffic
    H, W = work.canvas(m, tr["lr_patch"], tr["lr_patch"])
    least = work.least_seconds(work.attention_halves(m, H, W, tr["batch"], ctx.dtype), ctx.dtype)
    return 100.0 * least * ctx.counts["steps"] / t
