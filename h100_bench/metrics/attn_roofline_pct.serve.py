"""The least time for the attention halves' work of the traced window's
forwards (`work.attention_halves` on each request's padded canvas) over
the device time of the kernels `attn_kernels.json` names.  Nothing to read
where a half took the plain path (the port's `unrouted_halves`)."""

import json
from pathlib import Path

from h100_bench import work

MOVES = "restore_mpix_s"
KERNELS = json.loads(Path(__file__).with_name("attn_kernels.json").read_text())["kernels"]


def read(ctx):
    if ctx.kind != "serve" or not ctx.on_device() or ctx.counts["unrouted_halves"]:
        return None
    t = ctx.timeline.device_seconds(r"\b(" + "|".join(KERNELS) + r")\b")
    if t <= 0:
        return None
    m, bucket = ctx.model, ctx.traffic["shape_bucket"]
    least = sum(work.least_seconds(work.attention_halves(
        m, *work.canvas(m, h, w, bucket), 1, ctx.dtype), ctx.dtype)
        for h, w in ctx.counts["shapes"])
    return 100.0 * least / t
