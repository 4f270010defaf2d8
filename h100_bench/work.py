"""Operations and bytes of GRL's work, counted from shapes by the benchmark
(the yardstick of `mfu.*` and `attn_roofline_pct.*`).

Operations are those of the matrix products and convolutions, two a
multiply-add, as a product-counting profiler counts them
(`torch.utils.flop_counter`); normalisation, softmax and element-wise work
are not counted.  The tests hold these formulas to such a count of the
reference forward at small sizes.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import List, Tuple

from h100_bench.reference.geometry import pad_size

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def _cpb(table: int, heads: int) -> float:
    """The position-bias MLP over a table of `table` entries."""
    return 2.0 * table * (2 * 512 + 512 * heads)


def _stripe_tokens(m: dict, res: Tuple[float, float], vertical: bool):
    """(tokens of a stripe, its extent) of an H or a W (vertical) block."""
    size, groups = tuple(m["stripe_size"]), tuple(m["stripe_groups"])
    if vertical:
        size, groups = size[::-1], groups[::-1]
    ext = [s if g is None else d / g for s, g, d in zip(size, groups, res)]
    return ext[0] * ext[1], ext


def model_flops(m: dict, h: float, w: float, batch: int = 1) -> float:
    """Operations of one forward of `batch` images of h x w, counted at the
    images' own size (a padded canvas is not useful work)."""
    C, nf, cin, s = m["embed_dim"], m["num_out_feats"], m["in_channels"], m["upscale"]
    r = int(C * m["mlp_ratio"])
    df = m["anchor_window_down_factor"]
    T = batch * h * w
    win = m["window_size"]
    total = 2 * T * 9 * cin * C                                   # conv_first
    for st, depth in enumerate(m["depths"]):
        hw, hs = m["num_heads_window"][st], m["num_heads_stripe"][st]
        for b in range(depth):
            n1, ext = _stripe_tokens(m, (h, w), b % 2 == 1)
            total += 2 * T * C * 3 * C                            # qkv
            total += 2 * (T / df ** 2) * C * (C // 2)             # anchor
            total += 4 * T * win * win * (C // 2)                 # window attention
            total += 8 * T * n1 * (C // 2) / df ** 2              # a2w + w2a
            total += 2 * T * C * C + 4 * T * C * r                # proj, mlp
            total += _cpb((2 * win - 1) ** 2, hw)
            at = (ext[0] + ext[0] / df - 1) * (ext[1] + ext[1] / df - 1)
            total += 2 * _cpb(at, hs)
            if m["local_connection"]:
                total += 4 * T * 9 * C * (C // 4) + 4 * batch * C * (C // 18)
        total += 2 * T * 9 * C * C                                # stage conv
    total += 2 * T * 9 * C * C + 2 * T * 9 * C * nf               # body, pre-upsample
    for i in range(int(math.log2(s))):
        total += 2 * T * 4 ** i * 9 * nf * 4 * nf
    total += 2 * T * s * s * 9 * nf * cin                         # conv_last
    return total


def canvas(m: dict, h: int, w: int, bucket: int = 0) -> Tuple[int, int]:
    """The padded size the program's kernels work on."""
    if bucket:
        h, w = h + (-h % bucket), w + (-w % bucket)
    k = pad_size(m)
    return h + (-h % k), w + (-w % k)


def attention_halves(m: dict, H: int, W: int, batch: int, dtype: str) -> List[Tuple[float, float]]:
    """(operations, bytes) of every block's two attention halves, each a
    whole half as one call computes it: the half's qkv projection and its
    attention (window; anchors to stripes and stripes to anchors), on a
    canvas of H x W.  Bytes: each input read once (tokens, the projection's
    weights and bias, the position biases, the anchors) and the output
    written once, every element at the compute type's size."""
    C, df, win = m["embed_dim"], m["anchor_window_down_factor"], m["window_size"]
    T = batch * H * W
    e = ITEMSIZE[dtype]
    proj = 2 * T * C * 3 * C // 2
    proj_w = C * 3 * C // 2 + 3 * C // 2
    halves = []
    for st, depth in enumerate(m["depths"]):
        hw, hs = m["num_heads_window"][st], m["num_heads_stripe"][st]
        for b in range(depth):
            n1, _ = _stripe_tokens(m, (H, W), b % 2 == 1)
            n2 = n1 / df ** 2
            halves.append((proj + 4 * T * win * win * (C // 2),
                           e * (T * C + proj_w + hw * (win * win) ** 2 + T * C // 2)))
            halves.append((proj + 8 * T * n2 * (C // 2),
                           e * (T * C + T / df ** 2 * C // 2 + proj_w
                                + 2 * hs * n1 * n2 + T * C // 2)))
    return halves


def least_seconds(halves: List[Tuple[float, float]], dtype: str) -> float:
    """The least time the card can take for a sequence of calls: each
    call's operations at the peak of the compute type's tensor cores, or its
    bytes at the memory's bandwidth, whichever is longer."""
    peak, bw = PEAKS[f"{dtype}_flops"], PEAKS["hbm_bytes_s"]
    return sum(max(ops / peak, nbytes / bw) for ops, nbytes in halves)
