"""GRL's static attention geometry, worked out by the reference itself:
relative-coordinate tables, position indices and shift-band ids of one
padded input size, as numpy arrays.

A frozen copy of the equations of GRL's stripe info, relative
coordinate table, relative position index and shift-mask regions
(https://github.com/ofsoundof/GRL-Image-Restoration), written for the
benchmark so that it takes no table from the program under test.
"""

from __future__ import annotations

from math import prod
from typing import Optional, Sequence, Tuple

import numpy as np

Size2 = Tuple[int, int]


def stripe_info(size: Sequence[Optional[int]], groups: Sequence[Optional[int]],
                shift: bool, res: Size2) -> Tuple[Size2, Size2]:
    """Per axis: the stripe extent (fixed, or the resolution over its
    groups) and the shift (half a fixed stripe when shifted; half a
    group's extent for a grouped axis)."""
    stripe, shifts = [], []
    for s, g, d in zip(size, groups, res):
        if g is None:
            stripe.append(s)
            shifts.append(s // 2 if shift else 0)
        else:
            stripe.append(d // g)
            shifts.append(0 if g == 1 else d // (g * 2))
    return tuple(stripe), tuple(shifts)


def band_ids(res: Size2, window: Size2, shift: Size2) -> np.ndarray:
    """(windows, tokens) shift-band id of each token: 3 * band(row) +
    band(col), where an axis has band 0 in the bulk, 1 in its last window
    and 2 in its last `shift` (2 everywhere at shift 0)."""
    def axis(n, w, s):
        ids = np.zeros(n, np.int64)
        ids[n - w:] = 1
        if s > 0:
            ids[n - s:] = 2
        else:
            ids[:] = 2
        return ids

    H, W = res
    ids = 3 * axis(H, window[0], shift[0])[:, None] + axis(W, window[1], shift[1])[None]
    ids = ids.reshape(H // window[0], window[0], W // window[1], window[1])
    return ids.transpose(0, 2, 1, 3).reshape(-1, prod(window))


def coords_table(window: Size2, pretrained: Size2 = (0, 0), df: int = 1) -> np.ndarray:
    """(Th * Tw, 2) log-spaced relative coordinates between a window and
    its df-times smaller anchor window, Th = wh + wh / df - 1."""
    aw = [w // df for w in window]
    paw = [w // df for w in pretrained]
    hi = [w1 - 1 - (w1 - w2) // 2 for w1, w2 in zip(window, aw)]
    lo = [-(w2 - 1) - (w1 - w2) // 2 for w1, w2 in zip(window, aw)]
    phi = [w1 - 1 - (w1 - w2) // 2 for w1, w2 in zip(pretrained, paw)]
    ch = np.arange(lo[0], hi[0] + 1, dtype=np.float64)
    cw = np.arange(lo[1], hi[1] + 1, dtype=np.float64)
    t = np.stack(np.meshgrid(ch, cw, indexing="ij"), -1)
    denom = phi if phi[0] > 0 else hi
    t[..., 0] /= denom[0]
    t[..., 1] /= denom[1]
    t *= 8
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8)
    return t.reshape(-1, 2).astype(np.float32)


def position_index(window: Size2, df: int = 1, window_to_anchor: bool = True) -> np.ndarray:
    """(N_query, N_key) index into the coordinate table of every pair: window
    tokens against anchor tokens, or anchors against window tokens."""
    aw = [w // df for w in window]
    span = aw[1] + window[1] - 1

    def grid(n):
        return np.stack(np.meshgrid(np.arange(n[0]), np.arange(n[1]),
                                    indexing="ij")).reshape(2, -1)

    if window_to_anchor:
        c1, c2, off = grid(window), grid(aw), aw
    else:
        c1, c2, off = grid(aw), grid(window), window
    d = (c1[:, :, None] - c2[:, None, :]).transpose(1, 2, 0).copy()
    d[:, :, 0] += off[0] - 1
    d[:, :, 1] += off[1] - 1
    d[:, :, 0] *= span
    return d.sum(-1)


def pad_size(m: dict) -> int:
    """Spatial sizes a GRL forward pads its input to a multiple of."""
    ss = max(0 if s is None else s for s in m["stripe_size"])
    sg = max(0 if g is None else g for g in m["stripe_groups"])
    return max(m["window_size"], ss, sg * m["anchor_window_down_factor"])
